"""The upsampler's linear attention: the route rule of
``ops.linear_attend_fused`` (the plain form where autograd may
differentiate a call, or where the kernel does not take its dtype or head
dim on the card; else ``linear_attend_fwd``: the kernel on a CUDA tensor,
the plain form on a CPU one), and the kernel ``csrc/linear_attention.cu``.

On the CPU: the rule over grad mode, each operand's ``requires_grad``,
``plain_reference()``, the forward-over-reverse mode, the device type (a
CUDA device is passed to the rule itself), the dtype and the head dim;
``linear_attend_fused`` bitwise the function it replaced, with and without
a gradient, gradients included; the entry's refusals on meta tensors.
Marked ``cuda`` (skipped without a card; run there with ``python -m pytest
--noconftest -m cuda tests/test_torch_linear_attention.py``): the kernel
against the plain form at every linear-attention shape of
``upsampler-256`` (batch 8) and ``upsampler-1024`` (batch 1) as the
``to_qkv`` chunk views, at ragged n and odd b·H, with a column max that
first appears in the last split and with large magnitudes; two calls
bitwise equal, a CUDA graph's replay bitwise the eager call, and an eager
upsampler ``generate`` with every linear attention on the kernel.  This
file imports no JAX."""

import contextlib
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu_torch import GigaGAN, ops  # noqa: E402
from gigagan_tpu_torch.models.layers import init_parameters  # noqa: E402
from gigagan_tpu_torch.models.unet_upsampler import (  # noqa: E402
    LinearAttention2D,
)
from gigagan_tpu_torch.ops.attention import linear_attend_route  # noqa
from gigagan_tpu_torch.ops.kernels import linear_attention as kla  # noqa
from gigagan_tpu_torch.ops.kernels import plain_reference  # noqa: E402
from gigagan_tpu_torch.ops.kernels.flash_attention_hv import (  # noqa: E402
    flash_hv_mode,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# the kernel's distance from a float64 evaluation on the same bf16
# operands may be at most this many times the plain bf16 form's
FROM_F64_RATIO = chip_smoke.LINATTN_FROM_F64_RATIO


def todays_linear_attend_fused(q, k, v, *, heads, scale=None):
    """``ops.linear_attend_fused`` as it was before it had a kernel."""
    b, n, hd = q.shape
    d = hd // heads
    if scale is None:
        scale = d ** -0.5
    qf = torch.softmax(q.float().reshape(b, n, heads, d), dim=-1) * scale
    kr = k.reshape(b, n, heads, d).float()
    e = torch.exp(kr - kr.amax(dim=1, keepdim=True).detach())
    kf = e / e.sum(dim=1, keepdim=True)
    vh = v.reshape(b, n, heads, d)
    context = torch.einsum("bnhd,bnhe->bhde", kf.to(v.dtype), vh)
    out = torch.einsum("bnhd,bhde->bnhe", qf.to(q.dtype),
                       context.to(q.dtype))
    return out.reshape(b, n, hd).to(q.dtype)


def chunks(b, n, heads, d=64, dtype=torch.float32, device="cpu", seed=0,
           k_scale=1.0):
    """q, k, v (b, n, H·d) as the chunk views of one (b, n, 3·H·d)
    projection, as ``LinearAttention2D`` makes them."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, n, 3 * heads * d, generator=g, device=device)
    qkv[..., heads * d:2 * heads * d] *= k_scale
    return qkv.to(dtype).chunk(3, dim=-1)


# ------------------------------------------------------------- the route

GRAD_MODES = ("enabled", "no_grad", "inference_mode")
# (dtype, head dim): the kernel takes the first alone
KINDS = [(torch.bfloat16, 64), (torch.float32, 64), (torch.bfloat16, 32),
         (torch.bfloat16, 128)]


def grad_mode(mode):
    return {"enabled": torch.enable_grad, "no_grad": torch.no_grad,
            "inference_mode": torch.inference_mode}[mode]()


@pytest.mark.parametrize("kind", range(len(KINDS)))
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("hv", [False, True])
@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("needs_grad", [None, "q", "k", "v"])
@pytest.mark.parametrize("mode", GRAD_MODES)
def test_linear_attend_route(mode, needs_grad, plain, hv, device, kind):
    dtype, d = KINDS[kind]
    named = dict(zip("qkv", chunks(1, 4, 2, d=d, dtype=dtype)))
    if needs_grad is not None:
        named[needs_grad] = named[needs_grad].detach().requires_grad_(True)
    with grad_mode(mode), (plain_reference() if plain
                           else contextlib.nullcontext()), (
            flash_hv_mode() if hv else contextlib.nullcontext()):
        got = linear_attend_route(torch.device(device), *named.values(), 2)
    differentiated = mode == "enabled" and needs_grad is not None
    if plain or hv or differentiated:
        assert got == "autograd"
    elif device == "cpu":
        assert got == "plain"
    else:
        assert got == ("kernel" if kind == 0 else "autograd")


@pytest.mark.parametrize("mode", GRAD_MODES)
def test_fused_reaches_the_dispatcher_only_without_grad(mode, monkeypatch):
    calls = []

    def counted(q, k, v, *, heads, scale):
        calls.append(q.shape)
        return kla.linear_attend_plain(q, k, v, heads=heads, scale=scale)

    monkeypatch.setattr(kla, "linear_attend_fwd", counted)
    q, k, v = chunks(2, 10, 2)
    q = q.detach().requires_grad_(True)
    with grad_mode(mode):
        ops.linear_attend_fused(q, k, v, heads=2)
    assert len(calls) == (mode != "enabled")


# ----------------------------------------------- bitwise today's on the CPU

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d,n", [(2, 8, 37), (1, 64, 70),
                                       (3, 16, 5)])
def test_fused_is_bitwise_todays(heads, d, n, dtype):
    q, k, v = chunks(2, n, heads, d=d, dtype=dtype, seed=n)
    want = todays_linear_attend_fused(q, k, v, heads=heads)
    with torch.no_grad():
        assert torch.equal(ops.linear_attend_fused(q, k, v, heads=heads),
                           want)
    with torch.inference_mode():
        assert torch.equal(ops.linear_attend_fused(q, k, v, heads=heads,
                                                   scale=d ** -0.5), want)
    # with a gradient: the plain form, and the same gradients
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    got = ops.linear_attend_fused(*leaves, heads=heads)
    assert got.requires_grad and torch.equal(got.detach(), want)
    dout = torch.randn(got.shape, generator=torch.Generator().manual_seed(
        1)).to(dtype)
    grads = torch.autograd.grad(got, leaves, dout)
    ref = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    want_grads = torch.autograd.grad(
        todays_linear_attend_fused(*ref, heads=heads), ref, dout)
    assert all(torch.equal(g_, w_) for g_, w_ in zip(grads, want_grads))


def test_layer_without_grad_is_bitwise_the_differentiated_one():
    layer = LinearAttention2D(16, heads=2, dim_head=8)
    init_parameters(layer, torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 6, 16)
    with torch.no_grad():
        got = layer(x)
    assert torch.equal(got, layer(x).detach())


def test_linear_attend_cuda_refuses_what_it_does_not_take():
    meta = [t.to("meta") for t in chunks(2, 16, 2, dtype=torch.bfloat16)]
    q, k, v = meta
    with pytest.raises(TypeError, match="bfloat16"):
        kla.linear_attend_cuda(q.float(), k, v, 2, 0.125)
    with pytest.raises(ValueError, match="head dim 32"):
        kla.linear_attend_cuda(q, k, v, 4, 0.125)
    with pytest.raises(ValueError, match="last dimension is not contiguous"):
        kla.linear_attend_cuda(q, k.transpose(1, 2).contiguous()
                               .transpose(1, 2), v, 2, 0.125)
    with pytest.raises(ValueError, match="multiples of 8"):
        kla.linear_attend_cuda(q, k, v.as_strided(v.shape, (
            v.shape[1] * 388, 388, 1)), 2, 0.125)
    with pytest.raises(ValueError, match="one .* shape"):
        kla.linear_attend_cuda(q, k[:, :8], v, 2, 0.125)
    with pytest.raises(ValueError, match="is on meta"):
        kla.linear_attend_cuda(q, k, v, 2, 0.125)
    with pytest.raises(ValueError, match="is on cpu"):
        kla.linear_attend_cuda(*chunks(1, 4, 1, dtype=torch.bfloat16), 1,
                               0.125)


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with --noconftest "
                    "-m cuda)")
    return torch.device("cuda", 0)


# (configuration, batch, n of each linear attention of G's forward, in
# call order): three down stages at the input's size, the up path at 1×,
# 2× and 4× it; 8 heads of 64
PATH_SHAPES = [("upsampler-256", 8, [64 ** 2] * 4 + [128 ** 2, 256 ** 2]),
               ("upsampler-1024", 1, [256 ** 2] * 4 + [512 ** 2,
                                                         1024 ** 2])]
HEADS = 8


def f64_linear_attention(q, k, v, heads):
    """The linear attention in float64 on the given (bf16) operands."""
    b, n, hd = q.shape
    d = hd // heads
    qd, kd, vd = (t.double().reshape(b, n, heads, d) for t in (q, k, v))
    context = torch.einsum("bnhd,bnhe->bhde", torch.softmax(kd, 1), vd)
    del kd, vd
    return torch.einsum("bnhd,bhde->bnhe", torch.softmax(qd, -1) * d ** -0.5,
                        context).reshape(b, n, hd)


def gap(got, want):
    return float((got.double() - want).norm() / want.norm())


def kernel_call(q, k, v, heads=HEADS):
    before = kla.linear_attend_cuda.launches
    out = kla.linear_attend_fwd(q, k, v, heads=heads,
                                scale=(q.shape[-1] // heads) ** -0.5)
    assert kla.linear_attend_cuda.launches == before + 1
    return out


def check_against_plain(q, k, v, heads, label):
    got = kernel_call(q, k, v, heads)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous()
    plain = kla.linear_attend_plain(q, k, v, heads=heads)
    want = f64_linear_attention(q, k, v, heads)
    gaps = gap(got, want), gap(plain, want)
    del plain, want
    assert gaps[0] <= FROM_F64_RATIO * gaps[1], (label, gaps)
    # a second call repeats the first bit for bit
    assert torch.equal(kernel_call(q, k, v, heads), got), label
    return gaps


@pytest.mark.cuda
@pytest.mark.parametrize("config", [c for c, _, _ in PATH_SHAPES])
def test_kernel_matches_plain_at_the_path_shapes(card, config):
    _, b, sizes = next(row for row in PATH_SHAPES if row[0] == config)
    for i, n in enumerate(sorted(set(sizes))):
        q, k, v = chunks(b, n, HEADS, dtype=torch.bfloat16, device=card,
                         seed=i)
        assert q.stride() == (n * 3 * HEADS * 64, 3 * HEADS * 64, 1)
        gaps = check_against_plain(q, k, v, HEADS, (config, b, n))
        print(f"{config} b{b} n{n}: kernel {gaps[0]:.3e}, plain "
              f"{gaps[1]:.3e} from float64")
        del q, k, v
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,n", [(1, 3, 130), (3, 1, 4100),
                                       (1, 1, 1), (5, 3, 63),
                                       (2, 8, 65536 + 33)])
def test_kernel_at_ragged_shapes(card, b, heads, n):
    q, k, v = chunks(b, n, heads, dtype=torch.bfloat16, device=card, seed=n)
    check_against_plain(q, k, v, heads, (b, heads, n))


@pytest.mark.cuda
def test_kernel_takes_a_late_column_max_and_large_magnitudes(card):
    b, n = 1, 65536
    rows = kla.rows_per_split(b * HEADS, n, 0)
    assert -(-n // rows) > 2, "the case needs several splits"
    q, k, v = chunks(b, n, HEADS, dtype=torch.bfloat16, device=card, seed=5)
    # half of k's columns peak in the last split's last rows only
    k[:, -16:, ::2] += 3.0
    check_against_plain(q, k, v, HEADS, "late max")
    # large magnitudes: the running max rises tile after tile
    q, k, v = chunks(b, n, HEADS, dtype=torch.bfloat16, device=card, seed=6,
                     k_scale=16.0)
    check_against_plain(q, k, v, HEADS, "large k")


@pytest.mark.cuda
def test_graph_replay_is_bitwise_the_eager_call(card):
    q, k, v = chunks(1, 65536, HEADS, dtype=torch.bfloat16, device=card)
    kernel_call(q, k, v)  # built and warm outside the capture
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph):
        out = kla.linear_attend_fwd(q, k, v, heads=HEADS, scale=0.125)
    torch.cuda.current_stream().wait_stream(stream)
    for seed in (1, 2):
        for t, new in zip((q, k, v), chunks(1, 65536, HEADS,
                                            dtype=torch.bfloat16,
                                            device=card, seed=seed)):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, kla.linear_attend_fwd(q, k, v, heads=HEADS,
                                                      scale=0.125))


@pytest.mark.cuda
@pytest.mark.parametrize("config", [c for c, _, _ in PATH_SHAPES])
def test_eager_generate_runs_every_linear_attention_on_the_kernel(
        card, config, monkeypatch):
    _, b, sizes = next(row for row in PATH_SHAPES if row[0] == config)
    cfg = (chip_smoke.UPSAMPLER_G if config == "upsampler-256"
           else chip_smoke.UPSAMPLER_1K)
    gan = GigaGAN(generator=cfg, train_upsampler=True, amp=True,
                  device="cuda", seed=0)
    n_linear = sum(isinstance(m, LinearAttention2D)
                   for m in gan.G_ema.modules())
    assert n_linear == len(sizes) == 6
    seen = []
    entry = ops.linear_attend_fused

    def recording(q, k, v, *, heads, scale=None):
        seen.append((tuple(q.shape), q.dtype, heads))
        return entry(q, k, v, heads=heads, scale=scale)

    monkeypatch.setattr(ops, "linear_attend_fused", recording)
    size = cfg["input_image_size"]
    lowres = torch.rand(b, size, size, 3,
                        generator=torch.Generator().manual_seed(0)).numpy()
    before = kla.linear_attend_cuda.launches
    gan.generate(lowres, seed=0)  # the upsampler's forward is eager
    assert kla.linear_attend_cuda.launches - before == n_linear
    assert seen == [((b, n, HEADS * 64), torch.bfloat16, HEADS)
                    for n in sizes]
