"""The adaptive conv's demodulation scale: the route rule of
``ops.demod_scale`` (the einsum chain where autograd may differentiate a
call, else ``demod_scale_fwd``: the kernel on a CUDA tensor, its plain
version on a CPU one), and the kernel ``csrc/demod_scale.cu``.

On the CPU: the rule over grad mode, each operand's ``requires_grad``,
``plain_reference()``, the forward-over-reverse mode and the device type
(a CUDA device is passed to the rule itself); ``demod_scale`` bitwise the
chain it replaced, with and without a gradient; the plain version against
``adaptive_conv_reference``'s demodulation; the entry's refusals.  Marked
``cuda`` (skipped without a card; run there with ``python -m pytest
--noconftest -m cuda tests/test_torch_demod.py``): the kernel against its
plain version at every demodulation shape of the quickstart, the
text-to-image and the upsampler G at batch 1, 8 and 32 and at ragged
shapes, two calls bitwise equal, a CUDA graph's replay bitwise the eager
call, and an eager ``generate`` with every demodulated conv on the
kernel.  This file imports no JAX."""

import contextlib
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu_torch import GigaGAN, ops  # noqa: E402
from gigagan_tpu_torch.models.generator import Generator  # noqa: E402
from gigagan_tpu_torch.models.layers import AdaptiveConv  # noqa: E402
from gigagan_tpu_torch.models.unet_upsampler import UnetUpsampler  # noqa
from gigagan_tpu_torch.ops.adaptive_conv import demod_route  # noqa: E402
from gigagan_tpu_torch.ops.kernels import demod as kdemod  # noqa: E402
from gigagan_tpu_torch.ops.kernels import plain_reference  # noqa: E402
from gigagan_tpu_torch.ops.kernels.flash_attention_hv import (  # noqa: E402
    flash_hv_mode,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# the kernel against its plain version: both fp32, the sums taken in
# another order (the kernel adds s²·aᵀGa per input channel, per split and
# then over the splits; the chain sums over i per bank pair first) and
# rsqrt to the card's 2 ulp; each d² is a sum of positive terms per input
# channel, so the gap stays near fp32 rounding (4.7e-7 at worst on an H100
# over the shapes and batches below)
DEMOD_RTOL = 1e-5


def todays_demod_scale(weights, scale_in, attn=None, eps=1e-8):
    """``ops.demod_scale`` as it was before it had a kernel."""
    n = weights.shape[0]
    b = scale_in.shape[0]
    flat = weights.float().reshape(n, -1, weights.shape[-2],
                                   weights.shape[-1])
    gram = torch.einsum("nkio,mkio->nmio", flat, flat)
    s2 = scale_in * scale_in
    if n > 1:
        gram_flat = gram.reshape(n * n, *gram.shape[2:])
        t = torch.einsum("pio,bi->bpo", gram_flat, s2)
        pair = torch.einsum("bn,bm->bnm", attn, attn).reshape(b, n * n)
        d_sq = torch.einsum("bp,bpo->bo", pair, t)
    else:
        d_sq = torch.einsum("io,bi->bo", gram[0, 0], s2)
    return torch.rsqrt(torch.clamp(d_sq, min=eps))


def operands(n, taps, b=3, ci=12, co=10, device="cpu", seed=0):
    """Banks (n, *taps, ci, co), scale_in (b, ci), attn (b, n) or None."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(n, *taps, ci, co, generator=g)
    w = w * (2.0 / (ci * w[0, ..., 0, 0].numel())) ** 0.5
    s = 1.0 + 0.2 * torch.randn(b, ci, generator=g)
    a = (torch.softmax(torch.randn(b, n, generator=g), -1) if n > 1
         else None)
    return tuple(None if t is None else t.to(device) for t in (w, s, a))


# K = 1: a 1x1 conv; 3: a rank-1 conv's taps; 9: a 3x3 conv
TAPS = {1: (1, 1), 3: (3,), 9: (3, 3)}


# ------------------------------------------------------------- the route

GRAD_MODES = ("enabled", "no_grad", "inference_mode")


def grad_mode(mode):
    return {"enabled": torch.enable_grad, "no_grad": torch.no_grad,
            "inference_mode": torch.inference_mode}[mode]()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("hv", [False, True])
@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("needs_grad", [None, "weights", "scale_in",
                                        "attn"])
@pytest.mark.parametrize("mode", GRAD_MODES)
def test_demod_route(mode, needs_grad, plain, hv, device):
    w, s, a = operands(2, (3, 3))
    named = dict(weights=w, scale_in=s, attn=a)
    if needs_grad is not None:
        named[needs_grad].requires_grad_(True)
    with grad_mode(mode), (plain_reference() if plain
                           else contextlib.nullcontext()), (
            flash_hv_mode() if hv else contextlib.nullcontext()):
        got = demod_route(torch.device(device), *named.values())
    differentiated = mode == "enabled" and needs_grad is not None
    if plain or hv or differentiated:
        assert got == "autograd"
    else:
        assert got == ("plain" if device == "cpu" else "kernel")


def test_demod_route_takes_one_bank_without_attn():
    w, s, _ = operands(1, (3, 3))
    assert demod_route("cpu", w, s, None) == "plain"
    s.requires_grad_(True)
    assert demod_route("cpu", w, s, None) == "autograd"
    with torch.no_grad():
        assert demod_route("cuda:0", w, s, None) == "kernel"


@pytest.mark.parametrize("mode", GRAD_MODES)
def test_demod_scale_reaches_the_dispatcher_only_without_grad(
        mode, monkeypatch):
    calls = []

    def counted(*args):
        calls.append(args)
        return kdemod.demod_scale_plain(*args)

    monkeypatch.setattr(kdemod, "demod_scale_fwd", counted)
    w, s, a = operands(2, (3, 3))
    w.requires_grad_(True)
    with grad_mode(mode):
        ops.demod_scale(w, s, a)
    assert len(calls) == (mode != "enabled")


# ----------------------------------------------- bitwise today's on the CPU

@pytest.mark.parametrize("taps", [1, 3, 9])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_demod_scale_is_bitwise_todays(n, taps):
    w, s, a = operands(n, TAPS[taps])
    want = todays_demod_scale(w, s, a)
    with torch.no_grad():
        assert torch.equal(ops.demod_scale(w, s, a), want)
    with torch.inference_mode():
        assert torch.equal(ops.demod_scale(w, s, a), want)
    # with a gradient: the chain, and the same gradients
    leaves = [t.clone().requires_grad_(True) for t in (w, s, a)
              if t is not None]
    got = ops.demod_scale(*leaves, *([None] if a is None else []))
    assert got.requires_grad and torch.equal(got.detach(), want)
    grads = torch.autograd.grad(got.square().sum(), leaves)
    ref = [t.clone().requires_grad_(True) for t in (w, s, a)
           if t is not None]
    want_grads = torch.autograd.grad(
        todays_demod_scale(*ref, *([None] if a is None else [])).square()
        .sum(), ref)
    assert all(torch.equal(g_, w_) for g_, w_ in zip(grads, want_grads))


@pytest.mark.parametrize("taps", [1, 3, 9])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_plain_version_is_the_reference_demodulation(n, taps, monkeypatch):
    """``adaptive_conv_reference`` demodulates each sample's mixed kernel
    by rsqrt(max(Σ w², eps)): its rsqrt's output, recorded, against the
    plain version."""
    w, s, _ = operands(n, TAPS[taps], b=4, ci=24, co=20, seed=1)
    rank = len(TAPS[taps])
    x = torch.randn(4, *(5,) * rank, 24)
    # the reference's own selection and scale
    mod = s - 1.0
    kmod = torch.randn(4, n) if n > 1 else None
    a = None if kmod is None else torch.softmax(kmod, dim=-1)
    s = mod + 1.0
    seen = []
    rsqrt = torch.rsqrt

    def recording(t):
        out = rsqrt(t)
        seen.append(out)
        return out

    monkeypatch.setattr(torch, "rsqrt", recording)
    ops.adaptive_conv_reference(x, w, mod, kmod)
    monkeypatch.setattr(torch, "rsqrt", rsqrt)
    (ref,) = seen
    want = ref.reshape(4, 20)
    got = kdemod.demod_scale_plain(w, s, a)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_adaptive_conv_without_grad_is_bitwise_the_differentiated_one():
    x = torch.randn(2, 6, 6, 12)
    w, s, a = operands(2, (3, 3), b=2)
    kmod = torch.log(a)
    with torch.no_grad():
        got = ops.adaptive_conv(x, w, s - 1.0, kmod)
    want = ops.adaptive_conv(x, w.requires_grad_(True), s - 1.0, kmod)
    assert torch.equal(got, want.detach())


def test_demod_scale_cuda_refuses_what_it_does_not_take():
    w, s, a = operands(2, (9,))
    with pytest.raises(ValueError, match="not .*cuda|is on"):
        kdemod.demod_scale_cuda(w, s, a, 1e-8)
    with pytest.raises(TypeError, match="float32"):
        kdemod.demod_scale_cuda(w.double(), s, a, 1e-8)
    with pytest.raises(ValueError, match="disagree"):
        kdemod.demod_scale_cuda(w, s[:, :5], a, 1e-8)
    with pytest.raises(ValueError, match="attn"):
        kdemod.demod_scale_cuda(w, s, None, 1e-8)
    with pytest.raises(ValueError, match=r"\(n, k, ci, co\)"):
        kdemod.demod_scale_cuda(w[None], s, a, 1e-8)


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with --noconftest "
                    "-m cuda)")
    return torch.device("cuda", 0)


def demod_shapes():
    """(config, n, taps, ci, co) of every demodulated adaptive conv of the
    quickstart, the text-to-image and the upsampler G, built on the meta
    device, each shape once."""
    out = []
    for name, ctor, cfg in (
            ("quickstart", Generator, chip_smoke.QUICKSTART),
            ("t2i", Generator, chip_smoke.T2I_G),
            ("upsampler", UnetUpsampler, chip_smoke.UPSAMPLER_G)):
        with torch.device("meta"):
            g = ctor(**cfg)
        for m in g.modules():
            if isinstance(m, AdaptiveConv) and m.demod:
                shape = tuple(m.weights.shape)
                row = (name, shape[0], shape[1:-2], *shape[-2:])
                if row not in out:
                    out.append(row)
    return out


# ragged widths, every tile path of the banks (1, 2, 3-4, more than 4),
# the run-time tap loop (1, 3) and the 1024-wide upsampler input
RAGGED = [("ragged", 2, (3, 3), 17, 3), ("ragged", 1, (3, 3), 3, 17),
          ("ragged", 3, (3,), 40, 70), ("ragged", 4, (1, 1), 9, 33),
          ("ragged", 6, (3, 3), 24, 40), ("ragged", 2, (3,), 1024, 5)]


def kernel_call(w, s, a):
    before = kdemod.demod_scale_cuda.launches
    d = kdemod.demod_scale_fwd(w, s, a)
    assert kdemod.demod_scale_cuda.launches == before + 1
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 32])
def test_kernel_matches_plain_at_the_path_shapes(card, b):
    rows = demod_shapes()
    assert {r[0] for r in rows} == {"quickstart", "t2i", "upsampler"}
    worst = 0.0
    for i, (name, n, taps, ci, co) in enumerate(rows + RAGGED):
        w, s, a = operands(n, taps, b=b, ci=ci, co=co, device=card,
                           seed=i)
        got = kernel_call(w, s, a)
        want = kdemod.demod_scale_plain(w, s, a)
        rel = float(((got - want).abs() / want.abs()).max())
        worst = max(worst, rel)
        assert rel <= DEMOD_RTOL, (name, n, taps, ci, co, b, rel)
        # a second call repeats the first bit for bit
        assert torch.equal(kernel_call(w, s, a), got), (name, ci, co, b)
    print(f"demod kernel vs plain at b = {b}: worst relative gap {worst:.2e}")


@pytest.mark.cuda
def test_kernel_clamps_as_the_chain(card):
    w = torch.zeros(2, 9, 16, 8, device=card)
    s = torch.ones(3, 16, device=card)
    a = torch.softmax(torch.ones(3, 2, device=card), -1)
    assert torch.equal(kernel_call(w, s, a),
                       kdemod.demod_scale_plain(w, s, a))


@pytest.mark.cuda
def test_graph_replay_is_bitwise_the_eager_call(card):
    w, s, a = operands(2, (3, 3), b=1, ci=512, co=512, device=card)
    kernel_call(w, s, a)  # built and warm outside the capture
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph):
        out = kdemod.demod_scale_fwd(w, s, a)
    torch.cuda.current_stream().wait_stream(stream)
    for seed in (1, 2):
        nw, ns, na = operands(2, (3, 3), b=1, ci=512, co=512, device=card,
                              seed=seed)
        w.copy_(nw)
        s.copy_(ns)
        a.copy_(na)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, kdemod.demod_scale_fwd(w, s, a))


@pytest.mark.cuda
def test_eager_generate_runs_every_demodulated_conv_on_the_kernel(card):
    gan = GigaGAN(generator=chip_smoke.QUICKSTART, amp=True, device="cuda",
                  seed=0)
    n_demod = sum(isinstance(m, AdaptiveConv) and m.demod
                  for m in gan.G_ema.modules())
    assert n_demod == 15
    before = kdemod.demod_scale_cuda.launches
    gan.generate(batch_size=1, seed=0)  # a key's first call runs eagerly
    assert kdemod.demod_scale_cuda.launches - before == n_demod
