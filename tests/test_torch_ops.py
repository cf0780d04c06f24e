"""The PyTorch port's ops against the JAX package on the CPU: resample,
adaptive conv (plain path and K1's plain version against the JAX XLA
path, the Pallas kernel in interpret mode and the per-sample oracle), and
fused attention (against the Pallas kernel in interpret mode).  Inputs come
from numpy with a fixed seed; both sides get the same arrays."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gigagan_tpu.ops import adaptive_conv as jax_adaptive_conv  # noqa: E402
from gigagan_tpu.ops import resample as jax_resample  # noqa: E402
from gigagan_tpu.ops.adaptive_conv import (  # noqa: E402
    adaptive_conv_reference as jax_adaptive_conv_reference,
    demod_scale as jax_demod_scale,
)
from gigagan_tpu.ops.attention import attend as jax_attend  # noqa: E402
from gigagan_tpu.ops.pallas.adaptive_conv import (  # noqa: E402
    fused_adaptive_conv2d,
)
from gigagan_tpu.ops.pallas.flash_attention_fused import (  # noqa: E402
    _fwd_impl as jax_flash_fused_fwd,
)

from gigagan_tpu_torch.ops import resample  # noqa: E402
from gigagan_tpu_torch.ops.adaptive_conv import (  # noqa: E402
    adaptive_conv,
    adaptive_conv_reference,
    demod_scale,
)
from gigagan_tpu_torch.ops.attention import attend, attend_fused  # noqa: E402
from gigagan_tpu_torch.ops.kernels import adaptive_conv as k1  # noqa: E402
from gigagan_tpu_torch.ops.kernels import (  # noqa: E402
    flash_attention_fused as k3,
)

TOL = dict(rtol=3e-4, atol=3e-4)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- resample

@pytest.mark.parametrize("fn", ["blur_2d", "upsample_2x", "upsample_2x_blur"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 5, 7, 4)])
def test_resample_matches_jax(fn, shape):
    # reflect-padded blur and half-pixel bilinear, borders included
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(getattr(jax_resample, fn)(jnp.asarray(x)))
    got = getattr(resample, fn)(t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_blur_pads_with_reflect_not_zero():
    x = np.ones((1, 4, 4, 1), np.float32)
    np.testing.assert_allclose(resample.blur_2d(t(x)).numpy(), x, atol=1e-6)


# ----------------------------------------------------------- adaptive conv

def conv_inputs(seed, b=2, h=8, w=8, ci=8, co=24, n=2, k=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    weights = (rng.standard_normal((n, k, k, ci, co)) * 0.2).astype(
        np.float32)
    mod = rng.standard_normal((b, ci)).astype(np.float32)
    kmod = rng.standard_normal((b, n)).astype(np.float32) if n > 1 else None
    return x, weights, mod, kmod


def jax_fused_inputs(x, weights, mod, kmod, demod):
    """The operands `adaptive_conv` hands the Pallas kernel."""
    b, co = x.shape[0], weights.shape[-1]
    attn = (jax.nn.softmax(jnp.asarray(kmod), -1) if kmod is not None
            else jnp.ones((b, 1), jnp.float32))
    scale_in = jnp.asarray(mod) + 1.0
    x_mod = jnp.asarray(x) * scale_in[:, None, None, :]
    d = (jax_demod_scale(jnp.asarray(weights), scale_in, attn) if demod
         else jnp.ones((b, co), jnp.float32))
    return x_mod, attn, d


CONV_CASES = [
    dict(n=2, demod=True, co=24),
    dict(n=2, demod=False, co=24),
    dict(n=1, demod=True, co=24),
    dict(n=1, demod=False, co=16),
    dict(n=2, demod=True, co=80),  # co > 64: more than one K1 co tile
]


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=lambda c: f"n{c['n']}-demod{c['demod']}-"
                                       f"co{c['co']}")
def test_adaptive_conv_matches_jax(case):
    x, weights, mod, kmod = conv_inputs(1, n=case["n"], co=case["co"])
    demod = case["demod"]
    jargs = (jnp.asarray(x), jnp.asarray(weights), jnp.asarray(mod),
             None if kmod is None else jnp.asarray(kmod))
    targs = (t(x), t(weights), t(mod), None if kmod is None else t(kmod))
    got = adaptive_conv(*targs, demod=demod).numpy()

    want_xla = jax_adaptive_conv(*jargs, demod=demod, use_pallas=False)
    np.testing.assert_allclose(got, want_xla, **TOL)
    want_ref = jax_adaptive_conv_reference(*jargs, demod=demod)
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(
        adaptive_conv_reference(*targs, demod=demod).numpy(), want_ref, **TOL
    )

    # K1 as the JAX tests run it: the Pallas kernel in interpret mode, and
    # K1's plain version on the same operands
    x_mod, attn, d = jax_fused_inputs(x, weights, mod, kmod, demod)
    want_k1 = fused_adaptive_conv2d(x_mod, jnp.asarray(weights), attn, d,
                                    128, True)
    np.testing.assert_allclose(got, want_k1, **TOL)
    got_k1 = k1.adaptive_conv_fwd(t(x_mod), t(weights), t(attn), t(d))
    np.testing.assert_allclose(got_k1.numpy(), want_k1, **TOL)


def test_demod_scale_matches_jax():
    x, weights, mod, kmod = conv_inputs(2)
    attn = jax.nn.softmax(jnp.asarray(kmod), -1)
    want = jax_demod_scale(jnp.asarray(weights), jnp.asarray(mod) + 1, attn)
    got = demod_scale(t(weights), t(mod) + 1, t(attn))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_to_rgb_1x1_matches_jax():
    x, weights, mod, _ = conv_inputs(3, n=1, co=3, k=1)
    want = jax_adaptive_conv(jnp.asarray(x), jnp.asarray(weights),
                             jnp.asarray(mod), None, demod=False)
    got = adaptive_conv(t(x), t(weights), t(mod), None, demod=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_adaptive_conv_batch_expanded_mod():
    # mod/kernel_mod given per sample, x per (sample, group): batch-major
    x, weights, mod, kmod = conv_inputs(4, b=4)
    got = adaptive_conv(t(x), t(weights), t(mod[:2]), t(kmod[:2]))
    want = jax_adaptive_conv(jnp.asarray(x), jnp.asarray(weights),
                             jnp.asarray(mod[:2]), jnp.asarray(kmod[:2]),
                             use_pallas=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


class CudaStandIn(torch.Tensor):
    """A CPU tensor that says it lies on the card, as the ops see a CUDA
    tensor (``is_cuda``); what is computed from it is one too."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("stride,dilation", [(2, 1), (1, 2)])
def test_strided_adaptive_conv_on_the_card_takes_the_grouped_conv(
        stride, dilation, monkeypatch):
    # K1 takes stride-1, dilation-1 3x3 convs; on the card any other runs
    # the unfused grouped conv, as JAX runs it on its XLA conv
    # the module, which the package's function of the same name shadows
    op = importlib.import_module("gigagan_tpu_torch.ops.adaptive_conv")
    x, weights, mod, kmod = conv_inputs(6, h=9, w=9)
    calls = []

    def k1_stand_in(*args):  # K1's autograd Function, which would launch
        calls.append(args)
        return "K1"

    monkeypatch.setattr(op, "pconv2d", k1_stand_in)
    xc = t(x).as_subclass(CudaStandIn)
    assert xc.is_cuda
    kw = dict(stride=stride, dilation=dilation)
    got = adaptive_conv(xc, t(weights), t(mod), t(kmod), **kw)
    assert not calls
    got = got.as_subclass(torch.Tensor)
    want = adaptive_conv_reference(t(x), t(weights), t(mod), t(kmod), **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    want_jax = jax_adaptive_conv(
        jnp.asarray(x), jnp.asarray(weights), jnp.asarray(mod),
        jnp.asarray(kmod), use_pallas=False, **kw)
    np.testing.assert_allclose(got.numpy(), want_jax, **TOL)
    # a stride-1, dilation-1 3x3 conv on the card still goes to K1
    assert adaptive_conv(xc, t(weights), t(mod), t(kmod)) == "K1"
    assert len(calls) == 1


def test_k1_plain_rounds_the_mix_like_the_kernel():
    # bf16 operands: the mixed bank is rounded to bf16, accumulation fp32
    x, weights, mod, kmod = conv_inputs(5)
    x_mod, attn, d = jax_fused_inputs(x, weights, mod, kmod, True)
    want = fused_adaptive_conv2d(x_mod.astype(jnp.bfloat16),
                                 jnp.asarray(weights), attn, d, 128, True)
    got = k1.adaptive_conv_fwd(t(x_mod).bfloat16(), t(weights), t(attn),
                               t(d))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_kernel_wrappers_never_fall_back_off_the_cpu():
    # a tensor that is not on the CPU goes to the kernel or raises; CPU
    # calls run the plain version and do not count as launches
    k1_entries = (k1.adaptive_conv_fwd_tc, k1.adaptive_conv_fwd_simt)
    before = [f.launches for f in k1_entries]
    meta = torch.empty(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="on meta"):
        k1.adaptive_conv_fwd(meta, torch.empty(1, 3, 3, 8, 8, device="meta"),
                             torch.empty(1, 1, device="meta"),
                             torch.empty(1, 8, device="meta"))
    q = torch.empty(1, 16, 64, device="meta")
    with pytest.raises(ValueError, match="on meta"):
        k3.flash_attention_fused_fwd(q, q, q, None, None, None, None, 1)
    x, weights, mod, kmod = conv_inputs(6)
    adaptive_conv(t(x), t(weights), t(mod), t(kmod))
    assert [f.launches for f in k1_entries] == before


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("null", [True, False], ids=["null_kv", "no_null"])
@pytest.mark.parametrize("l2", [False, True], ids=["dot", "l2"])
def test_fused_attention_matches_pallas(l2, null):
    b, nq, nk, heads, d = 2, 24, 40, 2, 64
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((b, n, heads * d)).astype(np.float32)
               for n in (nq, nk, nk))
    null_kv = (rng.standard_normal((2, heads, d)).astype(np.float32)
               if null else None)
    scale = d ** -0.5
    out_j, (_, lse_j) = jax_flash_fused_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if null_kv is None else jnp.asarray(null_kv), heads, l2, scale,
        True,
    )
    lse_j = np.asarray(lse_j).reshape(b, heads, -1)[..., :nq]

    nkv = None if null_kv is None else t(null_kv)
    got = attend_fused(t(q), t(k), t(v), heads=heads, null_kv=nkv,
                       l2_dist=l2, scale=scale)
    np.testing.assert_allclose(got.numpy(), out_j, rtol=1e-4, atol=1e-4)

    # K3's plain version on the prepared operands: out and lse
    k_pre, bias, nk_pre, nv, nb = k3.prep_fused(t(k), t(v), nkv, heads, l2,
                                                scale)
    out_t, lse_t = k3.flash_attention_fused_fwd(t(q), k_pre, t(v), bias,
                                                nk_pre, nv, nb, heads)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("l2", [False, True], ids=["dot", "l2"])
def test_attend_masked_matches_jax(l2):
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((2, 2, n, 16)).astype(np.float32)
               for n in (12, 10, 10))
    mask = rng.random((2, 10)) > 0.3
    mask[:, 0] = True
    want = jax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      mask=jnp.asarray(mask), l2_dist=l2, use_flash=False)
    got = attend(t(q), t(k), t(v), mask=t(mask), l2_dist=l2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------ backward kernels K2, K4, K5

from gigagan_tpu.ops.pallas.adaptive_conv import pcorr2d as jax_pcorr2d  # noqa: E402,E501
from gigagan_tpu.ops.pallas.flash_attention_so import (  # noqa: E402
    _bwd_sc_impl as jax_flash_bwd,
    flash_bwd_so as jax_flash_bwd_so,
)

from gigagan_tpu_torch.ops import attention as attention_mod  # noqa: E402
from gigagan_tpu_torch.ops.kernels import plain_reference  # noqa: E402

# the package re-exports the function under the module's name
adaptive_conv_mod = importlib.import_module(
    "gigagan_tpu_torch.ops.adaptive_conv")
from gigagan_tpu_torch.ops.kernels import (  # noqa: E402
    flash_attention as k6,
    flash_attention_hv as k7,
    flash_attention_so as so,
)
from gigagan_tpu_torch.ops.kernels.flash_attention_hv import (  # noqa: E402
    flash_hv_mode,
)


def rel_max(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("n", [1, 2])
def test_k2_plain_matches_pallas_pcorr2d(n):
    rng = np.random.default_rng(20)
    b, h, w, ci, co = 2, 6, 5, 8, 12
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    g = rng.standard_normal((b, h, w, co)).astype(np.float32)
    weights = rng.standard_normal((n, 3, 3, ci, co)).astype(np.float32)
    a = rng.random((b, n)).astype(np.float32)
    dw_j, da_j = jax_pcorr2d(jnp.asarray(x), jnp.asarray(g),
                             jnp.asarray(weights), jnp.asarray(a), 128, True)
    dw, da = k1.adaptive_conv_bwd_w(t(x), t(g), t(weights), t(a))
    assert rel_max(dw.numpy(), dw_j) <= 1e-4
    assert rel_max(da.numpy(), da_j) <= 1e-4


@pytest.mark.parametrize("n", [5, 8])
def test_k2_bank_split_matches_one_call(n):
    # more banks than one K2 launch takes: the wrapper's groups of at most
    # MAX_BANKS, on the plain version, give the unsplit result
    rng = np.random.default_rng(21)
    b, h, w, ci, co = 2, 5, 6, 8, 12
    x = t(rng.standard_normal((b, h, w, ci)).astype(np.float32))
    g = t(rng.standard_normal((b, h, w, co)).astype(np.float32))
    weights = t(rng.standard_normal((n, 3, 3, ci, co)).astype(np.float32))
    a = t(rng.random((b, n)).astype(np.float32))
    dw, da = k1.by_banks(k1.adaptive_conv_bwd_w_plain, x, g, weights, a)
    want_dw, want_da = k1.adaptive_conv_bwd_w_plain(x, g, weights, a)
    torch.testing.assert_close(dw, want_dw, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(da, want_da, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [1, 4, 5, 8])
def test_k2_takes_any_bank_count_off_the_cpu(n, monkeypatch):
    # a tensor off the CPU: one launch per group of at most 4 banks, each
    # on its own banks and selection weights, the results concatenated
    calls = []

    def launch(x, g, weights, attn):
        assert attn.shape == (x.shape[0], weights.shape[0])
        assert attn.is_contiguous()
        calls.append(weights.shape[0])
        return (torch.empty(weights.shape, device="meta"),
                torch.empty(attn.shape, device="meta"))

    # float32 operands: the CUDA-core route, at most MAX_BANKS a launch
    monkeypatch.setattr(k1, "adaptive_conv_bwd_w_simt", launch)
    meta = dict(device="meta")
    dw, da = k1.adaptive_conv_bwd_w(
        torch.empty(2, 4, 4, 8, **meta), torch.empty(2, 4, 4, 16, **meta),
        torch.empty(n, 3, 3, 8, 16, **meta), torch.empty(2, n, **meta))
    assert calls == [min(4, n - i) for i in range(0, n, 4)]
    assert dw.shape == (n, 3, 3, 8, 16) and da.shape == (2, n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_k2_tc_route_groups_banks_at_its_limit(n, monkeypatch):
    # bf16 with channel multiples of 16 goes to the tensor-core route, one
    # launch per group of at most MAX_BANKS_TC banks
    calls = []

    def launch(x, g, weights, attn):
        assert attn.shape == (x.shape[0], weights.shape[0])
        assert attn.is_contiguous()
        calls.append(weights.shape[0])
        return (torch.empty(weights.shape, device="meta"),
                torch.empty(attn.shape, device="meta"))

    monkeypatch.setattr(k1, "adaptive_conv_bwd_w_tc", launch)
    monkeypatch.setattr(k1, "adaptive_conv_bwd_w_simt", None)
    meta = dict(device="meta", dtype=torch.bfloat16)
    dw, da = k1.adaptive_conv_bwd_w(
        torch.empty(2, 4, 4, 16, **meta), torch.empty(2, 4, 4, 32, **meta),
        torch.empty(n, 3, 3, 16, 32, device="meta"),
        torch.empty(2, n, device="meta"))
    lim = k1.MAX_BANKS_TC
    assert calls == [min(lim, n - i) for i in range(0, n, lim)]
    assert dw.shape == (n, 3, 3, 16, 32) and da.shape == (2, n)


@pytest.mark.parametrize("n", [3, 4])
def test_k2_bank_split_at_the_tc_limit_matches_one_call(n):
    # the tensor-core route's groups of MAX_BANKS_TC, on the plain version
    # with bf16 operands, give the unsplit result
    rng = np.random.default_rng(22)
    b, h, w, ci, co = 2, 5, 6, 16, 32
    x = t(rng.standard_normal((b, h, w, ci)).astype(np.float32)).bfloat16()
    g = t(rng.standard_normal((b, h, w, co)).astype(np.float32)).bfloat16()
    weights = t(rng.standard_normal((n, 3, 3, ci, co)).astype(np.float32))
    a = t(rng.random((b, n)).astype(np.float32))
    dw, da = k1.by_banks(k1.adaptive_conv_bwd_w_plain, x, g, weights, a,
                         k1.MAX_BANKS_TC)
    want_dw, want_da = k1.adaptive_conv_bwd_w_plain(x, g, weights, a)
    torch.testing.assert_close(dw, want_dw, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(da, want_da, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ci,co", [(16, 16), (32, 16)])
def test_k2_plain_matches_pallas_pcorr2d_bf16(ci, co):
    # the shapes the tensor-core route takes: bf16 x and g (the Pallas
    # kernel in interpret mode accumulates them in fp32, as the plain
    # version does) on a map that no 8- or 16-pixel box tiles evenly
    rng = np.random.default_rng(23)
    b, h, w, n = 2, 7, 13, 2
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    g = rng.standard_normal((b, h, w, co)).astype(np.float32)
    weights = (rng.standard_normal((n, 3, 3, ci, co)) * 0.2).astype(
        np.float32)
    a = rng.random((b, n)).astype(np.float32)
    xb, gb = (jnp.asarray(v, jnp.bfloat16) for v in (x, g))
    dw_j, da_j = jax_pcorr2d(xb, gb, jnp.asarray(weights), jnp.asarray(a),
                             128, True)
    to_t = (lambda v: torch.from_numpy(np.asarray(v, np.float32))
            .bfloat16())
    dw, da = k1.adaptive_conv_bwd_w(to_t(xb), to_t(gb), t(weights), t(a))
    assert dw.dtype == torch.float32 and da.dtype == torch.float32
    assert rel_max(dw.numpy(), dw_j) <= 1e-4
    assert rel_max(da.numpy(), da_j) <= 1e-4


def graph_nodes(out):
    """Names of every autograd node behind ``out``."""
    seen, todo = set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(fn for fn, _ in node.next_functions)
    return {type(node).__name__ for node in seen}


@pytest.mark.parametrize("l2", [False, True], ids=["dot", "l2"])
def test_plain_attend_takes_no_gradient_through_its_max(l2):
    # the row max is a constant (JAX's stop_gradient): no amax backward in
    # the graph, and the gradients of JAX's plain attend
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, 2, n, 16)).astype(np.float32)
               for n in (12, 10, 10))
    mask = rng.random((2, 10)) > 0.3
    mask[:, 0] = True
    w = rng.standard_normal(q.shape).astype(np.float32)

    def loss_j(q_, k_, v_):
        return jnp.sum(jax_attend(q_, k_, v_, mask=jnp.asarray(mask),
                                  l2_dist=l2, use_flash=False) * w)

    want = jax.grad(loss_j, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ins = [t(a).requires_grad_() for a in (q, k, v)]
    out = attend(*ins, mask=t(mask), l2_dist=l2)
    assert not any("Amax" in name for name in graph_nodes(out))
    (out * t(w)).sum().backward()
    for name, a, w_ in zip("qkv", ins, want):
        assert rel_max(a.grad.numpy(), w_) <= 1e-5, name


ATTN_CASES = [(l2, null) for l2 in (False, True) for null in (True, False)]
ATTN_IDS = [f"{'l2' if l2 else 'dot'}-{'null' if null else 'no_null'}"
            for l2, null in ATTN_CASES]


def attn_inputs(seed, null, b=2, n=64, heads=2, d=64):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, n, heads * d)).astype(np.float32)
                  for _ in range(4))
    null_kv = (rng.standard_normal((2, heads, d)).astype(np.float32)
               if null else None)
    return q, k, v, g, null_kv


@pytest.mark.parametrize("l2,null", ATTN_CASES, ids=ATTN_IDS)
def test_k4_plain_matches_pallas_bwd(l2, null):
    heads, d = 2, 64
    scale = d ** -0.5
    q, k, v, g, null_kv = attn_inputs(21, null)
    jnull = None if null_kv is None else jnp.asarray(null_kv)
    out_j, (_, lse_j) = jax_flash_fused_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnull, heads, l2,
        scale, True)
    want = jax_flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnull, jnp.asarray(g), lse_j, heads, l2, scale, True)

    # K4's plain version on the prepared operands, fed JAX's out and lse;
    # the chain rule back to k and null_kv through autograd of the prep
    kt = t(k).requires_grad_()
    nkv = None if null_kv is None else t(null_kv).requires_grad_()
    k_pre, bias, nk_pre, nv, nb = k3.prep_fused(kt, t(v), nkv, heads, l2,
                                                scale)
    lse = t(np.asarray(lse_j).reshape(2, heads, -1)[..., :64])
    dq, dkp, dv, dbias, dnk, dnv, dnb = so.flash_attention_fused_bwd(
        t(q), k_pre.detach(), t(v), None if bias is None else bias.detach(),
        None if nk_pre is None else nk_pre.detach(),
        None if nv is None else nv.detach(),
        None if nb is None else nb.detach(), t(g), t(np.asarray(out_j)), lse,
        heads)
    pairs = [(k_pre, dkp), (bias, dbias), (nk_pre, dnk), (nv, dnv),
             (nb if l2 else None, dnb)]
    pairs = [(o, gr) for o, gr in pairs if o is not None and o.requires_grad]
    torch.autograd.backward([o for o, _ in pairs], [gr for _, gr in pairs])
    assert rel_max(dq.numpy(), want[0]) <= 1e-4
    assert rel_max(kt.grad.numpy(), want[1]) <= 1e-4
    assert rel_max(dv.numpy(), want[2]) <= 1e-4
    if null:
        assert rel_max(nkv.grad.numpy(), want[3]) <= 1e-4


@pytest.mark.parametrize("l2,null", ATTN_CASES, ids=ATTN_IDS)
def test_k5_plain_matches_pallas_adjoint(l2, null, monkeypatch):
    heads, d = 2, 64
    scale = d ** -0.5
    q, k, v, g, null_kv = attn_inputs(22, null)
    rng = np.random.default_rng(23)
    cots = [rng.standard_normal(a.shape).astype(np.float32)
            for a in (q, k, v)]
    cot_null = (rng.standard_normal(null_kv.shape).astype(np.float32)
                if null else None)
    jnull = None if null_kv is None else jnp.asarray(null_kv)
    _, (_, lse_j) = jax_flash_fused_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnull, heads, l2,
        scale, True)

    def bwd(q_, k_, v_, null_, g_):
        return jax_flash_bwd_so(q_, k_, v_, null_, g_, lse_j, heads, l2,
                                scale, True)

    _, vjp = jax.vjp(bwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnull, jnp.asarray(g))
    want = vjp((*map(jnp.asarray, cots),
                None if cot_null is None else jnp.asarray(cot_null)))

    # the port: K3 → K4 with create_graph, then the double backward runs
    # K5's plain version (counted) and autograd of the prep
    calls = []
    plain = so.flash_attention_so_bwd2

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(so, "flash_attention_so_bwd2", counted)
    ins = [t(a).requires_grad_() for a in (q, k, v)]
    nkv = None if null_kv is None else t(null_kv).requires_grad_()
    gt = t(g).requires_grad_()
    out = so.flash_attend_fused(*ins, nkv, heads, l2, scale)
    leaves = ins + ([nkv] if null else [])
    first = torch.autograd.grad(out, leaves, gt, create_graph=True)
    cot_t = [t(c) for c in cots] + ([t(cot_null)] if null else [])
    second = torch.autograd.grad(first, leaves + [gt], cot_t)
    assert calls, "the double backward did not reach K5"
    names = ["q", "k", "v"] + (["null_kv"] if null else []) + ["g"]
    want = list(want[:3]) + ([want[3]] if null else []) + [want[4]]
    for name, got_, want_ in zip(names, second, want):
        assert rel_max(got_.numpy(), want_) <= 1e-4, name


def test_pconv_pcorr_pair_gradchecks():
    rng = torch.Generator().manual_seed(24)
    f64 = dict(dtype=torch.float64)
    x = torch.randn(2, 2, 3, 2, generator=rng, **f64).requires_grad_()
    w = torch.randn(2, 3, 3, 2, 2, generator=rng, **f64).requires_grad_()
    a = torch.randn(2, 2, generator=rng, **f64).requires_grad_()
    dm = (torch.rand(2, 2, generator=rng, **f64) + 0.5).requires_grad_()
    g = torch.randn(2, 2, 3, 2, generator=rng, **f64).requires_grad_()
    assert torch.autograd.gradcheck(k1.pconv2d, (x, w, a, dm))
    assert torch.autograd.gradgradcheck(k1.pconv2d, (x, w, a, dm))
    assert torch.autograd.gradcheck(k1.pcorr2d, (x, g, w, a))
    assert torch.autograd.gradgradcheck(k1.pcorr2d, (x, g, w, a))


@pytest.mark.parametrize("l2,null", ATTN_CASES, ids=ATTN_IDS)
def test_fused_attention_chain_gradchecks(l2, null):
    rng = torch.Generator().manual_seed(25)
    f64 = dict(dtype=torch.float64)
    q, k, v = (torch.randn(2, 5, 6, generator=rng, **f64).requires_grad_()
               for _ in range(3))
    nkv = (torch.randn(2, 2, 3, generator=rng, **f64).requires_grad_()
           if null else None)

    def through_prep(*args):
        return so.flash_attend_fused(args[0], args[1], args[2],
                                     args[3] if null else None, 2, l2, 0.7)

    args = (q, k, v, nkv) if null else (q, k, v)
    assert torch.autograd.gradcheck(through_prep, args)
    assert torch.autograd.gradgradcheck(through_prep, args)

    # the prepared-operand Function alone, bias and null bias free: K5's
    # bias and null-bias cotangents are checked too
    bias = torch.randn(2, 2, 5, generator=rng, **f64).requires_grad_()
    nrows = [torch.randn(2, 3, generator=rng, **f64).requires_grad_()
             for _ in range(2)] + [torch.randn(2, generator=rng, **f64)
                                   .requires_grad_()]

    def prepared(q_, k_, v_, bias_, *null_):
        null_ = null_ if null else (None, None, None)
        return so.fused_attention(q_, k_, v_, bias_, *null_, 2)

    pargs = (q, k, v, bias, *nrows) if null else (q, k, v, bias)
    assert torch.autograd.gradcheck(prepared, pargs)
    assert torch.autograd.gradgradcheck(prepared, pargs)


def test_backward_kernel_wrappers_never_fall_back_off_the_cpu():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="on meta"):
        k1.adaptive_conv_bwd_w(torch.empty(1, 4, 4, 8, **meta),
                               torch.empty(1, 4, 4, 8, **meta),
                               torch.empty(1, 3, 3, 8, 8, **meta),
                               torch.empty(1, 1, **meta))
    q = torch.empty(1, 16, 64, **meta)
    lse = torch.empty(1, 1, 16, **meta)
    with pytest.raises(ValueError, match="on meta"):
        so.flash_attention_fused_bwd(q, q, q, None, None, None, None, q, q,
                                     lse, 1)
    with pytest.raises(ValueError, match="on meta"):
        so.flash_attention_so_bwd2(q, q, q, None, None, None, None, q, lse,
                                   q, q, q, None, None, None, None, 1)


def _counting_standins(monkeypatch, mod, base):
    """Replace ``<base>_tc`` and ``<base>_simt`` of ``mod`` with stand-ins
    that count their calls; returns them by route."""
    def standin():
        def entry(*args):
            entry.launches += 1
        entry.launches = 0
        return entry

    entries = {r: standin() for r in ("tc", "simt")}
    for r, entry in entries.items():
        monkeypatch.setattr(mod, f"{base}_{r}", entry)
    return entries


# K3 and K4 each have a tensor-core and a CUDA-core kernel, picked by one
# rule on (dtype, head dim)
DISPATCH = [(torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
            (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
            (torch.bfloat16, 80, "simt"), (torch.bfloat16, 32, "simt")]


def _meta_attention(dtype, d, heads=2, n=16):
    q = torch.empty(1, n, heads * d, dtype=dtype, device="meta")
    return q, torch.empty(1, heads, n, device="meta"), heads


@pytest.mark.parametrize(
    "dtype,d,route", DISPATCH,
    ids=[f"{str(dt).split('.')[-1]}-d{d}" for dt, d, _ in DISPATCH])
def test_fused_attention_dispatch_rule(dtype, d, route, monkeypatch):
    # a tensor off the CPU goes to the implementation the rule names; each
    # entry is replaced by a stand-in that counts its launches
    entries = {}
    for mod, base in ((k3, "flash_attention_fused_fwd"),
                      (so, "flash_attention_fused_bwd")):
        for r, entry in _counting_standins(monkeypatch, mod, base).items():
            entries[f"{base}_{r}"] = entry
    q, lse, heads = _meta_attention(dtype, d)
    assert k3.uses_tensor_cores(dtype, d) == (route == "tc")
    k3.flash_attention_fused_fwd(q, q, q, None, None, None, None, heads)
    so.flash_attention_fused_bwd(q, q, q, None, None, None, None, q, q, lse,
                                 heads)
    assert {name: e.launches for name, e in entries.items()} == {
        f"{base}_{r}": int(r == route)
        for base in ("flash_attention_fused_fwd", "flash_attention_fused_bwd")
        for r in ("tc", "simt")}


# every implementation of K3, K4 and K5, each with its own launch count
ATTN_ENTRIES = (k3.flash_attention_fused_fwd_tc,
                k3.flash_attention_fused_fwd_simt,
                so.flash_attention_fused_bwd_tc,
                so.flash_attention_fused_bwd_simt,
                so.flash_attention_so_bwd2_tc,
                so.flash_attention_so_bwd2_simt)


@pytest.mark.parametrize("entry", ["fwd", "fwd_tc", "fwd_simt", "bwd",
                                   "bwd_tc", "bwd_simt", "so_bwd2",
                                   "so_bwd2_simt"])
def test_attention_kernels_take_heads_up_to_128(entry):
    # every entry of K3, K4 and K5 takes d = 128 (it reaches the device
    # check) and refuses d = 136; none counts a launch
    def call(d):
        q, lse, heads = _meta_attention(torch.bfloat16, d)
        if entry.startswith("fwd"):
            fn = getattr(k3, "flash_attention_fused_" + entry)
            return fn(q, q, q, None, None, None, None, heads), fn
        if entry.startswith("bwd"):
            fn = getattr(so, "flash_attention_fused_" + entry)
            return fn(q, q, q, None, None, None, None, q, q, lse, heads), fn
        fn = getattr(so, "flash_attention_" + entry)
        return fn(q, q, q, None, None, None, None, q, lse, q, q, q, None,
                  None, None, None, heads), fn

    launched = [f.launches for f in ATTN_ENTRIES]
    with pytest.raises(ValueError, match="on meta"):
        call(128)
    with pytest.raises(ValueError, match="head dim 136 > 128"):
        call(136)
    assert launched == [f.launches for f in ATTN_ENTRIES]


@pytest.mark.parametrize("d", [64, 80])
def test_fused_attention_on_cpu_runs_plain_and_launches_nothing(d):
    # bf16 CPU tensors, whichever implementation the rule would pick on the
    # card: the chain runs the plain versions, and no counter moves
    counters = ATTN_ENTRIES
    before = [f.launches for f in counters]
    q, k, v, g, null_kv = (None if a is None else t(a).bfloat16()
                           for a in attn_inputs(40, True, n=16, d=d))
    qg = q.clone().requires_grad_()
    out = so.flash_attend_fused(qg, k, v, null_kv, 2, l2_dist=True)
    (dq,) = torch.autograd.grad(out, qg, g, create_graph=True)
    dq.float().square().sum().backward()
    prepped = k3.prep_fused(k, v, null_kv, 2, True, d ** -0.5)
    ref, _ = k3.flash_attention_fused_fwd_plain(q, prepped[0], v, *prepped[1:],
                                                2)
    assert torch.equal(out, ref)
    assert qg.grad is not None
    assert [f.launches for f in counters] == before


# K1 and K5 each have a tensor-core and a CUDA-core kernel too: K1 by
# (dtype, ci, co), K5 by (dtype, head dim)
# the generator's 15 convs (forward and as dx, ci and co swapped) have
# channel counts 16-512 in powers of two; 48 and 24 are not on the path
K1_DISPATCH = [(torch.bfloat16, ci, co, "tc")
               for ci, co in ((512, 512), (512, 256), (256, 128), (128, 64),
                              (64, 32), (32, 16), (16, 16), (16, 32),
                              (64, 48))] + [
    (torch.bfloat16, 24, 16, "simt"), (torch.bfloat16, 64, 40, "simt"),
    (torch.float32, 512, 512, "simt"), (torch.float32, 16, 16, "simt")]


@pytest.mark.parametrize(
    "dtype,ci,co,route", K1_DISPATCH,
    ids=[f"{str(dt).split('.')[-1]}-{ci}-{co}" for dt, ci, co, _ in
         K1_DISPATCH])
def test_adaptive_conv_dispatch_rule(dtype, ci, co, route, monkeypatch):
    # a tensor off the CPU goes to the implementation the rule names
    entries = _counting_standins(monkeypatch, k1, "adaptive_conv_fwd")
    assert k1.conv_uses_tensor_cores(dtype, ci, co) == (route == "tc")
    meta = dict(device="meta")
    k1.adaptive_conv_fwd(torch.empty(2, 8, 8, ci, dtype=dtype, **meta),
                         torch.empty(2, 3, 3, ci, co, **meta),
                         torch.empty(2, 2, **meta), torch.empty(2, co, **meta))
    assert {r: e.launches for r, e in entries.items()} == {
        r: int(r == route) for r in ("tc", "simt")}


# K2's rule is K1's: the generator's 12 distinct (map, ci, co) shapes in
# bf16 go to the tensor cores; fp32 and channel counts that are not
# multiples of 16 to the CUDA cores
K2_DISPATCH = [(torch.bfloat16, h, ci, co, "tc")
               for h, ci, co in ((4, 512, 512), (8, 512, 512),
                                 (16, 512, 256), (16, 256, 256),
                                 (32, 256, 128), (32, 128, 128),
                                 (64, 128, 64), (64, 64, 64), (128, 64, 32),
                                 (128, 32, 32), (256, 32, 16),
                                 (256, 16, 16))] + [
    (torch.float32, 4, 512, 512, "simt"), (torch.float32, 256, 16, 16, "simt"),
    (torch.bfloat16, 8, 24, 16, "simt"), (torch.bfloat16, 8, 16, 40, "simt")]


@pytest.mark.parametrize(
    "dtype,h,ci,co,route", K2_DISPATCH,
    ids=[f"{str(dt).split('.')[-1]}-{h}-{ci}-{co}" for dt, h, ci, co, _ in
         K2_DISPATCH])
def test_adaptive_conv_bwd_w_dispatch_rule(dtype, h, ci, co, route,
                                           monkeypatch):
    # a tensor off the CPU goes to the implementation the rule names, once
    # for the path's two banks
    entries = _counting_standins(monkeypatch, k1, "adaptive_conv_bwd_w")
    assert k1.bwd_w_uses_tensor_cores(dtype, ci, co) == (route == "tc")
    meta = dict(device="meta")
    k1.adaptive_conv_bwd_w(torch.empty(2, h, h, ci, dtype=dtype, **meta),
                           torch.empty(2, h, h, co, dtype=dtype, **meta),
                           torch.empty(2, 3, 3, ci, co, **meta),
                           torch.empty(2, 2, **meta))
    assert {r: e.launches for r, e in entries.items()} == {
        r: int(r == route) for r in ("tc", "simt")}


K5_DISPATCH = [(torch.bfloat16, 64, "tc"), (torch.float32, 64, "simt"),
               (torch.bfloat16, 80, "simt"), (torch.bfloat16, 128, "simt"),
               (torch.float32, 128, "simt"), (torch.bfloat16, 32, "simt")]


@pytest.mark.parametrize(
    "dtype,d,route", K5_DISPATCH,
    ids=[f"{str(dt).split('.')[-1]}-d{d}" for dt, d, _ in K5_DISPATCH])
def test_so_bwd2_dispatch_rule(dtype, d, route, monkeypatch):
    entries = _counting_standins(monkeypatch, so, "flash_attention_so_bwd2")
    assert so.so_uses_tensor_cores(dtype, d) == (route == "tc")
    q, lse, heads = _meta_attention(dtype, d)
    so.flash_attention_so_bwd2(q, q, q, None, None, None, None, q, lse, q, q,
                               q, None, None, None, None, heads)
    assert {r: e.launches for r, e in entries.items()} == {
        r: int(r == route) for r in ("tc", "simt")}


@pytest.mark.parametrize("entry", ["k1_tc", "k1_simt", "k5_tc", "k5_simt",
                                   "k2_tc", "k2_simt"])
def test_new_entries_never_fall_back_off_the_cpu(entry):
    # each implementation, called directly on a tensor that is not on the
    # CPU, reaches the device check and raises; none counts a launch
    counted = (k1.adaptive_conv_fwd_tc, k1.adaptive_conv_fwd_simt,
               so.flash_attention_so_bwd2_tc, so.flash_attention_so_bwd2_simt,
               k1.adaptive_conv_bwd_w_tc, k1.adaptive_conv_bwd_w_simt)
    before = [f.launches for f in counted]
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="on meta"):
        if entry.startswith("k2"):
            fn = getattr(k1, "adaptive_conv_bwd_w_" + entry[3:])
            fn(torch.empty(1, 4, 4, 16, dtype=torch.bfloat16, **meta),
               torch.empty(1, 4, 4, 16, dtype=torch.bfloat16, **meta),
               torch.empty(1, 3, 3, 16, 16, **meta),
               torch.empty(1, 1, **meta))
        elif entry.startswith("k1"):
            fn = getattr(k1, "adaptive_conv_fwd_" + entry[3:])
            fn(torch.empty(1, 4, 4, 16, dtype=torch.bfloat16, **meta),
               torch.empty(1, 3, 3, 16, 16, **meta),
               torch.empty(1, 1, **meta), torch.empty(1, 16, **meta))
        else:
            fn = getattr(so, "flash_attention_so_bwd2_" + entry[3:])
            q, lse, heads = _meta_attention(torch.bfloat16, 64)
            fn(q, q, q, None, None, None, None, q, lse, q, q, q, None, None,
               None, None, heads)
    assert [f.launches for f in counted] == before


def test_tensor_core_entries_refuse_what_they_do_not_take():
    # K1's tensor-core entry takes bf16 with channel multiples of 16 only;
    # K5's takes head dim 64 only (d = 128 stays on the CUDA cores, up to
    # 128 like every attention entry); the message names the limit
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="multiples of 16"):
        k1.adaptive_conv_fwd_tc(
            torch.empty(1, 4, 4, 24, dtype=torch.bfloat16, **meta),
            torch.empty(1, 3, 3, 24, 16, **meta), torch.empty(1, 1, **meta),
            torch.empty(1, 16, **meta))
    # K2's takes the same channel counts in bf16, and at most MAX_BANKS_TC
    # banks a launch (its dispatcher groups more)
    for dtype, ci, n, msg in (
            (torch.bfloat16, 24, 1, "multiples of 16"),
            (torch.float32, 16, 1, "multiples of 16"),
            (torch.bfloat16, 16, k1.MAX_BANKS_TC + 1,
             f"at most {k1.MAX_BANKS_TC}")):
        with pytest.raises(ValueError, match=msg):
            k1.adaptive_conv_bwd_w_tc(
                torch.empty(1, 4, 4, ci, dtype=dtype, **meta),
                torch.empty(1, 4, 4, 16, dtype=dtype, **meta),
                torch.empty(n, 3, 3, ci, 16, **meta),
                torch.empty(1, n, **meta))
    for d, msg in ((128, "head dim 64"), (136, "head dim 136 > 128")):
        q, lse, heads = _meta_attention(torch.bfloat16, d)
        with pytest.raises(ValueError, match=msg):
            so.flash_attention_so_bwd2_tc(q, q, q, None, None, None, None, q,
                                          lse, q, q, q, None, None, None,
                                          None, heads)


@pytest.mark.parametrize("ci,co", [(16, 32), (24, 16)],
                         ids=["tc-route", "simt-route"])
def test_pconv2d_bf16_on_cpu_runs_plain_and_launches_nothing(ci, co):
    # bf16 CPU tensors, whichever implementation the rule would pick on the
    # card: the conv pair (K1 forward, K1 as dx, K2) runs the plain
    # versions, and no counter moves
    counters = (k1.adaptive_conv_fwd_tc, k1.adaptive_conv_fwd_simt,
                k1.adaptive_conv_bwd_w_tc, k1.adaptive_conv_bwd_w_simt)
    before = [f.launches for f in counters]
    rng = np.random.default_rng(41)
    x = t(rng.standard_normal((2, 5, 6, ci)).astype(np.float32)).bfloat16()
    w = t(rng.standard_normal((2, 3, 3, ci, co)).astype(np.float32) * 0.2)
    a = torch.softmax(t(rng.standard_normal((2, 2)).astype(np.float32)), -1)
    dm = t(rng.random((2, co)).astype(np.float32) + 0.5)
    xg = x.clone().requires_grad_()
    wg = w.clone().requires_grad_()
    out = k1.pconv2d(xg, wg, a, dm)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, k1.adaptive_conv_fwd_plain(x, w, a, dm))
    out.float().square().sum().backward()
    assert xg.grad is not None and wg.grad is not None
    assert [f.launches for f in counters] == before


def _standin(plain):
    """A kernel launch's stand-in: the plain result written into a fresh
    buffer under no_grad, as the ctypes launch writes into torch.empty."""
    def launch(*args):
        with torch.no_grad():
            res = plain(*args)
        if isinstance(res, tuple):
            return tuple(None if r is None else r.clone() for r in res)
        return res.clone()
    return launch


def test_gradients_survive_kernel_outputs(monkeypatch):
    # the ops take their kernel path as on the card, with every launch
    # replaced by a stand-in whose output has no autograd history
    for mod in (adaptive_conv_mod, attention_mod):
        monkeypatch.setattr(mod, "use_kernels", lambda t_: True,
                            raising=False)
    monkeypatch.setattr(adaptive_conv_mod, "adaptive_conv_fwd",
                        _standin(k1.adaptive_conv_fwd_plain), raising=False)
    monkeypatch.setattr(k1, "adaptive_conv_fwd",
                        _standin(k1.adaptive_conv_fwd_plain))
    monkeypatch.setattr(k1, "adaptive_conv_bwd_w",
                        _standin(k1.adaptive_conv_bwd_w_plain))
    fwd = _standin(k3.flash_attention_fused_fwd_plain)
    monkeypatch.setattr(k3, "flash_attention_fused_fwd", fwd)
    monkeypatch.setattr(so, "flash_attention_fused_fwd", fwd)
    monkeypatch.setattr(so, "flash_attention_fused_bwd",
                        _standin(so.flash_attention_fused_bwd_plain))
    # the split-heads kernels K6a/K6b and the grad-of-jvp pair K7a/K7b,
    # as the Functions in flash_attention_hv.py call them
    monkeypatch.setattr(k7, "flash_attention_fwd",
                        _standin(k6.flash_attention_fwd_plain))
    monkeypatch.setattr(k7, "flash_attention_bwd",
                        _standin(k6.flash_attention_bwd_plain))
    monkeypatch.setattr(k7, "flash_attention_hv_jvp",
                        _standin(k7.flash_attention_hv_jvp_plain))
    monkeypatch.setattr(k7, "flash_attention_hv_bwd",
                        _standin(k7.flash_attention_hv_bwd_plain))

    x, weights, mod, kmod = conv_inputs(26)
    conv_in = [t(a).requires_grad_() for a in (x, weights, mod, kmod)]
    q, k, v, _, null_kv = attn_inputs(27, True, n=16)
    attn_in = [t(a).requires_grad_() for a in (q, k, v, null_kv)]
    # flash-sized: attend goes to K6a/K6b (with K7a/K7b in a jvp), and
    # under flash_hv_mode attend_fused to the split heads and that attend
    q2, k2, v2, _, null2 = attn_inputs(28, True, b=1, n=256, d=8)
    flash_in = [t(a).requires_grad_() for a in (q2, k2, v2, null2)]
    tangents = [t(a) for a in attn_inputs(29, False, b=1, n=256, d=8)[:3]]

    def run(conv_args, attn_args, flash_args):
        out = adaptive_conv(*conv_args).square().sum()
        qa, ka, va, na = attn_args
        out = out + attend_fused(qa, ka, va, heads=2, null_kv=na,
                                 l2_dist=True).square().sum()
        qf, kf, vf, nf = flash_args
        heads = [a.reshape(1, 256, 2, 8).transpose(1, 2)
                 for a in (qf, kf, vf)]
        out = out + attend(*heads).square().sum()

        def layer(q_, k_, v_):
            return attend_fused(q_, k_, v_, heads=2, null_kv=nf,
                                l2_dist=True)

        with flash_hv_mode():
            primal, tangent = torch.func.jvp(layer, (qf, kf, vf),
                                             tuple(tangents))
        return out + tangent.square().sum() + primal.sin().sum()

    run(conv_in, attn_in, flash_in).backward()
    ref_in = [a.detach().clone().requires_grad_()
              for a in conv_in + attn_in + flash_in]
    with plain_reference():
        run(ref_in[:4], ref_in[4:8], ref_in[8:]).backward()
    names = ["x", "weights", "mod", "kernel_mod", "q", "k", "v", "null_kv",
             "flash q", "flash k", "flash v", "flash null_kv"]
    for name, a, r in zip(names, conv_in + attn_in + flash_in, ref_in):
        assert a.grad is not None, f"no gradient reached {name}"
        assert rel_max(a.grad.numpy(), r.grad.numpy()) <= 1e-4, name
