"""The PyTorch port's ops against the JAX package on the CPU: resample,
adaptive conv (plain path and K1's plain version against the JAX XLA
path, the Pallas kernel in interpret mode and the per-sample oracle), and
fused attention (against the Pallas kernel in interpret mode).  Inputs come
from numpy with a fixed seed; both sides get the same arrays."""

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
    before = k1.adaptive_conv_fwd.launches
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
    assert k1.adaptive_conv_fwd.launches == before


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
