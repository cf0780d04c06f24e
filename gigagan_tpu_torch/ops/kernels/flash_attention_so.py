"""Kernels K4 and K5: the backward of the fused-heads attention K3 and its
adjoint, their plain PyTorch versions, and the autograd chain K3 → K4 → K5
behind ``flash_attend_fused``.  Each has two implementations.  K4 is
picked as K3 is (``uses_tensor_cores``): on the tensor cores
(``csrc/flash_attention_fused_bwd_tc.cu``) for bf16 at d = 64 or 128, on
CUDA cores (``csrc/flash_attention_fused_bwd.cu``) otherwise.  K5 by
``so_uses_tensor_cores``, the same rule: on the tensor cores
(``csrc/flash_attention_so_bwd2_tc.cu``) for bf16 at d = 64 or 128, on CUDA
cores (``csrc/flash_attention_so_bwd2.cu``) otherwise.

Everything works on K3's PREPARED operands (``prep_fused``):
q (b, nq, H·d), k_pre = coeff·k and v (b, nk, H·d), bias (b, H, nk) fp32
or None, and the null token's nullk_pre / nullv (H, d) and null_bias (H,)
fp32 (all None without a null key/value).  Per batch and head, with the
null token as one extra logit column n:

    S = q·k_preᵀ + bias   Sⁿ = q·nullk_pre + null_bias
    P = softmax([S, Sⁿ]) (from the saved lse)   O = P·V + Pⁿ·nullv

K4 (the VJP of K3, as ``_bwd_sc_impl`` in
gigagan_tpu/ops/pallas/flash_attention_so.py) takes the cotangent G and
returns a gradient for every prepared operand:

    dA = G·Vᵀ   δ = rowsum(G ⊙ O)   dS = P ⊙ (dA − δ)   dSⁿ = Pⁿ (dAⁿ − δ)
    dq = dS·k_pre + dSⁿ nullk_pre   dk_pre = dSᵀ·q   dv = Pᵀ·G
    dbias = colsum(dS)   dnullk_pre = Σ dSⁿ q   dnullv = Σ Pⁿ G
    dnull_bias = Σ dSⁿ   (the null sums run over batch and rows)

K5 (the adjoint of K4, as ``_bwd_so_bwd``) takes the cotangents
Ã, B̃, C̃, D̃, Ẽ, F̃, H̃ of (dq, dk_pre, dv, dbias, dnullk_pre, dnullv,
dnull_bias) and returns the cotangents of (q, k_pre, v, bias, nullk_pre,
nullv, null_bias, G).  K3's lse and out enter K4 as constants, so K5
carries the whole second derivative, the softmax normalizer included:

    c_dS = Ã·k_preᵀ + q·B̃ᵀ + D̃        c_dSⁿ = Ã·nullk_pre + q·Ẽ + H̃
    r₁ = Σ P c_dS dA   r₂ = Σ P c_dS   r₃ = Σ P (G·C̃ᵀ)   (null column in
    every row sum)   c_δ = −r₂   ρ = r₁ + r₃ − 2δ r₂
    c_dA = P (c_dS − r₂)   c_S = P (c_dS (dA − δ) + G·C̃ᵀ − r₂ dA − ρ)
    c_q = c_S·k_pre + dS·B̃ (+ null)   c_G = c_dA·V + P·C̃ (+ null)
    c_k_pre = c_Sᵀ·q + dSᵀ·Ã   c_v = c_dAᵀ·G   c_bias = colsum(c_S)

The chain rule from the prepared operands to k, the shared q/k of L2
attention and null_kv runs through plain autograd of ``prep_fused``.  As
everywhere in the port, a wrapper launches its kernel on a CUDA tensor and
runs its plain version on a CPU tensor; the Functions are the same on both.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from gigagan_tpu_torch.ops.kernels import build
from gigagan_tpu_torch.ops.kernels.adaptive_conv import acc_dtype
from gigagan_tpu_torch.ops.kernels.flash_attention_fused import (
    _DTYPE_CODES,
    _check,
    _head_dim,
    _ptr,
    by_batch,
    check_tc,
    flash_attention_fused_fwd,
    prep_fused,
    uses_tensor_cores,
)

_BQ = 64  # fewest query rows per block of any K4/K5 kernel (null partials)


def _heads(t, heads, acc):
    b, n, hd = t.shape
    return t.to(acc).reshape(b, n, heads, hd // heads).permute(0, 2, 1, 3)


def _merge(t, dtype):
    b, h, n, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, n, h * d).to(dtype)


def _probs(q, kp, bias, nkp, nb, lse):
    """P (b, H, nq, nk) and the null column Pⁿ (b, H, nq) or None, from the
    saved lse."""
    s = torch.einsum("bhid,bhjd->bhij", q, kp)
    if bias is not None:
        s = s + bias.to(s.dtype)[:, :, None, :]
    p = torch.exp(s - lse.to(s.dtype)[..., None])
    if nkp is None:
        return p, None
    sn = torch.einsum("bhid,hd->bhi", q, nkp) + nb.to(s.dtype)[None, :, None]
    return p, torch.exp(sn - lse.to(s.dtype))


# ------------------------------------------------------------------ K4

def flash_attention_fused_bwd_plain(q, k_pre, v, bias, nullk_pre, nullv,
                                    null_bias, g, out, lse, heads: int):
    """The kernel's function in plain PyTorch.  Returns (dq, dk_pre, dv,
    dbias, dnullk_pre, dnullv, dnull_bias): dq/dk_pre/dv in q's dtype, the
    rest in the accumulation dtype; dbias is None without a bias and the
    null gradients are None without a null token."""
    acc = acc_dtype(q)
    qh, kh, vh, gh, oh = (_heads(t, heads, acc)
                          for t in (q, k_pre, v, g, out))
    have_null = nullk_pre is not None
    nk_ = nullk_pre.to(acc) if have_null else None
    p, pn = _probs(qh, kh, bias, nk_, null_bias, lse)
    da = torch.einsum("bhid,bhjd->bhij", gh, vh)
    delta = (gh * oh).sum(-1)
    ds = p * (da - delta[..., None])
    dq = torch.einsum("bhij,bhjd->bhid", ds, kh)
    dkp = torch.einsum("bhij,bhid->bhjd", ds, qh)
    dv = torch.einsum("bhij,bhid->bhjd", p, gh)
    dbias = ds.sum(2) if bias is not None else None
    dnk = dnv = dnb = None
    if have_null:
        dan = torch.einsum("bhid,hd->bhi", gh, nullv.to(acc))
        dsn = pn * (dan - delta)
        dq = dq + dsn[..., None] * nk_[None, :, None, :]
        dnk = torch.einsum("bhi,bhid->hd", dsn, qh)
        dnv = torch.einsum("bhi,bhid->hd", pn, gh)
        dnb = dsn.sum((0, 2))
    dt = q.dtype
    return (_merge(dq, dt), _merge(dkp, dt), _merge(dv, dt), dbias, dnk,
            dnv, dnb)


def _check_rows(what, name, t, shape, device):
    """A float32 per-(sample, head, row) operand: lse, or the bias
    cotangent."""
    if tuple(t.shape) != shape or t.dtype != torch.float32:
        raise ValueError(f"{what}: {name} must be float32 {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.device != device:
        raise ValueError(f"{what}: {name} must be contiguous on {device}")


def _check_like(what, ref, tensors):
    for name, t in tensors:
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(f"{what}: {name} {t.dtype} {tuple(t.shape)} "
                             f"must match {ref.dtype} {tuple(ref.shape)}")
        if not t.is_contiguous() or t.device != ref.device:
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{ref.device}")


def _null_workspace(b, nq, heads, d, device):
    """Per-(sample, query block) partials of the null gradients:
    (b·qtiles, H, 2·d + 1) fp32 for the smallest block, 64 rows; added in a
    fixed order by the kernel."""
    qtiles = -(-nq // _BQ)
    return torch.empty((b * qtiles, heads, 2 * d + 1), dtype=torch.float32,
                       device=device)


def _bwd_launch(what, source, q, k_pre, v, bias, nullk_pre, nullv,
                null_bias, g, out, lse, heads, *dtype):
    """Check the operands, allocate, and call ``gigagan_<what>`` of
    ``csrc/<source>.cu``: the two K4 kernels share one C signature, and
    only the CUDA-core one takes a dtype code.  The caller has run
    ``_check``."""
    _check_like(what, q, (("g", g), ("out", out)))
    b, nq, hd = q.shape
    nk = k_pre.shape[1]
    d = hd // heads
    dev = q.device
    _check_rows(what, "lse", lse, (b, heads, nq), dev)
    have_null = nullk_pre is not None
    f32 = dict(dtype=torch.float32, device=dev)
    dq = torch.empty_like(q)
    dkp = torch.empty_like(k_pre)
    dv = torch.empty_like(v)
    dbias = torch.empty((b, heads, nk), **f32) if bias is not None else None
    delta = torch.empty((b, heads, nq), **f32)
    part = dnk = dnv = dnb = None
    if have_null:
        part = _null_workspace(b, nq, heads, d, dev)
        dnk = torch.empty((heads, d), **f32)
        dnv = torch.empty((heads, d), **f32)
        dnb = torch.empty((heads,), **f32)
    lib = build.load(source)
    fn = getattr(lib, f"gigagan_{what}")
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * (
        7 + len(dtype)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k_pre.data_ptr(), v.data_ptr(), _ptr(bias),
        _ptr(nullk_pre), _ptr(nullv), _ptr(null_bias), g.data_ptr(),
        out.data_ptr(), lse.data_ptr(), dq.data_ptr(), dkp.data_ptr(),
        dv.data_ptr(), _ptr(dbias), delta.data_ptr(), _ptr(part), _ptr(dnk),
        _ptr(dnv), _ptr(dnb), b, nq, nk, heads, d, int(have_null),
        *dtype, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, what)
    return dq, dkp, dv, dbias, dnk, dnv, dnb


def flash_attention_fused_bwd_simt(q, k_pre, v, bias, nullk_pre, nullv,
                                   null_bias, g, out, lse, heads: int):
    """K4 on CUDA cores (``csrc/flash_attention_fused_bwd.cu``), float32 or
    bf16 with head dim up to 128 (returns as the plain version)."""
    _check(q, k_pre, v, bias, nullk_pre, nullv, null_bias, heads)
    res = _bwd_launch("flash_attention_fused_bwd_simt",
                      "flash_attention_fused_bwd", q, k_pre, v, bias,
                      nullk_pre, nullv, null_bias, g, out, lse, heads,
                      _DTYPE_CODES[q.dtype])
    flash_attention_fused_bwd_simt.launches += 1
    return res


def launch_bwd_tc(what, q, k_pre, v, bias, nullk_pre, nullv, null_bias, g,
                  out, lse, heads: int):
    """Check the operands and launch ``csrc/flash_attention_fused_bwd_tc.cu``
    (K4's tensor-core kernels, also K6b's with heads = 1); the caller counts
    the launch.  Returns as the plain version."""
    _check(q, k_pre, v, bias, nullk_pre, nullv, null_bias, heads)
    d = q.shape[-1] // heads
    if not uses_tensor_cores(q.dtype, d):
        raise ValueError(f"{what}: takes bf16 with head dim 64 or 128, got "
                         f"{q.dtype} with {d}")
    check_tc(what, (("q", q), ("k_pre", k_pre), ("v", v), ("g", g),
                    ("out", out), ("nullk_pre", nullk_pre), ("nullv", nullv)))
    return _bwd_launch("flash_attention_fused_bwd_tc",
                       "flash_attention_fused_bwd_tc", q, k_pre, v, bias,
                       nullk_pre, nullv, null_bias, g, out, lse, heads)


def flash_attention_fused_bwd_tc(q, k_pre, v, bias, nullk_pre, nullv,
                                 null_bias, g, out, lse, heads: int):
    """K4 on the tensor cores (``csrc/flash_attention_fused_bwd_tc.cu``),
    bf16 with head dim 64 or 128 (returns as the plain version)."""
    res = launch_bwd_tc("flash_attention_fused_bwd_tc", q, k_pre, v, bias,
                        nullk_pre, nullv, null_bias, g, out, lse, heads)
    flash_attention_fused_bwd_tc.launches += 1
    return res


flash_attention_fused_bwd_simt.launches = 0
flash_attention_fused_bwd_tc.launches = 0


def flash_attention_fused_bwd(q, k_pre, v, bias, nullk_pre, nullv,
                              null_bias, g, out, lse, heads: int):
    """K4: its plain version on CPU tensors; on CUDA tensors the
    tensor-core or the CUDA-core kernel by ``uses_tensor_cores``, in chunks
    of at most MAX_BATCH samples (same returns as the plain version)."""
    if q.device.type == "cpu":
        return flash_attention_fused_bwd_plain(
            q, k_pre, v, bias, nullk_pre, nullv, null_bias, g, out, lse,
            heads,
        )
    d = _head_dim("flash_attention_fused_bwd", q, heads)
    kernel = (flash_attention_fused_bwd_tc if uses_tensor_cores(q.dtype, d)
              else flash_attention_fused_bwd_simt)
    return by_batch(kernel, (q, k_pre, v, bias, nullk_pre, nullv, null_bias,
                             g, out, lse, heads),
                    batched=(0, 1, 2, 3, 7, 8, 9), summed=(4, 5, 6))


# ------------------------------------------------------------------ K5

def flash_attention_so_bwd2_plain(q, k_pre, v, bias, nullk_pre, nullv,
                                  null_bias, g, lse, cdq, cdk, cdv, cdbias,
                                  cdnullk, cdnullv, cdnull_bias, heads: int):
    """The kernel's function in plain PyTorch (module docstring math).
    Cotangents cdbias and the null ones may be None where K4 had no such
    output.  Returns the cotangents (cq, ck_pre, cv, cbias, cnullk_pre,
    cnullv, cnull_bias, cg): cq/ck_pre/cv/cg in q's dtype, the rest in the
    accumulation dtype; cbias is None without a bias, the null ones None
    without a null token."""
    acc = acc_dtype(q)
    qh, kh, vh, gh = (_heads(t, heads, acc) for t in (q, k_pre, v, g))
    ca, cb, cc = (_heads(t, heads, acc) for t in (cdq, cdk, cdv))
    have_null = nullk_pre is not None
    nk_ = nullk_pre.to(acc) if have_null else None
    nv_ = nullv.to(acc) if have_null else None
    p, pn = _probs(qh, kh, bias, nk_, null_bias, lse)
    da = torch.einsum("bhid,bhjd->bhij", gh, vh)
    c_ds = (torch.einsum("bhid,bhjd->bhij", ca, kh)
            + torch.einsum("bhid,bhjd->bhij", qh, cb))
    if cdbias is not None:
        c_ds = c_ds + cdbias.to(acc)[:, :, None, :]
    gc = torch.einsum("bhid,bhjd->bhij", gh, cc)
    delta = (p * da).sum(-1)
    r1 = (p * c_ds * da).sum(-1)
    r2 = (p * c_ds).sum(-1)
    r3 = (p * gc).sum(-1)
    if have_null:
        dan = torch.einsum("bhid,hd->bhi", gh, nv_)
        c_dsn = torch.einsum("bhid,hd->bhi", ca, nk_)
        if cdnullk is not None:
            c_dsn = c_dsn + torch.einsum("bhid,hd->bhi", qh,
                                         cdnullk.to(acc))
        if cdnull_bias is not None:
            c_dsn = c_dsn + cdnull_bias.to(acc)[None, :, None]
        gf = (torch.einsum("bhid,hd->bhi", gh, cdnullv.to(acc))
              if cdnullv is not None else torch.zeros_like(dan))
        delta = delta + pn * dan
        r1 = r1 + pn * c_dsn * dan
        r2 = r2 + pn * c_dsn
        r3 = r3 + pn * gf
    rho = r1 + r3 - 2.0 * delta * r2
    dl, r2e, rhoe = delta[..., None], r2[..., None], rho[..., None]
    ds = p * (da - dl)
    c_da = p * (c_ds - r2e)
    c_s = p * (c_ds * (da - dl) + gc - r2e * da - rhoe)
    cq = (torch.einsum("bhij,bhjd->bhid", c_s, kh)
          + torch.einsum("bhij,bhjd->bhid", ds, cb))
    cg = (torch.einsum("bhij,bhjd->bhid", c_da, vh)
          + torch.einsum("bhij,bhjd->bhid", p, cc))
    ckp = (torch.einsum("bhij,bhid->bhjd", c_s, qh)
           + torch.einsum("bhij,bhid->bhjd", ds, ca))
    cv = torch.einsum("bhij,bhid->bhjd", c_da, gh)
    cbias = c_s.sum(2) if bias is not None else None
    cnk = cnv = cnb = None
    if have_null:
        dsn = pn * (dan - delta)
        c_dan = pn * (c_dsn - r2)
        c_sn = pn * (c_dsn * (dan - delta) + gf - r2 * dan - rho)
        cq = cq + c_sn[..., None] * nk_[None, :, None, :]
        cg = cg + c_dan[..., None] * nv_[None, :, None, :]
        if cdnullk is not None:
            cq = cq + dsn[..., None] * cdnullk.to(acc)[None, :, None, :]
        if cdnullv is not None:
            cg = cg + pn[..., None] * cdnullv.to(acc)[None, :, None, :]
        cnk = (torch.einsum("bhi,bhid->hd", c_sn, qh)
               + torch.einsum("bhi,bhid->hd", dsn, ca))
        cnv = torch.einsum("bhi,bhid->hd", c_dan, gh)
        cnb = c_sn.sum((0, 2))
    dt = q.dtype
    return (_merge(cq, dt), _merge(ckp, dt), _merge(cv, dt), cbias, cnk,
            cnv, cnb, _merge(cg, dt))


def so_uses_tensor_cores(dtype, d: int) -> bool:
    """K5's dispatch rule, K3/K4's: bf16 operands at head dim 64 or 128 go
    to the tensor-core kernels (``csrc/flash_attention_so_bwd2_tc.cu``; at
    128 each block accumulates one 64-column slice of its outputs); fp32
    and every other head dim up to 128 to the CUDA-core kernels
    (``*_simt``)."""
    return dtype == torch.bfloat16 and d in (64, 128)


def _so_bwd2_launch(what, source, q, k_pre, v, bias, nullk_pre, nullv,
                    null_bias, g, lse, cdq, cdk, cdv, cdbias, cdnullk,
                    cdnullv, cdnull_bias, heads, *dtype):
    """Check the operands, allocate, and call ``gigagan_<what>`` of
    ``csrc/<source>.cu``: the two K5 implementations share one C signature,
    and only the CUDA-core one takes a dtype code.  The caller has run
    ``_check``."""
    b, nq, hd = q.shape
    nk = k_pre.shape[1]
    d = hd // heads
    dev = q.device
    have_null = nullk_pre is not None
    _check_like(what, q, (("g", g), ("cdq", cdq)))
    _check_like(what, k_pre, (("cdk", cdk), ("cdv", cdv)))
    _check_rows(what, "lse", lse, (b, heads, nq), dev)
    if bias is not None:
        if cdbias is None:
            cdbias = torch.zeros_like(bias)
        _check_rows(what, "cdbias", cdbias, (b, heads, nk), dev)
    else:
        cdbias = None
    f32 = dict(dtype=torch.float32, device=dev)
    if have_null:
        cdnullk = (torch.zeros((heads, d), **f32) if cdnullk is None
                   else cdnullk.float().contiguous())
        cdnullv = (torch.zeros((heads, d), **f32) if cdnullv is None
                   else cdnullv.float().contiguous())
        cdnull_bias = (torch.zeros((heads,), **f32) if cdnull_bias is None
                       else cdnull_bias.float().contiguous())
    else:
        cdnullk = cdnullv = cdnull_bias = None
    cq = torch.empty_like(q)
    ckp = torch.empty_like(k_pre)
    cv = torch.empty_like(v)
    cg = torch.empty_like(q)
    cbias = torch.empty((b, heads, nk), **f32) if bias is not None else None
    stats = torch.empty((b, heads, nq, 3), **f32)
    part = _null_workspace(b, nq, heads, d, dev) if have_null else None
    cnk = cnv = cnb = None
    if have_null:
        cnk = torch.empty((heads, d), **f32)
        cnv = torch.empty((heads, d), **f32)
        cnb = torch.empty((heads,), **f32)
    lib = build.load(source)
    fn = getattr(lib, f"gigagan_{what}")
    fn.argtypes = [ctypes.c_void_p] * 26 + [ctypes.c_int] * (
        7 + len(dtype)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k_pre.data_ptr(), v.data_ptr(), _ptr(bias),
        _ptr(nullk_pre), _ptr(nullv), _ptr(null_bias), g.data_ptr(),
        lse.data_ptr(), cdq.data_ptr(), cdk.data_ptr(), cdv.data_ptr(),
        _ptr(cdbias), _ptr(cdnullk), _ptr(cdnullv), _ptr(cdnull_bias),
        cq.data_ptr(), ckp.data_ptr(), cv.data_ptr(), cg.data_ptr(),
        _ptr(cbias), stats.data_ptr(), _ptr(part), _ptr(cnk), _ptr(cnv),
        _ptr(cnb), b, nq, nk, heads, d, int(have_null), *dtype, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, what)
    return cq, ckp, cv, cbias, cnk, cnv, cnb, cg


def flash_attention_so_bwd2_simt(q, k_pre, v, bias, nullk_pre, nullv,
                                 null_bias, g, lse, cdq, cdk, cdv, cdbias,
                                 cdnullk, cdnullv, cdnull_bias, heads: int):
    """K5 on CUDA cores (``csrc/flash_attention_so_bwd2.cu``), float32 or
    bf16 with head dim up to 128 (returns as the plain version)."""
    _check(q, k_pre, v, bias, nullk_pre, nullv, null_bias, heads)
    res = _so_bwd2_launch(
        "flash_attention_so_bwd2_simt", "flash_attention_so_bwd2", q, k_pre,
        v, bias, nullk_pre, nullv, null_bias, g, lse, cdq, cdk, cdv, cdbias,
        cdnullk, cdnullv, cdnull_bias, heads, _DTYPE_CODES[q.dtype])
    flash_attention_so_bwd2_simt.launches += 1
    return res


def flash_attention_so_bwd2_tc(q, k_pre, v, bias, nullk_pre, nullv,
                               null_bias, g, lse, cdq, cdk, cdv, cdbias,
                               cdnullk, cdnullv, cdnull_bias, heads: int):
    """K5 on the tensor cores (``csrc/flash_attention_so_bwd2_tc.cu``),
    bf16 at head dim 64 or 128 (returns as the plain version)."""
    what = "flash_attention_so_bwd2_tc"
    d = _head_dim(what, q, heads)
    if not so_uses_tensor_cores(q.dtype, d):
        raise ValueError(f"{what}: takes bf16 with head dim 64 or 128, got "
                         f"{q.dtype} with head dim {d}")
    _check(q, k_pre, v, bias, nullk_pre, nullv, null_bias, heads)
    check_tc(what, (("q", q), ("k_pre", k_pre), ("v", v), ("g", g),
                    ("cdq", cdq), ("cdk", cdk), ("cdv", cdv)))
    res = _so_bwd2_launch(
        what, what, q, k_pre, v, bias, nullk_pre, nullv, null_bias, g, lse,
        cdq, cdk, cdv, cdbias, cdnullk, cdnullv, cdnull_bias, heads)
    flash_attention_so_bwd2_tc.launches += 1
    return res


flash_attention_so_bwd2_simt.launches = 0
flash_attention_so_bwd2_tc.launches = 0


def flash_attention_so_bwd2(q, k_pre, v, bias, nullk_pre, nullv, null_bias,
                            g, lse, cdq, cdk, cdv, cdbias, cdnullk, cdnullv,
                            cdnull_bias, heads: int):
    """K5: its plain version on CPU tensors; on CUDA tensors the
    tensor-core or the CUDA-core kernel by ``so_uses_tensor_cores``, in
    chunks of at most MAX_BATCH samples (same returns as the plain
    version)."""
    args = (q, k_pre, v, bias, nullk_pre, nullv, null_bias, g, lse, cdq,
            cdk, cdv, cdbias, cdnullk, cdnullv, cdnull_bias, heads)
    if q.device.type == "cpu":
        return flash_attention_so_bwd2_plain(*args)
    d = _head_dim("flash_attention_so_bwd2", q, heads)
    kernel = (flash_attention_so_bwd2_tc if so_uses_tensor_cores(q.dtype, d)
              else flash_attention_so_bwd2_simt)
    return by_batch(kernel, args, batched=(0, 1, 2, 3, 7, 8, 9, 10, 11, 12),
                    summed=(4, 5, 6))


# ------------------------------------------------------ the autograd chain

def _like(t, ref):
    return None if t is None or ref is None else t.to(ref.dtype)


class _FusedAttention(torch.autograd.Function):
    """K3 on prepared operands; its backward is ``_FusedAttentionBwd``
    (K4), whose own backward is K5."""

    @staticmethod
    def forward(ctx, q, k_pre, v, bias, nullk_pre, nullv, null_bias, heads):
        out, lse = flash_attention_fused_fwd(q, k_pre, v, bias, nullk_pre,
                                             nullv, null_bias, heads)
        ctx.heads = heads
        ctx.save_for_backward(q, k_pre, v, bias, nullk_pre, nullv,
                              null_bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k_pre, v, bias, nullk_pre, nullv, null_bias, out, lse = (
            ctx.saved_tensors
        )
        grads = _FusedAttentionBwd.apply(
            q, k_pre, v, bias, nullk_pre, nullv, null_bias,
            g.to(q.dtype).contiguous(), out.detach(), lse.detach(),
            ctx.heads,
        )
        return (*grads, None)


class _FusedAttentionBwd(torch.autograd.Function):
    """K4 as a differentiable op of (q, k_pre, v, bias, null rows, g); out
    and lse are constants, and K5 is the full second derivative."""

    @staticmethod
    def forward(ctx, q, k_pre, v, bias, nullk_pre, nullv, null_bias, g, out,
                lse, heads):
        dq, dkp, dv, dbias, dnk, dnv, dnb = flash_attention_fused_bwd(
            q, k_pre, v, bias, nullk_pre, nullv, null_bias, g, out, lse,
            heads,
        )
        ctx.heads = heads
        ctx.save_for_backward(q, k_pre, v, bias, nullk_pre, nullv,
                              null_bias, g, lse)
        return (dq, dkp, dv, _like(dbias, bias), _like(dnk, nullk_pre),
                _like(dnv, nullv), _like(dnb, null_bias))

    @staticmethod
    @once_differentiable
    def backward(ctx, cdq, cdk, cdv, cdbias, cdnk, cdnv, cdnb):
        q, k_pre, v, bias, nullk_pre, nullv, null_bias, g, lse = (
            ctx.saved_tensors
        )
        cq, ckp, cv, cbias, cnk, cnv, cnb, cg = flash_attention_so_bwd2(
            q, k_pre, v, bias, nullk_pre, nullv, null_bias, g, lse,
            cdq.contiguous(), cdk.contiguous(), cdv.contiguous(), cdbias,
            cdnk, cdnv, cdnb, ctx.heads,
        )
        return (cq, ckp, cv, _like(cbias, bias), _like(cnk, nullk_pre),
                _like(cnv, nullv), _like(cnb, null_bias), cg, None, None,
                None)


def fused_attention(q, k_pre, v, bias, nullk_pre, nullv, null_bias,
                    heads: int):
    """K3 on prepared operands, differentiable to second order."""
    return _FusedAttention.apply(q, k_pre, v, bias, nullk_pre, nullv,
                                 null_bias, heads)


def flash_attend_fused(q, k, v, null_kv, heads: int, l2_dist: bool = False,
                       scale=None):
    """Fused-heads attention through K3/K4/K5: q (b, nq, H·d), k/v
    (b, nk, H·d), null_kv (2, H, d) or None → (b, nq, H·d)."""
    d = q.shape[-1] // heads
    if scale is None:
        scale = d ** -0.5
    k_pre, bias, nullk_pre, nullv, null_bias = prep_fused(
        k, v, null_kv, heads, l2_dist, scale
    )
    return fused_attention(q.contiguous(), k_pre.contiguous(), v.contiguous(),
                           bias, nullk_pre, nullv, null_bias, heads)
