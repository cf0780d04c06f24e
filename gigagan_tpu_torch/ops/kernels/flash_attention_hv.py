"""Kernels K7a and K7b: split-heads attention together with its tangent,
and the backward of that pair; their plain PyTorch versions; and the
Functions behind ``flash_attend_hv``, the split-heads attention of
``ops.attend`` at flash sizes, which the forward-over-reverse R1 penalty
can differentiate (counterpart of
gigagan_tpu/ops/pallas/flash_attention_hv.py).  Each kernel has two
implementations, picked by ``hv_uses_tensor_cores``: for bf16 at d = 64 the
tensor-core kernels (``csrc/flash_attention_hv_jvp_tc.cu``,
``csrc/flash_attention_hv_bwd_tc.cu``), otherwise the CUDA-core kernels
(``csrc/flash_attention_hv_jvp.cu``, ``csrc/flash_attention_hv_bwd.cu``).
Both put b·h on a grid axis of at most 65535 blocks, so the dispatchers run
larger b·h in chunks (``by_rows``).

Math per (b·h), on ``prep_split``'s prepared operands (k̂ = coeff·k) and
their tangents (t̂k = coeff·tk, tbias = −2·scale·Σ k⊙tk for L2, 0 for dot,
0 under the key mask — ``prep_tangents``; the same as the forward-mode
derivative of ``prep_split``):

    S = q k̂ᵀ + bias    T = tq k̂ᵀ + q t̂kᵀ + tbias    A = softmax(S)
    μ = rowsum(A⊙T)    out = A v    tout = (A⊙(T − μ)) v + A tv

K7a computes (out, tout, lse).  K7b takes the cotangents ĝo (may be
absent) and ĝt and returns those of all eight operands, with
r = rowsum(A⊙ĝtA):

    ĝtA = ĝt vᵀ   ĝA = ĝo vᵀ + ĝt tvᵀ + ĝtA⊙(T − μ) − T⊙r
    ĝT = A⊙(ĝtA − r)   ĝS = A⊙(ĝA − rowsum(A⊙ĝA))
    ĝq = ĝS k̂ + ĝT t̂k   ĝk̂ = ĝSᵀ q + ĝTᵀ tq   ĝtq = ĝT k̂   ĝt̂k = ĝTᵀ q
    ĝv = Aᵀ ĝo + (A⊙(T − μ))ᵀ ĝt   ĝtv = Aᵀ ĝt
    ĝbias = colsum(ĝS)   ĝtbias = colsum(ĝT)

How the four kernels meet under ``torch.func.jvp`` (the R1 surrogate φ of
``train/steps.py``): ``_FlashAttendHV``'s forward is K6a and its backward
K6b; its ``jvp`` returns the tangent output of ``_AttendJvpPair``, whose
forward is K7a and whose backward is K7b.  An autograd Function keeps its
own backward under forward-mode AD, so the outer reverse pass of
grad-of-jvp runs K6b through φ's primal and K7b through its tangent.  The
chain rules from k̂, the bias and their tangents back to k and tk are plain
autograd (and forward AD) of ``prep_split``.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.autograd.function import once_differentiable

from gigagan_tpu_torch.ops.kernels import build
from gigagan_tpu_torch.ops.kernels.adaptive_conv import acc_dtype
from gigagan_tpu_torch.ops.kernels.flash_attention import (
    _DTYPE_CODES,
    _check,
    _launcher,
    _logits,
    by_rows,
    flash_attention_bwd,
    flash_attention_fwd,
    prep_split,
)
from gigagan_tpu_torch.ops.kernels.flash_attention_fused import check_tc
from gigagan_tpu_torch.ops.kernels.flash_attention_so import _check_rows, _ptr

# Set while the R1 surrogate φ runs: ``ops.attend`` then routes its
# flash-sized calls to ``flash_attend_hv`` and ``ops.attend_fused`` takes
# the split-heads route, so φ can be differentiated forward-over-reverse.
_HV_MODE: contextvars.ContextVar = contextvars.ContextVar(
    "gigagan_torch_flash_hv", default=False
)


@contextlib.contextmanager
def flash_hv_mode():
    token = _HV_MODE.set(True)
    try:
        yield
    finally:
        _HV_MODE.reset(token)


def hv_mode() -> bool:
    return _HV_MODE.get()


def prep_tangents(q, k, tq, tk, mask, l2_dist: bool, scale: float):
    """Tangents of ``prep_split``'s operands along (tq, tk): (tq (b·h, nq,
    d), t̂k = coeff·tk (b·h, nk, d), tbias (b·h, nk) fp32)."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    acc = acc_dtype(k)
    coeff = 2.0 * scale if l2_dist else scale
    tkf = tk.reshape(b * h, nk, d)
    tk_pre = (tkf.to(acc) * coeff).to(tk.dtype)
    if l2_dist:
        prod = k.reshape(b * h, nk, d).to(acc) * tkf.to(acc)
        tbias = -2.0 * scale * prod.sum(-1)
    else:
        tbias = torch.zeros((b * h, nk), dtype=acc, device=k.device)
    if mask is not None:
        keep = mask.to(k.device).repeat_interleave(h, dim=0)
        tbias = torch.where(keep, tbias, torch.zeros_like(tbias))
    return (tq.reshape(b * h, nq, d).contiguous(), tk_pre.contiguous(),
            tbias.contiguous())


def _tangent_logits(q, k_pre, tq, tk_pre, tbias):
    acc = acc_dtype(q)
    return (torch.einsum("nid,njd->nij", tq.to(acc), k_pre.to(acc))
            + torch.einsum("nid,njd->nij", q.to(acc), tk_pre.to(acc))
            + tbias.to(acc)[:, None, :])


# ------------------------------------------------------------------ K7a

def flash_attention_hv_jvp_plain(q, k_pre, v, bias, tq, tk_pre, tv, tbias):
    """The kernel's function in plain PyTorch: fp32 logits and tangent
    logits, A and A⊙(T − μ) rounded to v's dtype for their products.
    Returns (out, tout) in q's dtype and lse (b·h, nq)."""
    acc = acc_dtype(q)
    s = _logits(q, k_pre, bias)
    t_sim = _tangent_logits(q, k_pre, tq, tk_pre, tbias)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    tot = e.sum(-1, keepdim=True)
    a = e / tot
    mu = (a * t_sim).sum(-1, keepdim=True)
    ta = a * (t_sim - mu)

    def mm(p, x):
        return torch.einsum("nij,njd->nid", p.to(x.dtype).to(acc), x.to(acc))

    dt = q.dtype
    return (mm(a, v).to(dt), (mm(ta, v) + mm(a, tv)).to(dt),
            (m + torch.log(tot))[..., 0])


def hv_uses_tensor_cores(dtype, d: int) -> bool:
    """K7a's and K7b's dispatch rule: bf16 operands at head dim 64 go to the
    tensor-core kernels (``csrc/flash_attention_hv_{jvp,bwd}_tc.cu``); fp32
    and every other head dim up to 128 to the CUDA-core kernels
    (``*_simt``).  d = 128 does not fit the tensor-core kernels' registers:
    K7a's two (64 × 128) fp32 accumulators, and K7b's in each of its three
    kernels, would take 128 of the 168 registers a thread gets."""
    return dtype == torch.bfloat16 and d == 64


def _check_tc(what, q, *tensors):
    """The tensor-core entries take what ``hv_uses_tensor_cores`` sends
    them, with every operand 16-byte aligned for TMA; after ``_check``."""
    if not hv_uses_tensor_cores(q.dtype, q.shape[-1]):
        raise ValueError(f"{what}: takes bf16 with head dim 64, got "
                         f"{q.dtype} with {q.shape[-1]}")
    check_tc(what, (("q", q),) + tuple(
        (f"operand {i}", t) for i, t in enumerate(tensors, 1)))


def _check_jvp(what, q, k_pre, v, bias, tq, tk_pre, tv, tbias):
    _check(what, q, k_pre, v, bias, nq_like=(("tq", tq),),
           nk_like=(("tk_pre", tk_pre), ("tv", tv)),
           bias_like=(("tbias", tbias),))


def _jvp_launch(what, source, q, k_pre, v, bias, tq, tk_pre, tv, tbias):
    """Allocate and call ``gigagan_<what>`` of ``csrc/<source>.cu`` on
    checked operands: both K7a implementations share one C signature."""
    bh, nq, d = q.shape
    out = torch.empty_like(q)
    tout = torch.empty_like(q)
    lse = torch.empty((bh, nq), dtype=torch.float32, device=q.device)
    lib, fn = _launcher(what, 11, source)
    err = fn(q.data_ptr(), k_pre.data_ptr(), v.data_ptr(), bias.data_ptr(),
             tq.data_ptr(), tk_pre.data_ptr(), tv.data_ptr(),
             tbias.data_ptr(), out.data_ptr(), tout.data_ptr(),
             lse.data_ptr(), bh, nq, k_pre.shape[1], d,
             _DTYPE_CODES[q.dtype], q.device.index,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, what)
    return out, tout, lse


def flash_attention_hv_jvp_simt(q, k_pre, v, bias, tq, tk_pre, tv, tbias):
    """K7a on CUDA cores (``csrc/flash_attention_hv_jvp.cu``): float32 or
    bf16 with head dim up to 128.  Returns (out, tout, lse)."""
    what = "flash_attention_hv_jvp_simt"
    _check_jvp(what, q, k_pre, v, bias, tq, tk_pre, tv, tbias)
    res = _jvp_launch(what, "flash_attention_hv_jvp", q, k_pre, v, bias, tq,
                      tk_pre, tv, tbias)
    flash_attention_hv_jvp_simt.launches += 1
    return res


def flash_attention_hv_jvp_tc(q, k_pre, v, bias, tq, tk_pre, tv, tbias):
    """K7a on the tensor cores (``csrc/flash_attention_hv_jvp_tc.cu``):
    bf16 at head dim 64.  Returns (out, tout, lse)."""
    what = "flash_attention_hv_jvp_tc"
    _check_jvp(what, q, k_pre, v, bias, tq, tk_pre, tv, tbias)
    _check_tc(what, q, k_pre, v, tq, tk_pre, tv)
    res = _jvp_launch(what, what, q, k_pre, v, bias, tq, tk_pre, tv, tbias)
    flash_attention_hv_jvp_tc.launches += 1
    return res


flash_attention_hv_jvp_simt.launches = 0
flash_attention_hv_jvp_tc.launches = 0


def flash_attention_hv_jvp(q, k_pre, v, bias, tq, tk_pre, tv, tbias):
    """K7a: its plain version on CPU tensors; on CUDA tensors the
    tensor-core or the CUDA-core kernel by ``hv_uses_tensor_cores``, in
    chunks of at most MAX_ROWS b·h rows.  Returns (out, tout, lse)."""
    if q.device.type == "cpu":
        return flash_attention_hv_jvp_plain(q, k_pre, v, bias, tq, tk_pre,
                                            tv, tbias)
    kernel = (flash_attention_hv_jvp_tc
              if hv_uses_tensor_cores(q.dtype, q.shape[-1])
              else flash_attention_hv_jvp_simt)
    return by_rows(kernel, q, k_pre, v, bias, tq, tk_pre, tv, tbias)


# ------------------------------------------------------------------ K7b

def flash_attention_hv_bwd_plain(q, k_pre, v, bias, tq, tk_pre, tv, tbias,
                                 lse, go, gt):
    """The kernel's function in plain PyTorch (module docstring math);
    ``go`` may be None (no cotangent on out).  Returns the cotangents
    (gq, gk_pre, gv, gbias, gtq, gtk_pre, gtv, gtbias): gq/gv/gtq/gtv in
    q's dtype, the others in the accumulation dtype."""
    acc = acc_dtype(q)
    k32, v32, tv32 = k_pre.to(acc), v.to(acc), tv.to(acc)
    q32, tq32, gt32 = q.to(acc), tq.to(acc), gt.to(acc)
    a = torch.exp(_logits(q, k_pre, bias) - lse.to(acc)[..., None])
    t_sim = _tangent_logits(q, k_pre, tq, tk_pre, tbias)
    t_cent = t_sim - (a * t_sim).sum(-1, keepdim=True)

    def nt(x, y):
        return torch.einsum("nid,njd->nij", x, y)

    def nn(p, y):
        return torch.einsum("nij,njd->nid", p, y)

    def tn(p, x):
        return torch.einsum("nij,nid->njd", p, x)

    gta = nt(gt32, v32)
    r = (a * gta).sum(-1, keepdim=True)
    ga = nt(gt32, tv32) + gta * t_cent - t_sim * r
    if go is not None:
        ga = ga + nt(go.to(acc), v32)
    g_t = a * (gta - r)
    g_s = a * (ga - (a * ga).sum(-1, keepdim=True))
    gv = tn(a * t_cent, gt32)
    if go is not None:
        gv = gv + tn(a, go.to(acc))
    dt = q.dtype
    return (
        (nn(g_s, k32) + nn(g_t, tk_pre.to(acc))).to(dt),
        tn(g_s, q32) + tn(g_t, tq32),
        gv.to(dt),
        g_s.sum(1),
        nn(g_t, k32).to(dt),
        tn(g_t, q32),
        tn(a, gt32).to(dt),
        g_t.sum(1),
    )


def _check_bwd(what, q, k_pre, v, bias, tq, tk_pre, tv, tbias, lse, go, gt):
    nq_like = [("tq", tq), ("gt", gt)] + ([("go", go)] if go is not None
                                          else [])
    _check(what, q, k_pre, v, bias, nq_like=nq_like,
           nk_like=(("tk_pre", tk_pre), ("tv", tv)),
           bias_like=(("tbias", tbias),))
    _check_rows(what, "lse", lse, tuple(q.shape[:2]), q.device)


def _bwd_launch(what, source, q, k_pre, v, bias, tq, tk_pre, tv, tbias, lse,
                go, gt):
    """Allocate and call ``gigagan_<what>`` of ``csrc/<source>.cu`` on
    checked operands: both K7b implementations share one C signature."""
    bh, nq, d = q.shape
    nk = k_pre.shape[1]
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    gq, gtq = torch.empty_like(q), torch.empty_like(q)
    gv, gtv = torch.empty_like(v), torch.empty_like(v)
    gk = torch.empty((bh, nk, d), **f32)
    gtk = torch.empty((bh, nk, d), **f32)
    gbias = torch.empty((bh, nk), **f32)
    gtbias = torch.empty((bh, nk), **f32)
    stats = torch.empty((bh, nq, 3), **f32)  # μ, r, rowsum(A⊙ĝA) per row
    lib, fn = _launcher(what, 20, source)
    err = fn(q.data_ptr(), k_pre.data_ptr(), v.data_ptr(), bias.data_ptr(),
             tq.data_ptr(), tk_pre.data_ptr(), tv.data_ptr(),
             tbias.data_ptr(), lse.data_ptr(), _ptr(go), gt.data_ptr(),
             gq.data_ptr(), gk.data_ptr(), gv.data_ptr(), gbias.data_ptr(),
             gtq.data_ptr(), gtk.data_ptr(), gtv.data_ptr(),
             gtbias.data_ptr(), stats.data_ptr(), bh, nq, nk, d,
             _DTYPE_CODES[q.dtype], dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, what)
    return gq, gk, gv, gbias, gtq, gtk, gtv, gtbias


def flash_attention_hv_bwd_simt(q, k_pre, v, bias, tq, tk_pre, tv, tbias,
                                lse, go, gt):
    """K7b on CUDA cores (``csrc/flash_attention_hv_bwd.cu``): float32 or
    bf16 with head dim up to 128 (same returns as the plain version; gk_pre
    and gtk_pre float32)."""
    what = "flash_attention_hv_bwd_simt"
    _check_bwd(what, q, k_pre, v, bias, tq, tk_pre, tv, tbias, lse, go, gt)
    res = _bwd_launch(what, "flash_attention_hv_bwd", q, k_pre, v, bias, tq,
                      tk_pre, tv, tbias, lse, go, gt)
    flash_attention_hv_bwd_simt.launches += 1
    return res


def flash_attention_hv_bwd_tc(q, k_pre, v, bias, tq, tk_pre, tv, tbias, lse,
                              go, gt):
    """K7b on the tensor cores (``csrc/flash_attention_hv_bwd_tc.cu``): bf16
    at head dim 64 (same returns as the plain version; gk_pre and gtk_pre
    float32)."""
    what = "flash_attention_hv_bwd_tc"
    _check_bwd(what, q, k_pre, v, bias, tq, tk_pre, tv, tbias, lse, go, gt)
    _check_tc(what, q, k_pre, v, tq, tk_pre, tv, gt, go)
    res = _bwd_launch(what, what, q, k_pre, v, bias, tq, tk_pre, tv, tbias,
                      lse, go, gt)
    flash_attention_hv_bwd_tc.launches += 1
    return res


flash_attention_hv_bwd_simt.launches = 0
flash_attention_hv_bwd_tc.launches = 0


def flash_attention_hv_bwd(q, k_pre, v, bias, tq, tk_pre, tv, tbias, lse,
                           go, gt):
    """K7b: its plain version on CPU tensors; on CUDA tensors the
    tensor-core or the CUDA-core kernel by ``hv_uses_tensor_cores``, in
    chunks of at most MAX_ROWS b·h rows (same returns as the plain version;
    gk_pre and gtk_pre float32)."""
    if q.device.type == "cpu":
        return flash_attention_hv_bwd_plain(q, k_pre, v, bias, tq, tk_pre,
                                            tv, tbias, lse, go, gt)
    kernel = (flash_attention_hv_bwd_tc
              if hv_uses_tensor_cores(q.dtype, q.shape[-1])
              else flash_attention_hv_bwd_simt)
    return by_rows(kernel, q, k_pre, v, bias, tq, tk_pre, tv, tbias, lse, go,
                   gt)


# -------------------------------------------------------- the Functions

def _zeros_if_none(t, like):
    return torch.zeros_like(like) if t is None else t.contiguous()


class _AttendJvpPair(torch.autograd.Function):
    """(q, k̂, v, bias, tq, t̂k, tv, tbias) → (out, tout): K7a forward, K7b
    backward.  ``setup_context`` form: it is applied inside
    ``_FlashAttendHV.jvp``, under ``torch.func`` transforms."""

    @staticmethod
    def forward(q, k_pre, v, bias, tq, tk_pre, tv, tbias):
        return flash_attention_hv_jvp(q, k_pre, v, bias, tq, tk_pre, tv,
                                      tbias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[2])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs, output[2])

    @staticmethod
    @once_differentiable
    def backward(ctx, go, gt, _glse):
        q, k_pre, v, bias, tq, tk_pre, tv, tbias, lse = ctx.saved_tensors
        if gt is None:
            gt = torch.zeros_like(q)
        if go is not None:
            go = go.to(q.dtype).contiguous()
        grads = flash_attention_hv_bwd(q, k_pre, v, bias, tq, tk_pre, tv,
                                       tbias, lse, go,
                                       gt.to(q.dtype).contiguous())
        return tuple(g_.to(x.dtype) for g_, x in zip(
            grads, (q, k_pre, v, bias, tq, tk_pre, tv, tbias)))


class _FlashAttendHV(torch.autograd.Function):
    """K6a forward and K6b backward on prepared operands, with a ``jvp``
    (K7a, differentiable through K7b): attention that supports
    grad-of-jvp.  Returns (out, lse); lse is not differentiable.  The
    backward is first-order only: a double backward raises."""

    @staticmethod
    def forward(q, k_pre, v, bias):
        return flash_attention_fwd(q, k_pre, v, bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(*inputs, out, lse)
        ctx.save_for_forward(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _glse):
        q, k_pre, v, bias, out, lse = ctx.saved_tensors
        dq, dkp, dv, dbias = flash_attention_bwd(
            q, k_pre, v, bias, g.to(q.dtype).contiguous(), out, lse)
        return dq, dkp, dv, dbias.to(bias.dtype)

    @staticmethod
    def jvp(ctx, tq, tk_pre, tv, tbias):
        q, k_pre, v, bias = ctx.saved_tensors
        _, tout, _ = _AttendJvpPair.apply(
            q, k_pre, v, bias, _zeros_if_none(tq, q),
            _zeros_if_none(tk_pre, k_pre), _zeros_if_none(tv, v),
            _zeros_if_none(tbias, bias))
        return tout, None


def flash_attend_hv(q, k, v, mask=None, l2_dist: bool = False, scale=None):
    """Split-heads attention through K6a/K6b that also supports
    grad-of-jvp (K7a/K7b): q (b, h, nq, d), k/v (b, h, nk, d), mask (b, nk)
    or None → (b, h, nq, d)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, _ = _FlashAttendHV.apply(*prep_split(q, k, v, mask, l2_dist,
                                              scale))
    return out.reshape(q.shape)
