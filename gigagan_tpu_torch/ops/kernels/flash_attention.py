"""Kernels K6a and K6b: split-heads flash attention forward and its
first-order backward, their plain PyTorch versions and the operand prep
(the counterpart of gigagan_tpu/ops/pallas/flash_attention.py).  Each has
two implementations, picked as K3/K4 pick theirs (``uses_tensor_cores``):
for bf16 at d = 64 or 128 the tensor-core kernels of K3 and K4 with one
head and no null token (``csrc/flash_attention_fused_fwd_tc.cu``,
``csrc/flash_attention_fused_bwd_tc.cu``), otherwise the CUDA-core kernels
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``).  The
autograd Function that runs them, with a jvp for the forward-over-reverse
R1 penalty, is ``_FlashAttendHV`` in ``flash_attention_hv.py``: a torch
Function can carry a backward and a jvp at once, so one entry point serves
where the JAX package needs ``flash_attend`` and ``flash_attend_hv``.

``prep_split`` folds heads into batch and prepares the operands as
``_prep`` does (without the TPU's 128-lane padding: the kernels mask any
nk): q (b·h, nq, d), k_pre = coeff·k and v (b·h, nk, d), and ONE fp32 bias
row per (b·h): −scale·|k|² for L2-distance similarity (coeff = 2·scale;
the |q|² term is constant per row and cancels in the softmax), 0 for dot
product (coeff = scale), NEG_INF at masked keys.  Per (b·h):

    S = q·k_preᵀ + bias    A = softmax(S)    out = A·v    lse = logsumexp(S)

A row whose every key is masked keeps NEG_INF finite, as the TPU kernel
does: out is the mean of v over the row's keys and lse = NEG_INF.

K6b (the VJP, from the saved lse) works on the same prepared operands:

    δ = rowsum(g ⊙ out)   dS = A ⊙ (g·vᵀ − δ)
    dq = dS·k_pre   dk_pre = dSᵀ·q   dv = Aᵀ·g   dbias = colsum(dS)

The chain rule from k_pre and the bias back to k (for L2:
dk = coeff·dk_pre − 2·scale·dbias·k = coeff·dSᵀq − colsum(dS)·k_pre, the
TPU kernel's in-kernel form) runs as plain autograd of ``prep_split``, so
the forward-mode derivative of the prep under ``torch.func.jvp`` is plain
autograd too (``flash_attention_hv.py``).

Both kernels put b·h on a grid axis of at most 65535 blocks; the
dispatchers run larger b·h in chunks (``by_rows``), which is exact since
the rows are independent.
"""

from __future__ import annotations

import ctypes

import torch

from gigagan_tpu_torch.ops.kernels import build
from gigagan_tpu_torch.ops.kernels.adaptive_conv import acc_dtype
from gigagan_tpu_torch.ops.kernels.flash_attention_fused import (
    _DTYPE_CODES,
    launch_fwd_tc,
    uses_tensor_cores,
)
from gigagan_tpu_torch.ops.kernels.flash_attention_so import (
    _check_rows,
    launch_bwd_tc,
)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# b·h rows per launch: the kernels' grids put b·h on an axis of at most
# 65535 blocks
MAX_ROWS = 65535


def prep_split(q, k, v, mask, l2_dist: bool, scale: float):
    """q (b, h, nq, d), k/v (b, h, nk, d), mask (b, nk) or None →
    (q (b·h, nq, d), k_pre, v (b·h, nk, d), bias (b·h, nk) fp32)."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    acc = acc_dtype(k)
    coeff = 2.0 * scale if l2_dist else scale
    qf = q.reshape(b * h, nq, d)
    kf = k.reshape(b * h, nk, d)
    vf = v.reshape(b * h, nk, d)
    if l2_dist:
        k32 = kf.to(acc)
        bias = -scale * (k32 * k32).sum(-1)
    else:
        bias = torch.zeros((b * h, nk), dtype=acc, device=k.device)
    if mask is not None:
        keep = mask.to(k.device).repeat_interleave(h, dim=0)
        bias = torch.where(keep, bias, torch.full_like(bias, NEG_INF))
    k_pre = (kf.to(acc) * coeff).to(k.dtype)
    return (qf.contiguous(), k_pre.contiguous(), vf.contiguous(),
            bias.contiguous())


def _logits(q, k_pre, bias):
    acc = acc_dtype(q)
    return (torch.einsum("nid,njd->nij", q.to(acc), k_pre.to(acc))
            + bias.to(acc)[:, None, :])


def by_rows(kernel, *operands, chunk=None):
    """``kernel`` on chunks of at most ``chunk`` (MAX_ROWS by default) b·h
    rows, its outputs concatenated: every operand and output has b·h rows
    first, and an operand that is None (K7b's absent ĝo) passes to every
    chunk as None."""
    chunk = chunk or MAX_ROWS
    bh = operands[0].shape[0]
    if bh <= chunk:
        return kernel(*operands)
    parts = [kernel(*(None if t is None else t[i:i + chunk]
                      for t in operands))
             for i in range(0, bh, chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


# ------------------------------------------------------------------ K6a

def flash_attention_fwd_plain(q, k_pre, v, bias):
    """The kernel's function in plain PyTorch on prepared operands: fp32
    logits, the exp'd map rounded to v's dtype for the A·v product, the
    divide on the output.  Returns (out (b·h, nq, d), lse (b·h, nq))."""
    acc = acc_dtype(q)
    s = _logits(q, k_pre, bias)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    tot = e.sum(-1, keepdim=True)
    av = torch.einsum("nij,njd->nid", e.to(v.dtype).to(acc), v.to(acc))
    return (av / tot).to(q.dtype), (m + torch.log(tot))[..., 0]


def _check(what, q, k_pre, v, bias, *, nq_like=(), nk_like=(),
           bias_like=()):
    """Operands of the split-heads kernels: (bh, nq, d) and (bh, nk, d)
    tensors in q's dtype (float32 or bfloat16), (bh, nk) float32 bias rows,
    all contiguous on one CUDA device, bh ≤ MAX_ROWS.  The ``*_like`` are
    extra (name, tensor) pairs of each kind."""
    bh, nq, d = q.shape
    nk = k_pre.shape[1]
    if d > 128:
        raise ValueError(f"{what}: head dim {d} > 128")
    if bh > MAX_ROWS:
        raise ValueError(f"{what}: {bh} b·h rows > {MAX_ROWS}, the grid "
                         "axis's limit")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    groups = ([(n, t, (bh, nq, d), q.dtype)
               for n, t in (("q", q), *nq_like)]
              + [(n, t, (bh, nk, d), q.dtype)
                 for n, t in (("k_pre", k_pre), ("v", v), *nk_like)]
              + [(n, t, (bh, nk), torch.float32)
                 for n, t in (("bias", bias), *bias_like)])
    for name, t, shape, dtype in groups:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, the kernel "
                             f"needs every operand on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _launcher(name, n_ptrs, source=None):
    """``gigagan_<name>`` of ``csrc/<source or name>.cu``: n_ptrs pointers,
    (bh, nq, nk, d, dtype, device) and the stream."""
    lib = build.load(source or name)
    fn = getattr(lib, f"gigagan_{name}")
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_fwd_simt(q, k_pre, v, bias):
    """K6a on CUDA cores (``csrc/flash_attention_fwd.cu``): float32 or bf16
    with head dim up to 128.  Returns (out, lse)."""
    what = "flash_attention_fwd_simt"
    _check(what, q, k_pre, v, bias)
    bh, nq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, nq), dtype=torch.float32, device=q.device)
    lib, fn = _launcher(what, 6, "flash_attention_fwd")
    err = fn(q.data_ptr(), k_pre.data_ptr(), v.data_ptr(), bias.data_ptr(),
             out.data_ptr(), lse.data_ptr(), bh, nq, k_pre.shape[1], d,
             _DTYPE_CODES[q.dtype], q.device.index,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, what)
    flash_attention_fwd_simt.launches += 1
    return out, lse


def flash_attention_fwd_tc(q, k_pre, v, bias):
    """K6a on the tensor cores: K3's kernel
    (``csrc/flash_attention_fused_fwd_tc.cu``) with one head and no null
    token; bf16 with head dim 64 or 128.  Returns (out, lse)."""
    what = "flash_attention_fwd_tc"
    _check(what, q, k_pre, v, bias)
    bh, nq, _ = q.shape
    out, lse = launch_fwd_tc(what, q, k_pre, v, bias[:, None], None, None,
                             None, 1)
    flash_attention_fwd_tc.launches += 1
    return out, lse.view(bh, nq)


flash_attention_fwd_simt.launches = 0
flash_attention_fwd_tc.launches = 0


def flash_attention_fwd(q, k_pre, v, bias):
    """K6a: its plain version on CPU tensors; on CUDA tensors the
    tensor-core or the CUDA-core kernel by ``uses_tensor_cores``, in chunks
    of at most MAX_ROWS b·h rows.  Returns (out, lse)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k_pre, v, bias)
    kernel = (flash_attention_fwd_tc if uses_tensor_cores(q.dtype, q.shape[-1])
              else flash_attention_fwd_simt)
    return by_rows(kernel, q, k_pre, v, bias)


# ------------------------------------------------------------------ K6b

def flash_attention_bwd_plain(q, k_pre, v, bias, g, out, lse):
    """The kernel's function in plain PyTorch.  Returns (dq, dk_pre, dv)
    in q's dtype and dbias (b·h, nk) in the accumulation dtype."""
    acc = acc_dtype(q)
    a = torch.exp(_logits(q, k_pre, bias) - lse.to(acc)[..., None])
    g32 = g.to(acc)
    da = torch.einsum("nid,njd->nij", g32, v.to(acc))
    delta = (g32 * out.to(acc)).sum(-1, keepdim=True)
    ds = a * (da - delta)
    dq = torch.einsum("nij,njd->nid", ds, k_pre.to(acc))
    dkp = torch.einsum("nij,nid->njd", ds, q.to(acc))
    dv = torch.einsum("nij,nid->njd", a, g32)
    dt = q.dtype
    return dq.to(dt), dkp.to(dt), dv.to(dt), ds.sum(1)


def _check_bwd(what, q, k_pre, v, bias, g, out, lse):
    _check(what, q, k_pre, v, bias, nq_like=(("g", g), ("out", out)))
    _check_rows(what, "lse", lse, tuple(q.shape[:2]), q.device)


def flash_attention_bwd_simt(q, k_pre, v, bias, g, out, lse):
    """K6b on CUDA cores (``csrc/flash_attention_bwd.cu``): float32 or bf16
    with head dim up to 128 (same returns as the plain version)."""
    what = "flash_attention_bwd_simt"
    _check_bwd(what, q, k_pre, v, bias, g, out, lse)
    bh, nq, d = q.shape
    nk = k_pre.shape[1]
    dev = q.device
    dq = torch.empty_like(q)
    dkp = torch.empty_like(k_pre)
    dv = torch.empty_like(v)
    dbias = torch.empty((bh, nk), dtype=torch.float32, device=dev)
    delta = torch.empty((bh, nq), dtype=torch.float32, device=dev)
    lib, fn = _launcher(what, 12, "flash_attention_bwd")
    err = fn(q.data_ptr(), k_pre.data_ptr(), v.data_ptr(), bias.data_ptr(),
             g.data_ptr(), out.data_ptr(), lse.data_ptr(), dq.data_ptr(),
             dkp.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
             delta.data_ptr(), bh, nq, nk, d, _DTYPE_CODES[q.dtype],
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, what)
    flash_attention_bwd_simt.launches += 1
    return dq, dkp, dv, dbias


def flash_attention_bwd_tc(q, k_pre, v, bias, g, out, lse):
    """K6b on the tensor cores: K4's kernels
    (``csrc/flash_attention_fused_bwd_tc.cu``) with one head and no null
    token; bf16 with head dim 64 or 128 (same returns as the plain
    version)."""
    what = "flash_attention_bwd_tc"
    _check_bwd(what, q, k_pre, v, bias, g, out, lse)
    bh, nq, _ = q.shape
    dq, dkp, dv, dbias = launch_bwd_tc(what, q, k_pre, v, bias[:, None],
                                       None, None, None, g, out,
                                       lse.view(bh, 1, nq), 1)[:4]
    flash_attention_bwd_tc.launches += 1
    return dq, dkp, dv, dbias.view(bh, -1)


flash_attention_bwd_simt.launches = 0
flash_attention_bwd_tc.launches = 0


def flash_attention_bwd(q, k_pre, v, bias, g, out, lse):
    """K6b: its plain version on CPU tensors; on CUDA tensors the
    tensor-core or the CUDA-core kernel by ``uses_tensor_cores``, in chunks
    of at most MAX_ROWS b·h rows (same returns as the plain version)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k_pre, v, bias, g, out, lse)
    kernel = (flash_attention_bwd_tc if uses_tensor_cores(q.dtype, q.shape[-1])
              else flash_attention_bwd_simt)
    return by_rows(kernel, q, k_pre, v, bias, g, out, lse)
