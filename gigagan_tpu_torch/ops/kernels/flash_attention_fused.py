"""Kernel K3: fused-heads flash attention forward with an analytic null
key/value (``csrc/flash_attention_fused_fwd.cu``), its plain PyTorch
version, the operand prep, and the wrapper that picks between kernel and
plain version by device.  Its backward (K4, K5) and the autograd chain are
in ``flash_attention_so.py``.

Operands stay in the network's ``(b, n, H·d)`` layout.  The prep is
``_prep_fused`` of the JAX package without the TPU's lane padding and
head grouping: k_pre = coeff·k (coeff = 2·scale for L2-distance
similarity, scale for dot product), a ``(b, H, nk)`` fp32 bias row
−scale·|k|² for L2 (None for dot product: the |q|² term is constant per
row and cancels in the softmax), and the null token as per-head
k_pre / v / bias rows.
"""

from __future__ import annotations

import ctypes

import torch

from gigagan_tpu_torch.ops.kernels import build
from gigagan_tpu_torch.ops.kernels.adaptive_conv import acc_dtype

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def prep_fused(k, v, null_kv, heads: int, l2_dist: bool, scale: float):
    """→ (k_pre, bias, nullk_pre, nullv, null_bias); the null entries are
    None without a null_kv."""
    b, nk, hd = k.shape
    d = hd // heads
    acc = acc_dtype(k)
    coeff = 2.0 * scale if l2_dist else scale
    k_pre = (k.to(acc) * coeff).to(k.dtype)
    bias = None
    if l2_dist:
        kh = k.reshape(b, nk, heads, d).to(acc)
        bias = (-scale * torch.einsum("bkhd,bkhd->bhk", kh, kh)).contiguous()
    if null_kv is None:
        return k_pre, bias, None, None, None
    nullk_raw = null_kv[0].to(acc)  # (H, d)
    nullk_pre = (nullk_raw * coeff).to(k.dtype)
    nullv = null_kv[1].to(v.dtype)
    if l2_dist:
        null_bias = -scale * (nullk_raw * nullk_raw).sum(-1)
    else:
        null_bias = torch.zeros(heads, dtype=acc, device=k.device)
    return k_pre, bias, nullk_pre.contiguous(), nullv.contiguous(), null_bias


def flash_attention_fused_fwd_plain(q, k_pre, v, bias, nullk_pre, nullv,
                                    null_bias, heads: int):
    """The kernel's function in plain PyTorch on prepared operands:
    fp32 logits, the null token as one extra logit column, the exp'd map
    rounded to v's dtype for the P·V product, the divide on the output.
    Returns (out (b, nq, H·d), lse (b, H, nq) fp32)."""
    b, nq, hd = q.shape
    nk = k_pre.shape[1]
    d = hd // heads
    acc = acc_dtype(q)
    qh = q.reshape(b, nq, heads, d).to(acc)
    kh = k_pre.reshape(b, nk, heads, d).to(acc)
    vh = v.reshape(b, nk, heads, d)
    sim = torch.einsum("bihd,bjhd->bhij", qh, kh)
    if bias is not None:
        sim = sim + bias.to(acc)[:, :, None, :]
    m = sim.amax(dim=-1, keepdim=True)
    if nullk_pre is not None:
        sim_n = torch.einsum("bihd,hd->bhi", qh, nullk_pre.to(acc))
        sim_n = sim_n[..., None] + null_bias.to(acc)[None, :, None, None]
        m = torch.maximum(m, sim_n)
    e = torch.exp(sim - m)
    s = e.sum(dim=-1, keepdim=True)
    av = torch.einsum("bhij,bjhd->bhid", e.to(v.dtype).to(acc), vh.to(acc))
    if nullk_pre is not None:
        en = torch.exp(sim_n - m)
        s = s + en
        av = av + en * nullv.to(acc)[None, :, None, :]
    out = (av / s).to(q.dtype).permute(0, 2, 1, 3).reshape(b, nq, hd)
    lse = (m + torch.log(s))[..., 0]
    return out, lse


def _check(q, k_pre, v, bias, nullk_pre, nullv, null_bias, heads):
    b, nq, hd = q.shape
    nk = k_pre.shape[1]
    if hd % heads != 0:
        raise ValueError(f"flash_attention_fused_fwd: {hd} % {heads} != 0")
    d = hd // heads
    if d > 128:
        raise ValueError(f"flash_attention_fused_fwd: head dim {d} > 128")
    if tuple(k_pre.shape) != (b, nk, hd) or tuple(v.shape) != (b, nk, hd):
        raise ValueError(
            f"flash_attention_fused_fwd: q {tuple(q.shape)}, k "
            f"{tuple(k_pre.shape)}, v {tuple(v.shape)} do not agree"
        )
    if q.dtype not in _DTYPE_CODES or k_pre.dtype != q.dtype or (
        v.dtype != q.dtype
    ):
        raise TypeError(
            "flash_attention_fused_fwd: q/k/v must share a float32 or "
            f"bfloat16 dtype, got {q.dtype}/{k_pre.dtype}/{v.dtype}"
        )
    tensors = [("q", q), ("k_pre", k_pre), ("v", v)]
    if bias is not None:
        if tuple(bias.shape) != (b, heads, nk) or bias.dtype != torch.float32:
            raise ValueError("flash_attention_fused_fwd: bias must be "
                             f"float32 ({b}, {heads}, {nk})")
        tensors.append(("bias", bias))
    if nullk_pre is not None:
        if (tuple(nullk_pre.shape) != (heads, d)
                or tuple(nullv.shape) != (heads, d)
                or nullk_pre.dtype != q.dtype or nullv.dtype != q.dtype
                or tuple(null_bias.shape) != (heads,)
                or null_bias.dtype != torch.float32):
            raise ValueError("flash_attention_fused_fwd: null rows must be "
                             f"({heads}, {d}) in {q.dtype} and a float32 "
                             f"({heads},) bias")
        tensors += [("nullk_pre", nullk_pre), ("nullv", nullv),
                    ("null_bias", null_bias)]
    for name, t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(
                f"flash_attention_fused_fwd: {name} is on {t.device}, the "
                f"kernel needs every operand on {q.device}"
            )
        if not t.is_contiguous():
            raise ValueError(
                f"flash_attention_fused_fwd: {name} is not contiguous"
            )


def launch(lib, q, k_pre, v, bias, nullk_pre, nullv, null_bias, out, lse,
           heads: int, device: int, stream: int):
    """Call the built library on already-checked operands."""
    fn = lib.gigagan_flash_attention_fused_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    b, nq, hd = q.shape
    have_null = nullk_pre is not None

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(
        q.data_ptr(), k_pre.data_ptr(), v.data_ptr(), ptr(bias),
        ptr(nullk_pre), ptr(nullv), ptr(null_bias), out.data_ptr(),
        lse.data_ptr(), b, nq, k_pre.shape[1], heads, hd // heads,
        int(have_null), _DTYPE_CODES[q.dtype], device, stream,
    )
    build.check(lib, err, "flash_attention_fused_fwd")


def flash_attention_fused_fwd(q, k_pre, v, bias, nullk_pre, nullv,
                              null_bias, heads: int):
    """K3 on CUDA tensors, its plain version on CPU tensors.
    Returns (out, lse)."""
    if q.device.type == "cpu":
        return flash_attention_fused_fwd_plain(
            q, k_pre, v, bias, nullk_pre, nullv, null_bias, heads
        )
    _check(q, k_pre, v, bias, nullk_pre, nullv, null_bias, heads)
    b, nq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, heads, nq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launch(build.load("flash_attention_fused_fwd"), q, k_pre, v, bias,
           nullk_pre, nullv, null_bias, out, lse, heads, q.device.index,
           stream)
    flash_attention_fused_fwd.launches += 1
    return out, lse


flash_attention_fused_fwd.launches = 0

