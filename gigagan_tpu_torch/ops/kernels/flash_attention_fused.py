"""Kernel K3: fused-heads flash attention forward with an analytic null
key/value, in two implementations (``uses_tensor_cores`` picks one by dtype
and head dim): the tensor-core kernel for bf16 at d = 64 or 128
(``csrc/flash_attention_fused_fwd_tc.cu``) and the CUDA-core kernel for the
rest (``csrc/flash_attention_fused_fwd.cu``); its plain PyTorch version,
the operand prep, and the wrapper that takes the plain version on CPU
tensors.  Its backward (K4, K5) and the autograd chain are in
``flash_attention_so.py``.

Operands stay in the network's ``(b, n, H·d)`` layout.  The prep is
``_prep_fused`` of the JAX package without the TPU's lane padding and
head grouping: k_pre = coeff·k (coeff = 2·scale for L2-distance
similarity, scale for dot product), a ``(b, H, nk)`` fp32 bias row
−scale·|k|² for L2 (None for dot product: the |q|² term is constant per
row and cancels in the softmax), and the null token as per-head
k_pre / v / bias rows.

The kernels of K3, K4 and K5 put the batch on a grid axis of at most 65535
blocks, so the dispatchers run a larger batch in chunks (``by_batch``):
each sample's rows are independent, and the null token's gradients, which
sum over the batch, are summed over the chunks in order.
"""

from __future__ import annotations

import ctypes

import torch

from gigagan_tpu_torch.ops.kernels import build
from gigagan_tpu_torch.ops.kernels.adaptive_conv import acc_dtype

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# samples per launch: the kernels' grids put the batch on an axis of at
# most 65535 blocks
MAX_BATCH = 65535


def by_batch(kernel, args, batched, summed=(), chunk=None):
    """``kernel(*args)`` on chunks of at most ``chunk`` (MAX_BATCH by
    default) samples: the operands at the indices ``batched`` are sliced
    along the batch (None passes as None), the others pass whole; the
    outputs at the indices ``summed`` (the null token's gradients, or None)
    are added over the chunks in order, the others concatenated."""
    chunk = chunk or MAX_BATCH
    b = args[0].shape[0]
    if b <= chunk:
        return kernel(*args)
    parts = [kernel(*(t[i:i + chunk] if j in batched and t is not None
                      else t for j, t in enumerate(args)))
             for i in range(0, b, chunk)]
    outs = []
    for j, got in enumerate(zip(*parts)):
        if got[0] is None:
            outs.append(None)
        elif j in summed:
            total = got[0]
            for t in got[1:]:
                total = total + t
            outs.append(total)
        else:
            outs.append(torch.cat(got))
    return tuple(outs)


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


def _head_dim(what, q, heads):
    hd = q.shape[-1]
    if hd % heads != 0:
        raise ValueError(f"{what}: {hd} % {heads} != 0")
    d = hd // heads
    if d > 128:
        raise ValueError(f"{what}: head dim {d} > 128")
    return d


def _check(q, k_pre, v, bias, nullk_pre, nullv, null_bias, heads):
    b, nq, hd = q.shape
    nk = k_pre.shape[1]
    d = _head_dim("flash_attention_fused_fwd", q, heads)
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


def uses_tensor_cores(dtype, d: int) -> bool:
    """The one dispatch rule of K3 and K4: bf16 operands with head dim 64 or
    128 go to the tensor-core kernels (``*_tc.cu``, one or two 64-column
    atoms); every other case (fp32, or another head dim up to 128) to the
    CUDA-core kernels (``*_simt``).  K6a and K6b dispatch by it too, since
    their tensor-core route is these same kernels with one head."""
    return dtype == torch.bfloat16 and d in (64, 128)


def check_tc(what, tensors):
    """The tensor-core route reads its operands through TMA maps, which
    need 16-byte aligned base addresses."""
    for name, t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned (the "
                             "tensor-core kernel reads it by TMA)")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _outputs(q, heads):
    b, nq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, heads, nq), dtype=torch.float32, device=q.device)
    return out, lse


def flash_attention_fused_fwd_simt(q, k_pre, v, bias, nullk_pre, nullv,
                                   null_bias, heads: int):
    """K3 on CUDA cores (``csrc/flash_attention_fused_fwd.cu``), any float32
    or bf16 operands with head dim up to 128.  Returns (out, lse)."""
    _check(q, k_pre, v, bias, nullk_pre, nullv, null_bias, heads)
    out, lse = _outputs(q, heads)
    b, nq, hd = q.shape
    lib = build.load("flash_attention_fused_fwd")
    fn = lib.gigagan_flash_attention_fused_fwd_simt
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k_pre.data_ptr(), v.data_ptr(), _ptr(bias),
        _ptr(nullk_pre), _ptr(nullv), _ptr(null_bias), out.data_ptr(),
        lse.data_ptr(), b, nq, k_pre.shape[1], heads, hd // heads,
        int(nullk_pre is not None), _DTYPE_CODES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "flash_attention_fused_fwd_simt")
    flash_attention_fused_fwd_simt.launches += 1
    return out, lse


def launch_fwd_tc(what, q, k_pre, v, bias, nullk_pre, nullv, null_bias,
                  heads: int):
    """Check the operands and launch ``csrc/flash_attention_fused_fwd_tc.cu``
    (K3's tensor-core kernel, also K6a's with heads = 1); the caller counts
    the launch.  Returns (out, lse (b, H, nq))."""
    _check(q, k_pre, v, bias, nullk_pre, nullv, null_bias, heads)
    b, nq, hd = q.shape
    if not uses_tensor_cores(q.dtype, hd // heads):
        raise ValueError(f"{what}: takes bf16 with head dim 64 or 128, got "
                         f"{q.dtype} with {hd // heads}")
    check_tc(what, (("q", q), ("k_pre", k_pre), ("v", v),
                    ("nullk_pre", nullk_pre), ("nullv", nullv)))
    out, lse = _outputs(q, heads)
    lib = build.load("flash_attention_fused_fwd_tc")
    fn = lib.gigagan_flash_attention_fused_fwd_tc
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k_pre.data_ptr(), v.data_ptr(), _ptr(bias),
        _ptr(nullk_pre), _ptr(nullv), _ptr(null_bias), out.data_ptr(),
        lse.data_ptr(), b, nq, k_pre.shape[1], heads, hd // heads,
        int(nullk_pre is not None), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, what)
    return out, lse


def flash_attention_fused_fwd_tc(q, k_pre, v, bias, nullk_pre, nullv,
                                 null_bias, heads: int):
    """K3 on the tensor cores (``csrc/flash_attention_fused_fwd_tc.cu``):
    bf16 operands with head dim 64 or 128.  Returns (out, lse)."""
    res = launch_fwd_tc("flash_attention_fused_fwd_tc", q, k_pre, v, bias,
                        nullk_pre, nullv, null_bias, heads)
    flash_attention_fused_fwd_tc.launches += 1
    return res


flash_attention_fused_fwd_simt.launches = 0
flash_attention_fused_fwd_tc.launches = 0


def flash_attention_fused_fwd(q, k_pre, v, bias, nullk_pre, nullv,
                              null_bias, heads: int):
    """K3: its plain version on CPU tensors; on CUDA tensors the
    tensor-core or the CUDA-core kernel by ``uses_tensor_cores``, in chunks
    of at most MAX_BATCH samples.  Returns (out, lse)."""
    if q.device.type == "cpu":
        return flash_attention_fused_fwd_plain(
            q, k_pre, v, bias, nullk_pre, nullv, null_bias, heads
        )
    d = _head_dim("flash_attention_fused_fwd", q, heads)
    kernel = (flash_attention_fused_fwd_tc if uses_tensor_cores(q.dtype, d)
              else flash_attention_fused_fwd_simt)
    return by_batch(kernel, (q, k_pre, v, bias, nullk_pre, nullv, null_bias,
                             heads), batched=(0, 1, 2, 3))
