"""The upsampler's linear attention in the fused-heads layout: its plain
PyTorch form, the kernel's entry and the wrapper that picks between them
by device.

    context = softmax_n(k)ᵀ·v,  out = (softmax_d(q)·scale)·context

per sample and head, with q, k, v (b, n, H·d) and each head a slice of the
last dimension.  ``linear_attend_plain`` is the form autograd
differentiates (the JAX package leaves it to XLA,
gigagan_tpu/ops/attention.py:211).  A call that needs no gradient goes to
``linear_attend_fwd`` instead (``ops/attention.py``
``linear_attend_route``): on a CUDA tensor the kernel
``csrc/linear_attention.cu``, which reads q, k and v once from their
strided views and writes out once (three launches: the context per split
of n, the splits' sum in a fixed order, the output); on a CPU tensor the
plain form.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gigagan_tpu_torch.ops.kernels import build

HEAD_DIM = 64


def softmax_over(x, dim: int):
    """fp32 softmax of x along ``dim``, from plain reductions: torch's
    softmax along an axis that is not the last runs a kernel that takes
    seconds at a million tokens.  The row max is a constant (it cancels)."""
    x = x.float()
    e = torch.exp(x - x.amax(dim=dim, keepdim=True).detach())
    return e / e.sum(dim=dim, keepdim=True)


def linear_attend_plain(q, k, v, *, heads: int, scale=None):
    """``linear_attend`` in the network's fused-heads layout: q, k, v (b, n,
    H·d) → (b, n, H·d), each head a slice of the last dimension (a (b, n,
    H, d) view), with no (b, H, n, d) copy."""
    b, n, hd = q.shape
    assert hd % heads == 0, (hd, heads)
    d = hd // heads
    if scale is None:
        scale = d ** -0.5
    qf = torch.softmax(q.float().reshape(b, n, heads, d), dim=-1) * scale
    kf = softmax_over(k.reshape(b, n, heads, d), 1)
    vh = v.reshape(b, n, heads, d)
    # (b, n, H, d)ᵀ(b, n, H, e) → (b, H, d, e): contraction over n
    context = torch.einsum("bnhd,bnhe->bhde", kf.to(v.dtype), vh)
    # (b, n, H, d)·(b, H, d, e) → (b, n, H, e)
    out = torch.einsum("bnhd,bhde->bnhe", qf.to(q.dtype),
                       context.to(q.dtype))
    return out.reshape(b, n, hd).to(q.dtype)


def kernel_takes(dtype, head_dim: int) -> bool:
    """Whether the kernel computes a call of this dtype and head dim."""
    return dtype == torch.bfloat16 and head_dim == HEAD_DIM


@functools.lru_cache(maxsize=None)
def _entry():
    """(library, split query, launch), the argument types set once."""
    lib = build.load("linear_attention")
    plan = lib.gigagan_linattn_rows_per_split
    plan.argtypes = [ctypes.c_int] * 3
    plan.restype = ctypes.c_int
    fn = lib.gigagan_linear_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, plan, fn


@functools.lru_cache(maxsize=None)
def rows_per_split(bh: int, n: int, device: int) -> int:
    """Rows of n per split of the kernels' grids (a multiple of 64): the
    library's choice, about four blocks per SM over the b·H heads."""
    _, plan, _ = _entry()
    rows = plan(bh, n, device)
    if rows <= 0:
        raise RuntimeError("linear_attend_cuda: could not query the device")
    return rows


def _check(q, k, v, heads: int):
    what = "linear_attend_cuda"
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
            f"{tuple(v.shape)} must be one (b, n, H·d) shape")
    b, n, hd = q.shape
    if min(b, n, hd, heads) <= 0 or hd % heads:
        raise ValueError(f"{what}: (b, n, H·d) {tuple(q.shape)} with "
                         f"{heads} heads is empty or does not divide")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: {name} is {t.dtype}, the kernel takes "
                            "bfloat16")
    if hd // heads != HEAD_DIM:
        raise ValueError(f"{what}: head dim {hd // heads}, the kernel takes "
                         f"{HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1:
            raise ValueError(f"{what}: {name}'s last dimension is not "
                             "contiguous")
        if t.stride(0) % 8 or t.stride(1) % 8:
            raise ValueError(f"{what}: {name}'s strides {t.stride()} are "
                             "not multiples of 8 elements")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, the kernel "
                             "takes CUDA tensors on one device")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def linear_attend_cuda(q, k, v, heads: int, scale: float):
    """The kernel (``csrc/linear_attention.cu``) on bf16 q, k, v (b, n, H·d)
    views with head dim 64 and the last dimension contiguous: out (b, n,
    H·d) bf16, contiguous.  Three launches on the current stream; out, the
    context and the splits' partials are allocated here."""
    _check(q, k, v, heads)
    b, n, hd = q.shape
    bh = b * heads
    dev = q.device
    lib, _, fn = _entry()
    rows = rows_per_split(bh, n, dev.index)
    splits = -(-n // rows)
    partials = torch.empty(bh * splits * (2 + HEAD_DIM) * HEAD_DIM,
                           dtype=torch.float32, device=dev)
    context = torch.empty((bh, HEAD_DIM, HEAD_DIM), dtype=torch.bfloat16,
                          device=dev)
    out = torch.empty((b, n, hd), dtype=torch.bfloat16, device=dev)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             partials.data_ptr(), context.data_ptr(), b, n, heads,
             *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], rows,
             scale, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "linear_attend_cuda")
    linear_attend_cuda.launches += 1
    return out


linear_attend_cuda.launches = 0


def linear_attend_fwd(q, k, v, *, heads: int, scale: float):
    """The linear attention of a call that needs no gradient: its plain
    form on a CPU tensor; on a CUDA tensor the kernel."""
    if q.device.type == "cpu":
        return linear_attend_plain(q, k, v, heads=heads, scale=scale)
    return linear_attend_cuda(q, k, v, heads, scale)
