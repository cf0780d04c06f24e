"""The demodulation scale of the sample-adaptive conv: its differentiable
einsum chain, the plain version of its kernel, the kernel's entry and the
wrapper that picks between them by device.

    d[b,o] = rsqrt(max(eps, Σᵢ s[b,i]² · Σ_{n,m} a[b,n]·a[b,m]·G[n,m,i,o]))
    G[n,m,i,o] = Σ_k Wₙ[k,i,o]·Wₘ[k,i,o]

with banks W (n, *k, i, o), s = 1 + the style modulation (b, i) and a the
softmaxed kernel selection (b, n), or 1 for one bank; fp32 throughout.

``demod_chain`` is the op as autograd differentiates it, a chain of
einsums (the JAX package leaves its form to XLA,
gigagan_tpu/ops/adaptive_conv.py:88-102).  A call that needs no gradient
goes to ``demod_scale_fwd`` instead (``ops/adaptive_conv.py``
``demod_route``): on a CUDA tensor the kernel ``csrc/demod_scale.cu``,
which forms the Gram in registers in one pass over the banks and never
writes it to device memory (two launches: the scale over splits of the
input channels, then their sum in a fixed order); on a CPU tensor its plain
version, the same chain under ``no_grad``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gigagan_tpu_torch.ops.kernels import build


def kernel_gram(weights):
    """Gram matrix of the kernel banks over their spatial taps:
    (n, *k_spatial, i, o) → (n, n, i, o)."""
    n = weights.shape[0]
    flat = weights.reshape(n, -1, weights.shape[-2], weights.shape[-1])
    return torch.einsum("nkio,mkio->nmio", flat, flat)


def demod_chain(weights, scale_in, attn=None, eps: float = 1e-8):
    """Per-sample output-channel demodulation scale (b, o) in fp32, as a
    differentiable einsum chain."""
    n = weights.shape[0]
    b = scale_in.shape[0]
    gram = kernel_gram(weights.float())  # (n, n, i, o)
    s2 = scale_in * scale_in  # (b, i)
    if n > 1:
        gram_flat = gram.reshape(n * n, *gram.shape[2:])
        t = torch.einsum("pio,bi->bpo", gram_flat, s2)
        pair = torch.einsum("bn,bm->bnm", attn, attn).reshape(b, n * n)
        d_sq = torch.einsum("bp,bpo->bo", pair, t)
    else:
        d_sq = torch.einsum("io,bi->bo", gram[0, 0], s2)
    return torch.rsqrt(torch.clamp(d_sq, min=eps))


def demod_scale_plain(weights, scale_in, attn=None, eps: float = 1e-8):
    """The kernel's function in plain PyTorch: the chain without a
    gradient."""
    with torch.no_grad():
        return demod_chain(weights, scale_in, attn, eps)


@functools.lru_cache(maxsize=None)
def _entry():
    """(library, split query, launch), the argument types set once."""
    lib = build.load("demod_scale")
    plan = lib.gigagan_demod_scale_ci_per_split
    plan.argtypes = [ctypes.c_int] * 4
    plan.restype = ctypes.c_int
    fn = lib.gigagan_demod_scale
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, plan, fn


@functools.lru_cache(maxsize=None)
def ci_per_split(b: int, ci: int, co: int, device: int) -> int:
    """Input channels per split of the kernel's grid (a multiple of 8):
    the library's choice, about four blocks per SM."""
    _, plan, _ = _entry()
    cps = plan(b, ci, co, device)
    if cps <= 0:
        raise RuntimeError("demod_scale_cuda: could not query the device")
    return cps


def _check(weights, scale_in, attn):
    what = "demod_scale_cuda"
    if weights.dim() != 4 or scale_in.dim() != 2:
        raise ValueError(
            f"{what}: weights {tuple(weights.shape)} must be (n, k, ci, co) "
            f"and scale_in {tuple(scale_in.shape)} (b, ci)")
    n, k, ci, co = weights.shape
    b = scale_in.shape[0]
    if scale_in.shape[1] != ci or min(b, n, k, ci, co) == 0:
        raise ValueError(
            f"{what}: weights {tuple(weights.shape)} and scale_in "
            f"{tuple(scale_in.shape)} disagree or are empty")
    if (attn is None) != (n == 1) or (
            attn is not None and tuple(attn.shape) != (b, n)):
        raise ValueError(
            f"{what}: attn {None if attn is None else tuple(attn.shape)} "
            f"must be ({b}, {n}), or None for one bank")
    operands = [("weights", weights), ("scale_in", scale_in)]
    if attn is not None:
        operands.append(("attn", attn))
    for name, t in operands:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, the kernel takes "
                            "float32")
        if not t.is_cuda or t.device != weights.device:
            raise ValueError(f"{what}: {name} is on {t.device}, the kernel "
                             "takes CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def demod_scale_cuda(weights, scale_in, attn, eps: float):
    """The kernel (``csrc/demod_scale.cu``) on fp32 banks (n, k, ci, co)
    with flattened taps, scale_in (b, ci) and attn (b, n), None for one
    bank: d (b, co).  Two launches on the current stream; the scratch and
    d are allocated here."""
    _check(weights, scale_in, attn)
    _, k, ci, co = weights.shape
    n = weights.shape[0]
    b = scale_in.shape[0]
    dev = weights.device
    lib, _, fn = _entry()
    cps = ci_per_split(b, ci, co, dev.index)
    splits = -(-ci // cps)
    partial = torch.empty((splits, b, co), dtype=torch.float32, device=dev)
    d = torch.empty((b, co), dtype=torch.float32, device=dev)
    err = fn(weights.data_ptr(), scale_in.data_ptr(),
             None if attn is None else attn.data_ptr(), partial.data_ptr(),
             d.data_ptr(), b, n, k, ci, co, cps, eps, dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "demod_scale_cuda")
    demod_scale_cuda.launches += 1
    return d


demod_scale_cuda.launches = 0


def demod_scale_fwd(weights, scale_in, attn=None, eps: float = 1e-8):
    """The demodulation scale of a call that needs no gradient: its plain
    version on a CPU tensor; on a CUDA tensor the kernel (banks as fp32
    (n, k, ci, co), taps flattened)."""
    if weights.device.type == "cpu":
        return demod_scale_plain(weights, scale_in, attn, eps)
    n = weights.shape[0]
    w = weights.float().reshape(n, -1, *weights.shape[-2:]).contiguous()
    a = attn.contiguous() if n > 1 else None
    return demod_scale_cuda(w, scale_in.contiguous(), a, eps)
