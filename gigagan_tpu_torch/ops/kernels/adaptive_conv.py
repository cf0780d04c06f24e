"""Kernel K1: fused sample-adaptive 3x3 conv forward
(``csrc/adaptive_conv_fwd.cu``), its plain PyTorch version, and the wrapper
that picks between them by device.

    out[b] = demod[b] ⊙ conv3x3_SAME(x_mod[b], Σₙ attn[b,n]·Wₙ)

x_mod (b, h, w, ci) float32/bfloat16 with (1+mod) folded in; weights
(n, 3, 3, ci, co) float32 or x_mod's dtype; attn (b, n) float32; demod
(b, co) float32; out (b, h, w, co) in x_mod's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gigagan_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def adaptive_conv_fwd_plain(x_mod, weights, attn, demod):
    """The kernel's function in plain PyTorch: the per-sample mixed kernel
    in fp32, rounded to the operand dtype, one grouped conv with fp32
    accumulation, the demod scale in fp32, then the cast."""
    b, h, w, ci = x_mod.shape
    co = weights.shape[-1]
    w_mix = torch.einsum("bn,nyxio->byxio", attn.float(), weights.float())
    w_mix = w_mix.to(x_mod.dtype).float()
    xg = x_mod.float().permute(0, 3, 1, 2).reshape(1, b * ci, h, w)
    wg = w_mix.permute(0, 4, 3, 1, 2).reshape(b * co, ci, 3, 3)
    out = F.conv2d(xg, wg, padding=1, groups=b)
    out = out.reshape(b, co, h, w).permute(0, 2, 3, 1)
    return (out * demod.float()[:, None, None, :]).to(x_mod.dtype)


def _check(x_mod, weights, attn, demod):
    if x_mod.dim() != 4 or weights.dim() != 5:
        raise ValueError(
            f"adaptive_conv_fwd: x_mod {tuple(x_mod.shape)} must be "
            f"(b,h,w,ci) and weights {tuple(weights.shape)} (n,3,3,ci,co)"
        )
    b, _, _, ci = x_mod.shape
    n, kh, kw, wci, co = weights.shape
    if (kh, kw) != (3, 3) or wci != ci:
        raise ValueError(
            f"adaptive_conv_fwd: weights {tuple(weights.shape)} do not fit "
            f"a 3x3 conv of x_mod {tuple(x_mod.shape)}"
        )
    if tuple(attn.shape) != (b, n) or tuple(demod.shape) != (b, co):
        raise ValueError(
            f"adaptive_conv_fwd: attn {tuple(attn.shape)} / demod "
            f"{tuple(demod.shape)} must be ({b}, {n}) / ({b}, {co})"
        )
    if x_mod.dtype not in _DTYPE_CODES or weights.dtype not in (
        torch.float32, x_mod.dtype
    ):
        raise TypeError(
            f"adaptive_conv_fwd: x_mod {x_mod.dtype} / weights "
            f"{weights.dtype}: the kernel takes float32 or bfloat16 operands "
            "with float32 or operand-dtype weights"
        )
    if attn.dtype != torch.float32 or demod.dtype != torch.float32:
        raise TypeError("adaptive_conv_fwd: attn and demod must be float32")
    for name, t in (("x_mod", x_mod), ("weights", weights), ("attn", attn),
                    ("demod", demod)):
        if not t.is_cuda or t.device != x_mod.device:
            raise ValueError(
                f"adaptive_conv_fwd: {name} is on {t.device}, the kernel "
                f"needs every operand on {x_mod.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"adaptive_conv_fwd: {name} is not contiguous")


def ci_per_split(lib, b, h, w, ci, co, device: int) -> int:
    """Input channels per block: the library's choice (K1 splits ci on
    small, wide maps)."""
    fn = lib.gigagan_adaptive_conv_fwd_ci_per_split
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    cps = fn(b, h, w, ci, co, device)
    if cps <= 0:
        raise RuntimeError("adaptive_conv_fwd: could not query the device")
    return cps


def launch(lib, x_mod, weights, attn, demod, out, partial, cps: int,
           device: int, stream: int):
    """Call the built library on already-checked operands; ``partial`` is
    the fp32 workspace (splits, b, h, w, co), None when cps >= ci."""
    fn = lib.gigagan_adaptive_conv_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    b, h, w, ci = x_mod.shape
    n, co = weights.shape[0], weights.shape[-1]
    err = fn(
        x_mod.data_ptr(), weights.data_ptr(), attn.data_ptr(),
        demod.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), b, h, w, ci, co, n,
        cps, _DTYPE_CODES[x_mod.dtype], _DTYPE_CODES[weights.dtype], device,
        stream,
    )
    build.check(lib, err, "adaptive_conv_fwd")


def adaptive_conv_fwd(x_mod, weights, attn, demod):
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if x_mod.device.type == "cpu":
        return adaptive_conv_fwd_plain(x_mod, weights, attn, demod)
    _check(x_mod, weights, attn, demod)
    b, h, w, ci = x_mod.shape
    co = weights.shape[-1]
    dev = x_mod.device
    lib = build.load("adaptive_conv_fwd")
    cps = ci_per_split(lib, b, h, w, ci, co, dev.index)
    splits = -(-ci // cps)
    partial = (torch.empty((splits, b, h, w, co), dtype=torch.float32,
                           device=dev) if splits > 1 else None)
    out = torch.empty((b, h, w, co), dtype=x_mod.dtype, device=dev)
    launch(lib, x_mod, weights, attn, demod, out, partial, cps, dev.index,
           torch.cuda.current_stream(dev).cuda_stream)
    adaptive_conv_fwd.launches += 1
    return out


adaptive_conv_fwd.launches = 0
