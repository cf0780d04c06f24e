"""Kernels K1 and K2 of the sample-adaptive 3x3 conv, their plain PyTorch
versions, the wrappers that pick between them by device, and the
autograd pair ``pconv2d``/``pcorr2d`` built on them.

K1, the forward with a fused demod scale, in two implementations
(``conv_uses_tensor_cores`` picks one by dtype and channel counts): on the
tensor cores (``csrc/adaptive_conv_fwd_tc.cu``) for bf16 with ci and co
multiples of 16, on CUDA cores (``csrc/adaptive_conv_fwd.cu``) otherwise:

    out[b] = demod[b] ⊙ conv3x3_SAME(x_mod[b], Σₙ attn[b,n]·Wₙ)

x_mod (b, h, w, ci) float32/bfloat16 with (1+mod) folded in; weights
(n, 3, 3, ci, co) float32 or x_mod's dtype; attn (b, n) float32; demod
(b, co) float32; out (b, h, w, co) in x_mod's dtype.

K2, the weight-gradient correlation contracted against the selection
weights and the banks, in two implementations as well
(``bwd_w_uses_tensor_cores`` picks one by the same rule as K1's): on the
tensor cores (``csrc/adaptive_conv_bwd_w_tc.cu``) for bf16 with ci and co
multiples of 16, on CUDA cores (``csrc/adaptive_conv_bwd_w.cu``)
otherwise.  With ``C[b] = Σ_{r,c} x_pad[b, r+ky, c+kx, i]·g[b, r, c, o]``

    dW[n] = Σ_b attn[b,n]·C[b]   (n, 3, 3, ci, co) float32
    da[b,n] = ⟨Wₙ, C[b]⟩          (b, n) float32

x and g share a dtype (float32 or bfloat16).  C never reaches device
memory in the TPU kernel nor in the tensor-core one, which contracts each
sample's C on chip; the CUDA-core kernel writes it as fp32 partial sums.

``pconv2d``/``pcorr2d`` mirror the JAX closure of the same names
(gigagan_tpu/ops/pallas/adaptive_conv.py): each op's backward is made of
the two ops, so the pair is differentiable to any order.  The structure is
the same on every device; only the innermost call changes (the kernel on a
CUDA tensor, the plain version on a CPU tensor).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from gigagan_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def acc_dtype(t):
    """The accumulation dtype of the plain versions: float64 operands (the
    gradchecks) stay float64, everything else accumulates in float32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


# ------------------------------------------------------------------ K1

def adaptive_conv_fwd_plain(x_mod, weights, attn, demod):
    """The kernel's function in plain PyTorch: the per-sample mixed kernel
    in fp32, rounded to the operand dtype, one grouped conv with fp32
    accumulation, the demod scale in fp32, then the cast."""
    acc = acc_dtype(x_mod)
    b, h, w, ci = x_mod.shape
    co = weights.shape[-1]
    w_mix = torch.einsum("bn,nyxio->byxio", attn.to(acc), weights.to(acc))
    w_mix = w_mix.to(x_mod.dtype).to(acc)
    xg = x_mod.to(acc).permute(0, 3, 1, 2).reshape(1, b * ci, h, w)
    wg = w_mix.permute(0, 4, 3, 1, 2).reshape(b * co, ci, 3, 3)
    out = F.conv2d(xg, wg, padding=1, groups=b)
    out = out.reshape(b, co, h, w).permute(0, 2, 3, 1)
    return (out * demod.to(acc)[:, None, None, :]).to(x_mod.dtype)


def _check_on_device(what, device, tensors):
    for name, t in tensors:
        if not t.is_cuda or t.device != device:
            raise ValueError(
                f"{what}: {name} is on {t.device}, the kernel needs every "
                f"operand on {device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


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
    _check_on_device("adaptive_conv_fwd", x_mod.device,
                     (("x_mod", x_mod), ("weights", weights), ("attn", attn),
                      ("demod", demod)))


def ci_per_split(lib, b, h, w, ci, co, device: int) -> int:
    """Input channels per block of the CUDA-core kernel: the library's
    choice (it splits ci on small, wide maps)."""
    fn = lib.gigagan_adaptive_conv_fwd_ci_per_split
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    cps = fn(b, h, w, ci, co, device)
    if cps <= 0:
        raise RuntimeError("adaptive_conv_fwd: could not query the device")
    return cps


def launch(lib, x_mod, weights, attn, demod, out, partial, cps: int,
           device: int, stream: int):
    """Call the built CUDA-core library on already-checked operands;
    ``partial`` is the fp32 workspace (splits, b, h, w, co), None when
    cps >= ci."""
    fn = lib.gigagan_adaptive_conv_fwd_simt
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
    build.check(lib, err, "adaptive_conv_fwd_simt")


def conv_uses_tensor_cores(dtype, ci: int, co: int) -> bool:
    """K1's dispatch rule: bf16 operands with ci and co multiples of 16 go
    to the tensor-core kernel (``csrc/adaptive_conv_fwd_tc.cu``: 16-, 32-
    or 64-channel chunks, 16-, 32- or 64-wide co tiles); fp32 and other
    channel counts to the CUDA-core kernel (``*_simt``)."""
    return dtype == torch.bfloat16 and ci % 16 == 0 and co % 16 == 0


def adaptive_conv_fwd_simt(x_mod, weights, attn, demod):
    """K1 on CUDA cores (``csrc/adaptive_conv_fwd.cu``): float32 or bf16
    operands with any channel counts."""
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
    adaptive_conv_fwd_simt.launches += 1
    return out


def adaptive_conv_fwd_tc(x_mod, weights, attn, demod):
    """K1 on the tensor cores (``csrc/adaptive_conv_fwd_tc.cu``): bf16
    x_mod with ci and co multiples of 16, float32 or bf16 weights."""
    what = "adaptive_conv_fwd_tc"
    ci, co = x_mod.shape[-1], weights.shape[-1]
    if not conv_uses_tensor_cores(x_mod.dtype, ci, co):
        raise ValueError(f"{what}: takes bf16 with ci and co multiples of "
                         f"16, got {x_mod.dtype} with {ci} -> {co}")
    _check(x_mod, weights, attn, demod)
    b, h, w, _ = x_mod.shape
    n = weights.shape[0]
    if x_mod.data_ptr() % 16:
        raise ValueError(f"{what}: x_mod is not 16-byte aligned (the "
                         "tensor-core kernel reads it by TMA)")
    dev = x_mod.device
    lib = build.load("adaptive_conv_fwd_tc")
    plan = lib.gigagan_adaptive_conv_fwd_tc_splits
    plan.argtypes = [ctypes.c_int] * 6
    plan.restype = ctypes.c_int
    splits = plan(b, h, w, ci, co, dev.index)
    if splits <= 0:
        raise RuntimeError(f"{what}: could not query the device")
    partial = (torch.empty((splits, b, h, w, co), dtype=torch.float32,
                           device=dev) if splits > 1 else None)
    out = torch.empty((b, h, w, co), dtype=x_mod.dtype, device=dev)
    fn = lib.gigagan_adaptive_conv_fwd_tc
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    err = fn(
        x_mod.data_ptr(), weights.data_ptr(), attn.data_ptr(),
        demod.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), b, h, w, ci, co, n,
        _DTYPE_CODES[weights.dtype], dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, what)
    adaptive_conv_fwd_tc.launches += 1
    return out


adaptive_conv_fwd_simt.launches = 0
adaptive_conv_fwd_tc.launches = 0


def adaptive_conv_fwd(x_mod, weights, attn, demod):
    """K1: its plain version on CPU tensors; on CUDA tensors the
    tensor-core or the CUDA-core kernel by ``conv_uses_tensor_cores``."""
    if x_mod.device.type == "cpu":
        return adaptive_conv_fwd_plain(x_mod, weights, attn, demod)
    kernel = (adaptive_conv_fwd_tc
              if conv_uses_tensor_cores(x_mod.dtype, x_mod.shape[-1],
                                        weights.shape[-1])
              else adaptive_conv_fwd_simt)
    return kernel(x_mod, weights, attn, demod)


# ------------------------------------------------------------------ K2

# banks per K2 launch: kMaxBanks of csrc/adaptive_conv_bwd_w.cu and kBanks
# of csrc/adaptive_conv_bwd_w_tc.cu, whose fp32 dW accumulators (one
# (64, N) tile per bank) live in a warpgroup's registers
MAX_BANKS = 4
MAX_BANKS_TC = 2


def adaptive_conv_bwd_w_plain(x, g, weights, attn):
    """The kernel's function in plain PyTorch: the per-sample correlation
    C, one tap at a time, contracted in fp32 against attn and the banks.
    Returns (dW (n, 3, 3, ci, co), da (b, n)) in the accumulation dtype."""
    acc = acc_dtype(x)
    b, h, w, ci = x.shape
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1))
    gf = g.to(acc)
    taps = [
        torch.einsum("bhwi,bhwo->bio", xp[:, ky:ky + h, kx:kx + w], gf)
        for ky in range(3) for kx in range(3)
    ]
    corr = torch.stack(taps, 1).reshape(b, 3, 3, ci, g.shape[-1])
    dw = torch.einsum("bn,byxio->nyxio", attn.to(acc), corr)
    da = torch.einsum("nyxio,byxio->bn", weights.to(acc), corr)
    return dw, da


def _check_bwd_w(what, x, g, weights, attn, max_banks):
    if x.dim() != 4 or g.dim() != 4 or weights.dim() != 5:
        raise ValueError(
            f"{what}: x {tuple(x.shape)}, g {tuple(g.shape)}, "
            f"weights {tuple(weights.shape)} must be (b,h,w,ci), (b,h,w,co), "
            "(n,3,3,ci,co)"
        )
    b, h, w, ci = x.shape
    n, kh, kw, wci, co = weights.shape
    if (kh, kw) != (3, 3) or wci != ci or tuple(g.shape) != (b, h, w, co):
        raise ValueError(
            f"{what}: x {tuple(x.shape)}, g {tuple(g.shape)} "
            f"and weights {tuple(weights.shape)} do not agree"
        )
    if tuple(attn.shape) != (b, n) or attn.dtype != torch.float32:
        raise ValueError(f"{what}: attn must be float32 ({b}, {n})")
    if n > max_banks:
        raise ValueError(f"{what}: {n} banks, one launch takes at most "
                         f"{max_banks}")
    if x.dtype not in _DTYPE_CODES or g.dtype != x.dtype or (
        weights.dtype not in (torch.float32, x.dtype)
    ):
        raise TypeError(
            f"{what}: x {x.dtype} / g {g.dtype} / weights "
            f"{weights.dtype}: x and g share a float32 or bfloat16 dtype, "
            "weights are float32 or that dtype"
        )
    _check_on_device(what, x.device,
                     (("x", x), ("g", g), ("weights", weights),
                      ("attn", attn)))


def bwd_w_uses_tensor_cores(dtype, ci: int, co: int) -> bool:
    """K2's dispatch rule: bf16 operands with ci and co multiples of 16 go
    to the tensor-core kernel (``csrc/adaptive_conv_bwd_w_tc.cu``); fp32
    and other channel counts to the CUDA-core kernel (``*_simt``)."""
    return dtype == torch.bfloat16 and ci % 16 == 0 and co % 16 == 0


def by_banks(kernel, x, g, weights, attn, max_banks=MAX_BANKS):
    """``kernel`` on groups of at most ``max_banks`` banks, its outputs
    concatenated: dW[n] and da[:, n] depend on bank n alone, so this is
    exact."""
    n = weights.shape[0]
    if n <= max_banks:
        return kernel(x, g, weights, attn)
    parts = [kernel(x, g, weights[i:i + max_banks],
                    attn[:, i:i + max_banks].contiguous())
             for i in range(0, n, max_banks)]
    return (torch.cat([dw for dw, _ in parts]),
            torch.cat([da for _, da in parts], 1))


def adaptive_conv_bwd_w(x, g, weights, attn):
    """K2: its plain version on a CPU tensor; on a CUDA tensor the
    tensor-core or the CUDA-core kernel by ``bwd_w_uses_tensor_cores``, one
    launch per group of at most that route's banks.  Returns (dW, da) in
    float32 (float64 for float64 CPU operands)."""
    if x.device.type == "cpu":
        return adaptive_conv_bwd_w_plain(x, g, weights, attn)
    if bwd_w_uses_tensor_cores(x.dtype, x.shape[-1], weights.shape[-1]):
        return by_banks(adaptive_conv_bwd_w_tc, x, g, weights, attn,
                        MAX_BANKS_TC)
    return by_banks(adaptive_conv_bwd_w_simt, x, g, weights, attn)


# K2's two routes: the library of each and the number of dtype arguments
# its C entry, gigagan_adaptive_conv_bwd_w_<route>, takes
BWD_W_ROUTES = {"simt": ("adaptive_conv_bwd_w", 2),
                "tc": ("adaptive_conv_bwd_w_tc", 1)}


@functools.lru_cache(maxsize=None)
def _bwd_w_entry(route: str):
    """(library, workspace query, launch) of K2's ``route``, the argument
    types set once."""
    name, codes = BWD_W_ROUTES[route]
    lib = build.load(name)
    symbol = f"gigagan_adaptive_conv_bwd_w_{route}"
    plan = getattr(lib, f"{symbol}_workspace")
    plan.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_long)] * 2
    plan.restype = ctypes.c_int
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * (7 + codes) + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return lib, plan, fn


@functools.lru_cache(maxsize=None)
def bwd_w_workspace(route: str, b: int, h: int, w: int, ci: int, co: int,
                    n: int, device: int) -> tuple[int, int]:
    """(dW partial floats, da partial floats) one K2 launch on ``route``
    needs at this shape; the tensor-core route needs no dW partials when it
    does not split the pixels."""
    lib, plan, _ = _bwd_w_entry(route)
    part_n, da_part_n = ctypes.c_long(), ctypes.c_long()
    err = plan(b, h, w, ci, co, n, device, ctypes.byref(part_n),
               ctypes.byref(da_part_n))
    build.check(lib, err, f"adaptive_conv_bwd_w_{route}")
    return part_n.value, da_part_n.value


def _launch_bwd_w(route, x, g, weights, attn, codes):
    """Allocate the workspace of K2's ``route`` and the outputs, and launch;
    ``codes`` are the dtype arguments the C entry takes."""
    b, h, w, ci = x.shape
    n, co = weights.shape[0], weights.shape[-1]
    dev = x.device
    lib, _, fn = _bwd_w_entry(route)
    part_n, da_part_n = bwd_w_workspace(route, b, h, w, ci, co, n, dev.index)
    work = torch.empty(part_n + da_part_n, dtype=torch.float32, device=dev)
    dw = torch.empty((n, 3, 3, ci, co), dtype=torch.float32, device=dev)
    da = torch.empty((b, n), dtype=torch.float32, device=dev)
    err = fn(
        x.data_ptr(), g.data_ptr(), weights.data_ptr(), attn.data_ptr(),
        dw.data_ptr(), da.data_ptr(), work.data_ptr() if part_n else None,
        work.data_ptr() + 4 * part_n, b, h, w, ci, co, n, *codes, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, f"adaptive_conv_bwd_w_{route}")
    return dw, da


def adaptive_conv_bwd_w_simt(x, g, weights, attn):
    """K2 on CUDA cores (``csrc/adaptive_conv_bwd_w.cu``), one launch on at
    most MAX_BANKS banks: float32 or bf16 x and g with any channel
    counts."""
    _check_bwd_w("adaptive_conv_bwd_w_simt", x, g, weights, attn, MAX_BANKS)
    out = _launch_bwd_w("simt", x, g, weights, attn,
                        (_DTYPE_CODES[x.dtype], _DTYPE_CODES[weights.dtype]))
    adaptive_conv_bwd_w_simt.launches += 1
    return out


def adaptive_conv_bwd_w_tc(x, g, weights, attn):
    """K2 on the tensor cores (``csrc/adaptive_conv_bwd_w_tc.cu``), one
    launch on at most MAX_BANKS_TC banks: bf16 x and g with ci and co
    multiples of 16, float32 or bf16 weights."""
    what = "adaptive_conv_bwd_w_tc"
    ci, co = x.shape[-1], weights.shape[-1]
    if not bwd_w_uses_tensor_cores(x.dtype, ci, co):
        raise ValueError(f"{what}: takes bf16 with ci and co multiples of "
                         f"16, got {x.dtype} with {ci} -> {co}")
    _check_bwd_w(what, x, g, weights, attn, MAX_BANKS_TC)
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError(f"{what}: x and g must be 16-byte aligned (the "
                         "tensor-core kernel reads them by TMA)")
    out = _launch_bwd_w("tc", x, g, weights, attn,
                        (_DTYPE_CODES[weights.dtype],))
    adaptive_conv_bwd_w_tc.launches += 1
    return out


adaptive_conv_bwd_w_simt.launches = 0
adaptive_conv_bwd_w_tc.launches = 0


# ------------------------------------------------- the AD-closed op pair

def flip_t(banks):
    """Spatially flip and (i,o)-transpose kernel banks:
    (n, 3, 3, i, o) → (n, 3, 3, o, i)."""
    return banks.flip((1, 2)).transpose(-1, -2).contiguous()


class _PConv2d(torch.autograd.Function):
    """out = demod ⊙ conv3x3_SAME(x, Σₙ coeff[b,n]·Wₙ) through K1.

    Backward: the demod folds into the cotangent (g' = g·demod);
    dx = K1(g', flip_t(W), coeff, 1); (dW, dcoeff) = K2(x, g', W, coeff);
    ddemod[b,o] = Σ_hw g·out / demod (demod = rsqrt(max(d², eps)) is never
    0).  The saved output is an output of this op, so under create_graph
    ddemod stays differentiable through it."""

    @staticmethod
    def forward(ctx, x, weights, coeff, demod):
        out = adaptive_conv_fwd(x, weights, coeff, demod)
        ctx.save_for_backward(x, weights, coeff, demod, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, weights, coeff, demod, out = ctx.saved_tensors
        acc = acc_dtype(x)
        # the kernels take contiguous operands; a cotangent that comes
        # back through a permute (the video path's space folding) is not
        g_s = (g.to(acc) * demod.to(acc)[:, None, None, :]).to(
            x.dtype).contiguous()
        dx = dw = dcoeff = ddemod = None
        if ctx.needs_input_grad[0]:
            ones = torch.ones((x.shape[0], x.shape[-1]), dtype=demod.dtype,
                              device=x.device)
            dx = pconv2d(g_s, flip_t(weights), coeff, ones)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, dcoeff = pcorr2d(x, g_s, weights, coeff)
            dw, dcoeff = dw.to(weights.dtype), dcoeff.to(coeff.dtype)
        if ctx.needs_input_grad[3]:
            ddemod = (g.to(acc) * out.to(acc)).sum((1, 2)) / demod.to(acc)
            ddemod = ddemod.to(demod.dtype)
        return dx, dw, dcoeff, ddemod


class _PCorr2d(torch.autograd.Function):
    """(dW, da) = K2(x, g, W, coeff).  Its backward, as in JAX, is made of
    the two ops with the 2n-bank mixture banks = [ĝdW; W], mix = [coeff; ĝda]:
    dx = pconv(g, flip_t(banks), mix), dg = pconv(x, banks, mix),
    (dW, dcoeff) = pcorr(x, g, ĝdW, ĝda)."""

    @staticmethod
    def forward(ctx, x, g, weights, coeff):
        dw, da = adaptive_conv_bwd_w(x, g, weights, coeff)
        ctx.save_for_backward(x, g, weights, coeff)
        return dw, da

    @staticmethod
    def backward(ctx, g_dw, g_da):
        x, g, weights, coeff = ctx.saved_tensors
        banks = torch.cat((g_dw.to(weights.dtype), weights), 0)
        mix = torch.cat((coeff, g_da.to(coeff.dtype)), 1)
        b = x.shape[0]
        ones_o = torch.ones((b, weights.shape[-1]), dtype=coeff.dtype,
                            device=x.device)
        ones_i = torch.ones((b, x.shape[-1]), dtype=coeff.dtype,
                            device=x.device)
        dx = pconv2d(g, flip_t(banks), mix, ones_i)
        dg = pconv2d(x, banks, mix, ones_o)
        dw_hat, da_hat = pcorr2d(x, g, g_dw.to(weights.dtype),
                                 g_da.to(coeff.dtype))
        return (dx, dg, dw_hat.to(weights.dtype), da_hat.to(coeff.dtype))


def pconv2d(x, weights, coeff, demod):
    """demod ⊙ conv3x3_SAME(x, Σₙ coeff[b,n]·Wₙ), differentiable to any
    order; coeff is NOT softmaxed here."""
    return _PConv2d.apply(x, weights, coeff, demod)


def pcorr2d(x, g, weights, coeff):
    """(dW, da) of a 3x3 SAME conv (see the module docstring),
    differentiable to any order."""
    return _PCorr2d.apply(x, g, weights, coeff)
