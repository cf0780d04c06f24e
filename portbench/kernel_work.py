"""The least time one NVIDIA H100 needs for a kernel call: the larger of
its operations over the dense bf16 tensor-core rate and its bytes over the
HBM3 rate (NVIDIA's data sheet, SXM part).  Each input byte is read once
and each output byte written once, whatever the kernel reads again, so a
call can never beat its bound.

The operation counts of the port's kernels, from their operands' shapes:

- K1 (adaptive conv forward, also the input gradient) and K2 (its weight
  gradient): 2·b·h·w·kh·kw·ci·co;
- K3 (fused attention forward): 2 (b·H, nq, nk, d) products, a null token
  adding one key; K4 (its backward): 5; K5 (the adjoint of the backward,
  R1's double backward): 12 — S, dA, two for c_dS, G·C̃ᵀ, then two each
  for c_q, c_g, c_k and one for c_v."""

from __future__ import annotations

PEAK_FLOPS = 989e12   # dense bf16 and fp16, tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None and hasattr(t, "element_size"))


def bound(flops: float, moved: float):
    """(seconds, 'operations' or 'bytes'): the least time for work of
    ``flops`` operations that must move ``moved`` bytes."""
    ops_s, bytes_s = flops / PEAK_FLOPS, moved / PEAK_BYTES
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def attn_bound(products: int, bh: int, nq: int, nk: int, d: int,
               moved: float):
    """Bound of attention work of ``products`` (nq, nk, d) products."""
    return bound(2.0 * products * bh * nq * nk * d, moved)


def _outputs(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def k1_bound(args, out):
    """K1 (x_mod (b, h, w, ci), weights (n, kh, kw, ci, co), attn,
    demod) → out."""
    x, w = args[0], args[1]
    b, h, w_, ci = x.shape
    flops = 2.0 * b * h * w_ * w.shape[1] * w.shape[2] * ci * w.shape[-1]
    return bound(flops, nbytes(*args[:4], *_outputs(out)))


def k2_bound(args, out):
    """K2 (x, g, weights, attn) → (dW, da)."""
    x, w = args[0], args[2]
    b, h, w_, ci = x.shape
    flops = 2.0 * b * h * w_ * w.shape[1] * w.shape[2] * ci * w.shape[-1]
    return bound(flops, nbytes(*args[:4], *_outputs(out)))


def _attn(products, args, out):
    q, k_pre, heads = args[0], args[1], args[-1]
    b, nq, hd = q.shape
    null = 1 if args[4] is not None else 0
    return attn_bound(products, b * heads, nq, k_pre.shape[1] + null,
                      hd // heads, nbytes(*args[:-1], *_outputs(out)))


def k3_bound(args, out):
    """K3 (q, k_pre, v, bias, nullk_pre, nullv, null_bias, heads) →
    (out, lse)."""
    return _attn(2, args, out)


def k4_bound(args, out):
    """K4 (…, g, out, lse, heads) → the seven gradients."""
    return _attn(5, args, out)


def k5_bound(args, out):
    """K5 (…, g, lse, seven cotangents, heads) → eight outputs."""
    return _attn(12, args, out)


BOUNDS = {"k1": k1_bound, "k2": k2_bound, "k3": k3_bound, "k4": k4_bound,
          "k5": k5_bound}
