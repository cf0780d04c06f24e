"""Attention primitives (counterpart of gigagan_tpu/ops/attention.py:
``attend``, ``attend_fused``, ``linear_attend`` and
``linear_attend_fused``).

The plain paths keep the JAX package's algebra:

- the |q|² term of the L2 similarity is constant per row and cancels in
  the softmax, so it is dropped;
- the scale folds into q, and |k|² plus the key mask fold into one bias
  row, so the similarity is one matmul plus one broadcast add;
- logits are fp32; only the exp'd map is rounded to the operand dtype;
- the softmax divide runs on the (i, d) output, not the (i, j) map.

The kernels are reached through autograd Functions (the kernel on a CUDA
tensor, its plain version on a CPU tensor), dispatched as in the JAX
package:

- ``attend_fused`` with d ≤ 128 goes through the chain K3 (forward), K4
  (backward) and K5 (its adjoint, for the R1 penalty's double backward)
  in ``ops/kernels/flash_attention_so.py``;
- ``attend`` at flash sizes (d ≤ 128, ≥ 256 queries, ≥ 128 keys) goes
  through K6a/K6b with the jvp pair K7a/K7b
  (``ops/kernels/flash_attention_hv.py``), which supports grad-of-jvp;
- under ``flash_hv_mode()`` (the forward-over-reverse R1 surrogate)
  ``attend_fused`` takes the split-heads route, so it reaches that
  ``attend``.

``plain_reference()`` takes the plain math everywhere.

The upsampler's linear attention is XLA, not Pallas, in JAX.
``linear_attend`` is plain PyTorch on every device; ``linear_attend_fused``
runs its plain form (``ops/kernels/linear_attention.py``) wherever
autograd may differentiate a call, and otherwise the kernel
``csrc/linear_attention.cu`` (``linear_attend_route``).
"""

from __future__ import annotations

import torch

from gigagan_tpu_torch.ops.adaptive_conv import demod_route
from gigagan_tpu_torch.ops.kernels import linear_attention as klinattn
from gigagan_tpu_torch.ops.kernels import use_fused
from gigagan_tpu_torch.ops.kernels.flash_attention_hv import (
    flash_attend_hv,
    hv_mode,
)
from gigagan_tpu_torch.ops.kernels.flash_attention_so import (
    flash_attend_fused,
)
from gigagan_tpu_torch.utils import exists

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attend(q, k, v, *, mask=None, l2_dist: bool = False, scale=None):
    """Softmax attention.  q: (b, h, i, d); k, v: (b, h, j, d); mask: (b, j)
    key-padding mask (True = attend).  Returns (b, h, i, d)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if (use_fused() and q.shape[-1] <= 128 and q.shape[-2] >= 256
            and k.shape[-2] >= 128):
        return flash_attend_hv(q, k, v, mask, l2_dist, scale)

    out_dtype = q.dtype
    coeff = 2.0 * scale if l2_dist else scale
    q_s = (q.float() * coeff).to(q.dtype)
    sim_dtype = torch.float32 if q.dtype == torch.float32 else q.dtype
    sim = torch.einsum("bhid,bhjd->bhij", q_s.float(), k.float())
    bias = None
    if l2_dist:
        kf = k.float()
        bias = -scale * (kf * kf).sum(dim=-1)  # (b, h, j)
    if exists(mask):
        mbias = torch.where(mask, 0.0, NEG_INF)[:, None, :].float()
        bias = mbias if bias is None else bias + mbias
    if bias is not None:
        sim = sim + bias[..., None, :]

    # a constant, as JAX's stop_gradient makes it: the softmax does not
    # depend on it
    m = sim.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(sim - m).to(sim_dtype)
    s = e.float().sum(dim=-1, keepdim=True)
    out = torch.einsum("bhij,bhjd->bhid", e.to(q.dtype).float(), v.float())
    return (out / s).to(out_dtype)


def attend_fused(q, k, v, *, heads: int, null_kv=None, l2_dist: bool = False,
                 scale=None):
    """Attention in the network's fused-heads layout: q (b, nq, H·d),
    k/v (b, nk, H·d), optional learned null_kv (2, H, d) → (b, nq, H·d)."""
    d = q.shape[-1] // heads
    if scale is None:
        scale = d ** -0.5
    if use_fused() and d <= 128 and not hv_mode():
        return flash_attend_fused(q, k, v, null_kv, heads, l2_dist, scale)

    b, nq, _ = q.shape
    nk = k.shape[1]

    def split(t, n):
        return t.reshape(b, n, heads, d).permute(0, 2, 1, 3)

    qh, kh, vh = split(q, nq), split(k, nk), split(v, nk)
    if exists(null_kv):
        nk_tok = null_kv[0][None, :, None, :].expand(b, heads, 1, d)
        nv_tok = null_kv[1][None, :, None, :].expand(b, heads, 1, d)
        kh = torch.cat((nk_tok.to(kh.dtype), kh), dim=-2)
        vh = torch.cat((nv_tok.to(vh.dtype), vh), dim=-2)
    out = attend(qh, kh, vh, l2_dist=l2_dist, scale=scale)
    return out.permute(0, 2, 1, 3).reshape(b, nq, heads * d)


def linear_attend(q, k, v, *, scale=None):
    """Linear attention (the upsampler's LinearAttention2D): q, k, v (b, h,
    n, d); q softmaxes over d, k over n, so the d×d context keeps the cost
    linear in n.  Softmax statistics in fp32; both context products in the
    operand dtype with fp32 accumulation."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = torch.softmax(q.float(), dim=-1) * scale
    kf = klinattn.softmax_over(k, -2)
    context = torch.einsum("bhnd,bhne->bhde", kf.to(v.dtype), v)
    out = torch.einsum("bhde,bhnd->bhne", context.to(q.dtype),
                       qf.to(q.dtype))
    return out.to(q.dtype)


def linear_attend_route(device, q, k, v, heads: int) -> str:
    """Where ``linear_attend_fused`` sends a call: ``"autograd"`` (the plain
    form, which autograd differentiates) where ``demod_route`` says so
    (grad mode on and an operand that requires a gradient, the
    forward-over-reverse surrogate, ``plain_reference()``) and on a CUDA
    device where the kernel does not take the dtype or head dim; else
    ``"plain"`` on a CPU device, ``"kernel"`` on a CUDA one.  Reads only the
    grad mode, the operands and the head count."""
    route = demod_route(device, q, k, v)
    if route == "kernel" and not klinattn.kernel_takes(
            q.dtype, q.shape[-1] // heads):
        return "autograd"
    return route


def linear_attend_fused(q, k, v, *, heads: int, scale=None):
    """``linear_attend`` in the network's fused-heads layout: q, k, v (b, n,
    H·d) → (b, n, H·d), each head a slice of the last dimension: the plain
    form where autograd may differentiate the call, else the kernel (the
    plain form on a CPU tensor)."""
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    if linear_attend_route(q.device, q, k, v, heads) == "autograd":
        return klinattn.linear_attend_plain(q, k, v, heads=heads,
                                            scale=scale)
    return klinattn.linear_attend_fwd(q, k, v, heads=heads, scale=scale)
