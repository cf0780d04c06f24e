"""Sample-adaptive modulated convolution (counterpart of
gigagan_tpu/ops/adaptive_conv.py).

The same exact factoring as the JAX package, with no per-sample weight in
device memory:

1. input-channel modulation folds into the activations:
   ``conv(x, W * (1+mod)[i]) == conv(x * (1+mod), W)``;
2. kernel-bank selection commutes with the conv:
   ``conv(x, Σₙ aₙ Wₙ) == Σₙ aₙ conv(x, Wₙ)``;
3. demodulation is a per-sample output-channel scale from the kernel-bank
   Gram matrix ``G[n,m,i,o] = Σ_k Wₙ[k,i,o]·Wₘ[k,i,o]``:
   ``d²[b,o] = Σ_{n,m} a[b,n]·a[b,m] · Σᵢ G[n,m,i,o]·(1+mod[b,i])²``.

Every 2-D 3x3 stride-1 conv goes through ``pconv2d``
(``ops/kernels/adaptive_conv.py``): kernel K1, which mixes the banks per
sample on chip, forward and as the input gradient, and K2 for the weight
and selection gradients — their plain versions on a CPU tensor.  The 1x1
``to_rgb`` conv and strided or dilated convs, as in JAX, and everything
under ``plain_reference()`` run the plain path: steps (2)+(3) as one conv
with n·o output channels and a per-sample mix.  So does every conv inside
the forward-over-reverse R1 surrogate (``flash_hv_mode()``), as JAX runs
its convs on XLA there: K1's autograd Function has no jvp.

Rank 1 (the upsampler's temporal blocks: ``(b, t, c)`` with banks
``(n, k, in, out)``) runs step (2) on every device, as JAX runs it on XLA:
its Pallas kernel takes rank 2 only.

Feature maps are channels-last ``(b, h, w, c)``; banks are
``(n, kh, kw, in, out)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gigagan_tpu_torch.ops.kernels import use_fused
from gigagan_tpu_torch.ops.kernels.adaptive_conv import pconv2d
from gigagan_tpu_torch.ops.kernels.flash_attention_hv import hv_mode
from gigagan_tpu_torch.utils import exists


def expand_batch(t, batch: int):
    """Repeat each row to match an expanded batch (batch-MAJOR group order:
    row ``i*s + g`` is sample ``i``, group ``g``)."""
    if t.shape[0] == batch:
        return t
    s, rem = divmod(batch, t.shape[0])
    assert rem == 0, f"cannot expand batch {t.shape[0]} to {batch}"
    return torch.repeat_interleave(t, s, dim=0)


def kernel_gram(weights):
    """Gram matrix of the kernel banks over their spatial taps:
    (n, *k_spatial, i, o) → (n, n, i, o)."""
    n = weights.shape[0]
    flat = weights.reshape(n, -1, weights.shape[-2], weights.shape[-1])
    return torch.einsum("nkio,mkio->nmio", flat, flat)


def demod_scale(weights, scale_in, attn=None, eps: float = 1e-8):
    """Per-sample output-channel demodulation scale (b, o) in fp32."""
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


def _conv(x, w, *, stride: int, dilation: int):
    """SAME-padded conv on channels-last x (b, *spatial, i) with w
    (*k, i, o), rank 1 or 2."""
    pad = dilation * (w.shape[0] - 1) // 2
    conv = F.conv2d if w.dim() == 4 else F.conv1d
    out = conv(x.movedim(-1, 1), w.movedim((-1, -2), (0, 1)),
               stride=stride, padding=pad, dilation=dilation)
    return out.movedim(1, -1)


def adaptive_conv(x, weights, mod, kernel_mod=None, *, demod: bool = True,
                  stride: int = 1, dilation: int = 1, eps: float = 1e-8):
    """Adaptive modulated conv, 2-D or 1-D by the input's rank.

    x:          (b, h, w, i) or (b, t, i) feature map, channels last
    weights:    (n, kh, kw, i, o) or (n, k, i, o) kernel banks
    mod:        (b or b/s, i) style modulation of input channels
    kernel_mod: (b or b/s, n) kernel-selection logits (None if n == 1)
    """
    rank = x.dim() - 2
    assert rank in (1, 2) and weights.dim() == rank + 3, (
        f"a rank-{rank} map needs (n, *k, i, o) banks of rank {rank}, got "
        f"{tuple(weights.shape)}")
    b = x.shape[0]
    n = weights.shape[0]
    k_spatial = tuple(weights.shape[1:-2])
    spatial = (slice(None),) + (None,) * rank
    adaptive = n > 1
    assert adaptive == exists(kernel_mod), (
        "kernel_mod must be given iff num_conv_kernels > 1"
    )

    compute_dtype = x.dtype
    mod = expand_batch(mod, b)
    scale_in = (mod + 1.0).float()  # (b, i)

    # (1) fold input-channel modulation into the activations
    x = x * scale_in[spatial].to(compute_dtype)

    if adaptive:
        kernel_mod = expand_batch(kernel_mod, b)
        attn = torch.softmax(kernel_mod.float(), dim=-1)  # (b, n)
    else:
        attn = None

    # K1 takes stride-1, dilation-1 3x3 convs outside the jvp of the
    # forward-over-reverse R1; any other runs step (2) below on every
    # device, as JAX runs it on its XLA conv
    fused = (use_fused() and not hv_mode() and k_spatial == (3, 3)
             and stride == 1 and dilation == 1)
    if fused:
        a = attn if adaptive else torch.ones(
            (b, 1), dtype=torch.float32, device=x.device
        )
        if demod:
            d = demod_scale(weights, scale_in, attn, eps)
        else:
            d = torch.ones((b, weights.shape[-1]), dtype=torch.float32,
                           device=x.device)
        return pconv2d(x.contiguous(), weights.contiguous(), a.contiguous(),
                       d.contiguous())

    # (2) one conv with n·o output channels, then per-sample bank mixing
    o = weights.shape[-1]
    w_flat = weights.movedim(0, -2).reshape(*k_spatial, -1, n * o)
    w_c = w_flat.to(compute_dtype)
    if adaptive:
        # fp32 per-bank outputs: bf16 rounding of the per-bank outputs
        # would blow up the relative error of the mix (see JAX notes)
        out = _conv(x.float(), w_c.float(), stride=stride,
                    dilation=dilation)
        out = out.reshape(*out.shape[:-1], n, o)
        out = torch.einsum("bn,b...no->b...o", attn, out).to(compute_dtype)
    else:
        out = _conv(x, w_c, stride=stride, dilation=dilation)

    # (3) demodulation as an output-channel scale from the Gram matrix
    if demod:
        d = demod_scale(weights, scale_in, attn, eps)
        out = out * d[spatial].to(compute_dtype)
    return out


def adaptive_conv_reference(x, weights, mod, kernel_mod=None, *,
                            demod: bool = True, stride: int = 1,
                            dilation: int = 1, eps: float = 1e-8):
    """Direct transcription of the reference semantics — per-sample weights,
    one conv per sample.  A numerics oracle for `adaptive_conv`."""
    b = x.shape[0]
    n = weights.shape[0]
    rank = weights.dim() - 3
    mod = expand_batch(mod, b)
    if n > 1:
        kernel_mod = expand_batch(kernel_mod, b)
        attn = torch.softmax(kernel_mod, dim=-1)
        w = torch.einsum("bn,n...->b...", attn, weights)  # (b, *k, i, o)
    else:
        w = weights[0].expand(b, *weights.shape[1:])
    w = w * (mod + 1.0)[(slice(None),) + (None,) * rank + (slice(None),
                                                           None)]
    if demod:
        sq = (w * w).sum(dim=tuple(range(1, rank + 2)), keepdim=True)
        w = w * torch.rsqrt(torch.clamp(sq, min=eps))
    return torch.cat([
        _conv(x[i : i + 1], w[i], stride=stride, dilation=dilation)
        for i in range(b)
    ])
