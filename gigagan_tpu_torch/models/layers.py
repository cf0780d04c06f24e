"""Core layer modules, channels-last throughout (counterpart of the parts
of gigagan_tpu/models/layers.py on the generator's and the
discriminator's paths).

- 1x1 convs are ``Dense`` on the trailing channel axis, exactly like flax
  ``nn.Dense``: weights are stored fp32 and cast, with the input, to the
  module's compute ``dtype``.
- flax ``nn.Conv`` with SAME padding is ``Conv``: a torch conv weight
  ``(out, in, k, k)`` (the bridge transposes flax's HWIO kernel), run on a
  channels-last view of the feature map.
- Parameters are created empty; ``init_parameters(module, generator)``
  draws every one from an explicit ``torch.Generator`` with the JAX
  package's distributions, in module-registration order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gigagan_tpu_torch import ops
from gigagan_tpu_torch.parallel import dist
from gigagan_tpu_torch.utils import exists
from gigagan_tpu_torch.utils.init import (
    dirac_1d_,
    kaiming_normal_leaky_,
    pixel_shuffle_icnr_,
)


def init_parameters(module: nn.Module, generator=None) -> None:
    """Draw every parameter of ``module`` from ``generator``."""
    for m in module.modules():
        reset = getattr(m, "reset_own_parameters", None)
        if reset is not None:
            reset(generator)


def leaky_relu(x, neg_slope: float = 0.2):
    return F.leaky_relu(x, negative_slope=neg_slope)


def l2norm(x, dim: int = -1, eps: float = 1e-12):
    """x / max(||x||₂, eps) with the clamp INSIDE the sqrt (so an all-zero
    row has a finite gradient), sums in fp32."""
    sum_sq = x.float().square().sum(dim=dim, keepdim=True)
    norm = torch.sqrt(torch.clamp(sum_sq, min=eps * eps))
    return (x / norm.to(x.dtype)).to(x.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x·W (+ b) in ``dtype``; weight stored as a
    torch Linear weight (out, in), kaiming-normal (leaky) on fan_in."""

    def __init__(self, dim_in: int, dim_out: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in))
        self.bias = nn.Parameter(torch.empty(dim_out)) if bias else None

    def reset_own_parameters(self, generator=None):
        kaiming_normal_leaky_(self.weight, "linear", generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        bias = self.bias.to(self.dtype) if self.bias is not None else None
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


def conv1x1(dim_in: int, dim_out: int, bias: bool = True,
            dtype=torch.float32):
    return Dense(dim_in, dim_out, bias=bias, dtype=dtype)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, padding="SAME")`` on
    (b, h, w, c), kaiming-normal (leaky) on fan_in, zero bias; odd k (or
    k = 1 at stride 2, which SAME leaves unpadded)."""

    def __init__(self, dim_in: int, dim_out: int, kernel: int = 3,
                 stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = kernel // 2
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.empty(dim_out))

    def reset_own_parameters(self, generator=None):
        kaiming_normal_leaky_(self.weight, "oihw", generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.to(self.dtype)
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        if w.shape[-1] == 1:  # a strided pointwise conv is a Dense
            s = self.stride
            return F.linear(x[:, ::s, ::s], w[:, :, 0, 0], b)
        out = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=self.stride,
                       padding=self.padding)
        return out.permute(0, 2, 3, 1)


def conv3x3(dim_in: int, dim_out: int, dtype=torch.float32):
    return Conv(dim_in, dim_out, kernel=3, dtype=dtype)


class DiracConv1d(nn.Module):
    """flax ``nn.Conv(features, (k,), padding="SAME")`` on (b, t, c) with
    the identity init (a torch conv1d weight (out, in, k), zero bias): the
    upsampler's temporal conv starts as a no-op."""

    def __init__(self, dim_in: int, dim_out: int, kernel: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, kernel))
        self.bias = nn.Parameter(torch.empty(dim_out))

    def reset_own_parameters(self, generator=None):
        dirac_1d_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.to(self.dtype)
        out = F.conv1d(x.transpose(1, 2), self.weight.to(self.dtype),
                       self.bias.to(self.dtype),
                       padding=self.weight.shape[-1] // 2)
        return out.transpose(1, 2)


class Blur(nn.Module):
    """Binomial [1,2,1] blur.  Parameter-free."""

    def forward(self, x):
        return ops.resample.blur_2d(x)


class _SpaceToDepthProj(nn.Module):
    """Dense over space-to-depth'd pixels, run as ONE 2×2 stride-2 conv.
    The parameter keeps the flax Dense layout (as a torch Linear weight
    (dim, 4·c) whose columns are (c, s1, s2)-major), so its conv view is a
    reshape to (dim, c, 2, 2)."""

    def __init__(self, dim_in: int, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, 4 * dim_in))
        self.bias = nn.Parameter(torch.empty(dim))

    def reset_own_parameters(self, generator=None):
        kaiming_normal_leaky_(self.weight, "linear", generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dim, c = self.weight.shape[0], x.shape[-1]
        w = self.weight.reshape(dim, c, 2, 2).to(self.dtype)
        out = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w,
                       self.bias.to(self.dtype), stride=2)
        return out.permute(0, 2, 3, 1)


class Downsample(nn.Module):
    """space-to-depth + 1x1 conv, as one 2×2 stride-2 conv (the dense form
    of the JAX package's ``Downsample``; its space-to-depth trunk variants
    exist only for the TPU's lane layout)."""

    def __init__(self, dim_in: int, dim: int, dtype=torch.float32):
        super().__init__()
        self.proj = _SpaceToDepthProj(dim_in, dim, dtype=dtype)

    def forward(self, x):
        return self.proj(x)


class RMSNorm(nn.Module):
    """RMSNorm over the channel (last) axis."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.empty(dim))

    def reset_own_parameters(self, generator=None):
        nn.init.ones_(self.gamma)

    def forward(self, x):
        scale = self.dim ** 0.5
        return l2norm(x) * (scale * self.gamma).to(x.dtype)


class Upsample(nn.Module):
    """Bilinear 2x + binomial blur.  Parameter-free."""

    def forward(self, x):
        return ops.resample.upsample_2x_blur(x)


class ICNRDense(Dense):
    """A Dense whose init is ICNR for a shuffle of ``factor`` (4 for a 2x
    pixel shuffle, 2 for a 2x temporal one): the shuffle starts as a
    nearest-neighbour upsample."""

    def __init__(self, dim_in: int, dim_out: int, factor: int = 4,
                 dtype=torch.float32):
        super().__init__(dim_in, dim_out, dtype=dtype)
        self.factor = factor

    def reset_own_parameters(self, generator=None):
        pixel_shuffle_icnr_(self.weight, self.factor, generator)
        nn.init.zeros_(self.bias)


class PixelShuffleUpsample(nn.Module):
    """1x1 conv to 4× the channels, SiLU, pixel shuffle; ICNR init unless
    ``use_icnr=False`` (then the Dense's own kaiming init, as the
    generator asks for: the reference's post-hoc re-init overwrites
    ICNR)."""

    def __init__(self, dim: int, dim_out=None, use_icnr: bool = True,
                 dtype=torch.float32):
        super().__init__()
        dim_out = dim if dim_out is None else dim_out
        self.conv = (ICNRDense if use_icnr else Dense)(dim, dim_out * 4,
                                                        dtype=dtype)

    def forward(self, x):
        return ops.resample.pixel_shuffle(F.silu(self.conv(x)), 2)


class SqueezeExcite(nn.Module):
    """Global pool → MLP → sigmoid gate; returns the (b, 1, 1, dim_out)
    gate that the caller multiplies into a deeper layer."""

    def __init__(self, dim_in: int, dim_out: int, reduction: int = 4,
                 dim_min: int = 32, dtype=torch.float32):
        super().__init__()
        dim_hidden = max(dim_out // reduction, dim_min)
        self.fc1 = conv1x1(dim_in, dim_hidden, dtype=dtype)
        self.fc2 = conv1x1(dim_hidden, dim_out, dtype=dtype)

    def forward(self, x):
        g = x.mean(dim=(1, 2))
        g = torch.sigmoid(self.fc2(F.silu(self.fc1(g))))
        return g[:, None, None, :]


class Noise(nn.Module):
    """Per-pixel noise with a learned per-channel weight.  An explicit
    ``noise`` wins; otherwise it is drawn from ``generator``."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))

    def reset_own_parameters(self, generator=None):
        nn.init.zeros_(self.weight)

    def forward(self, x, noise=None, generator=None):
        if not exists(noise):
            noise = dist.randn((*x.shape[:-1], 1), generator=generator,
                                device=x.device, dtype=x.dtype)
        return x + self.weight.to(x.dtype) * noise.to(x.dtype)


class EqualLinear(nn.Module):
    """StyleGAN equalized linear: weight ~ N(0, 1) stored (out, in), lr_mul
    folded in at run time."""

    def __init__(self, dim_in: int, dim_out: int, lr_mul: float = 1.0,
                 bias: bool = True):
        super().__init__()
        self.lr_mul = lr_mul
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in))
        self.bias = nn.Parameter(torch.empty(dim_out)) if bias else None

    def reset_own_parameters(self, generator=None):
        self.weight.data.normal_(0.0, 1.0, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        w = (self.weight * self.lr_mul).to(x.dtype)
        b = (self.bias * self.lr_mul).to(x.dtype) if exists(self.bias) else None
        return F.linear(x, w, b)


class AdaptiveConv(nn.Module):
    """Style-modulated, sample-adaptive conv over ``ops.adaptive_conv``:
    2-D on (b, h, w, c) with banks ``(n, k, k, dim_in, dim_out)``, or with
    ``rank=1`` 1-D on (b, t, c) with banks ``(n, k, dim_in, dim_out)``."""

    def __init__(self, dim_in: int, dim_out: int, kernel: int = 3,
                 demod: bool = True, num_conv_kernels: int = 1,
                 rank: int = 2, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.demod = demod
        n = max(num_conv_kernels, 1)
        self.weights = nn.Parameter(
            torch.empty(n, *(kernel,) * rank, dim_in, dim_out)
        )

    def reset_own_parameters(self, generator=None):
        kaiming_normal_leaky_(self.weights, "bank", generator)

    @property
    def adaptive(self):
        return self.weights.shape[0] > 1

    def forward(self, fmap, mod, kernel_mod=None):
        if not self.adaptive:
            kernel_mod = None
        return ops.adaptive_conv(fmap.to(self.dtype), self.weights, mod,
                                 kernel_mod, demod=self.demod)


class SelfAttention(nn.Module):
    """Self-attention on feature maps with a learned null key/value:
    L2-distance similarity with shared q/k, or dot product with its own
    to_k."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 dot_product: bool = False, dtype=torch.float32):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.dim_head = dim_head
        self.dot_product = dot_product
        self.norm = RMSNorm(dim)
        self.to_q = conv1x1(dim, inner, bias=False, dtype=dtype)
        self.to_k = (conv1x1(dim, inner, bias=False, dtype=dtype)
                     if dot_product else None)
        self.to_v = conv1x1(dim, inner, bias=False, dtype=dtype)
        self.to_out = conv1x1(inner, dim, bias=False, dtype=dtype)
        self.null_kv = nn.Parameter(torch.empty(2, heads, dim_head))

    def reset_own_parameters(self, generator=None):
        self.null_kv.data.normal_(0.0, 1.0, generator=generator)

    def forward(self, fmap):
        b, h, w, _ = fmap.shape
        inner = self.dim_head * self.heads
        fmap = self.norm(fmap)
        q = self.to_q(fmap)
        v = self.to_v(fmap)
        k = self.to_k(fmap) if self.dot_product else q  # shared q/k space
        q, k, v = (t.reshape(b, h * w, inner) for t in (q, k, v))
        out = ops.attend_fused(
            q, k, v, heads=self.heads, null_kv=self.null_kv,
            l2_dist=not self.dot_product, scale=self.dim_head ** -0.5,
        )
        return self.to_out(out.reshape(b, h, w, inner))


class FeedForward(nn.Module):
    """RMSNorm → proj → GELU (exact) → proj."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        super().__init__()
        dim_hidden = int(dim * mult)
        self.norm = RMSNorm(dim)
        self.proj_in = conv1x1(dim, dim_hidden, dtype=dtype)
        self.proj_out = conv1x1(dim_hidden, dim, dtype=dtype)

    def forward(self, x):
        return self.proj_out(F.gelu(self.proj_in(self.norm(x))))


class SelfAttentionBlock(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 ff_mult: int = 4, dot_product: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.attn = SelfAttention(dim, dim_head=dim_head, heads=heads,
                                  dot_product=dot_product, dtype=dtype)
        self.ff = FeedForward(dim, mult=ff_mult, dtype=dtype)

    def forward(self, x):
        x = self.attn(x) + x
        return self.ff(x) + x


class CrossAttention(nn.Module):
    """Feature-map queries attend to text tokens under the tokens' padding
    mask (no null token)."""

    def __init__(self, dim: int, dim_context: int, dim_head: int = 64,
                 heads: int = 8, dtype=torch.float32):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.dim_head = dim_head
        self.norm = RMSNorm(dim)
        self.norm_context = RMSNorm(dim_context)
        self.to_q = conv1x1(dim, inner, bias=False, dtype=dtype)
        self.to_kv = conv1x1(dim_context, inner * 2, bias=False, dtype=dtype)
        self.to_out = conv1x1(inner, dim, bias=False, dtype=dtype)

    def forward(self, fmap, context, mask=None):
        b, h, w, _ = fmap.shape
        q = self.to_q(self.norm(fmap)).reshape(b, h * w, self.heads, -1)
        k, v = self.to_kv(self.norm_context(context)).chunk(2, dim=-1)
        k, v = (t.reshape(b, t.shape[1], self.heads, -1) for t in (k, v))
        out = ops.attend(*(t.transpose(1, 2) for t in (q, k, v)), mask=mask,
                         scale=self.dim_head ** -0.5)
        return self.to_out(out.transpose(1, 2).reshape(b, h, w, -1))


class TextAttention(nn.Module):
    """Token self-attention with a learned null key/value and the tokens'
    padding mask (the null token always attended)."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 dtype=torch.float32):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.dim_head = dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = conv1x1(dim, inner * 3, bias=False, dtype=dtype)
        self.null_kv = nn.Parameter(torch.empty(2, heads, dim_head))
        self.to_out = conv1x1(inner, dim, bias=False, dtype=dtype)

    def reset_own_parameters(self, generator=None):
        self.null_kv.data.normal_(0.0, 1.0, generator=generator)

    def forward(self, encodings, mask=None):
        b, n, _ = encodings.shape
        q, k, v = (t.reshape(b, n, self.heads, -1).transpose(1, 2)
                   for t in self.to_qkv(self.norm(encodings)).chunk(3, -1))
        nk, nv = (t[None, :, None, :].expand(b, -1, 1, -1).to(q.dtype)
                  for t in self.null_kv)
        k, v = torch.cat((nk, k), dim=-2), torch.cat((nv, v), dim=-2)
        if exists(mask):
            mask = F.pad(mask, (1, 0), value=True)
        out = ops.attend(q, k, v, mask=mask, scale=self.dim_head ** -0.5)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class CrossAttentionBlock(nn.Module):
    def __init__(self, dim: int, dim_context: int, dim_head: int = 64,
                 heads: int = 8, ff_mult: int = 4, dtype=torch.float32):
        super().__init__()
        self.attn = CrossAttention(dim, dim_context, dim_head=dim_head,
                                   heads=heads, dtype=dtype)
        self.ff = FeedForward(dim, mult=ff_mult, dtype=dtype)

    def forward(self, x, context, mask=None):
        x = self.attn(x, context, mask=mask) + x
        return self.ff(x) + x


class Transformer(nn.Module):
    """Text transformer: depth × (TextAttention, FeedForward), each
    residual, then a final RMSNorm."""

    def __init__(self, dim: int, depth: int, dim_head: int = 64,
                 heads: int = 8, ff_mult: int = 4, dtype=torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"attn_{i}", TextAttention(
                dim, dim_head=dim_head, heads=heads, dtype=dtype))
            self.add_module(f"ff_{i}", FeedForward(dim, mult=ff_mult,
                                                   dtype=dtype))
        self.norm = RMSNorm(dim)

    def forward(self, x, mask=None):
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(x, mask=mask) + x
            x = getattr(self, f"ff_{i}")(x) + x
        return self.norm(x)


class RandomFixedProjection(nn.Module):
    """A frozen random projection (the projected-GAN trick): a buffer
    ``fixed_weights`` (in, out), kaiming-normal on fan_out with gain 1,
    that no optimizer sees."""

    def __init__(self, dim_in: int, dim_out: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("fixed_weights", torch.empty(dim_in, dim_out))

    def reset_own_parameters(self, generator=None):
        self.fixed_weights.normal_(
            0.0, self.fixed_weights.shape[1] ** -0.5, generator=generator)

    def forward(self, x):
        return x.to(self.dtype) @ self.fixed_weights.to(self.dtype)
