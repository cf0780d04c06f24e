"""The reference's UNet upsampler: a float32 copy of the image path of the
port's ``UnetUpsampler`` (``gigagan_tpu_torch/models/unet_upsampler.py``,
the same config keys and parameter names), unconditional, without
temporal layers.

- a 7x7 init conv, then per down stage two style-modulated ResnetBlocks,
  full or linear attention with its feed-forward, and the "HF shuttle"
  downsample: 3x3 conv → blur → 2x max pool, the high-frequency residual
  (pre-blur − blurred) concatenated into the skip connection; the first
  log2(out) − log2(in) stages skip the pooling (and the residual);
- a middle of two ResnetBlocks around full attention;
- per up stage: pixel-shuffle upsample, the rgb bilinear-upsampled and
  blurred, two skip concatenations scaled by 2^-0.5 (bilinear-resized
  where a stage that did not downsample meets the upsampled path), two
  ResnetBlocks, attention, an rgb added; then a final ResnetBlock and rgb;
- the linear attention in its textbook form: q softmaxed over its
  features, k over the positions, the d×d context kᵀv, then q·context.

Where the port follows the JAX package rather than the lucidrains code
(SURVEY §2.3 and the port's docstring), so does this copy:

- the style projection's slots are registered in the order the forward
  reads them (block1, block2 of each stage), one ``ModTable``;
- the pixel shuffle's ICNR init is kept (the base generator re-inits it);
- the skip resize is bilinear without antialiasing, the rgb upsample
  bilinear + blur, the max pool's gradient goes to one element of each
  window, as in JAX.

Departures from the port: the blur pads with ``F.pad(mode="reflect")``
and the resizes are ``F.interpolate`` (the port computes the same taps
by slices and interpolation matrices, for a backward without atomics);
the linear attention's softmax statistics and contractions are float32
(the port keeps fp32 statistics and contracts in the operand dtype); the
ICNR base kernel is drawn normal with the port's uniform's variance (the
reference draws every weight from one standard normal)."""

from __future__ import annotations

import math
from collections.abc import Mapping
from math import log2
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import numerics as nm
from portbench.reference import ops
from portbench.reference.conditioning import StyleNetwork
from portbench.reference.layers import (
    AdaptiveConv,
    Conv,
    Dense,
    FeedForward,
    RMSNorm,
    conv1x1,
)
from portbench.reference.utils import ModTable, default, exists, \
    is_power_of_two


def pixel_shuffle(x, r: int = 2):
    """(b, h, w, c·r²) → (b, h·r, w·r, c), in torch ``PixelShuffle``'s
    channel order (c, r1, r2)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def downsample_hf_shuttle(x, skip_downsample: bool):
    """(pooled, high-frequency residual); skipped: (x, an empty map)."""
    if skip_downsample:
        return x, x[..., 0:0]
    hf = x - ops.blur_2d(x)
    pooled = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return pooled, hf


def linear_attend(q, k, v, *, heads: int, scale: float):
    """Linear attention on q, k, v (b, n, H·d) → (b, n, H·d): per head,
    softmax(q) over d times ``scale``, softmax(k) over n, context kᵀv
    (d×d), out = q·context."""
    b, n, hd = q.shape
    d = hd // heads

    def split(t):
        return t.reshape(b, n, heads, d).permute(0, 2, 1, 3)

    q = torch.softmax(split(q), dim=-1) * scale
    k_t = torch.softmax(split(k).transpose(-1, -2), dim=-1)  # over n
    context = nm.einsum("bhdn,bhne->bhde", k_t, split(v))
    out = nm.einsum("bhnd,bhde->bhne", q, context)
    return out.permute(0, 2, 1, 3).reshape(b, n, hd)


class ICNRDense(Dense):
    """A Dense feeding a pixel shuffle of ``factor`` sub-pixels, whose init
    repeats each of out / factor base rows ``factor`` times (ICNR: the
    shuffle starts as a nearest-neighbour upsample)."""

    def __init__(self, dim_in: int, dim_out: int, factor: int = 4):
        super().__init__(dim_in, dim_out)
        self.factor = factor

    def reset_own_parameters(self, draws):
        out, fan_in = self.weight.shape
        base = torch.empty(out // self.factor, fan_in,
                           device=self.weight.device)
        draws.normal_(base, 0.0, 1.0 / math.sqrt(3.0 * max(fan_in, 1)))
        self.weight.data.copy_(base.repeat_interleave(self.factor, dim=0))
        self.bias.data.zero_()


class PixelShuffleUpsample(nn.Module):
    """1x1 conv to 4× the channels, SiLU, pixel shuffle."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.conv = ICNRDense(dim, dim_out * 4)

    def forward(self, x):
        return pixel_shuffle(F.silu(self.conv(x)), 2)


class UpsamplerDownsample(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, skip_downsample: bool):
        super().__init__()
        self.skip_downsample = skip_downsample
        self.conv2d = Conv(dim_in, dim_out, kernel=3)

    def forward(self, x):
        return downsample_hf_shuttle(self.conv2d(x), self.skip_downsample)


class Block(nn.Module):
    """AdaptiveConv → RMSNorm → SiLU."""

    def __init__(self, dim_in: int, dim_out: int, num_conv_kernels: int):
        super().__init__()
        self.proj = AdaptiveConv(dim_in, dim_out, kernel=3,
                                 num_conv_kernels=max(num_conv_kernels, 1))
        self.norm = RMSNorm(dim_out)

    def forward(self, x, mod, kernel_mod=None):
        return F.silu(self.norm(self.proj(x, mod=mod,
                                          kernel_mod=kernel_mod)))


class ResnetBlock(nn.Module):
    """Two modulated Blocks and a 1x1 residual; four mod-table slots."""

    def __init__(self, dim_in: int, dim_out: int, num_conv_kernels: int):
        super().__init__()
        self.block1 = Block(dim_in, dim_out, num_conv_kernels)
        self.block2 = Block(dim_out, dim_out, num_conv_kernels)
        self.res_conv = (conv1x1(dim_in, dim_out)
                         if dim_in != dim_out else None)

    @staticmethod
    def mod_dims(dim_in, dim_out, num_conv_kernels):
        k = num_conv_kernels if num_conv_kernels > 1 else 0
        return [dim_in, k, dim_out, k]

    def forward(self, x, mods):
        h = self.block1(x, mod=mods.next(), kernel_mod=mods.next())
        h = self.block2(h, mod=mods.next(), kernel_mod=mods.next())
        if exists(self.res_conv):
            x = self.res_conv(x)
        return h + x


class LinearAttention2D(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hidden = dim_head * heads
        self.norm = RMSNorm(dim)
        self.to_qkv = conv1x1(dim, hidden * 3, bias=False)
        self.to_out = conv1x1(hidden, dim)
        self.out_norm = RMSNorm(dim)

    def forward(self, x):
        b, h, w, _ = x.shape
        hidden = self.dim_head * self.heads
        q, k, v = (t.reshape(b, h * w, hidden)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        out = linear_attend(q, k, v, heads=self.heads,
                            scale=self.dim_head ** -0.5)
        return self.out_norm(self.to_out(out.reshape(b, h, w, hidden)))


class Attention2D(nn.Module):
    """Full softmax attention, dot product, no null token."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hidden = dim_head * heads
        self.norm = RMSNorm(dim)
        self.to_qkv = conv1x1(dim, hidden * 3, bias=False)
        self.to_out = conv1x1(hidden, dim)

    def forward(self, x):
        b, h, w, _ = x.shape
        hidden = self.dim_head * self.heads
        q, k, v = (t.reshape(b, h * w, hidden)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        out = ops.attend_fused(q, k, v, heads=self.heads,
                               scale=self.dim_head ** -0.5)
        return self.to_out(out.reshape(b, h, w, hidden))


class UpsamplerTransformer(nn.Module):
    """depth × (full or linear attention, FeedForward), each residual."""

    def __init__(self, dim: int, dim_head: int, heads: int, depth: int,
                 linear: bool, ff_mult: int = 4):
        super().__init__()
        self.depth = depth
        klass = LinearAttention2D if linear else Attention2D
        for i in range(depth):
            self.add_module(f"attn_{i}", klass(dim, heads=heads,
                                               dim_head=dim_head))
            self.add_module(f"ff_{i}", FeedForward(dim, mult=ff_mult))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(x) + x
            x = getattr(self, f"ff_{i}")(x) + x
        return x


class _Stage(nn.Module):
    def __init__(self, **parts):
        super().__init__()
        for name, part in parts.items():
            setattr(self, name, part)


class UnetUpsampler(nn.Module):
    def __init__(
        self,
        dim: int,
        image_size: int,
        input_image_size: int,
        init_dim: Optional[int] = None,
        style_network=None,
        dim_mults: Tuple[int, ...] = (1, 2, 4, 8, 16),
        channels: int = 3,
        full_attn: Tuple[bool, ...] = (False, False, False, True, True),
        self_attn_dim_head: int = 64,
        self_attn_heads: int = 8,
        attn_depths: Tuple[int, ...] = (1, 1, 1, 1, 1),
        cross_attn_dim_head: int = 64,
        has_temporal_layers: bool = False,
        mid_attn_depth: int = 1,
        num_conv_kernels: int = 2,
        unconditional: bool = True,
        skip_connect_scale: Optional[float] = None,
        **ignored,
    ):
        """The port's keys.  Those that only its text-conditioned or video
        paths read (``cross_attn``, ``cross_ff_mult``, ``self_attn_ff_mult``,
        ``temporal_attn_depths``, …) or that it takes and ignores
        (``flash_attn``, ``out_dim``, ``self_attn_dot_product``, …) are
        ignored here too."""
        super().__init__()
        assert unconditional and not has_temporal_layers, (
            "the reference upsampler is the unconditional image path")
        assert not {"text_encoder", "style_network_dim"} & set(ignored)
        if isinstance(style_network, Mapping):
            style_network = StyleNetwork(**style_network)
        assert style_network.dim_text_latent == 0
        assert is_power_of_two(image_size) and is_power_of_two(
            input_image_size)
        assert input_image_size < image_size
        self.style_net = style_network
        self.input_image_size = input_image_size
        num_no_downsample = int(log2(image_size) - log2(input_image_size))
        assert num_no_downsample <= len(dim_mults)

        init_dim = default(init_dim, dim)
        dims = [init_dim, *(dim * m for m in dim_mults)]
        mid_dim = dims[-1]
        in_out = list(zip(dims[:-1], dims[1:]))
        assert len(full_attn) == len(dim_mults)
        self.skip_scale = default(skip_connect_scale, 2 ** -0.5)
        split_dims = []

        def resnet(dim_in, dim_out):
            split_dims.extend(ResnetBlock.mod_dims(dim_in, dim_out,
                                                   num_conv_kernels))
            return ResnetBlock(dim_in, dim_out, num_conv_kernels)

        def transformer(d, depth, linear=False, dim_head=self_attn_dim_head):
            return UpsamplerTransformer(d, dim_head=dim_head,
                                        heads=self_attn_heads, depth=depth,
                                        linear=linear)

        self.init_conv = Conv(channels, init_dim, kernel=7)

        downs, skip_dims = [], []
        for ind, ((dim_in, dim_out), full, depth) in enumerate(
                zip(in_out, full_attn, attn_depths)):
            no_downsample = ind < num_no_downsample
            skip_dims.append(dim_in)
            skip_dims.append(dim_in + (dim_out if not no_downsample else 0))
            block1, block2 = resnet(dim_in, dim_in), resnet(dim_in, dim_in)
            downs.append(_Stage(
                block1=block1, block2=block2,
                attn=transformer(dim_in, depth, linear=not full),
                downsample=UpsamplerDownsample(dim_in, dim_out,
                                               no_downsample)))
        self.downs = nn.ModuleList(downs)

        self.mid_block1 = resnet(mid_dim, mid_dim)
        self.mid_attn = transformer(mid_dim, mid_attn_depth)
        self.mid_block2 = resnet(mid_dim, mid_dim)
        self.mid_to_rgb = conv1x1(mid_dim, channels)

        ups = []
        for (dim_in, dim_out), full, depth in zip(
                reversed(in_out), reversed(full_attn), reversed(attn_depths)):
            block1 = resnet(dim_in + skip_dims.pop(), dim_in)
            block2 = resnet(dim_in + skip_dims.pop(), dim_in)
            ups.append(_Stage(
                upsample=PixelShuffleUpsample(dim_out, dim_in),
                to_rgb=conv1x1(dim_in, channels),
                block1=block1, block2=block2,
                attn=transformer(dim_in, depth, linear=not full,
                                 dim_head=cross_attn_dim_head)))
        self.ups = nn.ModuleList(ups)

        self.final_res_block = resnet(dim, dim)
        self.final_to_rgb = conv1x1(dim, channels)
        self.style_embed_split_dims = tuple(split_dims)
        self.style_to_conv_modulations = conv1x1(style_network.dim,
                                                 sum(split_dims))

    def forward(self, lowres_image, *, return_all_rgbs: bool = False,
                latent_generator=None, noise=None):
        """``lowres_image`` (b, h, w, c) at ``input_image_size``; the style
        latent ``noise`` (b, style dim), or drawn from
        ``latent_generator``.  Returns the (b, H, W, c) output, and with
        ``return_all_rgbs`` the rgbs larger than the input, the input
        first."""
        x = lowres_image
        batch, size = x.shape[0], x.shape[1]
        assert x.shape[1] == x.shape[2] == self.input_image_size
        if not exists(noise):
            noise = nm.randn((batch, self.style_net.dim),
                             generator=latent_generator, device=x.device)
        mods = ModTable(self.style_to_conv_modulations(self.style_net(noise)),
                        self.style_embed_split_dims)

        lowres = x
        x = self.init_conv(x)
        h = []
        for stage in self.downs:
            x = stage.block1(x, mods)
            h.append(x)
            x = stage.block2(x, mods)
            x = stage.attn(x)
            skip = x
            x, hf = stage.downsample(x)
            h.append(torch.cat((skip, hf), dim=-1))

        x = self.mid_block1(x, mods)
        x = self.mid_attn(x)
        x = self.mid_block2(x, mods)

        rgb = self.mid_to_rgb(x)
        rgbs = [rgb]
        for stage in self.ups:
            x = stage.upsample(x)
            rgb = ops.upsample_2x_blur(rgb)
            res1 = h.pop() * self.skip_scale
            res2 = h.pop() * self.skip_scale
            if x.shape[1:3] != res1.shape[1:3]:
                res1 = ops.resize_image_to(res1, x.shape[1])
                res2 = ops.resize_image_to(res2, x.shape[1])
            x = stage.block1(torch.cat((x, res1), dim=-1), mods)
            x = stage.block2(torch.cat((x, res2), dim=-1), mods)
            x = stage.attn(x)
            rgb = rgb + stage.to_rgb(x)
            rgbs.append(rgb)

        x = self.final_res_block(x, mods)
        mods.assert_exhausted()
        rgb = rgb + self.final_to_rgb(x)
        if not return_all_rgbs:
            return rgb
        return rgb, [lowres, *(t for t in rgbs if t.shape[-2] > size)]
