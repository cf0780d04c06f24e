"""The UNet super-resolution generator, image and video (counterpart of
gigagan_tpu/models/unet_upsampler.py with the same config keys).

- the first log2(out) − log2(in) down stages skip their downsampling, so
  the up path nets a 2^k upsample;
- each down stage ends in the "HF shuttle" downsample: conv (and, with
  temporal layers, an identity-init temporal conv) → blur → 2x max pool,
  its high-frequency residual (pre-blur − blurred) concatenated into the
  skip connection;
- style-modulated ResnetBlocks read one projection of the style vector
  through ``ModTable``, whose slots are registered in the order they are
  consumed (the JAX package's repair of the reference, which registers the
  video up stages' slots in another order than it reads them); an image
  through a video-capable net skips its temporal blocks' four slots;
- full or linear attention per stage (``Attention2D`` through
  ``ops.attend_fused``, so K3 → K4 → K5 on the card; ``LinearAttention2D``
  through ``ops.linear_attend_fused``: the linear-attention kernel on the
  card where no gradient is asked, else plain), optional cross-attention
  to the text tokens;
- up path: pixel-shuffle upsample (ICNR kept: unlike the base generator,
  the upsampler has no re-init after it), rgb blur-upsample, two skip
  concatenations scaled by 2^-0.5 (resized, and repeated along the batch,
  where a stage that did not downsample meets the upsampled path),
  progressive rgbs from ``mid_to_rgb``;
- video: temporal AdaptiveConv1D resnet blocks and temporal attention with
  space folded into the batch, temporal (pixel-shuffle) upsampling;
- ``return_all_rgbs`` keeps the rgbs larger than the input and puts the
  true low-res input first; ``allowable_rgb_resolutions`` is what the
  trainer checks the discriminator's multiscale resolutions against.

Every reshape names its sizes: a -1 cannot be solved on the empty
high-frequency maps of the stages that skip their downsampling.
"""

from __future__ import annotations

from collections.abc import Mapping
from math import log2
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from gigagan_tpu_torch import ops
from gigagan_tpu_torch.models.conditioning import StyleNetwork, TextEncoder
from gigagan_tpu_torch.models.layers import (
    AdaptiveConv,
    Conv,
    CrossAttentionBlock,
    DiracConv1d,
    FeedForward,
    ICNRDense,
    PixelShuffleUpsample,
    RMSNorm,
    conv1x1,
)
from gigagan_tpu_torch.parallel import dist
from gigagan_tpu_torch.utils import (
    ModTable,
    default,
    exists,
    is_power_of_two,
    span,
)


def _fold_time(x):
    """(b, t, h, w, c) → (b·t, h, w, c)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _split_time(x, batch: int):
    """(b·t, ...) → (b, t, ...)."""
    return x.reshape(batch, x.shape[0] // batch, *x.shape[1:])


def _fold_space(x):
    """(b, t, h, w, c) → (b·h·w, t, c) and (b, h, w)."""
    b, t, h, w, c = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c), (b, h, w)


def _unfold_space(x, dims):
    b, h, w = dims
    t, c = x.shape[-2:]
    return x.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)


class UpsamplerDownsample(nn.Module):
    """conv (+ identity-init temporal conv) → blur → HF residual → max
    pool; returns (downsampled, hf residual)."""

    def __init__(self, dim_in: int, dim_out: int,
                 skip_downsample: bool = False,
                 has_temporal_layers: bool = False, dtype=torch.float32):
        super().__init__()
        self.skip_downsample = skip_downsample
        self.conv2d = Conv(dim_in, dim_out, kernel=3, dtype=dtype)
        self.conv1d = (DiracConv1d(dim_out, dim_out, dtype=dtype)
                       if has_temporal_layers else None)

    def forward(self, x):
        # x: (b, h, w, c) image or (b, t, h, w, c) video
        is_video = x.dim() == 5
        assert not (is_video and self.conv1d is None)
        batch = x.shape[0]
        if is_video:
            x = _fold_time(x)
        x = self.conv2d(x)
        if is_video:
            flat, dims = _fold_space(_split_time(x, batch))
            x = _unfold_space(self.conv1d(flat), dims)
        return ops.downsample_hf_shuttle(
            x, is_video=is_video, skip_downsample=self.skip_downsample)


class TemporalUpsample(nn.Module):
    """2x linear interpolation along time, then the temporal blur.
    Parameter-free."""

    def forward(self, x):
        assert x.dim() == 5
        t = x.shape[1]
        flat, dims = _fold_space(x)
        flat = ops.interpolate_1d(flat, t * 2)
        return ops.blur_temporal(_unfold_space(flat, dims))


class PixelShuffleTemporalUpsample(nn.Module):
    """1x1x1 conv to 2x the channels, SiLU, shuffle into time; ICNR-2
    init."""

    def __init__(self, dim: int, dim_out: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        dim_out = default(dim_out, dim)
        self.conv = ICNRDense(dim, dim_out * 2, factor=2, dtype=dtype)

    def forward(self, x):
        assert x.dim() == 5
        return ops.pixel_shuffle_temporal(F.silu(self.conv(x)), 2)


class Block(nn.Module):
    """AdaptiveConv → RMSNorm → SiLU."""

    def __init__(self, dim_in: int, dim_out: int, num_conv_kernels: int = 0,
                 rank: int = 2, dtype=torch.float32):
        super().__init__()
        self.proj = AdaptiveConv(dim_in, dim_out, kernel=3,
                                 num_conv_kernels=max(num_conv_kernels, 1),
                                 rank=rank, dtype=dtype)
        self.norm = RMSNorm(dim_out)

    def forward(self, x, mod=None, kernel_mod=None):
        return F.silu(self.norm(self.proj(x, mod=mod, kernel_mod=kernel_mod)))


class ResnetBlock(nn.Module):
    """Two modulated Blocks and a 1x1 residual; reads four mod-table slots
    (mod1, kernel mod1, mod2, kernel mod2).  ``rank=1`` for the temporal
    blocks, on (b·h·w, t, c)."""

    def __init__(self, dim_in: int, dim_out: int, num_conv_kernels: int = 0,
                 rank: int = 2, dtype=torch.float32):
        super().__init__()
        self.block1 = Block(dim_in, dim_out, num_conv_kernels, rank, dtype)
        self.block2 = Block(dim_out, dim_out, num_conv_kernels, rank, dtype)
        self.res_conv = (conv1x1(dim_in, dim_out, dtype=dtype)
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
    """Linear attention on feature maps through ``ops.linear_attend_fused``
    (the kernel for a call on the card that needs no gradient, else plain
    PyTorch)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hidden = dim_head * heads
        self.norm = RMSNorm(dim)
        self.to_qkv = conv1x1(dim, hidden * 3, bias=False, dtype=dtype)
        self.to_out = conv1x1(hidden, dim, dtype=dtype)
        self.out_norm = RMSNorm(dim)

    def forward(self, x):
        b, h, w, _ = x.shape
        hidden = self.dim_head * self.heads
        q, k, v = (t.reshape(b, h * w, hidden)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        with span("gigagan.up.linear_attn"):
            out = ops.linear_attend_fused(q, k, v, heads=self.heads,
                                          scale=self.dim_head ** -0.5)
        return self.out_norm(self.to_out(out.reshape(b, h, w, hidden)))


class Attention2D(nn.Module):
    """Full softmax attention on feature maps, dot product with no null
    token, through ``ops.attend_fused`` (K3 → K4 → K5 on the card)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hidden = dim_head * heads
        self.norm = RMSNorm(dim)
        self.to_qkv = conv1x1(dim, hidden * 3, bias=False, dtype=dtype)
        self.to_out = conv1x1(hidden, dim, dtype=dtype)

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

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 depth: int = 1, ff_mult: int = 4, linear: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.depth = depth
        attn_klass = LinearAttention2D if linear else Attention2D
        for i in range(depth):
            self.add_module(f"attn_{i}", attn_klass(
                dim, heads=heads, dim_head=dim_head, dtype=dtype))
            self.add_module(f"ff_{i}", FeedForward(dim, mult=ff_mult,
                                                   dtype=dtype))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(x) + x
            x = getattr(self, f"ff_{i}")(x) + x
        return x


class _Stage(nn.Module):
    """One down or up stage; absent parts are None."""

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
        out_dim: Optional[int] = None,
        text_encoder: Optional[Union[TextEncoder, Dict]] = None,
        style_network: Optional[Union[StyleNetwork, Dict]] = None,
        style_network_dim: Optional[int] = None,
        dim_mults: Tuple[int, ...] = (1, 2, 4, 8, 16),
        channels: int = 3,
        full_attn: Tuple[bool, ...] = (False, False, False, True, True),
        cross_attn: Tuple[bool, ...] = (False, False, False, True, True),
        flash_attn: bool = True,
        self_attn_dim_head: int = 64,
        self_attn_heads: int = 8,
        self_attn_dot_product: bool = True,
        self_attn_ff_mult: int = 4,
        attn_depths: Tuple[int, ...] = (1, 1, 1, 1, 1),
        temporal_attn_depths: Tuple[int, ...] = (1, 1, 1, 1, 1),
        cross_attn_dim_head: int = 64,
        cross_attn_heads: int = 8,
        cross_ff_mult: int = 4,
        has_temporal_layers: bool = False,
        mid_attn_depth: int = 1,
        num_conv_kernels: int = 2,
        unconditional: bool = True,
        skip_connect_scale: Optional[float] = None,
        dtype=torch.float32,
    ):
        super().__init__()
        if isinstance(style_network, Mapping):
            style_network = StyleNetwork(**style_network)
        if isinstance(text_encoder, Mapping):
            text_encoder = TextEncoder(**text_encoder)
        self.style_net = style_network
        self.text_enc = text_encoder
        assert exists(self.style_net) ^ exists(style_network_dim)
        assert unconditional ^ exists(self.text_enc)
        assert not (unconditional and exists(self.style_net)
                    and self.style_net.dim_text_latent > 0)
        assert unconditional or (
            self.text_enc.dim == self.style_net.dim_text_latent)
        assert is_power_of_two(image_size) and is_power_of_two(
            input_image_size)
        assert input_image_size < image_size

        self.dim = dim
        self.image_size = image_size
        self.input_image_size = input_image_size
        self.channels = channels
        self.unconditional = unconditional
        self.has_temporal_layers = has_temporal_layers
        self.dtype = dtype
        self.style_network_dim = default(
            style_network_dim,
            self.style_net.dim if exists(self.style_net) else None)

        num_layer_no_downsample = int(log2(image_size)
                                      - log2(input_image_size))
        assert num_layer_no_downsample <= len(dim_mults), (
            "you need more stages in this unet for the level of upsampling")

        init_dim = default(init_dim, dim)
        dims = [init_dim, *(dim * m for m in dim_mults)]
        mid_dim = dims[-1]
        in_out = list(zip(dims[:-1], dims[1:]))
        assert len(full_attn) == len(dim_mults)
        self.skip_scale = default(skip_connect_scale, 2 ** -0.5)

        k = num_conv_kernels
        split_dims = []

        def resnet(dim_in, dim_out, rank=2):
            split_dims.extend(ResnetBlock.mod_dims(dim_in, dim_out, k))
            return ResnetBlock(dim_in, dim_out, num_conv_kernels=k,
                               rank=rank, dtype=dtype)

        def transformer(d, depth, linear=False, dim_head=self_attn_dim_head):
            return UpsamplerTransformer(d, dim_head=dim_head,
                                        heads=self_attn_heads, depth=depth,
                                        linear=linear, dtype=dtype)

        def cross(d, ff_mult):
            return CrossAttentionBlock(
                d, self.text_enc.dim, dim_head=self_attn_dim_head,
                heads=self_attn_heads, ff_mult=ff_mult, dtype=dtype)

        temporal = has_temporal_layers
        self.init_conv = Conv(channels, init_dim, kernel=7, dtype=dtype)

        downs = []
        skip_connect_dims = []
        for ind, ((dim_in, dim_out), layer_full, layer_cross, depth,
                  t_depth) in enumerate(zip(in_out, full_attn, cross_attn,
                                            attn_depths,
                                            temporal_attn_depths)):
            no_downsample = ind < num_layer_no_downsample
            has_cross = not unconditional and layer_cross
            skip_connect_dims.append(dim_in)
            skip_connect_dims.append(
                dim_in + (dim_out if not no_downsample else 0))
            # slots in the order the forward reads them: block1, block2,
            # then the temporal block
            block1, block2 = resnet(dim_in, dim_in), resnet(dim_in, dim_in)
            downs.append(_Stage(
                block1=block1, block2=block2,
                cross_attn=(cross(dim_in, self_attn_ff_mult) if has_cross
                            else None),
                attn=transformer(dim_in, depth, linear=not layer_full),
                temporal_block=(resnet(dim_in, dim_in, rank=1) if temporal
                                else None),
                temporal_attn=(transformer(dim_in, t_depth) if temporal
                               else None),
                downsample=UpsamplerDownsample(
                    dim_in, dim_out, skip_downsample=no_downsample,
                    has_temporal_layers=temporal, dtype=dtype),
            ))
        self.downs = nn.ModuleList(downs)

        self.mid_block1 = resnet(mid_dim, mid_dim)
        self.mid_attn = transformer(mid_dim, mid_attn_depth)
        self.mid_block2 = resnet(mid_dim, mid_dim)
        self.mid_to_rgb = conv1x1(mid_dim, channels, dtype=dtype)

        ups = []
        for (dim_in, dim_out), layer_full, layer_cross, depth, t_depth in zip(
                reversed(in_out), reversed(full_attn), reversed(cross_attn),
                reversed(attn_depths), reversed(temporal_attn_depths)):
            has_cross = not unconditional and layer_cross
            block1 = resnet(dim_in + skip_connect_dims.pop(), dim_in)
            block2 = resnet(dim_in + skip_connect_dims.pop(), dim_in)
            ups.append(_Stage(
                upsample=PixelShuffleUpsample(dim_out, dim_in, dtype=dtype),
                temporal_upsample=(PixelShuffleTemporalUpsample(
                    dim_in, dtype=dtype) if temporal else None),
                temporal_upsample_rgb=(TemporalUpsample() if temporal
                                       else None),
                to_rgb=conv1x1(dim_in, channels, dtype=dtype),
                block1=block1, block2=block2,
                cross_attn=(cross(dim_in, cross_ff_mult) if has_cross
                            else None),
                attn=transformer(dim_in, depth, linear=not layer_full,
                                 dim_head=cross_attn_dim_head),
                temporal_block=(resnet(dim_in, dim_in, rank=1) if temporal
                                else None),
                temporal_attn=(transformer(dim_in, t_depth) if temporal
                               else None),
            ))
        self.ups = nn.ModuleList(ups)

        self.final_res_block = resnet(dim, dim)
        self.final_to_rgb = conv1x1(dim, channels, dtype=dtype)

        self.style_embed_split_dims = tuple(split_dims)
        self.style_to_conv_modulations = conv1x1(
            self.style_network_dim, sum(split_dims), dtype=dtype)

    @property
    def allowable_rgb_resolutions(self):
        """The sizes of the rgbs ``return_all_rgbs`` gives, the output's
        excepted: the discriminator's multiscale inputs must be among
        them."""
        lo = int(log2(self.input_image_size))
        hi = int(log2(self.image_size))
        return [2 ** p for p in range(lo, hi)]

    @property
    def can_upsample_video(self):
        return self.has_temporal_layers

    def _temporal(self, x, batch, stage, mods):
        """The stage's temporal resnet block and temporal attention, with
        space folded into the batch (the attention sees t as a 1-wide
        map)."""
        flat, dims = _fold_space(_split_time(x, batch))  # (b·h·w, t, c)
        flat = stage.temporal_block(flat, mods)
        flat = stage.temporal_attn(flat[:, :, None, :])[:, :, 0, :]
        return _fold_time(_unfold_space(flat, dims))

    def forward(self, *args, **kwargs):
        """``_forward`` inside the ``gigagan.up.generator`` span."""
        with span("gigagan.up.generator"):
            return self._forward(*args, **kwargs)

    def _forward(self, lowres_image=None, *, lowres_image_or_video=None,
                 styles=None, noise=None, text_encodings=None,
                 global_text_tokens=None, fine_text_tokens=None,
                 text_mask=None, return_all_rgbs: bool = False,
                 latent_generator=None):
        """``lowres_image`` (b, h, w, c) or, with temporal layers, a video
        (b, t, h, w, c) at ``input_image_size``.  ``noise`` is the style
        latent (b, style_network_dim); without it (and without ``styles``)
        it is drawn from ``latent_generator``.  Conditional: CLIP
        ``text_encodings``, or the text encoder's (``global_text_tokens``,
        ``fine_text_tokens``, ``text_mask``).  Returns the (b[, t'], H, W,
        c) output, and with ``return_all_rgbs`` the rgbs larger than the
        input, the input first."""
        x = default(lowres_image, lowres_image_or_video)
        assert exists(x), "lowres_image(_or_video) must be given"
        shape = x.shape
        batch = shape[0]
        assert shape[-3] == shape[-2] == self.input_image_size
        is_video = x.dim() == 5
        assert not (is_video and not self.can_upsample_video), (
            "set has_temporal_layers=True to upsample video")

        if not self.unconditional:
            if exists(text_encodings):
                global_text_tokens, fine_text_tokens, text_mask = (
                    self.text_enc(text_encodings))
            else:
                assert all(map(exists, (global_text_tokens, fine_text_tokens,
                                        text_mask)))
        else:
            assert not any(map(exists, (text_encodings, global_text_tokens,
                                        fine_text_tokens)))

        if not exists(styles):
            assert exists(self.style_net)
            if not exists(noise):
                noise = dist.randn((batch, self.style_network_dim),
                                    generator=latent_generator,
                                    device=x.device, dtype=self.dtype)
            styles = self.style_net(noise, global_text_tokens)
        mods = ModTable(self.style_to_conv_modulations(styles),
                        self.style_embed_split_dims)

        x = x.to(self.dtype)
        if is_video:
            x = _fold_time(x)
        lowres_images = x
        x = self.init_conv(x)

        h = []
        for stage in self.downs:
            x = stage.block1(x, mods)
            h.append(x)
            x = stage.block2(x, mods)
            x = stage.attn(x)
            if exists(stage.cross_attn):
                x = stage.cross_attn(x, fine_text_tokens, mask=text_mask)
            if is_video:
                x = self._temporal(x, batch, stage, mods)
            elif self.can_upsample_video:
                mods.skip(4)  # an image through a video-capable net
            skip_connect = x
            xs, hf = stage.downsample(_split_time(x, batch) if is_video
                                      else x)
            if is_video:
                xs, hf = _fold_time(xs), _fold_time(hf)
            x = xs
            h.append(torch.cat((skip_connect, hf), dim=-1))

        x = self.mid_block1(x, mods)
        x = self.mid_attn(x)
        x = self.mid_block2(x, mods)

        rgb = self.mid_to_rgb(x)
        rgbs = [rgb]
        for stage in self.ups:
            x = stage.upsample(x)
            rgb = ops.upsample_2x_blur(rgb)
            if is_video:
                x = _fold_time(stage.temporal_upsample(_split_time(x, batch)))
                rgb = _fold_time(stage.temporal_upsample_rgb(
                    _split_time(rgb, batch)))

            res1 = h.pop() * self.skip_scale
            res2 = h.pop() * self.skip_scale
            # a stage that did not downsample meets the upsampled path
            if (x.shape[0] != res1.shape[0]
                    or x.shape[1:3] != res1.shape[1:3]):
                res1 = ops.resize_image_to(res1, x.shape[1])
                res2 = ops.resize_image_to(res2, x.shape[1])
                if x.shape[0] != res1.shape[0]:
                    reps = x.shape[0] // res1.shape[0]
                    res1 = torch.repeat_interleave(res1, reps, dim=0)
                    res2 = torch.repeat_interleave(res2, reps, dim=0)

            x = stage.block1(torch.cat((x, res1), dim=-1), mods)
            x = stage.block2(torch.cat((x, res2), dim=-1), mods)
            if exists(stage.cross_attn):
                x = stage.cross_attn(x, fine_text_tokens, mask=text_mask)
            x = stage.attn(x)
            if is_video:
                x = self._temporal(x, batch, stage, mods)
            elif self.can_upsample_video:
                mods.skip(4)
            rgb = rgb + stage.to_rgb(x)
            rgbs.append(rgb)

        x = self.final_res_block(x, mods)
        mods.assert_exhausted()
        rgb = rgb + self.final_to_rgb(x)
        if is_video:
            rgb = _split_time(rgb, batch)
        if not return_all_rgbs:
            return rgb

        rgbs = [lowres_images, *(t for t in rgbs if t.shape[-2] > shape[-2])]
        if is_video:
            rgbs = [_split_time(t, batch) for t in rgbs]
        return rgb, rgbs
