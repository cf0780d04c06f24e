"""The base synthesis Generator (counterpart of
gigagan_tpu/models/generator.py with the same config keys).

- learned 4x4 init block + init adaptive conv;
- channel schedule 2^(i+1)·dim_capacity clamped to dim_max, reversed,
  prepended with dim_latent;
- ONE projection of the style vector to every layer's modulation and
  kernel selection, consumed in order through ``ModTable``;
- skip-layer squeeze-excitation push/pop gating;
- per stage: upsample (bilinear + blur, or ``PixelShuffleUpsample`` with
  ``pixel_shuffle_upsample``) → excite → 2×(adaptive conv + noise + leaky) →
  self-attn? → cross-attn to the text tokens? → to_rgb (no demod); rgb
  accumulated, then upsampled;
- conditional (``unconditional=False``): the TextEncoder turns CLIP token
  encodings into a global token, which the style network takes beside the
  latent, and fine tokens, which the cross-attention blocks attend to;
- ``return_all_rgbs`` collects the per-stage accumulated rgbs.

``s2d_trunk`` is accepted for config compatibility and computes the dense
form: the JAX package's space-to-depth trunk has identical parameters and
exact math, and exists only for the TPU's lane layout.
"""

from __future__ import annotations

from collections.abc import Mapping
from math import log2
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from gigagan_tpu_torch.models.conditioning import StyleNetwork, TextEncoder
from gigagan_tpu_torch.models.layers import (
    AdaptiveConv,
    CrossAttentionBlock,
    Noise,
    PixelShuffleUpsample,
    SelfAttentionBlock,
    SqueezeExcite,
    Upsample,
    conv1x1,
    leaky_relu,
)
from gigagan_tpu_torch.parallel import dist
from gigagan_tpu_torch.utils import ModTable, default, exists, is_power_of_two



class _Stage(nn.Module):
    def __init__(self, *, dim_in, dim_out, channels, num_conv_kernels,
                 upsample, upsample_rgb, dim_excite, self_attn, cross_attn,
                 pixel_shuffle, dtype):
        super().__init__()

        def make_upsample(dim):
            # the reference's post-init kaiming pass overwrites ICNR inside
            # the generator, so the JAX generator passes use_icnr=False
            if pixel_shuffle:
                return PixelShuffleUpsample(dim, use_icnr=False, dtype=dtype)
            return Upsample()

        self.upsample = make_upsample(dim_in) if upsample else None
        self.upsample_rgb = make_upsample(channels) if upsample_rgb else None
        self.squeeze_excite = (
            SqueezeExcite(dim_in, dim_excite, dtype=dtype)
            if exists(dim_excite) else None
        )
        self.conv1 = AdaptiveConv(dim_in, dim_out, kernel=3,
                                  num_conv_kernels=num_conv_kernels,
                                  dtype=dtype)
        self.noise1 = Noise(dim_out)
        self.conv2 = AdaptiveConv(dim_out, dim_out, kernel=3,
                                  num_conv_kernels=num_conv_kernels,
                                  dtype=dtype)
        self.noise2 = Noise(dim_out)
        self.to_rgb = AdaptiveConv(dim_out, channels, kernel=1,
                                   num_conv_kernels=1, demod=False,
                                   dtype=dtype)
        self.self_attn = self_attn
        self.cross_attn = cross_attn


class Generator(nn.Module):
    def __init__(
        self,
        image_size: int,
        dim_capacity: int = 16,
        dim_max: int = 2048,
        channels: int = 3,
        style_network: Optional[Union[StyleNetwork, Dict]] = None,
        style_network_dim: Optional[int] = None,
        text_encoder=None,
        dim_latent: int = 512,
        self_attn_resolutions: Tuple[int, ...] = (32, 16),
        self_attn_dim_head: int = 64,
        self_attn_heads: int = 8,
        self_attn_dot_product: bool = True,
        self_attn_ff_mult: int = 4,
        cross_attn_resolutions: Tuple[int, ...] = (32, 16),
        cross_attn_dim_head: int = 64,
        cross_attn_heads: int = 8,
        cross_attn_ff_mult: int = 4,
        num_conv_kernels: int = 2,
        num_skip_layers_excite: int = 0,
        unconditional: bool = False,
        pixel_shuffle_upsample: bool = False,
        s2d_trunk: bool = True,
        dtype=torch.float32,
    ):
        super().__init__()
        assert is_power_of_two(image_size)

        self.image_size = image_size
        self.channels = channels
        self.dim_latent = dim_latent
        self.num_skip_layers_excite = num_skip_layers_excite
        self.dtype = dtype

        if isinstance(style_network, Mapping):
            style_network = StyleNetwork(**style_network)
        if isinstance(text_encoder, Mapping):
            text_encoder = TextEncoder(**text_encoder)
        self.style_net = style_network
        self.text_enc = text_encoder
        self.unconditional = unconditional
        assert exists(self.style_net) ^ exists(style_network_dim), (
            "style_network_dim must be given to the generator if "
            "StyleNetwork not passed in"
        )
        self.style_network_dim = default(
            style_network_dim,
            self.style_net.dim if exists(self.style_net) else None,
        )
        assert not (unconditional and exists(self.text_enc))
        assert not (unconditional and exists(self.style_net)
                    and self.style_net.dim_text_latent > 0)
        assert unconditional or (
            exists(self.text_enc)
            and self.text_enc.dim == self.style_net.dim_text_latent
        ), (
            "the `dim_text_latent` on your StyleNetwork must equal the "
            "`dim` of the TextEncoder"
        )

        num_layers = int(log2(image_size) - 1)
        is_adaptive = num_conv_kernels > 1
        dim_kernel_mod = num_conv_kernels if is_adaptive else 0

        resolutions = [image_size // (2 ** i)
                       for i in reversed(range(num_layers))]
        dim_layers = [min(2 ** (i + 1) * dim_capacity, dim_max)
                      for i in range(num_layers)]
        dim_layers = [dim_latent, *reversed(dim_layers)]
        dim_pairs = list(zip(dim_layers[:-1], dim_layers[1:]))

        split_dims = [dim_latent, dim_kernel_mod]

        self.init_block = nn.Parameter(torch.empty(4, 4, dim_latent))
        self.init_conv = AdaptiveConv(dim_latent, dim_latent, kernel=3,
                                      num_conv_kernels=num_conv_kernels,
                                      dtype=dtype)

        stages = []
        for ind, ((dim_in, dim_out), resolution) in enumerate(
            zip(dim_pairs, resolutions)
        ):
            excite = (
                num_skip_layers_excite > 0
                and ind + num_skip_layers_excite < len(dim_pairs)
            )
            self_attn = (
                SelfAttentionBlock(
                    dim_out, dim_head=self_attn_dim_head,
                    heads=self_attn_heads, ff_mult=self_attn_ff_mult,
                    dot_product=self_attn_dot_product, dtype=dtype,
                )
                if resolution in self_attn_resolutions else None
            )
            cross_attn = (
                CrossAttentionBlock(
                    dim_out, self.text_enc.dim, dim_head=cross_attn_dim_head,
                    heads=cross_attn_heads, ff_mult=cross_attn_ff_mult,
                    dtype=dtype,
                )
                if resolution in cross_attn_resolutions and not unconditional
                else None
            )
            stages.append(_Stage(
                dim_in=dim_in, dim_out=dim_out, channels=channels,
                num_conv_kernels=num_conv_kernels,
                upsample=ind > 0,
                upsample_rgb=ind + 1 < len(dim_pairs),
                dim_excite=(dim_pairs[ind + num_skip_layers_excite][0]
                            if excite else None),
                self_attn=self_attn, cross_attn=cross_attn,
                pixel_shuffle=pixel_shuffle_upsample,
                dtype=dtype,
            ))
            split_dims.extend([
                dim_in,          # conv1 modulation
                dim_kernel_mod,  # conv1 kernel selection
                dim_out,         # conv2 modulation
                dim_kernel_mod,  # conv2 kernel selection
                dim_out,         # to_rgb modulation
                0,               # to_rgb has no kernel selection
            ])
        self.stages = nn.ModuleList(stages)
        self.style_embed_split_dims = tuple(split_dims)
        self.style_to_conv_modulations = conv1x1(
            self.style_network_dim, sum(split_dims), dtype=dtype
        )

    def reset_own_parameters(self, generator=None):
        self.init_block.data.normal_(0.0, 0.02, generator=generator)

    def forward(self, styles=None, noise=None, text_encodings=None,
                global_text_tokens=None, fine_text_tokens=None,
                text_mask=None, batch_size: int = 1,
                return_all_rgbs: bool = False, latent_generator=None,
                noise_generator=None, pixel_noise=None):
        """``noise`` is the style latent (b, style_network_dim); without it
        the latent is drawn from ``latent_generator``, one per text when
        conditional.  Pixel noise comes from ``pixel_noise`` (one (b, h, w,
        1) tensor per Noise layer, in call order) or is drawn from
        ``noise_generator``.  Conditional: CLIP ``text_encodings`` (b, n,
        clip_dim), or the text encoder's (``global_text_tokens``,
        ``fine_text_tokens``, ``text_mask``)."""
        if not self.unconditional:
            if exists(text_encodings):
                assert exists(self.text_enc)
                global_text_tokens, fine_text_tokens, text_mask = (
                    self.text_enc(text_encodings))
            else:
                assert all(map(exists, (global_text_tokens, fine_text_tokens,
                                        text_mask))), (
                    "text encodings or tokens must be passed in for "
                    "conditional training")
        else:
            assert not any(map(exists, (text_encodings, global_text_tokens,
                                        fine_text_tokens)))
        pixel_noise = iter(pixel_noise) if exists(pixel_noise) else None

        def next_noise():
            return next(pixel_noise) if exists(pixel_noise) else None

        device = self.init_block.device
        if not exists(styles):
            assert exists(self.style_net)
            if not exists(noise):
                if exists(global_text_tokens):
                    batch_size = global_text_tokens.shape[0]
                noise = dist.randn(
                    (batch_size, self.style_network_dim),
                    generator=latent_generator, device=device,
                    dtype=self.dtype,
                )
            styles = self.style_net(noise, global_text_tokens)

        batch_size = styles.shape[0]
        conv_mods = ModTable(self.style_to_conv_modulations(styles),
                             self.style_embed_split_dims)

        x = self.init_block.to(self.dtype).expand(batch_size, 4, 4,
                                                  self.dim_latent)
        x = self.init_conv(x, mod=conv_mods.next(),
                           kernel_mod=conv_mods.next())
        rgb = torch.zeros((batch_size, 4, 4, self.channels), dtype=x.dtype,
                          device=device)

        excitations = [None] * self.num_skip_layers_excite
        rgbs = []
        for stage in self.stages:
            if exists(stage.upsample):
                x = stage.upsample(x)

            if exists(stage.squeeze_excite):
                excitations.append(stage.squeeze_excite(x))
            excite = excitations.pop(0) if excitations else None
            if exists(excite):
                x = x * excite

            x = stage.conv1(x, mod=conv_mods.next(),
                            kernel_mod=conv_mods.next())
            x = leaky_relu(stage.noise1(x, noise=next_noise(),
                                        generator=noise_generator))
            x = stage.conv2(x, mod=conv_mods.next(),
                            kernel_mod=conv_mods.next())
            x = leaky_relu(stage.noise2(x, noise=next_noise(),
                                        generator=noise_generator))

            if exists(stage.self_attn):
                x = stage.self_attn(x)
            if exists(stage.cross_attn):
                x = stage.cross_attn(x, fine_text_tokens, mask=text_mask)

            rgb = rgb + stage.to_rgb(x, mod=conv_mods.next(),
                                     kernel_mod=conv_mods.next())
            rgbs.append(rgb)
            if exists(stage.upsample_rgb):
                rgb = stage.upsample_rgb(rgb)

        conv_mods.assert_exhausted()
        if return_all_rgbs:
            return rgb, rgbs
        return rgb
