"""The reference's vision-aided discriminator: light heads over frozen-CLIP
feature taps (a frozen copy of ``gigagan_tpu_torch/models/vision_aided.py``).

CLIP runs outside this module: it takes the (L, b, 1+n, d) tap stack of
``OpenClipAdapter.embed_images``, so only the heads are trainable.  With
text conditioning ``text_dim`` defaults to CLIP's *text* embed dim, the
embeds it is fed (the JAX package's fix of the reference, whose default
is the image width)."""

from __future__ import annotations

from math import sqrt
from typing import Optional, Tuple

import torch
from torch import nn

from portbench.reference.layers import (
    AdaptiveConv,
    RandomFixedProjection,
    conv1x1,
    conv3x3,
)
from portbench.reference.utils import default, exists


class VisionAidedDiscriminator(nn.Module):
    """Per tap: the class token pooled into the patch tokens, a frozen
    random projection, a conditional adaptive conv (or an unconditional
    3x3 conv), 3x3 logits."""

    def __init__(self, depth: int = 2, dim_head: int = 64, heads: int = 8,
                 clip_image_dim: int = 768, clip_text_dim: int = 512,
                 layer_indices: Tuple[int, ...] = (-1, -2, -3),
                 conv_dim: Optional[int] = None,
                 text_dim: Optional[int] = None, unconditional: bool = False,
                 num_conv_kernels: int = 2, dtype=torch.float32):
        super().__init__()
        conv_dim = default(conv_dim, clip_image_dim)
        self.text_dim = default(text_dim, clip_text_dim)
        self.layer_indices = tuple(layer_indices)
        self.unconditional = unconditional
        self.dtype = dtype
        for i in range(len(self.layer_indices)):
            self.add_module(f"rand_proj_{i}", RandomFixedProjection(
                clip_image_dim, conv_dim, dtype=dtype))
            if unconditional:
                self.add_module(f"conv_{i}", conv3x3(conv_dim, conv_dim,
                                                     dtype=dtype))
            else:
                self.add_module(f"to_conv_mod_{i}", conv1x1(
                    self.text_dim, conv_dim, dtype=dtype))
                self.add_module(f"to_conv_kernel_mod_{i}", conv1x1(
                    self.text_dim, num_conv_kernels, dtype=dtype))
                self.add_module(f"conv_{i}", AdaptiveConv(
                    conv_dim, conv_dim, kernel=3,
                    num_conv_kernels=num_conv_kernels, dtype=dtype))
            self.add_module(f"to_logits_{i}", conv3x3(conv_dim, 1,
                                                      dtype=dtype))

    def forward(self, image_encodings, text_embeds=None):
        """image_encodings: (L, b, 1+n, d) CLIP visual taps → one logit map
        (b, h, w) per tap of ``layer_indices``."""
        assert self.unconditional or exists(text_embeds)
        if exists(text_embeds):
            assert text_embeds.shape[-1] == self.text_dim
        logits = []
        for i, layer_index in enumerate(self.layer_indices):
            encoding = image_encodings[layer_index]
            cls_token, rest = encoding[:, :1], encoding[:, 1:]
            hw = int(sqrt(rest.shape[-2]))
            assert hw * hw == rest.shape[-2], "expected square patch grid"
            fmap = rest.reshape(rest.shape[0], hw, hw, rest.shape[-1])
            fmap = (fmap + cls_token[:, :, None, :]).to(self.dtype)
            fmap = getattr(self, f"rand_proj_{i}")(fmap)
            conv = getattr(self, f"conv_{i}")
            if self.unconditional:
                fmap = conv(fmap)
            else:
                fmap = conv(fmap,
                            mod=getattr(self, f"to_conv_mod_{i}")(text_embeds),
                            kernel_mod=getattr(
                                self, f"to_conv_kernel_mod_{i}")(text_embeds))
            logits.append(getattr(self, f"to_logits_{i}")(fmap)[..., 0])
        return logits
