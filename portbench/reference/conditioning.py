"""The reference's style mapping network and text encoder: a frozen copy of
the port's (``gigagan_tpu_torch/models/conditioning.py``).

CLIP itself lives outside the generator and the discriminator (it is
frozen): their text encoders take the adapter's precomputed token
encodings."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import (
    EqualLinear,
    Transformer,
    conv1x1,
    l2norm,
    leaky_relu,
)
from portbench.reference.utils import exists


class StyleNetwork(nn.Module):
    """l2-normalise the latent, concatenate the global text latent when
    ``dim_text_latent > 0``, then depth × (EqualLinear lr_mul → leaky)."""

    def __init__(self, dim: int, depth: int, lr_mul: float = 0.1,
                 dim_text_latent: int = 0):
        super().__init__()
        self.dim = dim
        self.depth = depth
        self.dim_text_latent = dim_text_latent
        for i in range(depth):
            dim_in = dim + dim_text_latent if i == 0 else dim
            self.add_module(f"linear_{i}",
                            EqualLinear(dim_in, dim, lr_mul=lr_mul))

    def forward(self, x, text_latent=None):
        x = l2norm(x)
        if self.dim_text_latent > 0:
            assert exists(text_latent), (
                "text_latent must be given when dim_text_latent > 0"
            )
            x = torch.cat((x, text_latent.to(x.dtype)), dim=-1)
        for i in range(self.depth):
            x = leaky_relu(getattr(self, f"linear_{i}")(x))
        return x


class TextEncoder(nn.Module):
    """Frozen-CLIP token encodings → (global token (b, dim), fine tokens
    (b, n, dim), mask (b, n)): project_in, a learned global token in front,
    the Transformer over both, split back."""

    def __init__(self, dim: int, depth: int, clip_dim: int = 512,
                 dim_head: int = 64, heads: int = 8, dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.clip_dim = clip_dim
        self.dtype = dtype
        self.project_in = (conv1x1(clip_dim, dim, dtype=dtype)
                           if clip_dim != dim else None)
        self.learned_global_token = nn.Parameter(torch.empty(dim))
        self.transformer = Transformer(dim, depth, dim_head=dim_head,
                                       heads=heads, dtype=dtype)

    def reset_own_parameters(self, draws):
        draws.normal_(self.learned_global_token)

    def forward(self, text_encodings, mask=None):
        b = text_encodings.shape[0]
        # any-nonzero per token, before any cast: the adapter zeroes the
        # encodings past EOS
        if not exists(mask):
            mask = (text_encodings != 0.0).any(dim=-1)
        x = text_encodings.to(self.dtype)
        if exists(self.project_in):
            x = self.project_in(x)
        glob = self.learned_global_token.to(x.dtype).expand(b, 1, self.dim)
        x = torch.cat((glob, x), dim=1)
        x = self.transformer(x, mask=F.pad(mask, (1, 0), value=True))
        return x[:, 0], x[:, 1:], mask
