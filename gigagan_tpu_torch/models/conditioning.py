"""Style mapping network (counterpart of ``StyleNetwork`` in
gigagan_tpu/models/conditioning.py), unconditional: the text latent input
and the text encoder come with the conditional path (ROADMAP.md)."""

from __future__ import annotations

from torch import nn

from gigagan_tpu_torch.models.layers import EqualLinear, l2norm, leaky_relu


class StyleNetwork(nn.Module):
    """l2-normalise the latent, then depth × (EqualLinear lr_mul → leaky)."""

    def __init__(self, dim: int, depth: int, lr_mul: float = 0.1):
        super().__init__()
        self.dim = dim
        self.depth = depth
        for i in range(depth):
            self.add_module(f"linear_{i}", EqualLinear(dim, dim, lr_mul=lr_mul))

    def forward(self, x):
        x = l2norm(x)
        for i in range(self.depth):
            x = leaky_relu(getattr(self, f"linear_{i}")(x))
        return x
