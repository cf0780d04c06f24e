"""The reference's initial weights: the port's distributions (kaiming
normal on fan_in with gain √2 for Dense, conv and bank kernels; N(0, 1)
for equalized linears, null tokens and the text encoder's global token;
N(0, 0.02) for G's init block; zero biases and noise weights; unit norm
gains; CLIP as the JAX package initialises it), drawn from ONE standard
normal of every weight's length, made on the device from a seed."""

from __future__ import annotations

import math

import torch


class FlatDraws:
    """Standard normal draws for a whole set of modules, made in one call
    and handed out in slices, in the order the modules' parameters are
    visited."""

    def __init__(self, total: int, seed: int, device):
        g = torch.Generator(device=device).manual_seed(int(seed))
        self.z = torch.randn(int(total), generator=g, device=device)
        self.offset = 0

    @torch.no_grad()
    def normal_(self, t, mean: float = 0.0, std: float = 1.0):
        n = t.numel()
        assert self.offset + n <= self.z.numel(), "draws exhausted"
        t.copy_(self.z[self.offset:self.offset + n].view(t.shape) * std
                + mean)
        self.offset += n
        return t


def _fan_in(shape, layout: str) -> int:
    if layout == "linear":  # (out, in)
        return shape[1]
    if layout == "bank":  # (n, *spatial, in, out)
        return shape[-2] * math.prod(shape[1:-2])
    if layout == "oihw":  # (out, in, *spatial)
        return shape[1] * math.prod(shape[2:])
    raise ValueError(layout)


def kaiming_normal_leaky_(tensor, layout: str, draws: FlatDraws):
    """N(0, 2/fan_in)."""
    std = math.sqrt(2.0) / math.sqrt(max(_fan_in(tensor.shape, layout), 1))
    return draws.normal_(tensor, 0.0, std)


def init_modules(modules, seed: int, device):
    """Draw every parameter and buffer of ``modules`` (each module's own
    ``reset_own_parameters(draws)``, CLIP's ``reset_parameters(draws)``)."""
    total = sum(t.numel() for m in modules
                for t in (*m.parameters(), *m.buffers()))
    draws = FlatDraws(total, seed, device)
    for module in modules:
        for m in module.modules():
            reset = getattr(m, "reset_own_parameters", None)
            if reset is not None:
                reset(draws)
        reset = getattr(module, "reset_parameters", None)
        if reset is not None:
            reset(draws)
    return draws
