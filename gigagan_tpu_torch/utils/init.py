"""Weight initializers with the JAX package's distributions
(counterpart of gigagan_tpu/utils/init.py).

kaiming normal, fan_in, nonlinearity='leaky_relu' with a=0 (gain sqrt(2)),
for three parameter layouts:

- ``linear``: a torch ``nn.Linear`` weight ``(out, in)`` — the transpose of
  flax's ``(in, out)`` Dense kernel, same fan_in;
- ``conv``: ``(*spatial, in, out)`` (HWIO);
- ``bank``: ``(n, *spatial, in, out)`` adaptive-conv kernel banks, kept in
  the JAX layout so the weight bridge copies them as they are;
- ``oihw``: a torch conv weight ``(out, in, *spatial)`` — flax ``nn.Conv``'s
  HWIO kernel, transposed, same fan_in;

the ICNR init of a pixel-shuffle projection, and the identity ("dirac")
init of a 1-D conv.
"""

from __future__ import annotations

import math

import torch


def _fan_in_out(shape, layout: str):
    if layout == "linear":  # (out, in)
        fan_in, fan_out = shape[1], shape[0]
    elif layout == "conv":  # (*spatial, in, out)
        receptive = math.prod(shape[:-2])
        fan_in = shape[-2] * receptive
        fan_out = shape[-1] * receptive
    elif layout == "bank":  # (n, *spatial, in, out)
        receptive = math.prod(shape[1:-2])
        fan_in = shape[-2] * receptive
        fan_out = shape[-1] * receptive
    elif layout == "oihw":  # (out, in, *spatial)
        receptive = math.prod(shape[2:])
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    else:
        raise ValueError(layout)
    return fan_in, fan_out


@torch.no_grad()
def kaiming_normal_leaky_(tensor, layout: str = "conv", generator=None):
    """In place: N(0, 2/fan_in) drawn from ``generator``."""
    fan_in, _ = _fan_in_out(tensor.shape, layout)
    std = math.sqrt(2.0) / math.sqrt(max(fan_in, 1))
    return tensor.normal_(0.0, std, generator=generator)


@torch.no_grad()
def pixel_shuffle_icnr_(tensor, upsample_factor: int = 4, generator=None):
    """In place, ICNR init of a torch Linear weight ``(out, in)`` that feeds
    a pixel shuffle: a kaiming-uniform (a = √5, torch's default) kernel for
    out / r output channels, each row repeated r times in a row, so that
    the shuffle starts as a nearest-neighbour upsample (the JAX package's
    ``pixel_shuffle_icnr_init``, whose flax kernel ``(in, out)`` repeats
    along its last axis)."""
    out, fan_in = tensor.shape
    assert out % upsample_factor == 0
    # torch kaiming_uniform_'s default: gain sqrt(2 / (1 + 5)) = 1/sqrt(3)
    bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0) / math.sqrt(max(fan_in, 1))
    base = torch.empty(out // upsample_factor, fan_in, dtype=tensor.dtype,
                       device=tensor.device)
    base.uniform_(-bound, bound, generator=generator)
    return tensor.copy_(base.repeat_interleave(upsample_factor, dim=0))


@torch.no_grad()
def dirac_1d_(tensor):
    """In place: a torch conv1d weight ``(out, in, k)`` that starts as the
    identity, 1 at the centre tap where in == out (the JAX package's
    ``_dirac_1d_init`` of its ``(k, in, out)`` kernel)."""
    out, cin, k = tensor.shape
    tensor.zero_()
    n = min(out, cin)
    tensor[torch.arange(n), torch.arange(n), k // 2] = 1.0
    return tensor
