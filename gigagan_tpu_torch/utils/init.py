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
  HWIO kernel, transposed, same fan_in.
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
