"""Faults in G's backward, planted in the system under test to show that
the upsampler's check catches them (``aconv_gap`` and ``linattn_gap``,
``drivers/train_upsampler.py``).  Each replaces a function of the port's
for the rest of the process (``restore()`` puts it back), as a fault of
the kernel's would be; D does not call either:

- ``k2-dw``: K2's weight gradient, of every adaptive convolution, 10%
  too large;
- ``linattn-dq``: the linear attention's gradient to q at half its value.

Their readings on the card, one JSON line per seed as ``readings.py``
gives them (with these faults among its modes):

    python3 portbench/faults_backward.py --workload up-train-b8 \\
        --mode k2-dw --seeds 1,2,3"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

K2_SCALE = 1.1
DQ_SCALE = 0.5


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the gradient."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def _k2_dw():
    from gigagan_tpu_torch.ops.kernels import adaptive_conv

    original = adaptive_conv.adaptive_conv_bwd_w

    def scaled(x, g, weights, attn):
        dw, da = original(x, g, weights, attn)
        return dw * K2_SCALE, da

    return adaptive_conv, "adaptive_conv_bwd_w", scaled


def _linattn_dq():
    from gigagan_tpu_torch import ops

    original = ops.linear_attend_fused

    def entry(q, k, v, *, heads: int, scale=None):
        return original(_ScaleGrad.apply(q, DQ_SCALE), k, v, heads=heads,
                        scale=scale)

    return ops, "linear_attend_fused", entry


# (module, name, original) of each function replaced
_planted = []


def _planting(make):
    def plant(gan) -> None:
        if _planted:
            return
        module, name, fault = make()
        _planted.append((module, name, getattr(module, name)))
        setattr(module, name, fault)

    return plant


def restore() -> None:
    """Every planted fault taken out."""
    while _planted:
        module, name, original = _planted.pop()
        setattr(module, name, original)


FAULTS = {"k2-dw": _planting(_k2_dw), "linattn-dq": _planting(_linattn_dq)}


def main(argv=None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench import faults, readings

    faults.FAULTS.update(FAULTS)
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
