"""Training traffic for the UNet upsampler (``train_upsampler=True``): the
train driver (``drivers/train.py``: ``GigaGAN.forward`` over whole
4-iteration cadences, its check of the first three iterations against the
reference, its ``control`` and its operation count) run against the
upsampler's reference (``reference/upsampler_trainer.py``).  The loader's
256² reals feed D, and their nearest-neighbour 64² copies G, in both the
program and the reference.

The check adds two numbers, ``aconv_gap`` and ``linattn_gap``
(``layer_check.py``): the adaptive convolution's and the linear
attention's calls of the first iterations, each replayed alone, forward
and backward, against the reference's float32 functions.  They read G's
backward, which the step's numbers do not: G's first step follows D's
first Adam step, which moves each of D's weights by ±lr by the sign of
its gradient, so that rounding flips some signs and sets the two Ds
apart, and a sharp D spreads G's gradient through it by rounding as
widely in bf16 as in the fp8 control.

The traced window also gives the device seconds of the kernels of the
``gigagan.up.generator`` and ``gigagan.up.linear_attn`` spans, forward
and backward, and the bound of the linear attention's calls
(``attribution.Traced``), for the ``up_g_share``, ``linattn_share`` and
``linattn_roofline`` readers.

The train driver's module is loaded once more under a name of its own,
and its reference trainer, its traced window, its two checks and its
comparison are replaced in that copy alone: the base driver of the other
cells is not touched."""

from __future__ import annotations

import types

from portbench import attribution, checks, harness, layer_check
from portbench.reference import upsampler_trainer

_train = harness.load_module(harness.PACKAGE / "drivers" / "train.py",
                             "portbench_driver_train_for_upsampler")
_program_check = _train.program_check
_reference_check = _train.reference_check


def program_check(ctx, gan, seeds):
    """The train driver's check of the program, with the gaps of the
    layers' calls it made (``layers``)."""
    with layer_check.Calls() as calls:
        mine = _program_check(ctx, gan, seeds)
    mine["layers"] = layer_check.gaps(calls, seeds["data"],
                                      under_test="program")
    return mine


def reference_check(ctx, seeds, batches, *, fp8: bool = False):
    """The train driver's reference numbers; in fp8 (the control, in the
    program's place) with the gaps of the reference's layer calls."""
    if not fp8:
        return _reference_check(ctx, seeds, batches)
    with layer_check.Calls(reference=True) as calls:
        out = _reference_check(ctx, seeds, batches, fp8=True)
    out["layers"] = layer_check.gaps(calls, seeds["data"], under_test="fp8")
    return out


def _train_numbers(mine, ref, limits):
    """The train driver's numbers with the compared side's layer gaps
    (none: each reads infinite)."""
    readings = checks.train_readings(mine, ref)
    readings.update(mine.get("layers") or {
        f"{layer}_gap": float("inf") for layer in layer_check.LAYERS})
    return checks.compared(readings, limits)


_train.ref_trainer = upsampler_trainer
_train.Traced = attribution.Traced
_train.program_check = program_check
_train.reference_check = reference_check
_train.checks = types.SimpleNamespace(
    train_numbers=_train_numbers, log_losses=checks.log_losses,
    worst_leaves=checks.worst_leaves)

run = _train.run
readings = _train.readings
control = _train.control
train_flops_per_image = _train.train_flops_per_image
