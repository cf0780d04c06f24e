"""Shared arithmetic of the per-layer readers."""

from __future__ import annotations

import json
import re
from pathlib import Path

from portbench import kernel_work

FAMILIES = json.loads((Path(__file__).resolve().parents[1]
                       / "kernel_families.json").read_text())


def family_pattern(family: str):
    return re.compile(r"\b(" + "|".join(map(re.escape, FAMILIES[family]))
                      + r")\b")


def launches(run, kind: str):
    """Device kernels per iteration or request of the traced window."""
    if run.kind != kind or run.trace is None or not run.units:
        return None
    return len(run.trace.kernels) / run.units


def mfu(run, kind: str):
    """Required operations per second over the dense bf16 peak, in %."""
    if run.kind != kind or not run.flops_per_unit or not run.rate_units_per_s:
        return None
    return (100.0 * run.flops_per_unit * run.rate_units_per_s
            / kernel_work.PEAK_FLOPS)


def roofline(run, kind: str, family: str, members):
    """Σ of the calls' bounds over the device time of their kernels, %."""
    if run.kind != kind or run.trace is None or not run.calls:
        return None
    bound = sum(run.calls["bound_s"][k] for k in members)
    seconds = run.trace.kernel_seconds(family_pattern(family))
    if bound <= 0 or seconds <= 0:
        return None
    return 100.0 * bound / seconds


def idle(run, kind: str):
    """The share of the traced window with nothing running on the card."""
    if run.kind != kind or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
