"""The device launches of the adaptive convs' demodulation kernel
(``csrc/demod_scale.cu``: ``demod_scale_kernel`` and
``demod_reduce_kernel``) per unit of the traced window, counted from the
profiler's kernel events by the kernels' own names.  None where the
program has no such kernel (its build list lacks ``demod_scale``)."""

from __future__ import annotations

import re

PATTERN = re.compile(r"\b(demod_scale_kernel|demod_reduce_kernel)\b")


def demod_launches(run, kind: str):
    from gigagan_tpu_torch.ops.kernels import build

    if run.kind != kind or run.trace is None or not run.units or (
            "demod_scale" not in build.KERNELS):
        return None
    return sum(bool(PATTERN.search(n)) for _, _, n, _ in run.trace.kernels
               ) / run.units
