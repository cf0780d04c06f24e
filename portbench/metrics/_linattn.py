"""The device launches of the upsampler's linear-attention kernel
(``csrc/linear_attention.cu``: ``linattn_context_kernel``,
``linattn_reduce_kernel`` and ``linattn_out_kernel``, three a call) per
unit of the traced window, counted from the profiler's kernel events by
the kernels' own names.  None where the program has no such kernel (its
build list lacks ``linear_attention``)."""

from __future__ import annotations

import re

PATTERN = re.compile(
    r"\b(linattn_context_kernel|linattn_reduce_kernel|linattn_out_kernel)\b")


def linattn_launches(run, kind: str):
    from gigagan_tpu_torch.ops.kernels import build

    if run.kind != kind or run.trace is None or not run.units or (
            "linear_attention" not in build.KERNELS):
        return None
    return sum(bool(PATTERN.search(n)) for _, _, n, _ in run.trace.kernels
               ) / run.units
