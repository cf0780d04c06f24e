"""The least time one NVIDIA H100 needs for a call of the upsampler's
linear attention, ``gigagan_tpu_torch.ops.linear_attend_fused`` (q, k, v
(b, n, H·d) → out (b, n, H·d)), by ``kernel_work.bound``: from the
operands' shapes and dtypes alone, whatever implements the call (the plain
path's softmaxes and two einsums, or a fused kernel), so no implementation
can beat it.

- forward: the context kᵀv and the product q·context, 2·b·n·H·d² each,
  4·b·n·H·d² operations; q, k and v read once, out written once;
- backward: dq, d(context), dk and dv, 8·b·n·H·d² operations; q, k, v and
  the gradient of out read once, dq, dk and dv written once.  A call
  whose operands need a gradient under autograd is followed by one.

``Recorder`` wraps the entry while open and sums the bounds of its
calls, in the manner of ``program.CallRecorder``."""

from __future__ import annotations

import torch

from portbench.kernel_work import bound, nbytes


def _ops(q, heads: int) -> float:
    b, n, hd = q.shape
    d = hd // heads
    return float(b) * n * heads * d * d


def forward_bound(q, k, v, out, heads: int):
    return bound(4.0 * _ops(q, heads), nbytes(q, k, v, out))


def backward_bound(q, k, v, out, heads: int):
    return bound(8.0 * _ops(q, heads), 2 * nbytes(q, k, v) + nbytes(out))


def call_bound_s(q, k, v, out, heads: int) -> float:
    """The call's forward bound, and its backward's where one follows."""
    seconds = forward_bound(q, k, v, out, heads)[0]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        seconds += backward_bound(q, k, v, out, heads)[0]
    return seconds


class Recorder:
    """While open, each call of ``ops.linear_attend_fused`` adds its bound
    (``call_bound_s``) to ``bound_s`` and one to ``calls``."""

    def __init__(self):
        self.bound_s = 0.0
        self.calls = 0
        self._original = None

    def __enter__(self):
        from gigagan_tpu_torch import ops

        self._original = original = ops.linear_attend_fused

        def entry(q, k, v, *, heads: int, scale=None):
            out = original(q, k, v, heads=heads, scale=scale)
            self.bound_s += call_bound_s(q, k, v, out, heads)
            self.calls += 1
            return out

        ops.linear_attend_fused = entry
        return self

    def __exit__(self, *exc):
        from gigagan_tpu_torch import ops

        ops.linear_attend_fused = self._original
        return False
