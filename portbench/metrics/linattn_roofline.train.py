"""The upsampler's linear attention over the traced window: the sum of
each ``ops.linear_attend_fused`` call's bound (``linattn_work.py``,
forward and, where one follows, backward) over the device time of the
kernels of the ``gigagan.up.linear_attn`` spans and their backward, in
%."""

from portbench.metrics._attributed import span_seconds


def read(run):
    seconds = span_seconds(run, "gigagan.up.linear_attn")
    bound = getattr(run.trace, "linattn_bound_s", 0.0) if seconds else 0.0
    if not bound:
        return None
    return 100.0 * bound / seconds
