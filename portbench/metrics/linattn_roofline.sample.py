"""The upsampler's linear attention in a request over the traced window:
the sum of each ``ops.linear_attend_fused`` call's forward bound
(``linattn_work.py``) over the device time of the kernels of the
``gigagan.up.linear_attn`` spans, in %."""

from portbench.metrics._request_spans import span_seconds


def read(run):
    seconds = span_seconds(run, "gigagan.up.linear_attn")
    bound = getattr(run.trace, "linattn_bound_s", 0.0) if seconds else 0.0
    if not bound:
        return None
    return 100.0 * bound / seconds
