"""The device time of the kernels of the upsampler's linear attentions in
a request (each ``ops.linear_attend_fused`` call, the
``gigagan.up.linear_attn`` spans: q, k, v → out), over the card's busy
time in the traced window, in %."""

from portbench.metrics._request_spans import busy_share


def read(run):
    return busy_share(run, "gigagan.up.linear_attn")
