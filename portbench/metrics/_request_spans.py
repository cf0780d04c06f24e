"""Shared arithmetic of the readers of a span's device time on a sampling
run (``attribution.py``: the kernels a span launched, left on the traced
window's summary by ``drivers/sample_upsampler.py``), as ``_attributed``
reads them on a train run.  Another driver's run, or a program without
the span, leaves nothing to read: the readers return None."""

from __future__ import annotations


def span_seconds(run, name: str):
    """The device seconds of span ``name`` in the traced window of a sample
    run, or None."""
    if run.kind != "sample" or run.trace is None:
        return None
    seconds = getattr(run.trace, "span_device_s", {}).get(name)
    return seconds or None


def busy_share(run, name: str):
    """Span ``name``'s device seconds over the card's busy time in the
    window, in %."""
    seconds = span_seconds(run, name)
    if seconds is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * seconds / run.trace.busy_s
