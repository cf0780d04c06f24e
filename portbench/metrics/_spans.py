"""Shared arithmetic of the readers of the program's phase spans: the
``gigagan.*`` events that ``gigagan_tpu_torch.utils.profiling.span``
records as profiler ``cpu_op`` events on the host's timeline (the
trace's ``host`` list), clipped to the traced window, against the card's
idle gaps in it.  A program without spans (the parent of the change that
added them) has no iteration or request span in its window: every reader
then returns None."""

from __future__ import annotations

PREFIX = "gigagan."
SYNC = "gigagan.sync."
# the span that holds each unit of a run's work, by the run's kind
UNIT = {"train": "gigagan.train.iteration", "sample": "gigagan.sample.request"}


def spans(run, kind: str):
    """The window's ``gigagan.*`` spans, (start, end, name) clipped to it,
    or None where the run is not of ``kind``, holds no trace or no unit, or
    its window holds no ``UNIT[kind]`` span."""
    if run.kind != kind or run.trace is None or not run.units:
        return None
    t = run.trace
    found = [(max(s, t.start_ns), min(e, t.end_ns), n) for s, e, n in t.host
             if n.startswith(PREFIX) and e > t.start_ns and s < t.end_ns]
    if not any(n == UNIT[kind] for _, _, n in found):
        return None
    return found


def union(intervals):
    """Sorted, disjoint [start, end] intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_ns(a, b) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(run, kind: str, names) -> float | None:
    """The card's idle time inside the union of the spans named
    ``names``, as a share of the traced window, in %: each idle instant
    counted once, however many of the spans cover it."""
    found = spans(run, kind)
    if found is None or run.trace.window_s <= 0:
        return None
    covered = union((s, e) for s, e, n in found if n in names)
    idle = overlap_ns(covered, run.trace.gaps())
    return 100.0 * idle / 1e9 / run.trace.window_s


def syncs_per_unit(run, kind: str) -> float | None:
    """``gigagan.sync.*`` spans (calls at which the host waits for the
    card) per iteration or request."""
    found = spans(run, kind)
    if found is None:
        return None
    return sum(n.startswith(SYNC) for _, _, n in found) / run.units


def ms_per_unit(run, kind: str, name: str) -> float | None:
    """The summed duration of the spans named ``name`` per iteration or
    request, in ms."""
    found = spans(run, kind)
    if found is None:
        return None
    return sum(e - s for s, e, n in found if n == name) / 1e6 / run.units
