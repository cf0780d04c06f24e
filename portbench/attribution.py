"""The device time of the kernels that a program span gave rise to, forward
and backward, from the traced window's profiler events.

A device interval (kernel, copy or fill) belongs to a span in either of
two cases:

- it was launched while the span was open on the launching thread: the
  profiler links each device event to the host operator that launched it
  (its ``linked_correlation_id`` is that operator's ``correlation_id``),
  and that operator started inside the span, on the span's thread;
- it was launched under an autograd backward node of an operator recorded
  inside the span: the backward runs on the autograd engine's thread,
  outside every forward span, and the profiler records each node's
  ``autograd::engine::evaluate_function`` event with the forward
  operator's ``sequence_nr`` and ``fwd_thread_id``.

``Traced`` is ``trace.Traced`` that also records the linear attention's
calls (``linattn_work.Recorder``) and leaves on its summary
``span_device_s`` ({span: device seconds in the window}, for the spans
found in it) and ``linattn_bound_s`` / ``linattn_calls``."""

from __future__ import annotations

import bisect

from portbench import linattn_work, trace

SPANS = ("gigagan.up.generator", "gigagan.up.linear_attn")
BACKWARD = "autograd::engine::evaluate_function:"


class Intervals:
    """Per thread, the union of [start, end] intervals (of times, or of
    sequence numbers); ``holds(tid, t)`` tells whether one of that
    thread's holds t."""

    def __init__(self, intervals):
        by = {}
        for tid, s, e in intervals:
            by.setdefault(tid, []).append((s, e))
        self._by = {}
        for tid, lst in by.items():
            merged = []
            for s, e in sorted(lst):
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._by[tid] = ([s for s, _ in merged], [e for _, e in merged])

    def holds(self, tid, t) -> bool:
        starts, ends = self._by.get(tid, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ends[i]


def host_links(events, names=SPANS):
    """From the host's events (the profiler's ``_KinetoEvent``s, or
    objects with their methods): the operators, {correlation id: (thread,
    start)}, and for each span of ``names`` found, (the spans' intervals,
    the intervals of the backward nodes of the operators recorded inside
    them), per thread.

    An operator records the thread's next autograd sequence number as it
    starts, and each node it makes takes one: the nodes made while a span
    is open are those numbered from the first operator inside it up to,
    not including, the first operator after it (an operator that makes
    no node records the number the next one takes)."""
    from torch.autograd import DeviceType

    ops, spans, forward, backward = {}, {}, {}, []
    for ev in events:
        if (ev.device_type() != DeviceType.CPU
                or ev.linked_correlation_id() > 0):  # a runtime call
            continue
        start = ev.start_ns()
        tid, name = ev.start_thread_id(), ev.name()
        ops[ev.correlation_id()] = (tid, start)
        if name in names:
            spans.setdefault(name, []).append(
                (tid, start, start + ev.duration_ns()))
        elif name.startswith(BACKWARD):
            backward.append((ev.fwd_thread_id(), ev.sequence_nr(), tid,
                             start, start + ev.duration_ns()))
        elif ev.sequence_nr() >= 0 and ev.fwd_thread_id() == 0:
            forward.setdefault(tid, []).append((start, ev.sequence_nr()))
    for lst in forward.values():
        lst.sort()
    links = {}
    for name, found in spans.items():
        numbered = []  # (thread, first node, last node)
        for tid, s, e in found:
            lst = forward.get(tid, [])
            i = bisect.bisect_left(lst, (s, -1))
            j = bisect.bisect_right(lst, (e, float("inf")))
            if i < j:
                end = lst[j][1] if j < len(lst) else lst[j - 1][1] + 1
                if end > lst[i][1]:
                    numbered.append((tid, lst[i][1], end - 1))
        nodes = Intervals(numbered)
        links[name] = (Intervals(found), Intervals(
            (tid, s, e) for fwd, seq, tid, s, e in backward
            if nodes.holds(fwd, seq)))
    return ops, links


def span_device_seconds(events, window, names=SPANS) -> dict:
    """{span: seconds} of the device intervals of ``events`` in ``window``
    (ns) that belong to each span of ``names`` found on the host, forward
    and backward."""
    from torch.autograd import DeviceType

    s0, s1 = window
    ops, links = host_links(events, names)
    totals = dict.fromkeys(links, 0)
    for ev in events:
        if ev.device_type() == DeviceType.CPU or ev.name() == trace.WINDOW:
            continue
        start = ev.start_ns()
        end = start + ev.duration_ns()
        op = ops.get(ev.linked_correlation_id())
        if op is None or end <= s0 or start >= s1:
            continue
        for name, (inside, under) in links.items():
            if inside.holds(*op) or under.holds(*op):
                totals[name] += min(end, s1) - max(start, s0)
    return {name: ns / 1e9 for name, ns in totals.items()}


class Traced(trace.Traced):
    """``trace.Traced``, with the spans' device seconds and the linear
    attention's bound left on its summary."""

    def __enter__(self):
        if self.on:
            self._calls = linattn_work.Recorder().__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        prof = getattr(self, "_prof", None)
        super().__exit__(*exc)
        if self.on:
            self._calls.__exit__(*exc)
        if self.summary is not None:
            events = prof.profiler.kineto_results.events()
            window = (self.summary.start_ns, self.summary.end_ns)
            self.summary.span_device_s = span_device_seconds(events, window)
            self.summary.linattn_bound_s = self._calls.bound_s
            self.summary.linattn_calls = self._calls.calls
        return False
