"""The traced window: ``torch.profiler`` over the host's operators and the
card's activity, reduced to what the per-layer metrics read: the device
intervals (kernels, copies, fills) inside the window, their union (the
busy time), the kernel count, the device time by kernel name, and the idle
gaps named by what the host was running while the card waited.

The window is the profiler's user annotation ``portbench.window``; its
end follows a ``torch.cuda.synchronize()``, so every kernel of the window
has ended inside it."""

from __future__ import annotations

import re

WINDOW = "portbench.window"
# an idle gap shorter than this is counted, not named
NAMED_GAP_NS = 20_000


def _short(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)", "anon")
    prev = None
    while prev != name:  # innermost template argument lists first
        prev, name = name, re.sub(r"<[^<>]*>", "", name)
    name = name.split("(")[0].strip()
    return (name.split()[-1] if name.split() else name)[:limit]


class Summary:
    """A window's device activity; times in seconds."""

    def __init__(self, window, device, host):
        self.start_ns, self.end_ns = window
        self.window_s = (self.end_ns - self.start_ns) / 1e9
        # (start, end, name, is_kernel) clipped to the window
        self.device = sorted(device)
        self.kernels = [d for d in self.device if d[3]]
        self.host = sorted(host)  # (start, end, name)
        self.union = self._union()
        self.busy_s = sum(e - s for s, e in self.union) / 1e9

    def _union(self):
        out = []
        for s, e, _, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def kernel_seconds(self, pattern) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        return sum(e - s for s, e, n, _ in self.kernels
                   if pattern.search(n)) / 1e9

    def device_ops(self, top: int = 10):
        by = {}
        for s, e, n, _ in self.device:
            key = _short(n)
            by[key] = by.get(key, 0) + (e - s)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v / 1e9] for k, v in ranked]

    def gaps(self):
        """Idle intervals of the card inside the window."""
        edges = [[self.start_ns, self.start_ns]] + self.union \
            + [[self.end_ns, self.end_ns]]
        return [(a[1], b[0]) for a, b in zip(edges, edges[1:])
                if b[0] > a[1]]

    def idle_gaps(self, top: int = 10):
        """Idle seconds by what the host was running: for each gap of at
        least NAMED_GAP_NS the host operator that overlaps it most (the
        innermost on a tie), else 'host outside operators'; shorter gaps
        pooled.  One sweep over the gaps and the host operators, both in
        time order."""
        by, short = {}, 0
        host, i, active = self.host, 0, []
        for g0, g1 in self.gaps():
            if g1 - g0 < NAMED_GAP_NS:
                short += g1 - g0
                continue
            while i < len(host) and host[i][0] < g1:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] > g0]
            best, best_key = None, None
            for s, e, n in active:
                key = (min(e, g1) - max(s, g0), -(e - s))
                if best_key is None or key > best_key:
                    best, best_key = n, key
            if best is None or best_key[0] < (g1 - g0) / 2:
                best = "host outside operators"
            by[best] = by.get(best, 0) + (g1 - g0)
        by[f"gaps under {NAMED_GAP_NS // 1000} us"] = short
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v / 1e9] for k, v in ranked if v > 0]

    def breakdown(self):
        return {"device_ops": self.device_ops(),
                "idle_gaps": self.idle_gaps()}


def summarize(prof) -> Summary:
    """The Summary of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window = None
    device, host = [], []
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CPU:
            if name == WINDOW:
                window = (start, end)
            else:
                host.append((start, end, name))
        elif name != WINDOW:  # the annotation's device-side span
            kernel = not name.startswith(("Memcpy", "Memset", "memcpy",
                                          "memset"))
            device.append((start, end, name, kernel))
    if window is None:
        raise RuntimeError("the trace holds no window annotation")
    s0, s1 = window
    device = [(max(s, s0), min(e, s1), n, k) for s, e, n, k in device
              if e > s0 and s < s1]
    host = [(s, e, n) for s, e, n in host if e > s0 and s < s1]
    return Summary(window, device, host)


class Traced:
    """``with Traced(torch, on) as t:`` profiles the block when ``on``;
    ``t.summary`` is then its Summary (None when off)."""

    def __init__(self, torch, on: bool):
        self.torch = torch
        self.on = on
        self.summary = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            acts = [ProfilerActivity.CPU]
            if self.torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._mark = record_function(WINDOW)
            self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            if self.torch.cuda.is_available():
                self.torch.cuda.synchronize()
            self._mark.__exit__(*exc)
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = summarize(self._prof)
            del self._prof
        return False
