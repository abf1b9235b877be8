"""The profiler's trace, reduced to what the per-layer metrics read.

:class:`Trace` sums a ``torch.profiler`` run from its raw events: each device
operation's calls and device ns by name, the device's busy time (the union
of the operations' intervals), and per range name (a ``record_function``
label of the harness, or a PyTorch op such as ``repro_torch::flash_attention``)
its calls and the device ns of the kernels launched inside it. A kernel
belongs to a range when the host call that launched it starts inside one of
the range's intervals, on any thread. Everything is counted within the
traced window only. Frozen from ``chip_smoke.py``'s ``Trace``, with the
window, the busy union, the idle gaps and the merging of nested ranges of
one name added; it reads no chrome trace and writes nothing.
"""

from __future__ import annotations

import bisect

__all__ = ["Trace", "merge"]


def merge(intervals):
    """Sorted, merged (start, end) intervals: nested or overlapping ones
    become one."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    def __init__(self, events, ranges=(), window: str | None = None):
        """``events``: a profiler's ``kineto_results.events()``; ``ranges``:
        the names whose intervals to collect; ``window``: the name of the
        range that marks the traced window (its first interval), else the
        span of the host's events. The harness's labels start with
        ``gpubench.``; their ranges on the device are not operations."""
        from torch.autograd import DeviceType

        spans = {name: [] for name in (*ranges, *([window] if window else []))}
        launch_start, device = {}, []
        cpu_lo, cpu_hi = None, None
        for e in events:
            name, start, dur = e.name(), e.start_ns(), e.duration_ns()
            if e.device_type() != DeviceType.CPU:
                if name not in spans and not name.startswith("gpubench."):  # not a label
                    device.append((name, start, start + dur, e.linked_correlation_id()))
                continue
            cpu_lo = start if cpu_lo is None else min(cpu_lo, start)
            cpu_hi = start + dur if cpu_hi is None else max(cpu_hi, start + dur)
            if name in spans:
                spans[name].append((start, start + dur))
            if not e.linked_correlation_id():
                launch_start[e.correlation_id()] = start
        self.window = spans[window][0] if window and spans[window] else (cpu_lo or 0,
                                                                          cpu_hi or 0)
        lo, hi = self.window
        # every device operation in the window, its time clipped to the window
        inside = [(n, max(a, lo), min(b, hi), c) for n, a, b, c in device if b > lo and a < hi]
        self.ops: dict[str, list] = {}
        for n, a, b, _ in inside:
            op = self.ops.setdefault(n, [0, 0])
            op[0] += 1
            op[1] += b - a
        self.busy = merge((a, b) for _, a, b, _ in inside)
        launched = sorted((launch_start[c], b - a) for _, a, b, c in inside if c in launch_start)
        starts = [t for t, _ in launched]
        cum = [0]
        for _, ns in launched:
            cum.append(cum[-1] + ns)
        self.ranges = {}
        for name, rs in spans.items():
            rs = [(a, b) for a, b in merge(rs) if lo <= a <= hi]
            dev = sum(cum[bisect.bisect_right(starts, b)] - cum[bisect.bisect_left(starts, a)]
                      for a, b in rs)
            self.ranges[name] = {"calls": len(rs), "host_ns": sum(b - a for a, b in rs),
                                 "device_ns": dev, "intervals": rs}

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def idle_gaps(self):
        """(start, end) ns of every stretch of the window with no device
        operation running."""
        gaps, at = [], self.window[0]
        for a, b in self.busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.window[1] > at:
            gaps.append((at, self.window[1]))
        return gaps

    def top_ops(self, n: int = 10):
        """The ``n`` device operations that took most time: [name, seconds]."""
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name, ns / 1e9] for name, (_, ns) in top]

    def idle_by(self, labels, n: int = 10):
        """Idle seconds summed by what the host was doing: the innermost of
        ``labels`` (names of collected ranges, outermost first) whose interval
        holds a gap's midpoint, else "outside the harness's spans"; the ``n``
        largest as [name, seconds]."""
        found = [(name, self.ranges[name]["intervals"]) for name in labels if name in self.ranges]
        sums: dict[str, float] = {}
        for a, b in self.idle_gaps():
            mid = (a + b) // 2
            who = "outside the harness's spans"
            for name, rs in found:
                i = bisect.bisect_right(rs, (mid, float("inf"))) - 1
                if i >= 0 and rs[i][0] <= mid <= rs[i][1]:
                    who = name
            sums[who] = sums.get(who, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]
