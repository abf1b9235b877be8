"""Spans of the port's host code, kept in memory.

One process-wide recorder, :data:`RECORDER`, as a server keeps its request
statistics: always on, bounded, written by the code it observes (the
serving engine) and read after the fact. A span is a name, an id, its
parent's id, a request id (``rid``, or None), its start and end on
``time.perf_counter_ns()``'s clock, and a few integer attributes. The spans
sit in a deque of ``capacity``; the recorder counts what it drops and keeps
the end of the newest span dropped, so a reader can tell whether the stretch
it reads is whole.

:meth:`Recorder.to_profiler_ns` maps a span's time onto the clock of
``torch.profiler``'s events (``kineto_results.events()``, which stamp the
host's CLOCK_REALTIME in ns) through (monotonic, realtime) anchors. The code
that records spans takes an anchor now and then (the engine at each step),
and a time maps through the newest anchor at or before it, so a slew of the
realtime clock cannot build up over a long run.

The recorder opens no ``record_function`` range: the profiler puts such a
range on the device's timeline too, where a reader of the device trace would
take it for an operation. Its spans meet a profiler trace through the clock.
"""

from __future__ import annotations

import bisect
import itertools
import math
import os
import time
from collections import deque
from typing import NamedTuple

__all__ = ["Span", "Recorder", "RECORDER", "now"]

now = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None
    rid: int | None
    start: int                  # time.perf_counter_ns()
    end: int
    attrs: dict


class Recorder:
    def __init__(self, capacity: int = 65536):
        self.spans: deque[Span] = deque(maxlen=capacity)
        self.dropped = 0
        self.dropped_end: int | None = None     # the end of the newest span dropped
        self._anchors: deque[tuple[int, int]] = deque(maxlen=capacity)  # (monotonic, offset)
        self._ids = itertools.count(1)

    def new_id(self) -> int:
        """An id for a span that is recorded later, after its children."""
        return next(self._ids)

    def record(self, name: str, start: int, end: int, *, parent: int | None = None,
               rid: int | None = None, span_id: int | None = None, **attrs: int) -> int:
        """Keep a finished span; returns its id."""
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
            old = self.spans[0].end
            self.dropped_end = old if self.dropped_end is None else max(self.dropped_end, old)
        sid = next(self._ids) if span_id is None else span_id
        self.spans.append(Span(name, sid, parent, rid, start, end, attrs))
        return sid

    def anchor(self) -> None:
        """Read the realtime clock between two monotonic reads."""
        m0 = time.perf_counter_ns()
        real = time.time_ns()
        m = (m0 + time.perf_counter_ns()) // 2
        self._anchors.append((m, real - m))

    def to_profiler_ns(self, t: int) -> int:
        """``t`` (``perf_counter_ns``) on the profiler's clock, through the
        newest anchor at or before it (the oldest, for a time before all)."""
        if not self._anchors:
            self.anchor()
        i = max(0, bisect.bisect_right(self._anchors, (t, math.inf)) - 1)
        return t + self._anchors[i][1]

    def chrome_events(self) -> list[dict]:
        """The spans as Chrome trace ``"X"`` events on the profiler's clock:
        ``ts`` in us since the Unix epoch (a ``torch.profiler`` export counts
        its ``ts`` from its ``baseTimeNanoseconds``). Spans of no request
        share one track; each request has its own."""
        pid = os.getpid()
        return [{"name": s.name, "ph": "X", "ts": self.to_profiler_ns(s.start) / 1e3,
                 "dur": (s.end - s.start) / 1e3, "pid": pid,
                 "tid": 0 if s.rid is None else s.rid + 1,
                 "args": {"id": s.id, "parent": s.parent, "rid": s.rid, **s.attrs}}
                for s in self.spans]


RECORDER = Recorder()
