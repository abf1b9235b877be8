"""The serving engine's own spans, as the engine's per-layer metrics read them.

The port records each request's and each step's life in
``repro_torch.obs.RECORDER`` (``serve.step``, ``serve.request.queued``,
``serve.request.prefill``, ``serve.request.hold``, ``serve.decode``), on
``time.perf_counter_ns()``, the clock of ``drivers/serve.py``'s ``time.perf_counter()``
seconds. A reader joins request spans to ``run.requests`` by ``rid``, and
maps spans onto the profiler's clock with the recorder's
``to_profiler_ns`` to meet ``run.trace``.

Every helper gives None where there is nothing sound to read: a port with no
recorder, a recorder with no spans, or one that dropped spans which ended
after the window opened.
"""

from __future__ import annotations

import bisect
import math

__all__ = ["recorder", "unprofiled", "due_unprofiled", "by_rid", "starting_in", "mapped",
           "idle_ns"]


def recorder(run):
    """The port's recorder, if it holds the run's window whole."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    rec = obs.RECORDER
    if not rec.spans:
        return None
    if rec.dropped_end is not None and rec.dropped_end >= run.window[0] * 1e9:
        return None
    return rec


def unprofiled(run) -> tuple[float, float]:
    """(start, end) s of the window before its traced part."""
    w0, closed = run.window
    return w0, min(w0 + run.seconds, run.extra.get("traced", [closed])[0])


def due_unprofiled(run) -> list[dict]:
    """The requests due in the unprofiled part of the window."""
    lo, hi = unprofiled(run)
    return [r for r in run.requests if lo <= r["due"] < hi]


def by_rid(rec, name: str) -> dict:
    return {s.rid: s for s in rec.spans if s.name == name}


def starting_in(rec, name: str, lo: float, hi: float) -> list:
    """The spans ``name`` that start in [lo, hi) s."""
    a, b = lo * 1e9, hi * 1e9
    return [s for s in rec.spans if s.name == name and a <= s.start < b]


def mapped(rec, name: str, window) -> list[tuple[int, int]]:
    """The spans ``name`` that start inside ``window`` ((lo, hi) ns on the
    profiler's clock), mapped there and cut at its end."""
    lo, hi = window
    out = []
    for s in rec.spans:
        if s.name == name:
            a = rec.to_profiler_ns(s.start)
            if lo <= a < hi:
                out.append((a, min(hi, a + s.end - s.start)))
    return out


def idle_ns(gaps, a: int, b: int) -> int:
    """The part of [a, b] that sorted, disjoint ``gaps`` cover."""
    i = max(0, bisect.bisect_right(gaps, (a, math.inf)) - 1)
    total = 0
    while i < len(gaps) and gaps[i][0] < b:
        total += max(0, min(b, gaps[i][1]) - max(a, gaps[i][0]))
        i += 1
    return total
