"""decode_idle_ms.batch: the device's idle time inside the engine's
``serve.decode`` spans, per span, in the traced part of the window: the spans
mapped onto the profiler's clock, against the trace's idle gaps (no device
operation running)."""

from gpubench import engine_spans


def read(run):
    rec = engine_spans.recorder(run)
    if rec is None or run.trace is None:
        return None
    spans = engine_spans.mapped(rec, "serve.decode", run.trace.window)
    if not spans:
        return None
    gaps = run.trace.idle_gaps()
    return sum(engine_spans.idle_ns(gaps, a, b) for a, b in spans) / 1e6 / len(spans)
