"""prefill_idle_share.serve: the share of the engine's
``serve.request.prefill`` spans' time in the traced part of the window with
the device idle, in %: the spans mapped onto the profiler's clock, against the
trace's idle gaps (no device operation running)."""

from gpubench import engine_spans


def read(run):
    rec = engine_spans.recorder(run)
    if rec is None or run.trace is None:
        return None
    spans = engine_spans.mapped(rec, "serve.request.prefill", run.trace.window)
    total = sum(b - a for a, b in spans)
    if not total:
        return None
    gaps = run.trace.idle_gaps()
    return 100.0 * sum(engine_spans.idle_ns(gaps, a, b) for a, b in spans) / total
