"""engine_prefill_ms_per_ktok.serve: the engine's ``serve.request.prefill``
spans (the prefill call, the splice and the first token read on the host)
that start in the window before its traced part began, summed, per 1,000
prompt tokens."""

from gpubench import engine_spans


def read(run):
    rec = engine_spans.recorder(run)
    if rec is None:
        return None
    spans = engine_spans.starting_in(rec, "serve.request.prefill", *engine_spans.unprofiled(run))
    tokens = sum(s.attrs["tokens"] for s in spans)
    if not tokens:
        return None
    return sum(s.end - s.start for s in spans) / 1e6 / tokens * 1e3
