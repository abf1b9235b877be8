"""engine_decode_step_ms.batch: the mean of the engine's ``serve.decode``
spans (the decode call to its tokens on the host) that start in the window
before its traced part began."""

from gpubench import engine_spans


def read(run):
    rec = engine_spans.recorder(run)
    if rec is None:
        return None
    spans = engine_spans.starting_in(rec, "serve.decode", *engine_spans.unprofiled(run))
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / 1e6 / len(spans)
