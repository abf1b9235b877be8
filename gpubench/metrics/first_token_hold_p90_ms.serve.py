"""first_token_hold_p90_ms.serve: the 90th percentile, over the admitted
requests due in the window before its traced part began, of the engine's
``serve.request.hold`` span: from the request's first token on the host to the
return of the step that admitted it (the later admissions' prefills and the
step's decode)."""

from gpubench import engine_spans
from gpubench.stats import percentile


def read(run):
    rec = engine_spans.recorder(run)
    if rec is None:
        return None
    hold = engine_spans.by_rid(rec, "serve.request.hold")
    holds = [hold[r["rid"]] for r in engine_spans.due_unprofiled(run) if r["rid"] in hold]
    if not holds:
        return None
    return percentile([s.end - s.start for s in holds], 90) / 1e6
