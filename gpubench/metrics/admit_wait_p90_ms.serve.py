"""admit_wait_p90_ms.serve: the 90th percentile, over the requests due in the
window before its traced part began, of the engine's ``serve.request.queued``
span: from ``submit()`` to the start of the request's own prefill. A request
not admitted when the window closed enters as the close minus its submit."""

from gpubench import engine_spans
from gpubench.stats import percentile


def read(run):
    rec = engine_spans.recorder(run)
    due = engine_spans.due_unprofiled(run)
    if rec is None or not due:
        return None
    queued = engine_spans.by_rid(rec, "serve.request.queued")
    closed = run.window[1]
    waits = [(queued[r["rid"]].end - queued[r["rid"]].start) / 1e9 if r["rid"] in queued
             else closed - r["submit"] for r in due]
    return 1e3 * percentile(waits, 90)
