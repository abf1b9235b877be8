"""queue_wait_p90_ms.serve: the 90th percentile, over the requests due in
the window before its traced part began, of the start of the engine step
whose admission produced the request's first token minus its due time (the
time the window closed for a request not yet admitted). The traced part is
left out because the profiler slows the host's dispatch: its requests would
read a system nearer its knee than the untraced runs that report
``ttft_p90_ms``."""

from gpubench.stats import percentile


def read(run):
    w0, closed = run.window
    end = min(w0 + run.seconds, run.extra.get("traced", [closed])[0])
    due = [r for r in run.requests if w0 <= r["due"] < end]
    if not due:
        return None
    return 1e3 * percentile([(r["first_step_start"] or closed) - r["due"] for r in due], 90)
