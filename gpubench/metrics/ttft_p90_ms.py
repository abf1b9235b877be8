"""ttft_p90_ms: the 90th percentile of time to first token over every
request due in the window, from its due time to the return of the engine
step that produced its first token. A request with no first token when the
window closed enters at the time it had waited by then (a lower bound)."""

from gpubench.stats import percentile


def read(run):
    w0, closed = run.window
    due = [r for r in run.requests if w0 <= r["due"] < w0 + run.seconds]
    if not due:
        return None
    waits = [(r["times"][0] if r["times"] else closed) - r["due"] for r in due]
    return 1e3 * percentile(waits, 90)
