"""itl_p95_ms: the 95th percentile of every gap between a request's
consecutive output tokens whose later token came in the window, each token
stamped when the engine step that produced it returned. Every active row
of a step shares its gap, so a stall enters the sample once per active
request (about 20 at this load); the 95th percentile leaves about 11
engine steps beyond it, where the 99th would leave 2."""

from gpubench.stats import percentile


def read(run):
    w0, closed = run.window
    gaps = [b - a for r in run.requests for a, b in zip(r["times"], r["times"][1:])
            if w0 <= b <= closed]
    return 1e3 * percentile(gaps, 95) if gaps else None
