"""prefill_ms_per_ktok.serve: the engine's prefill calls in the window, each
timed from its call to a synchronise after it, per 1,000 prompt tokens."""


def read(run):
    calls = run.spans.get("prefill", [])
    tokens = sum(c["prompt"] for c in calls)
    if not tokens:
        return None
    return 1e3 * sum(c["end"] - c["start"] for c in calls) / tokens * 1e3
