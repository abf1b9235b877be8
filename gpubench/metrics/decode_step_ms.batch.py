"""decode_step_ms.batch: the mean time of the engine's decode calls in the
window, each from its call to a synchronise after it."""


def read(run):
    calls = run.spans.get("decode", [])
    if not calls:
        return None
    return 1e3 * sum(c["end"] - c["start"] for c in calls) / len(calls)
