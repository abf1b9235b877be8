"""slot_occupancy.batch: active decode slots over max_batch, read from the
engine's slots after each step of the window, averaged, in %."""


def read(run):
    steps = [s for s in run.steps if "active" in s]
    if not steps:
        return None
    return 100.0 * sum(s["active"] for s in steps) / (len(steps) * run.extra["max_batch"])
