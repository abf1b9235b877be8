"""train_tokens_per_s: the tokens of every training step completed in the
window, over the time from its opening to the synchronise after the last."""


def read(run):
    if not run.steps or "tokens" not in run.steps[0]:
        return None
    return sum(s["tokens"] for s in run.steps) / (run.steps[-1]["end"] - run.window[0])
