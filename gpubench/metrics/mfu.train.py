"""mfu.train: the model FLOPs of the training steps completed in the window
(gpubench.flops: 6 x the matmul parameters a token and 3 x the SSD
forward; remat's recompute not counted) over the time to the synchronise
after the last step times the card's bf16 peak, in %."""

from gpubench.flops import mamba2_train_flops
from gpubench.peaks import PEAK_BF16_FLOPS


def read(run):
    steps = [s for s in run.steps if "tokens" in s]
    if not steps:
        return None
    seq = run.traffic["seq"]
    flops = sum(mamba2_train_flops(run.config, s["tokens"] // seq, seq) for s in steps)
    return 100.0 * flops / ((steps[-1]["end"] - run.window[0]) * PEAK_BF16_FLOPS)
