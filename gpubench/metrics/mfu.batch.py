"""mfu.batch: the model FLOPs of the traced part's prefill and decode calls
(gpubench.flops, from the published widths) over that part's length times
the card's bf16 peak, in %."""

from gpubench.flops import dense_decode_flops, dense_prefill_flops
from gpubench.peaks import PEAK_BF16_FLOPS


def read(run):
    pre, dec = run.spans.get("prefill", []), run.spans.get("decode", [])
    if not pre and not dec:
        return None
    start, end = run.extra["traced"]
    flops = sum(dense_prefill_flops(run.config, c["prompt"]) for c in pre)
    flops += sum(dense_decode_flops(run.config, n) for c in dec for n in c["contexts"])
    return 100.0 * flops / ((end - start) * PEAK_BF16_FLOPS)
