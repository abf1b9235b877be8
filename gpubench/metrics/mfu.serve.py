"""mfu.serve: the model FLOPs of the window's prefill and decode calls
(gpubench.flops, from the published widths) over those calls' synchronised
time times the card's bf16 peak, in %. The denominator is the calls' time,
not the window's: under an open loop the offered load fixes the work."""

from gpubench.flops import dense_decode_flops, dense_prefill_flops
from gpubench.peaks import PEAK_BF16_FLOPS


def read(run):
    pre, dec = run.spans.get("prefill", []), run.spans.get("decode", [])
    busy = sum(c["end"] - c["start"] for c in pre + dec)
    if not busy:
        return None
    flops = sum(dense_prefill_flops(run.config, c["prompt"]) for c in pre)
    flops += sum(dense_decode_flops(run.config, n) for c in dec for n in c["contexts"])
    return 100.0 * flops / (busy * PEAK_BF16_FLOPS)
