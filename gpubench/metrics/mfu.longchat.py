"""mfu.longchat: the model FLOPs of the window's prefill and decode calls
(gpubench.mla_flops, from the published widths, attention in the published
non-absorbed form) over those calls' synchronised time times the card's bf16
peak, in %. Read as mfu.serve reads: the denominator is the calls' time,
not the window's."""

from gpubench.mla_flops import mla_decode_flops, mla_prefill_flops
from gpubench.peaks import PEAK_BF16_FLOPS


def read(run):
    pre, dec = run.spans.get("prefill", []), run.spans.get("decode", [])
    busy = sum(c["end"] - c["start"] for c in pre + dec)
    if not busy:
        return None
    flops = sum(mla_prefill_flops(run.config, c["prompt"]) for c in pre)
    flops += sum(mla_decode_flops(run.config, n) for c in dec for n in c["contexts"])
    return 100.0 * flops / (busy * PEAK_BF16_FLOPS)
