"""mla_decode_roofline.longchat: the least time the traced decode steps'
latent attention needs (gpubench.mla_flops: each active row's written slots
read once in every layer, with its query and output, against max(FLOPs /
peak, bytes / bandwidth)), over the device time of the latent decode
kernels in the traced window, found by kernel name (``mla_decode`` in it:
the main kernel and its combine), in %. The serve driver collects op ranges
for the flash op only, so the kernels are read from the trace's operations.
Nothing is returned when the trace shows no such kernel."""

from gpubench.mla_flops import mla_decode_bound_s

KERNEL = "mla_decode"


def read(run):
    if run.trace is None:
        return None
    ns = sum(t for name, (_, t) in run.trace.ops.items() if KERNEL in name)
    if not ns:
        return None
    need = sum(mla_decode_bound_s(run.config, c["contexts"])
               for c in run.spans.get("decode", []) if c["contexts"])
    return 100.0 * need / (ns / 1e9)
