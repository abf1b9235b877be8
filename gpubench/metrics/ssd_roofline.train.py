"""ssd_roofline.train: the least time of the window's SSD-scan forward calls
(max(FLOPs / peak, bytes / bandwidth) of each call at the traffic's shapes,
by gpubench.flops; remat's second forward is a call too) over the device
time of the kernels launched under the ``repro_torch::ssd_scan`` op in the
traced window, in %. Nothing is returned when the trace shows no such op."""

from gpubench.flops import bound_s, ssd_counts

OP = "repro_torch::ssd_scan"


def read(run):
    r = run.trace.ranges.get(OP) if run.trace is not None else None
    if not r or not r["device_ns"]:
        return None
    a, mix = run.config["assumed"], run.traffic
    H = a["expand"] * run.config["d_model"] // a["headdim"]
    per_call = bound_s(*ssd_counts(mix["rows"], mix["seq"], H, a["headdim"], a["d_state"],
                                   a["chunk_size"]))
    return 100.0 * r["calls"] * per_call / (r["device_ns"] / 1e9)
