"""flash_roofline.serve: the least time the window's flash-attention
forward work needs (each prefill's causal self-attention in every layer,
max(FLOPs / peak, bytes / bandwidth) by gpubench.flops), over the device
time of the kernels launched under the ``repro_torch::flash_attention`` op
in the traced window, in %. Read by op, so the share survives a change of
kernel; nothing is returned when the trace shows no such op."""

from gpubench.flops import attention_counts, bound_s

OP = "repro_torch::flash_attention"


def read(run):
    if run.trace is None or not run.trace.ranges.get(OP, {}).get("device_ns"):
        return None
    c = run.config
    H, K = c["num_attention_heads"], c["num_key_value_heads"]
    D = c.get("head_dim") or c["hidden_size"] // H
    need = sum(c["num_hidden_layers"] * bound_s(*attention_counts(1, p["prompt"], p["prompt"],
                                                                  H, K, D, True))
               for p in run.spans.get("prefill", []))
    return 100.0 * need / (run.trace.ranges[OP]["device_ns"] / 1e9)
