"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates at the
700 W limit). A frozen copy of the port's table (``repro_torch.launch.mesh.HW``,
which ``chip_smoke.py`` reads): the benchmark keeps its own, so a change to
the port's cannot move a roofline share."""

PEAK_BF16_FLOPS = 989e12      # FLOP/s, tensor cores
PEAK_F32_FLOPS = 67e12        # FLOP/s, outside the tensor cores
PEAK_HBM_BYTES = 3.35e12      # B/s
