"""Time the flash backward kernel with its dK/dV pass split over the q heads
and not, at shapes on both sides of the library's split rule
(``SPLIT_WAVES`` in ``src/repro_torch/csrc/flash_attention_bwd.cu``), so
that the rule can be read against a measurement.

    python tools/flash_bwd_split.py          (on a card)

The source is built three times into ``src/repro_torch/_build/split/``: as
it is (``rule``), with ``SPLIT_WAVES = 0`` (``never`` split) and with
``SPLIT_WAVES = 1 << 20`` (``always``, wherever a kv head has G > 1 q
heads). Each shape is timed on the three in turns (rule, never, always,
always, never, rule) by CUDA events, and the results of the three are
checked equal to the split's own rounding. One JSON line per shape, with
the unsplit grid's CTAs and the card's SM count; the first line names the
card and its power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.build import BUILD_DIR, build_library  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    SOURCE_BWD, bind_bwd, flash_attention_kernel)

RULE = "constexpr int SPLIT_WAVES = 2;"
VARIANTS = {"rule": None, "never": "0", "always": "1 << 20"}
# (B, S, H, K, D, window, dtype), causal: recurrentgemma-2b's call (K = 1)
# at 1 to 4 rows and two lengths, tiny's heads (K = 4) at bf16 around two
# waves, and the f32 route at both models' calls.
SHAPES = [(1, 4096, 10, 1, 256, 2048, torch.bfloat16), (1, 2048, 10, 1, 256, 2048, torch.bfloat16),
          (2, 4096, 10, 1, 256, 2048, torch.bfloat16), (4, 4096, 10, 1, 256, 2048, torch.bfloat16),
          (1, 4096, 8, 4, 64, None, torch.bfloat16), (2, 4096, 8, 4, 64, None, torch.bfloat16),
          (8, 2048, 8, 4, 64, None, torch.bfloat16), (8, 4096, 8, 4, 64, None, torch.float32),
          (1, 4096, 10, 1, 256, 2048, torch.float32)]


def variant_library(name: str):
    """The backward library built with SPLIT_WAVES replaced (``rule``: as
    it is), from a copy of the source and its headers."""
    src = SOURCE_BWD.read_text()
    if RULE not in src:
        raise SystemExit(f"{SOURCE_BWD.name} has no line {RULE!r}")
    value = VARIANTS[name]
    out = BUILD_DIR / "split" / name
    out.mkdir(parents=True, exist_ok=True)
    for header in SOURCE_BWD.parent.glob("*.cuh"):
        (out / header.name).write_bytes(header.read_bytes())
    copy = out / SOURCE_BWD.name
    copy.write_text(src if value is None else src.replace(RULE, f"constexpr int SPLIT_WAVES = {value};"))
    return bind_bwd(build_library(copy, out))


def run(lib, g, q, k, v, o, window):
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    is_bf16 = int(q.dtype == torch.bfloat16)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty(lib.repro_flash_attention_bwd_scratch_floats(B, Sq, Sk, H, K, D, is_bf16),
                      dtype=torch.float32, device=q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = lib.repro_flash_attention_bwd(
        g.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, Sq, Sk, H, K, D,
        is_bf16, 1, window or 0, D ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"backward kernel failed: CUDA error {err}")
    return dq, dk, dv


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("this tool times the kernel on a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(json.dumps({"card": card.strip(), "sms": sms, "rule": RULE}), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:      # one nvcc each, together
        libs = dict(zip(VARIANTS, pool.map(variant_library, VARIANTS)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H, K, D, window, dt in SHAPES:
        q, g = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda").to(dt) for _ in range(2))
        o = flash_attention_kernel(q, k, v, causal=True, window=window)
        outs = {name: run(lib, g, q, k, v, o, window) for name, lib in libs.items()}
        # the split sums the heads in another order: equal to f32's rounding,
        # or to one bf16 rounding of the f32 sums
        tol = 1e-2 if dt == torch.bfloat16 else 1e-4
        diff = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                   for name in ("never", "always") for a, b in zip(outs[name], outs["rule"]))
        if diff > tol:
            raise SystemExit(f"variants disagree by {diff:.3e} of the scale at {B, S, H, K, D}")
        fns = {name: (lambda lib=lib: run(lib, g, q, k, v, o, window)) for name, lib in libs.items()}
        order = list(VARIANTS) + list(VARIANTS)[::-1]
        ms = {name: 0.0 for name in VARIANTS}
        for name in order:
            ms[name] += time_ms(fns[name]) / 2
        bn = 32 if (D == 256 and dt == torch.float32) else 64
        print(json.dumps({"shape": f"{str(dt)[6:]} causal B={B} S={S} H={H} K={K} D={D}"
                          + (f" w={window}" if window else ""),
                          "ctas_unsplit": -(-S // bn) * K * B, "split_below": 2 * sms,
                          "ms": {n: round(t, 4) for n, t in ms.items()},
                          "max_rel_diff": float(f"{diff:.3g}")}), flush=True)
        del q, k, v, g, o, outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
