#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:
  1. device   — a CUDA card must be visible; prints its name and power limit;
  2. build    — builds the hand-written kernels from src/repro_torch/csrc;
  3. kernels  — holds each kernel against its plain PyTorch version on the
                card, on seeded inputs, and times it beside the plain version,
                the matching PyTorch library call and its roofline bound;
  4. model    — granite-smoke in float32 on the card against the same seeded
                weights on the CPU: prefill and one decode step;
  5. serving  — granite-8b at full width (36 x 4096, bf16, weights made on the
                card from a seed) serves 8 requests through ServeEngine; the
                kernel launch counts are read around this run only;
  6. profile  — the same 8 requests served again under torch.profiler: host
                and device time of the prefill and decode spans, the device's
                idle share, and the kernels that take the device time.
The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel record. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention_kernel  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel vs plain version: float32 differs by summation order only; bf16
# by the rounding of the output (and of P inside the kernel's sums).
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
MODEL_TOL = dict(atol=1e-3, rtol=1e-3)      # whole model, float32, card vs CPU


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(B, Sq, Sk, H, K, D, causal):
    """Least time (ms) for bf16 attention on these inputs: each input read and
    the output written once; QK^T and PV over the (q, k) pairs the mask keeps."""
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    flops = 4 * B * H * D * pairs
    nbytes = 2 * B * D * (2 * Sq * H + 2 * Sk * K)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# --------------------------------------------------------------------- phases
def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    # float32 matmuls in full float32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {nvidia_smi('name,power.limit')}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} cards {torch.cuda.device_count()}")
    return torch.cuda.get_device_name(0)


def phase_build():
    t0 = time.perf_counter()
    kernel._library()
    log(f"[build] flash_attention.cu built and loaded in "
        f"{time.perf_counter() - t0:.3f} s (set-up)")
    for logfile in sorted(build.BUILD_DIR.glob("*.log")):
        for line in logfile.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")


def phase_kernels(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, Sq, Sk, H, K, D, dt):
        return [torch.randn(shape, generator=gen, device=dev).to(dt)
                for shape in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D))]

    cases = []
    for S in (1, 37, 128, 340, 1000, 2048):
        for dt in (torch.bfloat16, torch.float32):
            cases.append((1, S, S, 32, 8, 128, dt, True, None))
    cases += [
        (1, 1000, 1000, 32, 8, 128, torch.bfloat16, True, 256),   # window
        (2, 300, 300, 32, 8, 128, torch.float32, False, None),    # non-causal
        (1, 128, 384, 32, 8, 128, torch.float32, True, None),     # Sq != Sk
        (2, 77, 77, 4, 2, 16, torch.float32, True, None),         # granite-smoke heads
        (2, 77, 77, 4, 2, 16, torch.bfloat16, True, None),
    ]
    errs = {}
    for (B, Sq, Sk, H, K, D, dt, causal, window) in cases:
        q, k, v = inputs(B, Sq, Sk, H, K, D, dt)
        out = flash_attention_kernel(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=causal, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), **TOL[dt])
        name = (f"B={B} Sq={Sq} Sk={Sk} H={H} K={K} D={D} {str(dt)[6:]} "
                f"causal={causal} window={window}")
        errs[(Sq, Sk, dt, causal, window, H)] = err
        log(f"[kernels] flash_attention {name}: max_abs_err={err:.3e} "
            f"(atol=rtol={TOL[dt]['atol']:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"flash_attention disagrees with its plain version at {name}")

    timings = {}
    for S in (340, 2048):
        B, H, K, D = 1, 32, 8, 128
        q, k, v = inputs(B, S, S, H, K, D, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = time_ms(lambda: flash_attention_kernel(q, k, v))
        plain_ms = time_ms(lambda: attention_ref(q, k, v), iters=5)
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bound_ms, bound_by = attention_bound(B, S, S, H, K, D, True)
        timings[S] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log(f"[kernels] flash_attention bf16 causal B=1 S={S} H=32 K=8 D=128: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), kernel at "
            f"{bound_ms / ms:.1%} of bound")
    rec = timings[340]
    rec["max_abs_err"] = errs[(340, 340, torch.bfloat16, True, None, 32)]
    return rec


def phase_model(dev) -> None:
    cfg = configs.get_smoke("granite-8b").replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 37)))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
    pos = torch.tensor([37, 30])
    before = flash_attention_kernel.launches
    res = {}
    for device in ("cpu", dev):
        p = to_device(params, device)
        with torch.inference_mode():
            logits, cache = M.prefill(p, cfg, {"tokens": tokens.to(device)}, 64)
            dlogits, cache = M.decode_step(p, cfg, cache, nxt.to(device), pos.to(device))
        res[str(device)] = (logits.cpu(), dlogits.cpu(), cache["layers"]["k"].cpu())
    launches = flash_attention_kernel.launches - before
    (cl, cd, ck), (gl, gd, gk) = res["cpu"], res[str(dev)]
    errs = [(a - b).abs().max().item() for a, b in ((gl, cl), (gd, cd), (gk, ck))]
    log(f"[model] granite-smoke f32 card vs CPU: prefill logits err {errs[0]:.3e}, "
        f"decode logits err {errs[1]:.3e}, cache err {errs[2]:.3e} "
        f"(atol=rtol=1e-3); flash_attention launches {launches}")
    if not all(torch.allclose(a, b, **MODEL_TOL)
               for a, b in ((gl, cl), (gd, cd), (gk, ck))):
        fail("granite-smoke on the card disagrees with the CPU")
    if launches != cfg.num_layers:
        fail(f"prefill launched the kernel {launches} times, not {cfg.num_layers}")


def phase_serve(dev) -> dict:
    cfg = configs.get("granite-8b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           M.compute_dtype(cfg), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in (*params["layers"].values(), params["embed"],
                                       params["unembed"], params["final_norm"]))
    log(f"[serve] granite-8b {cfg.num_layers} x {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"params in {cfg.dtype}, made on the card in "
        f"{time.perf_counter() - t0:.3f} s (set-up)")
    engine = ServeEngine(cfg, params, max_batch=4, max_len=1024, device=dev)

    stats = {"prefill_s": [], "decode_s": [], "finite": True}
    prefill, decode = engine.prefill, engine.decode

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = fn(*args)
            torch.cuda.synchronize()
            stats[key].append(time.perf_counter() - t)
            stats["finite"] &= bool(torch.isfinite(logits).all())
            if logits.shape[-1] != cfg.vocab_size:
                fail(f"logits shape {tuple(logits.shape)}")
            return logits, cache
        return run

    engine.prefill, engine.decode = timed(prefill, "prefill_s"), timed(decode, "decode_s")
    engine.submit(list(range(1, 65)), max_new_tokens=2)      # warm-up (cuBLAS set-up)
    engine.run()
    for key in ("prefill_s", "decode_s"):
        stats[key].clear()
    steps0 = engine.steps_run

    rng = np.random.default_rng(0)
    lengths = rng.integers(100, 341, 8)
    lengths[0] = 340                      # the shape the kernel is timed at
    max_new = rng.integers(2, 17, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lengths]
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = 0   # count the main path's run only
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=int(n)) for p, n in zip(prompts, max_new)]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_kernel.launches
    done = [engine.requests[r] for r in rids]
    tokens = sum(len(r.generated) for r in done)
    n_prefill, n_steps = len(stats["prefill_s"]), engine.steps_run - steps0
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] {len(done)} requests, prompts {sorted(int(n) for n in lengths)}, "
        f"max_new {[int(n) for n in max_new]}")
    log(f"[serve] wall {wall:.4f} s: {n_prefill} prefills, mean "
        f"{1e3 * statistics.mean(stats['prefill_s']):.3f} ms per request; "
        f"{n_steps} decode steps (batch 4), mean "
        f"{1e3 * statistics.mean(stats['decode_s']):.3f} ms, median "
        f"{1e3 * statistics.median(stats['decode_s']):.3f} ms per step; "
        f"{tokens} tokens, {tokens / wall:.2f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB; flash_attention launches {launches}")
    log(f"[serve] card during run: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    if not all(r.done for r in done):
        fail("not every request completed")
    if not all(1 <= len(r.generated) <= n for r, n in zip(done, max_new)):
        fail("a request generated more tokens than its budget")
    if not stats["finite"]:
        fail("non-finite logits")
    if n_prefill != len(done) or launches != cfg.num_layers * n_prefill:
        fail(f"flash_attention launches {launches} != {cfg.num_layers} x {n_prefill} prefills")
    with torch.inference_mode():                # greedy first token, request alone
        logits, _ = M.prefill(params, cfg, {"tokens": torch.tensor([prompts[0]], device=dev)}, 1024)
    if int(torch.argmax(logits[0])) != done[0].generated[0]:
        fail("first token of request 0 differs from its single-request prefill")
    return {"launches": launches, "engine": engine, "prompts": prompts,
            "max_new": max_new, "stats": stats, "wall_s": wall,
            "tokens": tokens, "steps": n_steps}


def phase_profile(serve: dict) -> None:
    """Serve phase 5's 8 requests again, under torch.profiler. Greedy decoding
    on the same weights repeats phase 5's schedule exactly (8 prefills, the
    same decode steps), which is checked. The device's idle share is given
    two ways: within the traced run (1 - kernel time / traced wall; tracing
    slows the host, so this overstates idling) and against phase 5's untraced
    wall for the same work (1 - kernel time / untraced wall; kernel times do
    not change under tracing)."""
    engine, stats = serve["engine"], serve["stats"]

    def labelled(fn, name):
        def run(*args):
            with record_function(name):
                return fn(*args)
        return run

    untraced_us = {"serve.prefill": statistics.mean(stats["prefill_s"]) * 1e6,
                   "serve.decode": statistics.mean(stats["decode_s"]) * 1e6}
    engine.prefill = labelled(engine.prefill, "serve.prefill")
    engine.decode = labelled(engine.decode, "serve.decode")
    steps0 = engine.steps_run
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rids = [engine.submit(p, max_new_tokens=int(n))
                for p, n in zip(serve["prompts"], serve["max_new"])]
        engine.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    tokens = sum(len(engine.requests[r].generated) for r in rids)
    steps = engine.steps_run - steps0
    if (tokens, steps) != (serve["tokens"], serve["steps"]):
        fail(f"traced run served {tokens} tokens in {steps} steps, phase 5 "
             f"{serve['tokens']} in {serve['steps']}")
    spans = tuple(untraced_us)
    events = prof.key_averages()
    # device-side entries: the kernels, plus one GPU range per span (skipped)
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.key not in spans]
    busy_us = sum(e.self_device_time_total for e in kernels)
    untraced_wall_us = serve["wall_s"] * 1e6
    log(f"[profile] {len(rids)} requests, {steps} decode steps: kernels busy "
        f"{busy_us / 1e3:.3f} ms; traced wall {wall_us / 1e3:.3f} ms (device idle "
        f"{1 - busy_us / wall_us:.1%}); untraced wall (phase 5) "
        f"{untraced_wall_us / 1e3:.3f} ms (device idle "
        f"{1 - busy_us / untraced_wall_us:.1%})")
    for e in events:
        if e.key in spans and e.device_type == DeviceType.CPU:
            dev_us = e.device_time_total / e.count
            log(f"[profile] {e.key}: {e.count} calls, per call: untraced "
                f"(phase 5) {untraced_us[e.key] / 1e3:.3f} ms, traced host "
                f"{e.cpu_time_total / e.count / 1e3:.3f} ms, kernels "
                f"{dev_us / 1e3:.3f} ms; device idle share of an untraced call "
                f"{1 - dev_us / untraced_us[e.key]:.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile] kernel {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.self_device_time_total / max(busy_us, 1):6.1%} x{e.count:<5} {e.key[:90]}")


def main() -> int:
    kind = phase_device()
    dev = torch.device("cuda")
    phase_build()
    rec = phase_kernels(dev)
    phase_model(dev)
    serve = phase_serve(dev)
    phase_profile(serve)
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:79",
        "launches": serve["launches"], "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
    }]
    log(nvidia_smi("name,power.limit"))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
