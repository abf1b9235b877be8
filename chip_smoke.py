#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:
  1. device   — a CUDA card must be visible; prints its name and power limit;
  2. build    — builds the hand-written kernels from src/repro_torch/csrc,
                one nvcc per source, all started together;
  3. kernels  — holds each kernel against its plain PyTorch version on the
                card, on seeded inputs (flash attention at head_dim 128 and
                256, the RG-LRU scan, the SSD scan), and times it beside the
                plain version, the matching PyTorch library call where there
                is one and its roofline bound; holds the SSD kernel's
                gradient rule (autograd through the Function) against
                autograd through the plain version, and times it;
  4. model    — granite-smoke and recurrentgemma-smoke in float32 on the card
                against the same seeded weights on the CPU: prefill, decode
                and every cache leaf, with the kernel launches per prefill;
                mamba2-smoke training in float32, card against CPU: the loss
                and every gradient leaf of one step, then a 3-step loss
                curve, with the SSD launches per step;
  5. serving  — granite-8b at full width (36 x 4096, bf16), then
                recurrentgemma-2b at full width (26 layers, 2560 wide, bf16),
                weights made on the card from a seed, each serving 8 requests
                through ServeEngine; the kernel launch counts are set to 0
                just before each run and read just after it;
  6. profile  — after each serving run, the same 8 requests served again under
                torch.profiler: host and device time of the prefill and decode
                spans, the device's idle share, and the kernels that take the
                device time;
  7. training — mamba2-130m at full width (24 layers, d_model 768, bf16
                activations over f32 master params and moments) trained for
                6 steps of 8 x 2048 tokens through train_loop, the SSD launch
                count set to 0 just before and read just after (24 per step);
                loss per step, ms/step, tokens/s, peak memory; then one more
                step of the same state under torch.profiler: kernel time by
                name, the SSD kernel's and the gradient rule's shares, and
                the device's idle share.
The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel record. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_module  # noqa: E402
from repro_torch.kernels.rglru import kernel as lru_module  # noqa: E402
from repro_torch.kernels.rglru import lru_scan_kernel, lru_scan_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_module  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ssd_kernel, ssd_ref, ssd_vjp  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.parallel.steps import init_train_state, make_train_step  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.train.loop import train_loop  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_BYTES = 3.35e12

# Kernel vs plain version: float32 differs by summation order only; bf16
# by the rounding of the output (and of P inside the flash kernel's sums).
# The SSD scan's cum, which exp(cum_i - cum_j) amplifies, is summed alike on
# both sides (in f64, rounded once), so there too only matmul sums differ.
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# The scan and its plain version do the same f32 steps in the same order
# (a product, then a sum, each rounded), so they agree to the bit; the
# tolerance allows one ulp of the output should the compiler contract them.
LRU_TOL = {torch.float32: dict(atol=1e-6, rtol=1e-6),
           torch.bfloat16: dict(atol=0, rtol=8e-3)}
MODEL_TOL = dict(atol=1e-3, rtol=1e-3)      # whole model, float32, card vs CPU
T_START = time.perf_counter()


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


def bound(t_ops: float, t_bytes: float) -> tuple[float, str]:
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(B, Sq, Sk, H, K, D, causal, window=None):
    """Least time (ms) for bf16 attention on these inputs: each input read and
    the output written once; QK^T and PV over the (q, k) pairs the mask keeps
    (q and k positions both counted from 0)."""
    def keys(i):
        hi = min(i + 1, Sk) if causal else Sk
        lo = max(0, i - window + 1) if window else 0
        return max(0, hi - lo)
    pairs = sum(keys(i) for i in range(Sq))
    flops = 4 * B * H * D * pairs
    nbytes = 2 * B * D * (2 * Sq * H + 2 * Sk * K)
    return bound(flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3)


def lru_bound(B, S, W, itemsize):
    """Least time (ms) for the scan: a and b read once, h written once; one
    f32 product and one sum per element."""
    return bound(2 * B * S * W / PEAK_F32_FLOPS * 1e3,
                 3 * B * S * W * itemsize / PEAK_BYTES * 1e3)


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def reset_counts() -> None:
    flash_attention_kernel.launches = 0
    lru_scan_kernel.launches = 0
    ssd_kernel.launches = 0


def read_counts() -> dict:
    return {"flash_attention": flash_attention_kernel.launches,
            "lru_scan": lru_scan_kernel.launches,
            "ssd_scan": ssd_kernel.launches}


NO_LAUNCHES = {"flash_attention": 0, "lru_scan": 0, "ssd_scan": 0}


def launches_per_prefill(cfg) -> dict:
    kinds = tfm.layer_kinds(cfg)
    return {"flash_attention": sum(k in ("attn", "local_attn") for k in kinds),
            "lru_scan": kinds.count("rglru"), "ssd_scan": 0}


def launches_per_train_step(cfg) -> dict:
    """One SSD launch per ssm layer in each step's forward; the backward is
    the plain gradient rule and launches nothing."""
    return {**NO_LAUNCHES, "ssd_scan": tfm.layer_kinds(cfg).count("ssm")}


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
    modules = (flash_module, lru_module, ssd_module)
    with ThreadPoolExecutor(len(modules)) as pool:      # one nvcc per source
        for fut in [pool.submit(m._library) for m in modules]:
            fut.result()
    log(f"[build] {', '.join(m.SOURCE.name for m in modules)} built and loaded "
        f"in {time.perf_counter() - t0:.3f} s (set-up)")
    for logfile in sorted(build.BUILD_DIR.glob("*.log")):
        for line in logfile.read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[build] {logfile.name.split('-')[0]}: {line.strip()}")


def check_flash(gen, dev) -> dict:
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
    for S in (340, 2500):                   # recurrentgemma-2b local attention
        for dt in (torch.bfloat16, torch.float32):
            cases.append((1, S, S, 10, 1, 256, dt, True, 2048))
    cases.append((2, 45, 45, 4, 1, 16, torch.float32, True, 32))  # recurrentgemma-smoke
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
        errs[(Sq, dt, H, D, window)] = err
        log(f"[kernels] flash_attention {name}: max_abs_err={err:.3e} "
            f"(atol=rtol={TOL[dt]['atol']:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"flash_attention disagrees with its plain version at {name}")

    timings = {}
    for (S, H, K, D, window) in ((340, 32, 8, 128, None), (2048, 32, 8, 128, None),
                                 (340, 10, 1, 256, 2048), (2500, 10, 1, 256, 2048)):
        B = 1
        q, k, v = inputs(B, S, S, H, K, D, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if window is None:
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        else:                              # SDPA takes the window as a boolean mask
            qpos = torch.arange(S, device=dev)[:, None]
            kpos = torch.arange(S, device=dev)[None, :]
            mask = (kpos <= qpos) & (qpos - kpos < window)
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        ms = time_ms(lambda: flash_attention_kernel(q, k, v, window=window))
        plain_ms = time_ms(lambda: attention_ref(q, k, v, window=window), iters=5)
        lib_ms = time_ms(lib)
        bound_ms, bound_by = attention_bound(B, S, S, H, K, D, True, window)
        shape = f"bf16 causal B=1 S={S} H={H} K={K} D={D} window={window}"
        timings[(S, D)] = dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               max_abs_err=errs.get((S, torch.bfloat16, H, D, window)))
        log(f"[kernels] flash_attention {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), kernel at {bound_ms / ms:.1%} of bound")
    return {"d128": timings[(340, 128)], "d256": timings[(2500, 256)]}


def check_lru(gen, dev) -> dict:
    def inputs(B, S, W, dt):
        a = torch.rand((B, S, W), generator=gen, device=dev).to(dt)   # decays in [0, 1)
        b = torch.randn((B, S, W), generator=gen, device=dev).to(dt)
        return a, b

    errs = {}
    shapes = [(1, 1, 2560), (1, 3, 2560), (1, 340, 2560), (4, 1000, 2560),
              (1, 2500, 2560), (2, 77, 64), (1, 300, 130), (3, 17, 130)]
    for (B, S, W) in shapes:
        for dt in (torch.float32, torch.bfloat16):
            a, b = inputs(B, S, W, dt)
            out = lru_scan_kernel(a, b)
            torch.cuda.synchronize()
            ref = lru_scan_ref(a, b)
            err = (out.float() - ref.float()).abs().max().item()
            ok = out.dtype == dt and torch.allclose(out.float(), ref.float(), **LRU_TOL[dt])
            name = f"B={B} S={S} W={W} {str(dt)[6:]}"
            errs[(B, S, W, dt)] = err
            log(f"[kernels] lru_scan {name}: max_abs_err={err:.3e} "
                f"(atol={LRU_TOL[dt]['atol']:g} rtol={LRU_TOL[dt]['rtol']:g}) "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"lru_scan disagrees with its plain version at {name}")

    timings = {}
    for S in (340, 2500):
        B, W = 1, 2560
        a, b = inputs(B, S, W, torch.bfloat16)
        ms = time_ms(lambda: lru_scan_kernel(a, b))
        plain_ms = time_ms(lambda: lru_scan_ref(a, b), iters=3, warmup=1)
        bound_ms, bound_by = lru_bound(B, S, W, 2)
        shape = f"bf16 B=1 S={S} W={W}"
        timings[S] = dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=errs[(B, S, W, torch.bfloat16)])
        log(f"[kernels] lru_scan {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"no library call, bound {bound_ms:.4f} ms ({bound_by}), kernel at "
            f"{bound_ms / ms:.1%} of bound")
    return timings[2500]


def ssd_counts(B, S, H, P, N, chunk, itemsize) -> tuple[float, float]:
    """(FLOPs, bytes) the SSD scan needs on these shapes, in its chunked form:
    C B^T once per (batch row, chunk) over the causal (i, j) pairs (B and C
    are shared by the heads), then per head the masked scores times u over
    the same pairs, the inter-chunk term C h^T (every chunk after the first)
    and the state update (every chunk before the last). Bytes: x, B, C read
    and y written once in the compute dtype, dt and A once in f32."""
    flops = 0
    starts = range(0, S, min(chunk, S))
    for c, c0 in enumerate(starts):
        q = min(chunk, S - c0)
        pairs = q * (q + 1) // 2
        flops += 2 * B * pairs * N                      # C B^T
        flops += 2 * B * H * pairs * P                  # scores u
        if c > 0:
            flops += 2 * B * H * q * N * P              # C h^T
        if c < len(starts) - 1:
            flops += 2 * B * H * q * P * N              # state update
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * itemsize + (B * S * H + H) * 4
    return float(flops), float(nbytes)


def ssd_inputs(gen, dev, B, S, H, P, N, dt):
    """Reference-test statistics: x, B, C ~ N(0, 1) in ``dt``; dt =
    softplus(N(0, 1)) and A = -exp(N(0, 1)) in f32."""
    x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dt)
    dts = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev))
    Bm = torch.randn((B, S, N), generator=gen, device=dev).to(dt)
    Cm = torch.randn((B, S, N), generator=gen, device=dev).to(dt)
    return x, dts, A, Bm, Cm


def check_ssd(gen, dev) -> dict:
    errs = {}
    shapes = [(1, 1, 24, 64, 128, 256), (2, 77, 8, 16, 16, 32), (1, 31, 8, 16, 16, 32),
              (1, 300, 3, 24, 40, 64), (2, 1000, 24, 64, 128, 256),
              (8, 2048, 24, 64, 128, 256)]
    for (B, S, H, P, N, chunk) in shapes:
        for dt in (torch.float32, torch.bfloat16):
            inputs = ssd_inputs(gen, dev, B, S, H, P, N, dt)
            out = ssd_kernel(*inputs, chunk=chunk)
            torch.cuda.synchronize()
            ref = ssd_ref(*inputs, chunk=chunk)
            err = (out.float() - ref.float()).abs().max().item()
            ok = out.dtype == dt and torch.allclose(out.float(), ref.float(), **TOL[dt])
            name = f"B={B} S={S} H={H} P={P} N={N} chunk={chunk} {str(dt)[6:]}"
            errs[(B, S, dt)] = err
            log(f"[kernels] ssd_scan {name}: max_abs_err={err:.3e} (max |y| "
                f"{ref.float().abs().max().item():.1f}; atol=rtol={TOL[dt]['atol']:g}) "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"ssd_scan disagrees with its plain version at {name}")
            del inputs, out, ref

    B, S, H, P, N, chunk = 8, 2048, 24, 64, 128, 256      # mamba2-130m's training shape
    inputs = ssd_inputs(gen, dev, B, S, H, P, N, torch.bfloat16)
    ms = time_ms(lambda: ssd_kernel(*inputs, chunk=chunk))
    plain_ms = time_ms(lambda: ssd_ref(*inputs, chunk=chunk), iters=5)
    flops, nbytes = ssd_counts(B, S, H, P, N, chunk, 2)
    bound_ms, bound_by = bound(flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3)
    shape = f"bf16 B={B} S={S} H={H} P={P} N={N} chunk={chunk}"
    log(f"[kernels] ssd_scan {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"no library call, bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.3f} "
        f"GFLOP at 989 TFLOP/s, {nbytes / 1e6:.3f} MB at 3.35 TB/s), kernel at "
        f"{bound_ms / ms:.1%} of bound")
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=errs[(B, S, torch.bfloat16)],
                flops=flops, bytes=nbytes)


def check_ssd_grad(gen, dev) -> dict:
    """The gradient rule on the card: backward through the kernel's
    autograd.Function (forward: the kernel; backward: ssd_vjp) against
    autograd through the plain version, for all five inputs; then the
    rule's time at the training shape."""
    res = {}
    for (B, S, H, P, N, chunk, dt) in ((2, 77, 8, 16, 16, 32, torch.float32),
                                       (8, 2048, 24, 64, 128, 256, torch.bfloat16)):
        inputs = ssd_inputs(gen, dev, B, S, H, P, N, dt)
        g = torch.randn((B, S, H, P), generator=gen, device=dev).to(dt)
        a = [t.detach().clone().requires_grad_() for t in inputs]
        b = [t.detach().clone().requires_grad_() for t in inputs]
        ssd_ops._SSDKernel.apply(*a, chunk).backward(g)
        ssd_ref(*b, chunk=chunk).backward(g)
        torch.cuda.synchronize()
        name = f"B={B} S={S} H={H} P={P} N={N} chunk={chunk} {str(dt)[6:]}"
        worst = 0.0
        for label, ta, tb in zip(("x", "dt", "A", "Bm", "Cm"), a, b):
            err = (ta.grad.float() - tb.grad.float()).abs().max().item()
            worst = max(worst, err)
            if ta.grad.dtype != tb.grad.dtype or not torch.allclose(
                    ta.grad.float(), tb.grad.float(), **TOL[dt]):
                fail(f"ssd gradient rule disagrees with autograd through ssd_ref "
                     f"for {label} at {name} (err {err:.3e})")
        log(f"[kernels] ssd_scan gradient rule {name}: all five input gradients "
            f"agree with autograd through ssd_ref, max_abs_err={worst:.3e} "
            f"(atol=rtol={TOL[dt]['atol']:g})")
        res = dict(shape=name, max_abs_err=worst)
        del a, b
    ms = time_ms(lambda: ssd_vjp(g, *inputs, chunk=chunk), iters=5)
    fwd_ms = time_ms(lambda: ssd_ref(*inputs, chunk=chunk), iters=5)
    log(f"[kernels] ssd_scan gradient rule (ssd_vjp: plain recompute + autograd) "
        f"{name}: {ms:.4f} ms per call (the plain forward alone {fwd_ms:.4f} ms)")
    return {**res, "ms": ms}


def phase_kernels(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    return {"flash": check_flash(gen, dev), "lru": check_lru(gen, dev),
            "ssd": check_ssd(gen, dev), "ssd_grad": check_ssd_grad(gen, dev)}


def model_check(dev, arch: str, B: int, S: int, pos: list[int], max_len: int) -> None:
    """Smoke width in float32, card against CPU on one set of seeded weights:
    one prefill and one decode step at per-row positions ``pos``."""
    cfg = configs.get_smoke(arch).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
    res, counts = {}, {}
    for device in ("cpu", dev):
        p = to_device(params, device)
        with torch.inference_mode():
            reset_counts()
            logits, cache = M.prefill(p, cfg, {"tokens": tokens.to(device)}, max_len)
            counts[str(device)] = read_counts()
            dlogits, cache = M.decode_step(p, cfg, cache, nxt.to(device),
                                           torch.tensor(pos, device=device))
        res[str(device)] = {"prefill logits": logits.cpu(), "decode logits": dlogits.cpu(),
                            **{f"cache {k}": t.cpu() for k, t in leaves(cache["layers"])}}
    cpu, card = res["cpu"], res[str(dev)]
    errs = {k: (card[k] - cpu[k]).abs().max().item() for k in cpu}
    worst = max(errs, key=errs.get)
    launches, expect = counts[str(dev)], launches_per_prefill(cfg)
    log(f"[model] {cfg.name} f32 card vs CPU, prompt {S} x {B} rows, decode at "
        f"pos {pos}: prefill logits err {errs['prefill logits']:.3e}, decode logits "
        f"err {errs['decode logits']:.3e}, {len(errs) - 2} cache leaves, worst "
        f"{worst} {errs[worst]:.3e} (atol=rtol=1e-3); launches per prefill "
        f"{launches}, expected {expect}")
    if not all(torch.allclose(card[k], cpu[k], **MODEL_TOL) for k in cpu):
        fail(f"{cfg.name} on the card disagrees with the CPU")
    if counts["cpu"] != NO_LAUNCHES:
        fail(f"the CPU path launched kernels: {counts['cpu']}")
    if launches != expect:
        fail(f"{cfg.name} prefill launched {launches}, expected {expect}")


def train_check(dev) -> None:
    """mamba2-smoke in float32, card against CPU from one set of seeded
    params: the loss and every gradient leaf of one step, then a 3-step loss
    curve through make_train_step, with the SSD launches per step."""
    cfg = configs.get_smoke("mamba2-130m").replace(dtype="float32")
    batches = [make_batch(cfg, 2, 100, seed=0, step=i) for i in range(3)]  # ragged vs chunk 32
    res, counts = {}, {}
    for device in ("cpu", dev):
        # the same seeded draw on the CPU for each device (a train step
        # updates its state in place)
        state = to_device(init_train_state(cfg, torch.Generator().manual_seed(0)), device)
        params = state["params"]
        names, tensors = zip(*leaves(params))
        for t in tensors:
            t.requires_grad_(True)
        reset_counts()
        loss = M.loss_fn(params, cfg, to_device(batches[0], device))
        grads = torch.autograd.grad(loss, tensors)
        one = {"loss": loss.detach().cpu(),
               **{f"grad {n}": g.cpu() for n, g in zip(names, grads)}}
        step = make_train_step(cfg, opt=OptConfig(warmup_steps=2))
        curve, per_step = [], []
        for b in batches:
            reset_counts()
            state, metrics = step(state, to_device(b, device))
            curve.append(metrics["loss"].item())
            per_step.append(read_counts())
        res[str(device)] = (one, torch.tensor(curve))
        counts[str(device)] = per_step
    (cpu_one, cpu_curve), (card_one, card_curve) = res["cpu"], res[str(dev)]
    errs = {k: (card_one[k] - cpu_one[k]).abs().max().item() for k in cpu_one}
    worst = max(errs, key=errs.get)
    expect = launches_per_train_step(cfg)
    log(f"[model] {cfg.name} training f32 card vs CPU, batch 2 x 100: loss "
        f"{cpu_one['loss'].item():.6f} err {errs['loss']:.3e}, {len(errs) - 1} grad "
        f"leaves, worst {worst} {errs[worst]:.3e}; 3-step loss curve card "
        f"{card_curve.tolist()} CPU {cpu_curve.tolist()} (atol=rtol=1e-3); launches "
        f"per step {counts[str(dev)]}, expected {expect}")
    if not all(torch.allclose(card_one[k], cpu_one[k], **MODEL_TOL) for k in cpu_one):
        fail(f"{cfg.name} training on the card disagrees with the CPU")
    if not torch.allclose(card_curve, cpu_curve, **MODEL_TOL):
        fail(f"{cfg.name} loss curve on the card disagrees with the CPU")
    if any(c != NO_LAUNCHES for c in counts["cpu"]):
        fail(f"the CPU path launched kernels: {counts['cpu']}")
    if any(c != expect for c in counts[str(dev)]):
        fail(f"{cfg.name} train steps launched {counts[str(dev)]}, expected {expect} each")


def phase_model(dev) -> None:
    model_check(dev, "granite-8b", B=2, S=37, pos=[37, 30], max_len=64)
    # longer than the smoke window of 32: the local-attention ring rolls
    model_check(dev, "recurrentgemma-2b", B=2, S=45, pos=[45, 33], max_len=64)
    train_check(dev)


def phase_serve(dev, arch: str, *, max_len: int, prompt_range: tuple[int, int]) -> dict:
    """Serve 8 requests at full width with prompt lengths drawn from
    ``prompt_range`` (the longest forced into request 0), 2-16 new tokens."""
    cfg = configs.get(arch)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           M.compute_dtype(cfg), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in leaves(params))
    log(f"[serve] {arch} {cfg.num_layers} x {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"params in {cfg.dtype}, made on the card in "
        f"{time.perf_counter() - t0:.3f} s (set-up)")
    engine = ServeEngine(cfg, params, max_batch=4, max_len=max_len, device=dev)

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
    lengths = rng.integers(prompt_range[0], prompt_range[1] + 1, 8)
    lengths[0] = prompt_range[1]          # the longest shape the kernels are timed at
    max_new = rng.integers(2, 17, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lengths]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                        # count the main path's run only
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=int(n)) for p, n in zip(prompts, max_new)]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    done = [engine.requests[r] for r in rids]
    tokens = sum(len(r.generated) for r in done)
    n_prefill, n_steps = len(stats["prefill_s"]), engine.steps_run - steps0
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] {arch}: {len(done)} requests, prompts "
        f"{sorted(int(n) for n in lengths)}, max_new {[int(n) for n in max_new]}")
    log(f"[serve] {arch}: wall {wall:.4f} s: {n_prefill} prefills, mean "
        f"{1e3 * statistics.mean(stats['prefill_s']):.3f} ms per request; "
        f"{n_steps} decode steps (batch 4), mean "
        f"{1e3 * statistics.mean(stats['decode_s']):.3f} ms, median "
        f"{1e3 * statistics.median(stats['decode_s']):.3f} ms per step; "
        f"{tokens} tokens, {tokens / wall:.2f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB; launches {launches}")
    log(f"[serve] card during run: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    if not all(r.done for r in done):
        fail("not every request completed")
    if not all(1 <= len(r.generated) <= n for r, n in zip(done, max_new)):
        fail("a request generated more tokens than its budget")
    if not stats["finite"]:
        fail("non-finite logits")
    expect = {k: n * n_prefill for k, n in launches_per_prefill(cfg).items()}
    if n_prefill != len(done) or launches != expect:
        fail(f"{arch}: launches {launches} != {expect} for {n_prefill} prefills")
    with torch.inference_mode():                # greedy first token, request alone
        logits, _ = M.prefill(params, cfg, {"tokens": torch.tensor([prompts[0]], device=dev)},
                              max_len)
    if int(torch.argmax(logits[0])) != done[0].generated[0]:
        fail("first token of request 0 differs from its single-request prefill")
    return {"arch": arch, "launches": launches, "engine": engine, "prompts": prompts,
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
    engine, stats, arch = serve["engine"], serve["stats"], serve["arch"]

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
        fail(f"{arch}: traced run served {tokens} tokens in {steps} steps, phase 5 "
             f"{serve['tokens']} in {serve['steps']}")
    spans = tuple(untraced_us)
    events = prof.key_averages()
    # device-side entries: the kernels, plus one GPU range per span (skipped)
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.key not in spans]
    busy_us = sum(e.self_device_time_total for e in kernels)
    untraced_wall_us = serve["wall_s"] * 1e6
    log(f"[profile] {arch}: {len(rids)} requests, {steps} decode steps: kernels busy "
        f"{busy_us / 1e3:.3f} ms; traced wall {wall_us / 1e3:.3f} ms (device idle "
        f"{1 - busy_us / wall_us:.1%}); untraced wall (phase 5) "
        f"{untraced_wall_us / 1e3:.3f} ms (device idle "
        f"{1 - busy_us / untraced_wall_us:.1%})")
    for e in events:
        if e.key in spans and e.device_type == DeviceType.CPU:
            dev_us = e.device_time_total / e.count
            log(f"[profile] {arch} {e.key}: {e.count} calls, per call: untraced "
                f"(phase 5) {untraced_us[e.key] / 1e3:.3f} ms, traced host "
                f"{e.cpu_time_total / e.count / 1e3:.3f} ms, kernels "
                f"{dev_us / 1e3:.3f} ms; device idle share of an untraced call "
                f"{1 - dev_us / untraced_us[e.key]:.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile] {arch} kernel {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.self_device_time_total / max(busy_us, 1):6.1%} x{e.count:<5} {e.key[:90]}")


def serve_and_profile(dev, arch: str, **kw) -> dict:
    """Phases 5 and 6 for one arch; frees its weights and cache after."""
    serve = phase_serve(dev, arch, **kw)
    phase_profile(serve)
    launches = serve["launches"]
    serve.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] {arch} served and profiled at {time.perf_counter() - T_START:.1f} s")
    return launches


TRAIN = dict(steps=6, global_batch=8, seq_len=2048, seed=0)


def phase_train(dev) -> dict:
    """mamba2-130m at full width through train_loop, the entry point the
    launcher and a cluster job call, on the card, 6 steps of 8 x 2048
    tokens at --lr 3e-4; the kernel counts are set to 0 just before and read
    just after. Step times come from the host clock between the loop's
    per-step metric reads, each of which synchronises."""
    cfg = configs.get("mamba2-130m")
    opt = OptConfig(lr=3e-4)
    stamps, losses = [], []

    def on_metrics(step, m):
        stamps.append(time.perf_counter())
        losses.append(m["loss"])
        log(f"[train] step {step}: loss {m['loss']:.6f} grad_norm {m['grad_norm']:.4f} "
            f"lr {m['lr']:.3e}")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()                        # count the main path's run only
    t0 = time.perf_counter()
    result = train_loop(cfg, opt=opt, log_every=1, on_metrics=on_metrics,
                        device=dev, **TRAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    steady = step_s[1:]                   # step 0 also pays cuBLAS and allocator set-up
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    expect = {k: n * TRAIN["steps"] for k, n in launches_per_train_step(cfg).items()}
    log(f"[train] {cfg.name} {cfg.num_layers} x {cfg.d_model}, "
        f"{cfg.param_count():,} params (f32 masters and moments), activations "
        f"{cfg.dtype}, {TRAIN['steps']} steps of {TRAIN['global_batch']} x "
        f"{TRAIN['seq_len']} tokens: wall {wall:.4f} s (params made on the card "
        f"included); step 0 {1e3 * step_s[0]:.3f} ms; steps 1-{len(steady)} mean "
        f"{1e3 * statistics.mean(steady):.3f} ms, median "
        f"{1e3 * statistics.median(steady):.3f} ms per step, "
        f"{tokens / statistics.mean(steady):.1f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB; launches {launches}")
    log(f"[train] card during run: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    if result.status != "done" or result.step != TRAIN["steps"] or len(losses) != TRAIN["steps"]:
        fail(f"training ended {result.status} at step {result.step}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        fail(f"first loss {losses[0]:.4f} is far from ln(vocab) {math.log(cfg.vocab_size):.4f}")
    if launches != expect:
        fail(f"training launched {launches}, expected {expect} "
             f"({launches_per_train_step(cfg)} per step)")
    return {"launches": launches, "cfg": cfg, "opt": opt,
            "step_ms": statistics.mean(steady) * 1e3}


def phase_train_profile(dev, train: dict) -> None:
    """One train step of mamba2-130m at full width under torch.profiler, after
    one untraced warm-up step of the same state and batch shape: kernel time
    by name, the SSD kernel's share, the gradient rule's share (the device
    time under a label put around ssd_vjp for this run), and the device's
    idle share of the traced step and of phase 7's untraced mean step."""
    cfg, opt = train["cfg"], train["opt"]
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(1),
                             opt=opt, device=dev)
    step = make_train_step(cfg, opt=opt)
    batch = to_device(make_batch(cfg, TRAIN["global_batch"], TRAIN["seq_len"],
                                 seed=1, step=0), dev)
    step(state, batch)[1]["loss"].item()
    rule = ssd_ops.ssd_vjp

    def labelled_rule(*args, **kw):
        with record_function("ssd.grad_rule"):
            return rule(*args, **kw)

    ssd_ops.ssd_vjp = labelled_rule
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("train.step"):
                t0 = time.perf_counter()
                step(state, batch)[1]["loss"].item()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ssd_ops.ssd_vjp = rule
    spans = ("train.step", "ssd.grad_rule")
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.key not in spans]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ssd_ms = sum(e.self_device_time_total for e in kernels if "ssd_fwd" in e.key) / 1e3
    rule_ms = sum(e.device_time_total for e in events
                  if e.key == "ssd.grad_rule" and e.device_type == DeviceType.CPU) / 1e3
    log(f"[profile] mamba2-130m train step: kernels busy {busy_ms:.3f} ms; traced wall "
        f"{wall_ms:.3f} ms (device idle {1 - busy_ms / wall_ms:.1%}); untraced mean step "
        f"(phase 7) {train['step_ms']:.3f} ms (device idle "
        f"{1 - busy_ms / train['step_ms']:.1%}); SSD kernel {ssd_ms:.3f} ms "
        f"({ssd_ms / busy_ms:.1%}); gradient rule {rule_ms:.3f} ms ({rule_ms / busy_ms:.1%})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile] mamba2-130m kernel {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.self_device_time_total / 1e3 / max(busy_ms, 1e-9):6.1%} x{e.count:<5} "
            f"{e.key[:90]}")
    if ssd_ms <= 0:
        fail("the profiled train step shows no SSD kernel time")


def record(name: str, source: str, replaces: str, launches: int, rec: dict,
           **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"], **extra}


def main() -> int:
    kind = phase_device()
    dev = torch.device("cuda")
    phase_build()
    recs = phase_kernels(dev)
    log(f"[time] kernels checked at {time.perf_counter() - T_START:.1f} s")
    phase_model(dev)
    granite = serve_and_profile(dev, "granite-8b", max_len=1024, prompt_range=(100, 340))
    rg = serve_and_profile(dev, "recurrentgemma-2b", max_len=4096,
                           prompt_range=(100, 2500))
    train = phase_train(dev)
    phase_train_profile(dev, train)
    log(f"[time] mamba2-130m trained and profiled at {time.perf_counter() - T_START:.1f} s")
    kernels = [
        record("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:79",
               granite["flash_attention"] + rg["flash_attention"], recs["flash"]["d128"],
               launches_by_path={"granite-8b": granite["flash_attention"],
                                 "recurrentgemma-2b": rg["flash_attention"]},
               d256=recs["flash"]["d256"]),
        record("lru_scan", "src/repro_torch/csrc/lru_scan.cu",
               "src/repro/kernels/rglru/kernel.py:49", rg["lru_scan"], recs["lru"]),
        record("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd/kernel.py:75", train["launches"]["ssd_scan"],
               recs["ssd"], flops=recs["ssd"]["flops"], bytes=recs["ssd"]["bytes"],
               gradient_rule=recs["ssd_grad"]),
    ]
    log(f"[time] total {time.perf_counter() - T_START:.1f} s")
    log(nvidia_smi("name,power.limit"))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
