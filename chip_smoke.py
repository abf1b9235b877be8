#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--old-src DIR]

Phases, each of which ends the run with a non-zero exit when it fails. A
failure, a failed check or an uncaught exception alike, prints one line on
stdout, "chip_smoke FAILED in phase <n> <name> [<arch>]: <cause>" (an
exception adds the last frames of its traceback), and exits with code 1;
nothing is caught and carried on past:
  1. device   — a CUDA card must be visible; prints its name and power limit;
  2. build    — builds the hand-written kernels from src/repro_torch/csrc
                (flash_attention.cu, flash_attention_bwd.cu, lru_scan.cu,
                ssd_scan.cu, decode_attention.cu), one nvcc per source, all
                started together
                (with --old-src, another design's sources of those names,
                those of them that DIR holds, beside them);
                reads registers, spills and shared memory from the
                -Xptxas -v logs and counts HMMA (mma.sync) and LDGSTS
                (cp.async) instructions in the SASS (cuobjdump);
  3. kernels  — holds each kernel against its plain PyTorch version on the
                card, on seeded inputs, in bf16 (the tensor-core routes of
                flash attention and the SSD scan) and in f32 (their FMA
                routes), at head_dim 8 (run at width 16, zero-filled) to
                256, GQA groups of 1 (moonshot) to 10, the shapes of the vlm
                and audio paths (seamless-m4t-large-v2's encoder, not causal
                at 1024 x 1024, its decoder's self-attention, its
                cross-attention at prefill, Sq of 100-340 against Sk = 1024,
                and at decode, Sq = 1 against 1024; internvl2-26b's prefill
                of 356-596 at G = 6), and the RG-LRU and SSD shapes
                (the scan also on long-memory inputs that carry h across
                its chunks, and in f32 against an f64 scan beside the plain
                version); one line per kernel: the cases and the worst
                error over its limit (a failing case prints its own line
                and ends the run). Times each kernel beside the plain
                version, the matching PyTorch library call where there is
                one and its roofline bound, and with --old-src the other
                design, in turns (old, new, new, old); the RG-LRU scan by
                its kernels' device time (torch.profiler; a session without
                them is taken once more, and fails the second time), back to back and
                with the L2 cache flushed (by a read) before each call, and
                by CUDA events as the others (the host's enqueue included);
                holds the SSD kernel's gradient rule (autograd through its
                custom op, the model's entry point) against autograd through
                the plain version, and times it; holds the flash kernel's
                custom op at the training shapes (its forward output
                against the plain version, its rule, a plain recompute,
                against an f64 autograd, in f32 and bf16) and the RG-LRU
                scan's rule (a reversed scan that launches the kernel once
                more) against autograd through the plain scan in f32 and an
                f64 autograd in bf16 (bf16 errors over the gradient's scale),
                and times each rule beside its bound (flash's in f32 and bf16,
                beside SDPA's backward); holds the flash backward kernel (the
                flash op's gradient under attn_chunked) against its plain
                version, flash_bwd_ref, in f32 and bf16 over each gradient's
                scale (BWD_REL), at the rule's shapes, phase 7's chunked
                shapes (CHUNKED_FLASH, 4096 a row; the forward kernel is held
                there too), seamless's cross-attention (not causal, Sq != Sk),
                head_dim 8 and granite-8b's D = 128 (its dK/dV pass split
                over the q heads and not), checks the op under chunked
                launches it once, and times it there beside flash_bwd_ref,
                flash_vjp, SDPA's backward, its bound and, with --old-src,
                the other design; holds the decode-attention kernel against
                decode_attention_ref (bf16 to one rounding of the output,
                f32 to TOL) at the main path's shapes (granite-8b's 64 and
                32 rows of 4096 slots, positions drawn from the benchmark's
                mixes; recurrentgemma-2b's wrapped window ring of 2048 at
                D = 256, K = 1) and others (head_dim 8 to 256, G of 1 to
                16), at the split rule's chunk length, at 64 slots and
                unsplit, and times it beside its byte bound, the plain
                version and SDPA (the main shape also by chunk length);
  4. model    — MODEL_CHECKS (granite-, recurrentgemma-, mamba2-, qwen2.5-,
                mistral-nemo- with head_dim 32, llama3-, mixtral-, moonshot-,
                internvl2- and seamless-smoke) in float32 on the card against
                the same seeded weights on the CPU: prefill, decode and every
                cache leaf (seamless's enc_k and enc_v too), with the kernel
                launches per prefill and per decode step (none for mamba2:
                its prefill runs the plain scan, as the reference's does; a
                decode step launches the decode kernel once per
                self-attention layer);
                TRAIN_CHECKS (mamba2-, tiny-, recurrentgemma-, qwen2.5-,
                mixtral-, internvl2- and seamless-smoke) training in float32,
                card against CPU: the
                loss and every gradient leaf of one step, then a 3-step
                (mamba2) or 2-step loss and grad_norm curve, with the kernel
                launches per step; for MoE the experts each token chose on
                the card against the CPU (a difference is a fault unless the
                router's k-th and (k+1)-th probabilities lie within
                ROUTE_TIE, a tie, reported) and the tokens dropped past the
                capacity (some must be); one line for each kind of check;
  5. serving  — granite-8b at full width (36 x 4096, bf16), then
                recurrentgemma-2b (26 layers, 2560 wide, bf16), then
                mamba2-130m (24 x 768, bf16), then moonshot-v1-16b-a3b (48
                x 2048, 64 experts top-6, bf16: 52.3 GiB of weights),
                qwen2.5-14b (48 x 5120, QKV bias, bf16), internvl2-26b (48 x
                6144, 256 vision tokens before each prompt, bf16: 37.0 GiB)
                and seamless-m4t-large-v2 (24 + 24 x 1024, its encoder over
                1024 speech frames at each prefill, bf16), weights made on
                the card from a seed, each serving 8 requests through
                ServeEngine (the last four on granite-8b's schedule); the
                kernel launch counts are set to 0 just before each run, read
                just after it and matched exactly (per prefill and decode
                step, e.g. seamless: 72 and 24; the decode step is a CUDA
                graph, captured in the warm-up, and each replay adds its
                capture's launches to the wrappers' counts), and every
                decode step of the run must replay the graph; then
                graph_check: a graphed engine against an eager one
                (M.decode_step called directly) over GRAPH_STEPS decode steps
                of batch 4, greedy tokens identical and the widest logit
                difference reported, one eager step under
                torch.cuda.set_sync_debug_mode("error"), a replaced cache
                captured again; moonlight-smoke in bf16 (the dropless
                experts' grouped GEMMs) the same, on one line;
  6. profile  — after each serving run, the same 8 requests served again under
                torch.profiler: host and device time of the prefill and decode
                spans, the device's idle share, the port kernels' time and the
                kernels that take the most device time;
  7. training — at full width through train_loop, f32 master params and
                moments: mamba2-130m (bf16 activations, 6 steps of 8 x 2048
                tokens), tiny (f32, 6 steps of 8 x 2048) and recurrentgemma-2b
                (bf16, 6 steps of 4 x 2048 in 4 microbatches); the launch
                counts set to 0 just before and read just after each run and
                matched exactly (per step, with remat on, as by default: two
                SSD launches per ssm layer, two flash launches per attention
                layer, three scans per rglru layer (forward, its recompute,
                the rule), times the microbatches); losses (the first near ln V plus
                half the logits' variance, the last below the first),
                grad_norm, ms/step, tokens/s, peak memory; then one more step
                of each under torch.profiler: kernel time, the port kernels'
                and their gradient rules' shares, the device's idle share;
                then tiny (8 x 4096) and recurrentgemma-2b (4 x 4096 in 4
                microbatches: D = 256, window 2048, K = 1) at full width with
                ModelConfig.attn_chunked on and off from one seed (CHUNKED_RUNS):
                every step's loss equal within CHUNKED_LOSS_REL, launches
                matched (one backward-kernel launch per attention per
                microbatch with the flag), ms/step and peak of both, the peak
                lower with the flag for tiny and never higher;
  8. runner   — the port's ClusterRunner (the OAR bridge) runs tiny at full
                width (smoke: false, 8 x 2048 tokens) as jobs, with an
                in-memory sqlite jobs table and a recorder standing in for
                OAR's database and executor: a best-effort job is preempted
                (toCancel=1) after its first checkpoint and must yield
                within one step, with a checkpoint and no completion, while a
                regular job starts at once and trains to its end beside it;
                a clone of the best-effort job resumes from the checkpoint
                and ends where an uninterrupted run of the same spec ends;
                flash launches matched to 16 per step (remat) over all the
                jobs, each job on the runner's one-rank mesh;
  9. sharded  — on a one-rank nccl group and a 1 x 1 DeviceMesh:
                recurrentgemma-2b trained at full width under the fsdp rules
                with remat (phase 7's run: 6 steps of 4 x 2048 in 4
                microbatches), every step's loss within 1e-5 relative of
                phase 7's and the launches equal to its; granite-8b serving
                phase 5's 8 requests under the tp2d rules, the greedy tokens
                and launches equal to phase 5's (a sharded step runs
                eagerly); then, with the group
                destroyed, the dry-run (repro_torch.launch.dryrun.run_cell)
                of llama3-405b x train_4k (fsdp), mixtral-8x22b x
                decode_32k (tp2d), recurrentgemma-2b x long_500k
                (baseline) and qwen2.5-14b x train_4k under --chunked
                (baseline_chunked) on the meta device under a fake 256-rank group
                (16 x 16): GiB per device, fits in 80 GB, the dominant
                roofline term (H100 spec numbers), useful_ratio; one line.
A summary block follows (phase 10: card, build time, each library's registers,
spills, tensor-core and cp.async instruction counts, with each kernel's in
src/repro_torch/_build/chip_smoke_build.json, where each kernel's other timed
shapes and its gradient rule's timings go too; the kernel and rule times
beside their bounds). The whole output stays under 24,000 bytes.
The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel record. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import ctypes
import gc
import json
import math
import os
import re
import sqlite3
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Where the run is: (phase number, name, arch or kernel or None). fail() and
# the handler around main() name it on stdout, so a failure names its own
# phase and cause wherever only the standard output is kept.
PHASE: list = [0, "import", None]


def _where() -> str:
    n, name, arch = PHASE
    return f"phase {n} {name}" + (f" [{arch}]" if arch else "")


def at_phase(n: int, name: str, arch: str | None = None) -> None:
    PHASE[:] = [n, name, arch]


def fail(msg: str):
    """Ends the run: one line on stdout naming the phase and the cause, then
    exit code 1."""
    print(f"chip_smoke FAILED in {_where()}: {msg}", flush=True)
    raise SystemExit(1)


def report_exception(exc: BaseException, frames: int = 6) -> None:
    """An uncaught exception, on stdout: the FAILED line with its type and
    message, then the last ``frames`` frames of its traceback."""
    print(f"chip_smoke FAILED in {_where()}: {type(exc).__name__}: {exc}"[:2000], flush=True)
    print("".join(traceback.format_tb(exc.__traceback__)[-frames:]).rstrip()[-4000:],
          flush=True)


try:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import configs  # noqa: E402
    from repro_torch.kernels import build  # noqa: E402
    from repro_torch.kernels.decode_attention import decode_attention_kernel, decode_attention_ref  # noqa: E402
    from repro_torch.kernels.decode_attention import kernel as decode_module  # noqa: E402
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_kernel  # noqa: E402
    from repro_torch.kernels.mla_decode import mla_decode_attention_ref, mla_decode_kernel  # noqa: E402
    from repro_torch.kernels.mla_decode import kernel as mla_module  # noqa: E402
    from repro_torch.kernels.flash_attention import flash_attention_bwd_kernel, flash_bwd_ref  # noqa: E402
    from repro_torch.kernels.flash_attention import kernel as flash_module  # noqa: E402
    from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
    from repro_torch.kernels.rglru import kernel as lru_module  # noqa: E402
    from repro_torch.kernels.rglru import ops as lru_ops  # noqa: E402
    from repro_torch.kernels.rglru import lru_scan_kernel, lru_scan_ref  # noqa: E402
    from repro_torch.kernels.ssd import kernel as ssd_module  # noqa: E402
    from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
    from repro_torch.kernels.ssd import ssd_kernel, ssd_ref, ssd_vjp  # noqa: E402
    from repro_torch.kernels.flash_attention.ops import attention_pairs  # noqa: E402
    from repro_torch.kernels.ssd.ops import ssd_flops  # noqa: E402
    from repro_torch.launch import dryrun  # noqa: E402
    from repro_torch.launch.cluster import ClusterRunner  # noqa: E402
    from repro_torch.launch.mesh import HW, make_local_mesh  # noqa: E402
    from repro_torch.parallel.sharding import RULES as SHARDING_RULES  # noqa: E402
    from repro_torch.models import model as M  # noqa: E402
    from repro_torch.models import moe as moe_mod  # noqa: E402
    from repro_torch.models import transformer as tfm  # noqa: E402
    from repro_torch.parallel.steps import init_train_state, make_train_step  # noqa: E402
    from repro_torch.serve.engine import ServeEngine  # noqa: E402
    from repro_torch.data.pipeline import make_batch  # noqa: E402
    from repro_torch.train import checkpoint as ckpt  # noqa: E402
    from repro_torch.train.loop import TrainResult, train_loop  # noqa: E402
    from repro_torch.train.optimizer import OptConfig  # noqa: E402
except ImportError as exc:       # e.g. run alone, without the repository's src/
    report_exception(exc)
    sys.exit(1)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): the port's
# one table of them, repro_torch.launch.mesh.HW.
PEAK_BF16_FLOPS = HW["peak_flops_bf16"]
PEAK_F32_FLOPS = HW["peak_flops_f32"]          # outside the tensor cores
PEAK_BYTES = HW["hbm_bw"]

# Kernel vs plain version: float32 differs by summation order only; bf16
# by the rounding of the output (and of P inside the flash kernel's sums).
# The SSD scan's cum, which exp(cum_i - cum_j) amplifies, is summed alike on
# both sides (in f64, rounded once), so there too only matmul sums differ.
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# The chunked scan re-walks each chunk with the plain version's f32 steps (a
# product, then a sum, each rounded) from a carry-in composed over the
# chunks before it (A carry + H), which rounds otherwise than the plain
# version's walk; from there the two walks round independently, so they
# part by about sqrt(S) roundings of |h|: of order 1e-5 over 2500 steps at
# |h| <= 5 (long_memory_inputs' statistics), and that difference can fall
# where h is near 0. f32: 2e-5, the tolerance of the plain version against
# the JAX reference's associative scan, another rounding order
# (tests/test_torch_rglru.py, where an emulation of this kernel's
# arithmetic is held to this limit too). bf16: the same f32 difference can
# flip the output's rounding by one ulp, at most 2^-7 |h| (rtol); where h
# is near 0 the f32 difference itself shows (atol, that of f32).
LRU_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-5, rtol=8e-3)}
MODEL_TOL = dict(atol=1e-3, rtol=1e-3)      # whole model, float32, card vs CPU
# Gradient rules in bf16, against an f64 autograd of the plain version on the
# same bf16 inputs, as max |err| / max |ref| (the gradient's scale): bf16
# keeps 8 significant bits, so one rounding moves a value by at most 2^-8
# (0.4 %) of itself; flash's rule rounds each gradient once, the scan's da
# three times (its lambda and the saved h, each in a's dtype, then the
# product), at most 1.2 % of the scale; 2 % leaves room for the f32 sums.
BF16_GRAD_REL = 2e-2
# The scan's rule in f32 against an f64 autograd: its error may be twice the
# plain autograd's (as for the forward scan), or 16 ulps of the gradient's
# scale where the plain error happens to fall near 0.
F32_GRAD_FLOOR = 16 * 2.0 ** -24
# The flash rule in f32 (autograd through attention_ref) against an f64
# autograd, as max |err| / max |ref|: f32's TOL, whose rtol sits far above
# the f32 sums' roundings (about sqrt(S) 2^-24, 3e-6 at S=2048).
F32_FLASH_GRAD_REL = TOL[torch.float32]["rtol"]
T_START = time.perf_counter()


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


_pairs = attention_pairs       # (q, k) pairs the mask keeps, the flash op's FLOP count


def attention_bound(B, Sq, Sk, H, K, D, causal, window=None):
    """Least time (ms) for bf16 attention on these inputs: each input read and
    the output written once; QK^T and PV over the (q, k) pairs the mask keeps."""
    flops = 4 * B * H * D * _pairs(Sq, Sk, causal, window)
    nbytes = 2 * B * D * (2 * Sq * H + 2 * Sk * K)
    return bound(flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3)


def attention_grad_bound(B, S, H, K, D, window=None, dt=torch.bfloat16):
    """Least time (ms) for the gradient of causal attention in ``dt``: q, k, v
    and the cotangent read once, dq, dk and dv written once; five products
    over the kept (q, k) pairs (QK^T again, since P is not an input, then dV,
    dP, dQ and dK), on the tensor cores in bf16, on the FMA units in f32 (TF32
    stays off)."""
    flops = 10 * B * H * D * _pairs(S, S, True, window)
    nbytes = dt.itemsize * B * S * D * (3 * H + 4 * K)
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
    return bound(flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3)


def lru_bound(B, S, W, itemsize):
    """Least time (ms) for the scan: a and b read once, h written once; one
    f32 product and one sum per element."""
    return bound(2 * B * S * W / PEAK_F32_FLOPS * 1e3,
                 3 * B * S * W * itemsize / PEAK_BYTES * 1e3)


def lru_grad_bound(B, S, W, itemsize):
    """Least time (ms) for the scan's gradient: a, h and the cotangent read
    once, da and db written once; the reversed scan's product and sum and
    da's product per element, in f32."""
    return bound(3 * B * S * W / PEAK_F32_FLOPS * 1e3,
                 5 * B * S * W * itemsize / PEAK_BYTES * 1e3)


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
    decode_attention_kernel.launches = 0
    mla_decode_kernel.launches = 0
    flash_attention_kernel.launches = 0
    flash_attention_bwd_kernel.launches = 0
    lru_scan_kernel.launches = 0
    ssd_kernel.launches = 0


def read_counts() -> dict:
    return {"flash_attention": flash_attention_kernel.launches,
            "flash_attention_bwd": flash_attention_bwd_kernel.launches,
            "lru_scan": lru_scan_kernel.launches,
            "ssd_scan": ssd_kernel.launches,
            "decode_attention": decode_attention_kernel.launches,
            "mla_decode_attention": mla_decode_kernel.launches}


NO_LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0, "lru_scan": 0, "ssd_scan": 0,
               "decode_attention": 0, "mla_decode_attention": 0}


SHORT = {"flash_attention": "flash", "flash_attention_bwd": "flash_bwd", "lru_scan": "lru",
         "ssd_scan": "ssd", "decode_attention": "decode", "mla_decode_attention": "mla"}


def counts_str(counts: dict) -> str:
    """Launch counts on one short field: the kernels launched (short names),
    or none."""
    return ", ".join(f"{SHORT[k]} {n}" for k, n in counts.items() if n) or "none"


ATTENTION_KINDS = ("attn", "local_attn", "enc_attn", "cross")


def _flash_per_pass(cfg) -> int:
    """Flash launches in one pass over the sequence: one per attention layer
    (``attn``, ``local_attn``, an MLA layer), two per ``cross`` layer (its
    self-attention and its cross-attention) and one per encoder layer."""
    kinds = tfm.layer_kinds(cfg)
    return (sum(k in ("attn", "local_attn", *tfm.MLA_KINDS) for k in kinds)
            + 2 * kinds.count("cross")
            + len(tfm.layer_kinds(cfg, encoder=True)))


def launches_per_prefill(cfg) -> dict:
    """One flash launch per attention of the pass (``_flash_per_pass``) and
    one scan per rglru layer. No SSD launch: the ssm prefill runs the plain
    scan, which also returns the final state, as the reference's prefill
    does (the kernel returns y only); the SSD kernel runs on the training
    path."""
    kinds = tfm.layer_kinds(cfg)
    return {**NO_LAUNCHES, "flash_attention": _flash_per_pass(cfg),
            "lru_scan": kinds.count("rglru")}


DECODE_KINDS = ("attn", "local_attn", "cross")


def launches_per_decode(cfg) -> dict:
    """A decode step attends over its cache with the decode kernel, one
    launch per self-attention (``attn``, ``local_attn`` and a ``cross``
    layer's self-attention), or the latent decode kernel per MLA layer, and
    a ``cross`` layer's cross-attention over the encoder's K/V with flash:
    one launch (Sq = 1) per cross layer."""
    kinds = tfm.layer_kinds(cfg)
    return {**NO_LAUNCHES, "flash_attention": kinds.count("cross"),
            "decode_attention": sum(k in DECODE_KINDS for k in kinds),
            "mla_decode_attention": sum(k in tfm.MLA_KINDS for k in kinds)}


def launches_per_train_step(cfg, microbatches: int = 1) -> dict:
    """Per microbatch, the forward launches flash once per attention of the
    pass, the scan once per rglru layer and the SSD kernel once per ssm
    layer; with remat (``cfg.remat``, on by default, as in the reference)
    the backward runs each layer's forward again first, the same launches
    once more; then the scan's rule launches the scan once more, and the
    SSD rule (a plain recompute) launches nothing. The flash gradient
    launches nothing (``flash_vjp``, a plain recompute) unless
    ``cfg.attn_chunked``: then the backward kernel once per chunked
    attention, every attention of the pass but a ``cross`` layer's
    cross-attention, to which the reference passes no flag."""
    kinds = tfm.layer_kinds(cfg)
    passes = 2 if cfg.remat else 1
    chunked = _flash_per_pass(cfg) - kinds.count("cross") if cfg.attn_chunked else 0
    per_mb = {**NO_LAUNCHES, "flash_attention": passes * _flash_per_pass(cfg),
              "flash_attention_bwd": chunked, "lru_scan": (passes + 1) * kinds.count("rglru"),
              "ssd_scan": passes * kinds.count("ssm")}
    return {k: n * microbatches for k, n in per_mb.items()}


# --------------------------------------------------------------------- phases
def phase_device() -> str:
    at_phase(1, "device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    # float32 matmuls in full float32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {nvidia_smi('name,power.limit')}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} cards {torch.cuda.device_count()}")
    return torch.cuda.get_device_name(0)


# ------------------------------------------------------------------ build
# Each source, and the loader that builds it at first use.
KERNEL_SOURCES = {"flash_attention": (flash_module.SOURCE, flash_module._library),
                  "flash_attention_bwd": (flash_module.SOURCE_BWD, flash_module._bwd_library),
                  "lru_scan": (lru_module.SOURCE, lru_module._library),
                  "ssd_scan": (ssd_module.SOURCE, ssd_module._library),
                  "decode_attention": (decode_module.SOURCE, decode_module._library),
                  "mla_decode_attention": (mla_module.SOURCE, mla_module._library)}
OLD_BUILD_DIR = build.BUILD_DIR / "old"


def _demangle(name: str) -> str:
    """'_ZN..19flash_fwd_tc_kernelILi128EEEv..' -> 'flash_fwd_tc_kernel<128>':
    the length-prefixed identifier that ends in _kernel, and its template
    arguments (types and integers)."""
    # a hash's digits may run into the length, and a digit run of the hash
    # may read as the length of a longer name: the last start that reads as
    # an identifier ending in _kernel is the name's own
    found = None
    for m in re.finditer(r"\d+", name):
        for k in range(len(m.group())):
            start = m.end()
            ident = name[start:start + int(m.group()[k:])]
            if re.fullmatch(r"[A-Za-z_]\w*_kernel", ident):
                found = (start, ident)
    if found is None:
        return name[:60]
    start, ident = found
    targs = re.match(r"I((?:13__nv_bfloat16|f|Li\d+E)+)E", name[start + len(ident):])
    labels = [{"13__nv_bfloat16": "bf16", "f": "f32"}.get(a, a[2:-1]) for a in
              re.findall(r"13__nv_bfloat16|f|Li\d+E", targs.group(1))] if targs else []
    return ident + (f"<{','.join(labels)}>" if labels else "")


def ptxas_info(log_path: Path) -> dict:
    """{kernel: {"registers", "spill_bytes", "static_smem"}} from an nvcc
    ``-Xptxas -v`` log."""
    info, cur = {}, None
    for line in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = _demangle(m.group(1))
            info[cur] = {"registers": None, "spill_bytes": 0, "static_smem": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            info[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[cur]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            info[cur]["static_smem"] = int(sm.group(1)) if sm else 0
    return info


def sass_counts(lib_path: Path) -> dict:
    """{kernel: (HMMA, LDGSTS)}: tensor-core mma.sync and cp.async
    instructions in the library's SASS, from cuobjdump."""
    exe = Path(build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(exe), "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib_path.name}: {out.stderr.strip()[:300]}")
    counts, cur = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            cur = _demangle(line.split("Function :")[1].strip())
            counts[cur] = [0, 0]
        elif cur is not None:
            counts[cur][0] += "HMMA" in line
            counts[cur][1] += "LDGSTS" in line
    return {k: tuple(v) for k, v in counts.items()}


def phase_build(old_src: Path | None) -> dict:
    """Builds the five sources, one nvcc each (the decode kernel's once for
    each dtype and head_dim), all started together (and the old design's
    sources that ``old_src`` holds beside them, into their own directory);
    then reads registers, spills and shared memory from the -Xptxas -v logs
    (the decode kernel's of its bf16, D = 128 library) and counts HMMA and
    LDGSTS in the SASS."""
    at_phase(2, "build")
    t0 = time.perf_counter()
    jobs = {name: loader for name, (_, loader) in KERNEL_SOURCES.items()}
    for dt in (torch.bfloat16, torch.float32):   # the decode kernel's other libraries
        for D in decode_module.HEAD_DIMS:
            jobs.setdefault(f"decode_attention {str(dt)[6:]} D={D}",
                            lambda dt=dt, D=D: decode_module._library(dt, D))
        for C, R in MLA_WIDTHS:                  # the latent decode kernel's
            jobs.setdefault(f"mla_decode_attention {str(dt)[6:]} C={C} R={R}",
                            lambda dt=dt, C=C, R=R: mla_module._library(dt, C, R))
    if old_src is not None:
        old = [name for name in KERNEL_SOURCES if (old_src / f"{name}.cu").exists()]
        if not old:
            fail(f"--old-src {old_src} holds none of "
                 f"{', '.join(f'{n}.cu' for n in KERNEL_SOURCES)}")
        for name in old:
            src = old_src / f"{name}.cu"
            jobs[f"old {name}"] = lambda src=src: build.build_library(src, OLD_BUILD_DIR)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        libs = {name: fut.result() for name, fut in futures.items()}
    seconds = time.perf_counter() - t0
    info = {}
    for name in KERNEL_SOURCES:
        path = Path(libs[name]._name)
        kernels = ptxas_info(path.with_suffix(".log"))
        for fn, (hmma, ldgsts) in sass_counts(path).items():
            if fn in kernels:
                kernels[fn].update(hmma=hmma, ldgsts=ldgsts)
        info[name] = kernels
    log(f"[build] {len(jobs)} libraries built and loaded in {seconds:.3f} s (set-up)")
    return {"seconds": seconds, "info": info,
            "old": {k[4:]: v for k, v in libs.items() if k.startswith("old ")}}


def _old_flash(lib):
    """The old design's flash kernel (the same C interface), bf16 only."""
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(q, k, v, window):
        B, Sq, H, D = q.shape
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
                 k.shape[1], H, k.shape[2], D, 1, 1, window or 0, D ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"the old design's flash kernel failed: CUDA error {err}")
        return out
    return run


def _old_flash_bwd(lib):
    """The old design's backward kernel through the same C interface
    (``repro_flash_attention_bwd``; lse and delta as (B, H, Sq) scratch)."""
    fn = lib.repro_flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(g, q, k, v, o, window):
        B, Sq, H, D = q.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        lse, delta = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
                      for _ in range(2))
        err = fn(g.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 B, Sq, k.shape[1], H, k.shape[2], D, int(q.dtype == torch.bfloat16), 1,
                 window or 0, D ** -0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"the old design's flash backward kernel failed: CUDA error {err}")
        return dq, dk, dv
    return run


def _old_ssd(lib):
    """The old design's two-pass SSD kernel, bf16, through its C interface
    (``repro_ssd_fwd`` with an ``is_bf16`` argument)."""
    fn = lib.repro_ssd_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(x, dt, A, Bm, Cm, chunk):
        Bsz, S, H, P = x.shape
        N, Q = Bm.shape[2], min(chunk, S)
        y = torch.empty_like(x)
        cbt = torch.empty(Bsz * -(-S // Q) * Q * Q, dtype=torch.float32, device=x.device)
        st = (ctypes.c_longlong * 6)(x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
                                     Cm.stride(0), Cm.stride(1))
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), cbt.data_ptr(), Bsz, S, H, P, N, Q, 1, st,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"the old design's SSD kernel failed: CUDA error {err}")
        return y
    return run


def time_in_turns(new, old, timer=time_ms) -> tuple[float, float | None]:
    """(new ms, old ms): each timed by ``timer`` twice, old, new, new, old,
    and averaged; without the old design, the new one alone."""
    if old is None:
        return timer(new), None
    a, b, c, d = timer(old), timer(new), timer(new), timer(old)
    return (b + c) / 2, (a + d) / 2


# ---------------------------------------------------------------- kernels
class Cases:
    """Kernel-vs-plain checks of one kernel: one line when all pass (the
    count and the worst error over its limit, atol + rtol |ref|), the full
    line of a case that fails."""

    def __init__(self, name: str):
        self.name, self.n, self.worst, self.errs = name, 0, (0.0, ""), {}

    def check(self, label: str, out, ref, tol: dict, key=None) -> float:
        out, ref = out.float(), ref.float()
        diff = (out - ref).abs()
        limit = tol["atol"] + tol["rtol"] * ref.abs()
        ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / limit).max().item()
        err = diff.max().item()
        self.n += 1
        if key is not None:
            self.errs[key] = max(self.errs.get(key, 0.0), err)
        if ratio > self.worst[0]:
            self.worst = (ratio, label)
        if not torch.allclose(out, ref, **tol):
            log(f"[kernels] {self.name} {label}: max_abs_err={err:.3e} (atol={tol['atol']:g} "
                f"rtol={tol['rtol']:g}), worst err/limit {ratio:.3f} MISMATCH")
            fail(f"{self.name} disagrees with its plain version at {label}")
        return err

    def report(self, more: str = "") -> None:
        worst = (f"worst err/limit {self.worst[0]:.3f} at {self.worst[1]}" if self.worst[1]
                 else "all equal to the plain version")
        log(f"[kernels] {self.name}: {self.n} cases ok, {worst}{more}")


# The flash shapes of the vlm and audio paths, (B, Sq, Sk, H, K, D) and
# (causal, window): seamless-m4t-large-v2's encoder (1024 frames, not
# causal), decoder self-attention (a prompt of 100 or 340), cross-attention
# at prefill (the prompt against the 1024 frames) and at decode (4 rows of
# one token); internvl2-26b's prefill (256 vision tokens before a prompt of
# 100 or 340, GQA 48/8 at D=128).
SEAMLESS_INTERNVL_FLASH = [((1, 1024, 1024, 16, 16, 64), (False, None)),
                           ((1, 100, 100, 16, 16, 64), (True, None)),
                           ((1, 340, 340, 16, 16, 64), (True, None)),
                           ((1, 100, 1024, 16, 16, 64), (False, None)),
                           ((1, 340, 1024, 16, 16, 64), (False, None)),
                           ((4, 1, 1024, 16, 16, 64), (False, None)),
                           ((1, 356, 356, 48, 8, 128), (True, None)),
                           ((1, 596, 596, 48, 8, 128), (True, None))]
# Timed in bf16 beside SDPA and the bound, (B, Sq, Sk, H, K, D, causal,
# window): granite-8b's prefill (the first: the kernels line's main shape)
# and its S=2048, recurrentgemma-2b's local attention, moonshot's G=1, then
# seamless-m4t-large-v2's encoder, cross-attention at prefill and at
# decode, internvl2-26b's longest prefill, and phase 7's chunked runs at
# 4096 a row (CHUNKED_FLASH).
FLASH_TIMED = [(1, 340, 340, 32, 8, 128, True, None), (1, 2048, 2048, 32, 8, 128, True, None),
               (1, 340, 340, 10, 1, 256, True, 2048), (1, 2500, 2500, 10, 1, 256, True, 2048),
               (1, 340, 340, 16, 16, 128, True, None),
               (1, 1024, 1024, 16, 16, 64, False, None), (1, 340, 1024, 16, 16, 64, False, None),
               (4, 1, 1024, 16, 16, 64, False, None), (1, 596, 596, 48, 8, 128, True, None),
               (8, 4096, 4096, 8, 4, 64, True, None), (1, 4096, 4096, 10, 1, 256, True, 2048)]
FLASH_MAIN = (1, 340, 340, 32, 128, True)


def check_flash(gen, dev, old) -> dict:
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
        (2, 300, 300, 32, 8, 128, torch.bfloat16, False, None),
        (1, 128, 384, 32, 8, 128, torch.float32, True, None),     # Sq != Sk
        (1, 128, 384, 32, 8, 128, torch.bfloat16, True, None),
        (2, 77, 77, 4, 2, 16, torch.float32, True, None),         # granite-smoke heads
        (2, 77, 77, 4, 2, 16, torch.bfloat16, True, None),
        (1, 100, 150, 4, 2, 32, torch.bfloat16, False, None),     # D=32, ragged
        (1, 384, 384, 4, 2, 64, torch.bfloat16, True, 64),        # D=64, window
    ]
    for S in (340, 2500):                   # recurrentgemma-2b local attention
        for dt in (torch.bfloat16, torch.float32):
            cases.append((1, S, S, 10, 1, 256, dt, True, 2048))
    cases.append((2, 45, 45, 4, 1, 16, torch.float32, True, 32))  # recurrentgemma-smoke
    cases.append((2, 45, 45, 4, 1, 16, torch.bfloat16, True, 32))
    for dt in (torch.float32, torch.bfloat16):    # llama3-smoke: D=8, run at width 16
        cases += [(2, 45, 45, 8, 2, 8, dt, True, None), (1, 130, 130, 8, 2, 8, dt, True, 64)]
    cases += [(1, 340, 340, 16, 16, 128, torch.bfloat16, True, None),  # moonshot: G=1
              (1, 340, 340, 40, 8, 128, torch.bfloat16, True, None)]   # qwen2.5-14b: G=5
    for dt in (torch.bfloat16, torch.float32):
        cases += [case + (dt,) + mask for case, mask in SEAMLESS_INTERNVL_FLASH]
    for dt in (torch.float32, torch.bfloat16):    # phase 7's chunked runs, 4096 a row
        cases += [(B, S, S, H, K, D, dt, True, w) for B, S, H, K, D, w in CHUNKED_FLASH]
    check = Cases("flash_attention")
    for (B, Sq, Sk, H, K, D, dt, causal, window) in cases:
        q, k, v = inputs(B, Sq, Sk, H, K, D, dt)
        out = flash_attention_kernel(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=causal, window=window)
        check.check(f"B={B} Sq={Sq} Sk={Sk} H={H} K={K} D={D} {str(dt)[6:]} "
                    f"causal={causal} window={window}", out, ref, TOL[dt],
                    key=(B, Sq, Sk, dt, H, D, causal, window))
    check.report()

    old_run = _old_flash(old) if old is not None else None
    timings = {}
    for (B, Sq, Sk, H, K, D, causal, window) in FLASH_TIMED:
        q, k, v = inputs(B, Sq, Sk, H, K, D, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if window is None:
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        else:                              # SDPA takes the window as a boolean mask
            qpos = torch.arange(Sq, device=dev)[:, None]
            kpos = torch.arange(Sk, device=dev)[None, :]
            mask = (kpos <= qpos) & (qpos - kpos < window)
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        old_fn = None
        if old_run is not None and causal and Sq == Sk:
            if not torch.allclose(old_run(q, k, v, window).float(),
                                  attention_ref(q, k, v, window=window).float(),
                                  **TOL[torch.bfloat16]):
                fail(f"the old design's flash kernel disagrees at S={Sq} D={D}")
            old_fn = lambda: old_run(q, k, v, window)  # noqa: E731
        ms, old_ms = time_in_turns(
            lambda: flash_attention_kernel(q, k, v, causal=causal, window=window), old_fn)
        plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=causal, window=window),
                           iters=5)
        lib_ms = time_ms(lib)
        bound_ms, bound_by = attention_bound(B, Sq, Sk, H, K, D, causal, window)
        seq = f"S={Sq}" if Sq == Sk else f"S={Sq}x{Sk}"
        shape = (f"bf16 {'causal' if causal else 'full'} B={B} {seq} H={H} K={K} D={D}"
                 + (f" w={window}" if window else ""))
        timings[(B, Sq, Sk, H, D, causal)] = dict(
            shape=shape, ms=ms, old_ms=old_ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            max_abs_err=check.errs[(B, Sq, Sk, torch.bfloat16, H, D, causal, window)])
    return timings


LRU_KERNELS = r"lru_scan\w*_kernel"    # every kernel of the scan, either design


def long_memory_inputs(kind: str, B, S, W, dt, gen, dev):
    """Coefficients whose h carries across many chunks: "long" draws a in
    [0.999, 1), "one" takes a = 1 (h is the prefix sum of b), "reset" mixes
    a = 0 (2 % of steps, so most chunks of 32 hold a reset) into the long
    draw. b = sqrt(1 - a^2) x with x ~ N(0, 1), as the model's gates make it
    (x / sqrt(S) for a = 1), which keeps h near unit size; with b ~ N(0, 1)
    and a near 1, |h| would walk to sqrt(S) and beyond, and the rounding of
    any f32 order of the scan (the plain walk's too) grows with it, past
    LRU_TOL."""
    x = torch.randn((B, S, W), generator=gen, device=dev)
    if kind == "one":
        return torch.ones_like(x).to(dt), (x / math.sqrt(S)).to(dt)
    a = 0.999 + 0.001 * torch.rand((B, S, W), generator=gen, device=dev)
    if kind == "reset":
        a = torch.where(torch.rand((B, S, W), generator=gen, device=dev) < 0.02, 0.0, a)
    return a.to(dt), (torch.sqrt(1 - a * a) * x).to(dt)


def scan_f64(a, b):
    """h_t = a_t h_{t-1} + b_t walked in f64, the yardstick of f32 rounding."""
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float64, device=a.device)
    out = torch.empty(a.shape, dtype=torch.float64, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t].double() * h + b[:, t].double()
        out[:, t] = h
    return out


class Trace:
    """A torch.profiler run summed from its raw events: each kernel's calls
    and device ns by name (every device-side event but the ranges of the
    labels), and per record_function label its calls, host ns and the
    device ns of the kernels that its ops launched (an op is the label's
    when it starts inside one of the label's ranges, on any thread: the
    backward's rules run on autograd's) or that its CUDA graph launches
    replayed (a replayed kernel shares its ``cudaGraphLaunch``'s correlation
    id; ``graph_kernels`` counts them). ``prof.key_averages()`` gives the
    same sums but first builds the event tree, which takes tens of seconds
    for the few hundred thousand events of one serving run."""

    def __init__(self, prof, labels=()):
        self.kernels: dict[str, list] = {}
        ranges = {label: [] for label in labels}
        op_start, kernel_ops, graph_launches = {}, [], {}
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() != DeviceType.CPU:
                if name in ranges:
                    continue                     # a label's range on the device
                k = self.kernels.setdefault(name, [0, 0])
                k[0] += 1
                k[1] += e.duration_ns()
                kernel_ops.append((e.linked_correlation_id(), e.correlation_id(),
                                   e.duration_ns()))
            elif name in ranges:
                ranges[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
            elif "GraphLaunch" in name:              # the runtime call of a replay
                graph_launches[e.correlation_id()] = e.start_ns()
            elif not e.linked_correlation_id():      # a PyTorch op, not a runtime call
                op_start[e.correlation_id()] = e.start_ns()
        # a replayed CUDA graph's kernels are launched by no op, but by the
        # graph launch whose correlation id they carry
        graphed = [(graph_launches[corr], ns) for _, corr, ns in kernel_ops
                   if corr in graph_launches]
        self.graph_kernels = len(graphed)
        launched = sorted([(op_start[op], ns) for op, corr, ns in kernel_ops
                           if corr not in graph_launches and op in op_start] + graphed)
        starts = [t for t, _ in launched]
        cum = [0]
        for _, ns in launched:
            cum.append(cum[-1] + ns)
        self.labels = {}
        for label, rs in ranges.items():
            device = sum(cum[bisect.bisect_right(starts, b)] - cum[bisect.bisect_left(starts, a)]
                         for a, b in rs)
            self.labels[label] = {"calls": len(rs), "host_ns": sum(b - a for a, b in rs),
                                  "device_ns": device}

    def busy_ms(self) -> float:
        return sum(ns for _, ns in self.kernels.values()) / 1e6

    def matching_ms(self, pattern: str) -> float:
        """Device ms of the kernels whose name matches ``pattern``."""
        return sum(ns for name, (_, ns) in self.kernels.items()
                   if re.search(pattern, name)) / 1e6


def scan_device_ms(fn, flush=None, iters: int = 20) -> float:
    """Device time of one call of ``fn``: the summed durations of the RG-LRU
    kernels it launches (``LRU_KERNELS``), from torch.profiler's kernel events
    over ``iters`` calls after 3 warm-up calls; the host's enqueue and the
    gaps between launches are not counted. With ``flush``, a buffer five
    times the 50 MB L2 cache is read before each call, so the call finds its
    inputs in device memory only. A read, not a write: a written buffer would
    leave L2 full of dirty lines, which the timed call would then write back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush.sum()
                fn()
            torch.cuda.synchronize()
        trace = Trace(prof)
        ms = trace.matching_ms(LRU_KERNELS)
        if ms > 0:
            return ms / iters
        # the scan has passed its checks, so a session without its kernels
        # is the profiler's fault: say what the trace held, profile once more
        seen = sorted(trace.kernels, key=lambda n: -trace.kernels[n][0])
        log(f"[kernels] lru_scan profile {attempt} of 2 shows no RG-LRU kernel time: "
            f"{sum(n for n, _ in trace.kernels.values())} device events, kernels "
            f"{', '.join(name[:40] for name in seen[:4]) or 'none'}"
            + ("; profiling again" if attempt == 1 else ""))
    fail("the profiler shows no RG-LRU kernel time in two sessions")


def _old_lru(lib):
    """The old design's scan (one thread per (row, channel), all S steps)
    through its C interface repro_lru_scan(a, b, y, B, S, W, is_bf16, stream)."""
    fn = lib.repro_lru_scan
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(a, b):
        B, S, W = a.shape
        y = torch.empty_like(a)
        err = fn(a.data_ptr(), b.data_ptr(), y.data_ptr(), B, S, W,
                 int(a.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"the old design's RG-LRU scan failed: CUDA error {err}")
        return y
    return run


def check_lru(gen, dev, old) -> dict:
    def inputs(B, S, W, dt):
        a = torch.rand((B, S, W), generator=gen, device=dev).to(dt)   # decays in [0, 1)
        b = torch.randn((B, S, W), generator=gen, device=dev).to(dt)
        return a, b

    check = Cases("lru_scan")
    f64 = []                                 # f32 cases: (label, kernel err, plain err)

    def case(label, a, b, key=None):
        dt = a.dtype
        out = lru_scan_kernel(a, b)
        torch.cuda.synchronize()
        if out.dtype != dt:
            fail(f"lru_scan returned {out.dtype} for {dt}")
        B, S, W = a.shape
        label = f"{label} L={lru_scan_kernel.last_launch[0]} {str(dt)[6:]}"
        plain = lru_scan_ref(a, b)
        check.check(label, out, plain, LRU_TOL[dt], key=key)
        if dt == torch.float32:
            exact = scan_f64(a, b)
            f64.append((label, (out.double() - exact).abs().max().item(),
                        (plain.double() - exact).abs().max().item()))

    shapes = [(1, 1, 2560), (1, 3, 2560), (1, 340, 2560), (4, 1000, 2560),
              (1, 2500, 2560), (2, 77, 64), (1, 300, 130), (3, 17, 130)]
    for (B, S, W) in shapes:
        for dt in (torch.float32, torch.bfloat16):
            a, b = inputs(B, S, W, dt)
            case(f"B={B} S={S} W={W}", a, b, key=(B, S, W, dt))
    # own generator: the draws of `gen` that the SSD checks see stay as they were
    gen_long = torch.Generator(device=dev).manual_seed(1)
    for (B, S, W) in ((1, 2500, 2560), (4, 1000, 2560), (3, 77, 130)):
        for kind in ("long", "one", "reset"):
            for dt in (torch.float32, torch.bfloat16):
                a, b = long_memory_inputs(kind, B, S, W, dt, gen_long, dev)
                case(f"{kind} B={B} S={S} W={W}", a, b)
    for dt in (torch.float32, torch.bfloat16):     # not 16-byte aligned: the scalar route
        n = 2 * 77 * 64 + 1
        a = torch.rand(n, generator=gen_long, device=dev).to(dt)[1:].view(2, 77, 64)
        b = torch.randn(n, generator=gen_long, device=dev).to(dt)[1:].view(2, 77, 64)
        case("B=2 S=77 W=64 offset by one element", a, b)
    check.report()
    worst = max(f64, key=lambda r: r[1])
    ratio = max(f64, key=lambda r: r[1] / max(r[2], 1e-30))
    log(f"[kernels] lru_scan f32 against an f64 scan: {len(f64)} cases, worst kernel err "
        f"{worst[1]:.3e} (plain {worst[2]:.3e}) at {worst[0]}; worst kernel/plain "
        f"{ratio[1]:.3e}/{ratio[2]:.3e} at {ratio[0]} (limit 2x)")
    if any(k > 2 * p for _, k, p in f64):
        fail(f"lru_scan's f32 error against an f64 scan exceeds twice the plain version's "
             f"at {ratio[0]}")

    old_run = _old_lru(old) if old is not None else None
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device=dev)     # 256 MB
    timings, launched = {}, {}
    for S in (340, 2500):
        B, W = 1, 2560
        a, b = inputs(B, S, W, torch.bfloat16)
        old_fn = None
        if old_run is not None:
            if not torch.allclose(old_run(a, b).float(), lru_scan_ref(a, b).float(),
                                  **LRU_TOL[torch.bfloat16]):
                fail(f"the old design's RG-LRU scan disagrees at S={S}")
            old_fn = lambda: old_run(a, b)  # noqa: E731
        new_fn = lambda: lru_scan_kernel(a, b)  # noqa: E731
        warm, old_warm = time_in_turns(new_fn, old_fn, timer=scan_device_ms)
        cold, old_cold = time_in_turns(new_fn, old_fn,
                                       timer=lambda fn: scan_device_ms(fn, flush, 10))
        # CUDA events around 20 calls: the host's enqueue and the gaps between
        # the three launches included, as the flash and SSD times are taken
        events, old_events = time_in_turns(new_fn, old_fn)
        launched[S] = lru_scan_kernel.last_launch
        plain_ms = time_ms(lambda: lru_scan_ref(a, b), iters=3, warmup=1)
        bound_ms, bound_by = lru_bound(B, S, W, 2)
        timings[S] = dict(shape=f"bf16 B=1 S={S} W={W}", ms=cold, old_ms=old_cold,
                          warm_ms=warm, old_warm_ms=old_warm, events_ms=events,
                          old_events_ms=old_events, plain_ms=plain_ms, library_ms=None,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=check.errs[(B, S, W, torch.bfloat16)])
    del flush
    return timings, launched


def ssd_counts(B, S, H, P, N, chunk, itemsize) -> tuple[float, float]:
    """(FLOPs, bytes) the SSD scan needs on these shapes, in its chunked form:
    C B^T once per (batch row, chunk) over the causal (i, j) pairs (B and C
    are shared by the heads), then per head the masked scores times u over
    the same pairs, the inter-chunk term C h^T (every chunk after the first)
    and the state update (every chunk before the last). Bytes: x, B, C read
    and y written once in the compute dtype, dt and A once in f32."""
    flops = ssd_flops(B, S, H, P, N, chunk)          # the SSD op's FLOP formula
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * itemsize + (B * S * H + H) * 4
    return float(flops), float(nbytes)


def ssd_grad_counts(B, S, H, P, N, chunk, itemsize) -> tuple[float, float]:
    """(FLOPs, bytes) of the SSD gradient rule, counted as ssd_counts counts
    the forward: ssd_vjp recomputes the forward's products, and the gradient
    of each product of two operands is two products of its size, so three
    times the forward's operations. Bytes: x, B, C, dt, A and the cotangent
    read once, their five gradients written once, each in its input's
    dtype (the cotangent in x's)."""
    flops, _ = ssd_counts(B, S, H, P, N, chunk, itemsize)
    nbytes = 2 * ((B * S * H * P + 2 * B * S * N) * itemsize + (B * S * H + H) * 4)
    return 3 * flops, float(nbytes + B * S * H * P * itemsize)


def ssd_inputs(gen, dev, B, S, H, P, N, dt):
    """Reference-test statistics: x, B, C ~ N(0, 1) in ``dt``; dt =
    softplus(N(0, 1)) and A = -exp(N(0, 1)) in f32."""
    x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dt)
    dts = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev))
    Bm = torch.randn((B, S, N), generator=gen, device=dev).to(dt)
    Cm = torch.randn((B, S, N), generator=gen, device=dev).to(dt)
    return x, dts, A, Bm, Cm


def check_ssd(gen, dev, old) -> dict:
    check = Cases("ssd_scan")
    shapes = [(1, 1, 24, 64, 128, 256), (2, 77, 8, 16, 16, 32), (1, 31, 8, 16, 16, 32),
              (1, 300, 3, 24, 40, 64), (2, 1000, 24, 64, 128, 256),
              (8, 2048, 24, 64, 128, 256)]
    for (B, S, H, P, N, chunk) in shapes:
        for dt in (torch.float32, torch.bfloat16):
            inputs = ssd_inputs(gen, dev, B, S, H, P, N, dt)
            out = ssd_kernel(*inputs, chunk=chunk)
            torch.cuda.synchronize()
            if out.dtype != dt:
                fail(f"ssd_scan returned {out.dtype} for {dt}")
            check.check(f"B={B} S={S} H={H} P={P} N={N} chunk={chunk} {str(dt)[6:]}", out,
                        ssd_ref(*inputs, chunk=chunk), TOL[dt], key=(B, S, dt))
            del inputs, out
    check.report()

    B, S, H, P, N, chunk = 8, 2048, 24, 64, 128, 256      # mamba2-130m's training shape
    inputs = ssd_inputs(gen, dev, B, S, H, P, N, torch.bfloat16)
    old_fn = None
    if old is not None:
        old_run = _old_ssd(old)
        if not torch.allclose(old_run(*inputs, chunk).float(),
                              ssd_ref(*inputs, chunk=chunk).float(), **TOL[torch.bfloat16]):
            fail("the old design's SSD kernel disagrees with its plain version")
        old_fn = lambda: old_run(*inputs, chunk)  # noqa: E731
    ms, old_ms = time_in_turns(lambda: ssd_kernel(*inputs, chunk=chunk), old_fn)
    plain_ms = time_ms(lambda: ssd_ref(*inputs, chunk=chunk), iters=5)
    flops, nbytes = ssd_counts(B, S, H, P, N, chunk, 2)
    bound_ms, bound_by = bound(flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3)
    return dict(shape=f"bf16 B={B} S={S} H={H} P={P} N={N} chunk={chunk}", ms=ms,
                old_ms=old_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=check.errs[(B, S, torch.bfloat16)],
                flops=flops, bytes=nbytes)


def check_ssd_grad(gen, dev) -> dict:
    """The gradient rule on the card: backward through the kernel's custom
    op, the model's entry point (forward: the kernel, one launch; backward:
    ssd_vjp, none) against autograd through the plain version, for all five
    inputs; then the rule's time at the training shape."""
    check = Cases("ssd_scan gradient rule")
    for (B, S, H, P, N, chunk, dt) in ((2, 77, 8, 16, 16, 32, torch.float32),
                                       (8, 2048, 24, 64, 128, 256, torch.bfloat16)):
        inputs = ssd_inputs(gen, dev, B, S, H, P, N, dt)
        g = torch.randn((B, S, H, P), generator=gen, device=dev).to(dt)
        a = [t.detach().clone().requires_grad_() for t in inputs]
        b = [t.detach().clone().requires_grad_() for t in inputs]
        reset_counts()
        ssd_ops.ssd(*a, chunk=chunk).backward(g)
        name = f"B={B} S={S} H={H} P={P} N={N} chunk={chunk} {str(dt)[6:]}"
        if read_counts() != {**NO_LAUNCHES, "ssd_scan": 1}:
            fail(f"ssd gradient rule at {name} launched {read_counts()}")
        ssd_ref(*b, chunk=chunk).backward(g)
        torch.cuda.synchronize()
        for label, ta, tb in zip(("x", "dt", "A", "Bm", "Cm"), a, b):
            if ta.grad.dtype != tb.grad.dtype:
                fail(f"ssd gradient rule: {label} gradient dtype {ta.grad.dtype}, "
                     f"autograd {tb.grad.dtype}")
            check.check(f"d{label} {name}", ta.grad, tb.grad, TOL[dt], key=dt)
        del a, b
    check.report()
    ms = time_ms(lambda: ssd_vjp(g, *inputs, chunk=chunk), iters=5)
    flops, nbytes = ssd_grad_counts(B, S, H, P, N, chunk, 2)
    bound_ms, bound_by = bound(flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3)
    return dict(shape=name, max_abs_err=check.errs[torch.bfloat16], ms=ms,
                bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)


def rel_err(x, ref) -> float:
    """max |x - ref| / max |ref|: an error over the gradient's scale."""
    return ((x.double() - ref).abs().max() / ref.abs().max().clamp(min=1e-300)).item()


def report_rel(name: str, rel: list) -> None:
    """bf16 gradients (label, rule err, plain err), each over its scale."""
    worst = max(rel, key=lambda r: r[1])
    log(f"[kernels] {name} bf16 against an f64 autograd: {len(rel)} gradients, worst "
        f"{worst[1]:.3e} of the gradient's scale (plain autograd in bf16 {worst[2]:.3e}) "
        f"at {worst[0]} (limit {BF16_GRAD_REL:g})")
    if worst[1] > BF16_GRAD_REL:
        fail(f"{name} is off by {worst[1]:.3e} of the gradient's scale at {worst[0]}")


def attention_f64(q, k, v, *, causal: bool, window: int | None):
    """attention_ref's function in f64 (attention_ref computes in f32)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.double().reshape(B, Sq, K, H // K, D),
                     k.double()) * D ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    keep = kpos <= qpos if causal else torch.ones_like(kpos - qpos, dtype=torch.bool)
    if window is not None:
        keep &= qpos - kpos < window
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.double()).reshape(B, Sq, H, D)


# (B, S, H, K, D, window), causal: a small ragged case, tiny's training shape,
# recurrentgemma-2b's, and a window that bites; each in f32 and bf16.
FLASH_GRAD_CASES = [(2, 77, 4, 2, 16, None), (8, 2048, 8, 4, 64, None),
                    (1, 2048, 10, 1, 256, 2048), (1, 1000, 10, 1, 256, 256)]
# The attention calls of phase 7's chunked runs (CHUNKED_RUNS), (B, S, H, K,
# D, window), causal: tiny's 8 rows of CHUNKED_SEQ in one microbatch and
# recurrentgemma-2b's one row a microbatch (D = 256, K = 1, its window).
CHUNKED_SEQ = 4096
CHUNKED_FLASH = [(8, CHUNKED_SEQ, 8, 4, 64, None), (1, CHUNKED_SEQ, 10, 1, 256, 2048)]
# The rule is timed at tiny's shape in f32 (tiny's own precision) and bf16
# (recurrentgemma-2b's precision), and at recurrentgemma-2b's shape in bf16.
FLASH_GRAD_TIMED = [(8, 2048, 8, 4, 64, None, torch.float32),
                    (8, 2048, 8, 4, 64, None, torch.bfloat16),
                    (1, 2048, 10, 1, 256, 2048, torch.bfloat16)]
# (kind, B, S, W): recurrentgemma-2b's width at its training length and at a
# length that is no multiple of any chunk, on uniform and long-memory
# inputs, and a small ragged case with a = 1; the rule is timed at bf16
# LRU_GRAD_TIMED.
LRU_GRAD_CASES = [("uniform", 1, 2048, 2560), ("long", 1, 2048, 2560),
                  ("reset", 1, 2500, 2560), ("one", 2, 77, 130)]
LRU_GRAD_TIMED = (1, 2048, 2560)


def check_flash_grad(gen, dev) -> list:
    """The flash kernel's custom op, the model's entry point, on the card
    (forward: the kernel, one launch; backward: flash_vjp, none) at
    FLASH_GRAD_CASES: its forward output against attention_ref at TOL, and
    its gradients against an f64 autograd over the gradient's scale, in f32 (F32_FLASH_GRAD_REL) and bf16
    (BF16_GRAD_REL, beside autograd through attention_ref in bf16; in f32
    flash_vjp is that autograd itself). Then the rule's time at
    FLASH_GRAD_TIMED, beside SDPA's backward and the bound."""
    check, rel, rel32 = Cases("flash_attention custom op forward"), [], []
    for (B, S, H, K, D, window) in FLASH_GRAD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
            g = torch.randn((B, S, H, D), generator=gen, device=dev).to(dt)
            label = f"B={B} S={S} H={H} K={K} D={D} window={window} {str(dt)[6:]}"
            x = [t.clone().requires_grad_() for t in (q, k, v)]
            reset_counts()
            out = flash_ops.flash_attention(*x, causal=True, window=window)
            out.backward(g)
            if read_counts() != {**NO_LAUNCHES, "flash_attention": 1}:
                fail(f"flash gradient rule at {label} launched {read_counts()}")
            y = [t.clone().requires_grad_(dt == torch.bfloat16) for t in (q, k, v)]
            ref = attention_ref(*y, causal=True, window=window)
            check.check(f"out {label}", out.detach(), ref.detach(), TOL[dt], key=(S, D, dt))
            for name, a in zip("qkv", x):
                if a.grad.dtype != dt:
                    fail(f"flash gradient rule: d{name} has dtype {a.grad.dtype} for {dt}")
            z = [t.double().requires_grad_() for t in (q, k, v)]
            attention_f64(*z, causal=True, window=window).backward(g.double())
            if dt == torch.bfloat16:
                ref.backward(g)
                rel += [(f"d{name} {label}", rel_err(a.grad, c.grad), rel_err(b.grad, c.grad))
                        for name, a, b, c in zip("qkv", x, y, z)]
            else:
                rel32 += [(f"d{name} {label}", rel_err(a.grad, c.grad))
                          for name, a, c in zip("qkv", x, z)]
            del x, y, z, out, ref
    check.report()
    worst = max(rel32, key=lambda r: r[1])
    log(f"[kernels] flash_attention gradient rule f32 against an f64 autograd: {len(rel32)} "
        f"gradients, worst {worst[1]:.3e} of the gradient's scale at {worst[0]} "
        f"(limit {F32_FLASH_GRAD_REL:g})")
    if worst[1] > F32_FLASH_GRAD_REL:
        fail(f"flash_attention gradient rule is off by {worst[1]:.3e} of the gradient's "
             f"scale at {worst[0]}")
    report_rel("flash_attention gradient rule", rel)

    timings = []
    for (B, S, H, K, D, window, dt) in FLASH_GRAD_TIMED:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
        g = torch.randn((B, S, H, D), generator=gen, device=dev).to(dt)
        ms, lib_ms = grad_rivals_ms(g, q, k, v, window)
        bound_ms, bound_by = attention_grad_bound(B, S, H, K, D, window, dt)
        label = f"B={B} S={S} H={H} K={K} D={D} window={window} {str(dt)[6:]}"
        timings.append(dict(shape=f"{str(dt)[6:]} causal {label[:label.rindex(' ')]}", ms=ms,
                            library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                            forward_max_abs_err=check.errs[(S, D, dt)],
                            max_rel_err=max(r[1] for r in rel + rel32 if label in r[0])))
    return timings


def grad_rivals_ms(g, q, k, v, window) -> tuple[float, float]:
    """Device ms of one call of the plain rule, flash_vjp, and of SDPA's
    backward (the library's), on the same causal inputs, by CUDA events."""
    S = q.shape[1]
    ms = time_ms(lambda: flash_ops.flash_vjp(g, q, k, v, causal=True, window=window), iters=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    mask = None
    if window is not None and window < S:        # else the window keeps every causal pair
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        mask = (kpos <= qpos) & (qpos - kpos < window)
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=mask is None, enable_gqa=True)
    gt = g.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
    return ms, lib_ms


# The backward kernel against flash_bwd_ref on the same inputs, as max |err|
# / max |ref| per gradient: in f32 both sum in f32 in other orders (TOL's
# rtol, far above the sums' roundings); in bf16 each rounds its f32 gradient
# once to bf16, so the two may part by one bf16 ulp, at most 2^-7 (0.78 %) of
# the gradient's scale, and 1 % leaves room for the f32 sums' order and the
# kernel's bf16 P and dS operands (its plain emulation,
# tests/test_torch_flash_bwd_tc.py, is 0.2-0.7 % from flash_bwd_ref).
BWD_REL = {torch.float32: TOL[torch.float32]["rtol"], torch.bfloat16: 1e-2}
# FLASH_GRAD_CASES (causal) and CHUNKED_FLASH, the main path's shapes (at
# 4096 the window of 2048 masks: the window bounds of every pass run), plus
# seamless-m4t-large-v2's cross-attention at prefill (not causal, Sq !=
# Sk), llama3-smoke's head_dim 8 (run at 16), granite-8b's heads at D = 128
# with a window (the dK/dV pass split over the q heads) and at 2 x 2048
# (512 CTAs: not split), and D = 32 with a window and no causal mask, ragged
# against the tiles: (B, Sq, Sk, H, K, D, causal, window).
FLASH_BWD_CASES = ([(B, S, S, H, K, D, True, w)
                    for B, S, H, K, D, w in FLASH_GRAD_CASES + CHUNKED_FLASH]
                   + [(1, 340, 1024, 16, 16, 64, False, None), (2, 45, 45, 8, 2, 8, True, None),
                      (1, 340, 340, 32, 8, 128, True, 256), (2, 2048, 2048, 32, 8, 128, True, None),
                      (1, 200, 200, 4, 2, 32, False, 64)])
# Timed beside flash_bwd_ref, flash_vjp, SDPA's backward and the bound: the
# main path's shapes in their models' precisions (tiny f32, the kernels
# line's record; recurrentgemma-2b bf16), then FLASH_GRAD_TIMED's.
FLASH_BWD_MAIN = [CHUNKED_FLASH[0] + (torch.float32,), CHUNKED_FLASH[1] + (torch.bfloat16,)]


def check_flash_bwd(gen, dev, rule: list, old) -> list:
    """The backward kernel (the flash op's gradient under ``chunked``)
    against flash_bwd_ref, its plain version, on the same inputs and the
    forward kernel's output, at FLASH_BWD_CASES in f32 and bf16 (BWD_REL of
    each gradient's scale); then the custom op under ``chunked`` on the
    first case: one forward and one backward launch, gradients equal to the
    kernel's. Times it at FLASH_BWD_MAIN and FLASH_GRAD_TIMED by CUDA
    events beside flash_bwd_ref, the unchunked rule (flash_vjp), SDPA's
    backward and the bound; at FLASH_GRAD_TIMED the last three are
    ``rule``'s, check_flash_grad's at the same shapes. With ``old`` (the
    old design's library, --old-src) each kernel time is taken in turns
    with the old design's."""
    gen_b = torch.Generator(device=dev).manual_seed(3)   # leaves `gen`'s draws alone

    def inputs(B, Sq, Sk, H, K, D, dt):
        return [torch.randn(shape, generator=gen_b, device=dev).to(dt)
                for shape in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D), (B, Sq, H, D))]

    rel, errs = [], {}
    for (B, Sq, Sk, H, K, D, causal, window) in FLASH_BWD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, g = inputs(B, Sq, Sk, H, K, D, dt)
            o = flash_attention_kernel(q, k, v, causal=causal, window=window)
            out = flash_attention_bwd_kernel(g, q, k, v, o, causal=causal, window=window)
            torch.cuda.synchronize()
            ref = flash_bwd_ref(g, q, k, v, causal=causal, window=window)
            seq = f"S={Sq}" if Sq == Sk else f"S={Sq}x{Sk}"
            label = (f"B={B} {seq} H={H} K={K} D={D} {'causal' if causal else 'full'} "
                     f"window={window} {str(dt)[6:]}")
            for name, a, r in zip("qkv", out, ref):
                if a.dtype != dt or a.shape != r.shape:
                    fail(f"flash backward kernel: d{name} {a.dtype} {tuple(a.shape)} at {label}")
                rel.append((f"d{name} {label}", rel_err(a, r.double()), BWD_REL[dt]))
                errs[(B, Sq, Sk, H, D, dt)] = max(errs.get((B, Sq, Sk, H, D, dt), 0.0),
                                                  (a.float() - r.float()).abs().max().item())
            del q, k, v, g, o, out, ref
    worst = max(rel, key=lambda r: r[1] / r[2])
    log(f"[kernels] flash_attention backward kernel against flash_bwd_ref: {len(rel)} "
        f"gradients, worst {worst[1]:.3e} of the gradient's scale at {worst[0]} (limit "
        f"{worst[2]:g}; f32 {BWD_REL[torch.float32]:g}, bf16 {BWD_REL[torch.bfloat16]:g})")
    if worst[1] > worst[2]:
        fail(f"the flash backward kernel is off by {worst[1]:.3e} of the gradient's scale "
             f"at {worst[0]}")

    B, S, _, H, K, D, causal, window = FLASH_BWD_CASES[0]
    q, k, v, g = inputs(B, S, S, H, K, D, torch.float32)
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_counts()
    flash_ops.flash_attention(*x, causal=causal, window=window, chunked=True).backward(g)
    if read_counts() != {**NO_LAUNCHES, "flash_attention": 1, "flash_attention_bwd": 1}:
        fail(f"the flash op under chunked launched {read_counts()}, expected one forward "
             "and one backward launch")
    direct = flash_attention_bwd_kernel(
        g, q, k, v, flash_attention_kernel(q, k, v, causal=causal, window=window),
        causal=causal, window=window)
    if not all(torch.equal(a.grad, b) for a, b in zip(x, direct)):
        fail("the flash op's gradient under chunked differs from the backward kernel's")

    timings = []
    old_run = _old_flash_bwd(old) if old is not None else None
    for (B, S, H, K, D, window, dt), r in zip(FLASH_BWD_MAIN + FLASH_GRAD_TIMED,
                                              [None] * len(FLASH_BWD_MAIN) + rule):
        q, k, v, g = inputs(B, S, S, H, K, D, dt)
        o = flash_attention_kernel(q, k, v, causal=True, window=window)
        ms, old_ms = time_in_turns(
            lambda: flash_attention_bwd_kernel(g, q, k, v, o, causal=True, window=window),
            old_run and (lambda: old_run(g, q, k, v, o, window)),
            timer=lambda fn: time_ms(fn, iters=10))
        plain_ms = time_ms(lambda: flash_bwd_ref(g, q, k, v, causal=True, window=window),
                           iters=3, warmup=1)
        if r is None:                   # a main-path shape, which check_flash_grad skips
            rule_ms, lib_ms = grad_rivals_ms(g, q, k, v, window)
            r = dict(zip(("ms", "library_ms", "bound_ms", "bound_by"), (rule_ms, lib_ms)
                         + attention_grad_bound(B, S, H, K, D, window, dt)))
        timings.append(dict(
            shape=f"{str(dt)[6:]} causal B={B} S={S} H={H} K={K} D={D}"
                  + (f" w={window}" if window else ""),
            ms=ms, old_ms=old_ms, plain_ms=plain_ms, rule_ms=r["ms"],
            library_ms=r["library_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            max_abs_err=errs[(B, S, S, H, D, dt)]))
        del q, k, v, g, o
    return timings


def check_lru_grad(gen, dev) -> list:
    """The scan's custom op, the model's entry point, on the card (forward:
    the kernel; backward: lru_scan_vjp, one more launch of the kernel) against autograd
    through lru_scan_ref and through an f64 walk: in f32 its error against
    the f64 gradient may be twice the plain autograd's (or F32_GRAD_FLOOR of
    the scale), in bf16 BF16_GRAD_REL of the scale; at LRU_GRAD_CASES. Then
    the rule's time at LRU_GRAD_TIMED in bf16, beside autograd through the
    plain scan and the bound."""
    gen_g = torch.Generator(device=dev).manual_seed(2)   # leaves `gen`'s draws alone
    f32, rel = [], []
    for (kind, B, S, W) in LRU_GRAD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            if kind == "uniform":
                a = torch.rand((B, S, W), generator=gen_g, device=dev).to(dt)
                b = torch.randn((B, S, W), generator=gen_g, device=dev).to(dt)
            else:
                a, b = long_memory_inputs(kind, B, S, W, dt, gen_g, dev)
            g = torch.randn((B, S, W), generator=gen_g, device=dev).to(dt)
            label = f"{kind} B={B} S={S} W={W} {str(dt)[6:]}"
            x = [t.clone().requires_grad_() for t in (a, b)]
            reset_counts()
            h = lru_ops.lru_scan(*x)
            forward = lru_scan_kernel.launches
            h.backward(g)
            if (forward, lru_scan_kernel.launches) != (1, 2):
                fail(f"lru_scan gradient rule at {label}: {forward} forward and "
                     f"{lru_scan_kernel.launches - forward} backward launches, expected 1 and 1")
            y = [t.clone().requires_grad_() for t in (a, b)]
            lru_scan_ref(*y).backward(g)
            z = [t.double().requires_grad_() for t in (a, b)]
            scan_f64(*z).backward(g.double())
            for name, tx, ty, tz in zip(("da", "db"), x, y, z):
                if tx.grad.dtype != dt:
                    fail(f"lru_scan gradient rule: {name} has dtype {tx.grad.dtype} for {dt}")
                if dt == torch.float32:
                    f32.append((f"{name} {label}", (tx.grad.double() - tz.grad).abs().max().item(),
                                (ty.grad.double() - tz.grad).abs().max().item(),
                                tz.grad.abs().max().item()))
                else:
                    rel.append((f"{name} {label}", rel_err(tx.grad, tz.grad),
                                rel_err(ty.grad, tz.grad)))
            del x, y, z
    worst = max(f32, key=lambda r: r[1] / max(2 * r[2], F32_GRAD_FLOOR * r[3]))
    log(f"[kernels] lru_scan gradient rule f32 against an f64 autograd: {len(f32)} gradients, "
        f"worst rule/plain error {worst[1]:.3e}/{worst[2]:.3e} at {worst[0]} (limit 2x, or "
        f"{F32_GRAD_FLOOR:.1e} of the scale {worst[3]:.3e}); one scan launched in each backward")
    if worst[1] > max(2 * worst[2], F32_GRAD_FLOOR * worst[3]):
        fail(f"lru_scan gradient rule's f32 error exceeds its limit at {worst[0]}")
    report_rel("lru_scan gradient rule", rel)

    B, S, W = LRU_GRAD_TIMED
    a = torch.rand((B, S, W), generator=gen_g, device=dev).bfloat16()
    b, g = (torch.randn((B, S, W), generator=gen_g, device=dev).bfloat16() for _ in range(2))
    h = lru_scan_kernel(a, b)
    ms = time_ms(lambda: lru_ops.lru_scan_vjp(g, a, h))
    y = [t.clone().requires_grad_() for t in (a, b)]
    hp = lru_scan_ref(*y)
    plain_ms = time_ms(lambda: torch.autograd.grad(hp, y, g, retain_graph=True),
                       iters=2, warmup=1)
    bound_ms, bound_by = lru_grad_bound(B, S, W, 2)
    return [dict(shape=f"bf16 B={B} S={S} W={W}", ms=ms, plain_ms=plain_ms, library_ms=None,
                 bound_ms=bound_ms, bound_by=bound_by,
                 max_rel_err=max(r[1] for r in rel if "bfloat16" in r[0]))]


# The decode kernel against decode_attention_ref: bf16 is held to one
# rounding of the output (an f32 sum in another order may round it the
# other way: one ulp, at most 2^-7 of the value); f32 to TOL.
DECODE_TOL = {torch.float32: TOL[torch.float32], torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7)}
# Serving mixes of the benchmark's cells (gpubench/workloads), for the rows'
# positions: lognormal prompt and output lengths (median, sigma, max).
CONVERSATION = ((1020, 0.8, 3072), (129, 1.0, 1024))
CODING = ((1500, 0.8, 3840), (13, 1.0, 256))
# (name, B, Smax, H, K, D, window, mix): the main path's shapes (the
# kernels line's first), then the other configs' and the tiny variants'.
DECODE_MAIN = ("granite-8b batch", 64, 4096, 32, 8, 128, None, CONVERSATION)
DECODE_TIMED = [DECODE_MAIN,
                ("granite-8b serve", 32, 4096, 32, 8, 128, None, CODING),
                ("recurrentgemma-2b", 8, 2048, 10, 1, 256, 2048, "wrapped"),
                ("llama3-405b G=16", 8, 4096, 128, 8, 128, None, CONVERSATION),
                ("moonshot G=1", 8, 1024, 16, 16, 128, None, "uniform")]
DECODE_CASES = DECODE_TIMED + [
    ("qwen2.5-14b G=5", 8, 1024, 40, 8, 128, None, "uniform"),
    ("seamless D=64", 4, 1024, 16, 16, 64, None, "uniform"),
    ("mixtral swa ring", 4, 512, 48, 8, 128, 512, "wrapped"),
    ("mistral-nemo-smoke D=32", 4, 96, 4, 2, 32, None, "wrapped"),
    ("granite-smoke D=16", 4, 96, 4, 2, 16, None, "wrapped"),
    ("llama3-smoke D=8", 4, 96, 8, 2, 8, None, "wrapped"),
    ("recurrentgemma-smoke window", 4, 32, 4, 1, 16, 32, "wrapped"),
    ("granite window 256", 8, 4096, 32, 8, 128, 256, CONVERSATION)]
DECODE_CHUNKS = (128, 256, 512, 1024, 4096)      # forced chunk lengths, timed at the main shape


def decode_positions(B: int, Smax: int, mix, gen) -> torch.Tensor:
    """Each row's position: a prompt and part of its output drawn from a
    serving mix's lognormals (clipped as the mix clips), the ring's length
    at most; ``wrapped``: past the ring, up to 3 times round; ``uniform``:
    anywhere in it; the first row at 0 and the second at the ring's last
    slot where the mix draws (the edges)."""
    if mix == "wrapped":
        return torch.randint(0, 3 * Smax, (B,), generator=gen)
    if mix == "uniform":
        pos = torch.randint(0, Smax, (B,), generator=gen)
    else:
        (pm, ps, pmax), (om, os_, omax) = mix
        z = torch.randn((2, B), generator=gen)
        prompt = (pm * torch.exp(ps * z[0])).round().clamp(1, pmax)
        out = (om * torch.exp(os_ * z[1])).round().clamp(1, omax)
        pos = (prompt + torch.rand(B, generator=gen) * out).long().clamp(max=Smax - 1)
    pos[0], pos[min(1, B - 1)] = 0, Smax - 1
    return pos


def decode_bound(pos, Smax, H, K, D, window, itemsize=2):
    """Least time (ms) for decode attention: the written slots' K and V read
    once, one token's q.k and P.V over them on the FMA units (f32)."""
    n = torch.clamp(pos + 1, max=min(Smax, window or Smax)).sum().item()
    flops = 4 * n * (H // K) * K * D
    return bound(flops / PEAK_F32_FLOPS * 1e3, 2 * n * K * D * itemsize / PEAK_BYTES * 1e3)


def check_decode(gen, dev) -> dict:
    """The decode kernel against decode_attention_ref in bf16 and f32 at
    DECODE_CASES (and at forced chunk lengths, so both the split and the
    single-chunk routes run), then timed in bf16 at DECODE_TIMED beside the
    plain version, SDPA over the ring with the written slots as a mask, and
    its bound; the main shape also at DECODE_CHUNKS."""
    cgen = torch.Generator().manual_seed(0)
    check = Cases("decode_attention")
    timings = {}

    def inputs(B, Smax, H, K, D, dt):
        return (torch.randn((B, 1, H, D), generator=gen, device=dev).to(dt),
                *(torch.randn((B, Smax, K, D), generator=gen, device=dev).to(dt)
                  for _ in range(2)))

    for name, B, Smax, H, K, D, window, mix in DECODE_CASES:
        pos = decode_positions(B, Smax, mix, cgen).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = inputs(B, Smax, H, K, D, dt)
            ref = decode_attention_ref(q, k, v, pos, window)
            for chunk in (0, 64, Smax):
                out = decode_attention_kernel(q, k, v, pos, window, _chunk_len=chunk)
                torch.cuda.synchronize()
                check.check(f"{name} B={B} Smax={Smax} H={H} K={K} D={D} w={window} "
                            f"{str(dt)[6:]} chunk={chunk or 'rule'}", out, ref, DECODE_TOL[dt],
                            key=(name, dt))
    # one launch a call; the combine kernel only where the rule splits the ring
    reset_counts()
    decode_attention_kernel.combine_launches = 0
    q, k, v = inputs(64, 4096, 32, 8, 128, torch.bfloat16)
    decode_attention_kernel(q, k, v, torch.zeros(64, dtype=torch.long, device=dev))
    split = decode_module.chunks(64, 8, 4096, 128, torch.bfloat16) > 1
    if (read_counts() != {**NO_LAUNCHES, "decode_attention": 1}
            or decode_attention_kernel.combine_launches != split):
        fail(f"one decode call launched {read_counts()}, "
             f"{decode_attention_kernel.combine_launches} combines")

    for name, B, Smax, H, K, D, window, mix in DECODE_TIMED:
        pos = decode_positions(B, Smax, mix, cgen).to(dev)
        q, k, v = inputs(B, Smax, H, K, D, torch.bfloat16)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        live = ((pos[:, None] % Smax - torch.arange(Smax, device=dev)[None, :]) % Smax
                < torch.clamp(pos + 1, max=min(Smax, window or Smax))[:, None])
        mask = live[:, None, None, :]
        ms = time_ms(lambda: decode_attention_kernel(q, k, v, pos, window))
        plain_ms = time_ms(lambda: decode_attention_ref(q, k, v, pos, window), iters=5)
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        bound_ms, bound_by = decode_bound(pos, Smax, H, K, D, window)
        n_chunks = decode_module.chunks(B, K, Smax, D, torch.bfloat16)
        rec = dict(shape=f"bf16 {name} B={B} Smax={Smax} H={H} K={K} D={D}"
                   + (f" w={window}" if window else "")
                   + f" pos {pos.float().mean().item():.0f}, {n_chunks} chunks",
                   ms=ms, old_ms=None, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   max_abs_err=check.errs[(name, torch.bfloat16)])
        if (name, B) == DECODE_MAIN[:2]:
            rec["by_chunk_ms"] = {str(c): time_ms(lambda: decode_attention_kernel(  # noqa: E731
                q, k, v, pos, window, _chunk_len=c)) for c in DECODE_CHUNKS}
        timings[name] = rec
    t = timings[DECODE_MAIN[0]]
    check.report(f"; {t['shape'][5:]}: {t['ms']:.4f} ms ({t['bound_ms'] / t['ms']:.1%} of the "
                 "bound); by chunk length "
                 + ", ".join(f"{c} {ms:.4f}" for c, ms in t["by_chunk_ms"].items()))
    return timings


# The latent (MLA) decode kernel against mla_decode_attention_ref, held to
# DECODE_TOL: in bf16 its scores are exact products summed in f32 and its
# weights carry about 16 bits (two bf16 terms), so the output differs from
# the f32 reference's by its one rounding; f32 by summation order.
LONGCHAT = ((4096, 0.6, 7680), (256, 0.8, 512))   # gpubench's longchat mix
MLA_WIDTHS = ((512, 64), (32, 16))                # (C, R): Moonlight, its smoke
# (name, B, S, H, C, R, mix); the first is the cell's shape, timed
MLA_MAIN = ("moonlight longchat", 128, 8192, 16, 512, 64, LONGCHAT)
MLA_CASES = [MLA_MAIN,
             ("moonlight 4 rows", 4, 8192, 16, 512, 64, "uniform"),
             ("moonlight H=8 ring", 8, 1024, 8, 512, 64, "wrapped"),
             ("moonlight-smoke", 4, 96, 4, 32, 16, "wrapped")]


def mla_bound(pos, S, H, C, R, itemsize=2):
    """Least time (ms) of the latent decode: the written slots read once
    (C + R values each) beside q and the output, and 2 H (C + R + C)
    operations a slot on the tensor cores."""
    n = torch.clamp(pos + 1, max=S).sum().item()
    B = pos.numel()
    nbytes = itemsize * (n * (C + R) + B * H * (2 * C + R))
    return bound(2 * H * (2 * C + R) * n / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3)


def check_mla_decode(gen, dev) -> dict:
    """The latent decode kernel against its plain version in bf16 and f32
    at MLA_CASES (at the rule's chunk length, at 64 slots and unsplit), one
    launch a call, then timed in bf16 at MLA_MAIN beside the plain version
    and its bound; one line."""
    cgen = torch.Generator().manual_seed(1)
    check = Cases("mla_decode_attention")
    for name, B, S, H, C, R, mix in MLA_CASES:
        pos = decode_positions(B, S, mix, cgen).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            q = torch.randn((B, 1, H, C + R), generator=gen, device=dev).to(dt)
            cache = torch.randn((B, S, C + R), generator=gen, device=dev).to(dt)
            scale = (C // 4 + R) ** -0.5
            ref = mla_decode_attention_ref(q, cache, pos, C, scale)
            for chunk in (0, 64, S):
                out = mla_decode_kernel(q, cache, pos, C, scale, _chunk_len=chunk)
                torch.cuda.synchronize()
                check.check(f"{name} B={B} S={S} H={H} C={C} R={R} {str(dt)[6:]} "
                            f"chunk={chunk or 'rule'}", out, ref, DECODE_TOL[dt], key=(name, dt))
            del q, cache, ref, out
    name, B, S, H, C, R, mix = MLA_MAIN
    pos = decode_positions(B, S, mix, cgen).to(dev)
    q = torch.randn((B, 1, H, C + R), generator=gen, device=dev).to(torch.bfloat16)
    cache = torch.randn((B, S, C + R), generator=gen, device=dev).to(torch.bfloat16)
    reset_counts()
    mla_decode_kernel.combine_launches = 0
    mla_decode_kernel(q, cache, pos, C, 0.1)
    split = mla_module.chunks(B, S, torch.bfloat16, C, R) > 1
    if (read_counts() != {**NO_LAUNCHES, "mla_decode_attention": 1}
            or mla_decode_kernel.combine_launches != split):
        fail(f"one latent decode call launched {read_counts()}, "
             f"{mla_decode_kernel.combine_launches} combines")
    ms = time_ms(lambda: mla_decode_kernel(q, cache, pos, C, 0.1))
    plain_ms = time_ms(lambda: mla_decode_attention_ref(q, cache, pos, C, 0.1), iters=3)
    bound_ms, bound_by = mla_bound(pos, S, H, C, R)
    rec = dict(shape=f"bf16 {name} B={B} S={S} H={H} C={C} R={R} pos "
               f"{pos.float().mean().item():.0f}, {mla_module.chunks(B, S, torch.bfloat16, C, R)}"
               " chunks", ms=ms, old_ms=None, plain_ms=plain_ms, library_ms=None,
               bound_ms=bound_ms, bound_by=bound_by,
               max_abs_err=check.errs[(name, torch.bfloat16)])
    check.report(f"; the cell's shape (pos mean {pos.float().mean().item():.0f}, "
                 f"{mla_module.chunks(B, S, torch.bfloat16, C, R)} chunks): {ms:.4f} ms "
                 f"({bound_ms / ms:.1%} of the {bound_by} bound {bound_ms:.4f}), plain {plain_ms:.2f}")
    return {name: rec}


# The routed experts' op (repro_torch::moe_experts) at the longchat cell's
# shapes, (name, tokens): a prefill of 4,096 tokens and a decode step of 128
# rows, 6 of Moonlight's 64 experts (2048 -> 1408 -> 2048) a token, experts 0
# and 17 given no rows.
MOE_CASES = (("prefill", 4096), ("decode", 128))
# bf16 on the card (three grouped GEMMs) against experts_loop in f32 on the
# same bf16 inputs, per sorted row as ||out - ref|| / ||ref||: the bf16 route
# rounds gate, up, the SiLU, the product and the output once each (at most
# 2^-8 of a value), and a row's error averages over its 2048 values, so it
# reads about 1.3 x 2^-8; the limit is 2^-7, bf16's epsilon. A row that meets
# a wrong expert, or lands in another row's place, reads about 1.4.
MOE_ROW_REL = 2.0 ** -7


def check_moe_experts(gen, dev) -> dict:
    """moe_experts in bf16 on the card against experts_loop in f32 at
    MOE_CASES, with the rows sorted by expert as moe_dropless sorts them,
    each timed beside its bound (the touched experts' weights read once, or
    their operations on the tensor cores); one line."""
    E, D, F, k = 64, 2048, 1408, 6
    w16 = [(torch.randn(shape, generator=gen, device=dev) * shape[1] ** -0.5).to(torch.bfloat16)
           for shape in ((E, D, F), (E, D, F), (E, F, D))]
    w32 = [w.float() for w in w16]
    recs, parts = {}, []
    for name, T in MOE_CASES:
        logits = torch.randn((T, E), generator=gen, device=dev)
        logits[:, [0, 17]] = -math.inf
        sel = torch.topk(logits, k, dim=-1).indices
        order, offs = moe_mod.dispatch_order(sel, E)
        xt = torch.randn((T, D), generator=gen, device=dev).to(torch.bfloat16)
        x = xt[order // k]
        out = moe_mod.moe_experts(x, offs, *w16)
        ref = moe_mod.experts_loop(x.float(), offs, *w32)
        torch.cuda.synchronize()
        rel = ((out.float() - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
        if out.dtype != torch.bfloat16 or rel > MOE_ROW_REL:
            fail(f"moe_experts {name} {T} x {k}: {out.dtype}, worst row {rel:.3e} of its norm "
                 f"(limit {MOE_ROW_REL:.3e})")
        ms = time_ms(lambda: moe_mod.moe_experts(x, offs, *w16))
        touched = int((torch.diff(offs, prepend=offs.new_zeros(1)) > 0).sum())
        bound_ms, bound_by = bound(2 * 3 * T * k * D * F / PEAK_BF16_FLOPS * 1e3,
                                   2 * (3 * touched * D * F + 2 * T * k * D) / PEAK_BYTES * 1e3)
        recs[name] = dict(shape=f"bf16 {name} {T} x {k} of {E}, D={D} F={F}", ms=ms,
                          bound_ms=bound_ms, bound_by=bound_by, max_row_rel=rel)
        parts.append(f"{name} {T}x{k} {rel / MOE_ROW_REL:.3f}, {ms:.4f} ms "
                     f"({bound_ms / ms:.1%} of the {bound_by} bound)")
        del x, xt, out, ref
    log("[kernels] moe_experts bf16 vs experts_loop f32, worst row over its limit 2^-7 "
        "(experts 0, 17 empty): " + "; ".join(parts))
    return recs


def phase_kernels(dev, old: dict) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    at_phase(3, "kernels", "flash_attention")
    flash = check_flash(gen, dev, old.get("flash_attention"))
    at_phase(3, "kernels", "lru_scan")
    lru, lru_launch = check_lru(gen, dev, old.get("lru_scan"))
    at_phase(3, "kernels", "ssd_scan")
    recs = {"flash": flash, "lru": lru, "lru_launch": lru_launch,
            "ssd": check_ssd(gen, dev, old.get("ssd_scan"))}
    at_phase(3, "kernels", "ssd_scan gradient rule")
    recs["ssd_grad"] = check_ssd_grad(gen, dev)
    at_phase(3, "kernels", "flash_attention gradient rule")
    recs["flash_grad"] = check_flash_grad(gen, dev)
    at_phase(3, "kernels", "flash_attention backward kernel")
    recs["flash_bwd"] = check_flash_bwd(gen, dev, recs["flash_grad"],
                                        old.get("flash_attention_bwd"))
    at_phase(3, "kernels", "lru_scan gradient rule")
    recs["lru_grad"] = check_lru_grad(gen, dev)
    at_phase(3, "kernels", "decode_attention")
    recs["decode"] = check_decode(gen, dev)
    at_phase(3, "kernels", "mla_decode_attention")
    recs["mla_decode"] = check_mla_decode(gen, dev)
    at_phase(3, "kernels", "moe_experts")
    recs["moe_experts"] = check_moe_experts(gen, dev)
    return recs


# A differing expert choice between the card and the CPU is a routing tie
# when the k-th and (k+1)-th router probabilities of that token lie within
# this of each other (f32 rounding of the router's product moves them by
# about 1e-7); above it, a differing choice is a fault.
ROUTE_TIE = 1e-5


class Routes:
    """While entered, wraps ``moe.route`` (every MoE layer's router, both
    paths) and records per call: the chosen experts (sorted per token), the
    gap between each token's k-th and (k+1)-th router probability, and, on
    the dense path, the assignments dropped past the capacity."""

    def __init__(self, cfg):
        self.cfg, self.calls = cfg, []

    def __enter__(self):
        route = self.route = moe_mod.route

        def recording(x, router, k):
            probs, gate_vals, sel = route(x, router, k)
            top = torch.topk(probs.detach(), k + 1, dim=-1).values
            drops = 0
            if sel.dim() == 3:                  # the dense dispatch over (B, S)
                C = moe_mod.capacity(self.cfg, sel.shape[1])
                _, assign, _, keep = moe_mod.slots(sel, self.cfg.num_experts, C)
                drops = int(((assign > 0) & ~keep).sum())
            self.calls.append((sel.sort(dim=-1).values.cpu(),
                               (top[..., k - 1] - top[..., k]).cpu(), drops))
            return probs, gate_vals, sel

        moe_mod.route = recording
        return self

    def __exit__(self, *exc):
        moe_mod.route = self.route


def compare_routes(name: str, cpu: Routes, card: Routes) -> tuple[str, bool]:
    """The card's expert choices against the CPU's, call by call: a fault
    (fail) where they differ and the gap is above ROUTE_TIE, a tie at or
    below it. Returns (a short report, whether a tie was found)."""
    if len(cpu.calls) != len(card.calls):
        fail(f"{name}: {len(card.calls)} router calls on the card, {len(cpu.calls)} on the CPU")
    tokens, ties, faults, min_gap = 0, [], [], math.inf
    for (sa, ga, _), (sb, _, _) in zip(cpu.calls, card.calls):
        differ = (sa != sb).any(dim=-1)
        tokens += differ.numel()
        min_gap = min(min_gap, ga.min().item())
        ties += [g for g in ga[differ].tolist() if g <= ROUTE_TIE]
        faults += [g for g in ga[differ].tolist() if g > ROUTE_TIE]
    if faults:
        fail(f"{name}: expert choices differ between the card and the CPU at gaps {faults[:4]} "
             f"(a tie is at most {ROUTE_TIE:g})")
    drops = sum(d for *_, d in card.calls)
    report = (f"routes {tokens} equal, min gap {min_gap:.1e}, {drops} drops"
              + (f", {len(ties)} TIE(S) at gap {max(ties):.1e}" if ties else ""))
    return report, bool(ties)


def _maybe_routes(cfg):
    """Routes of the softmax router's capacity path; a sigmoid router's
    dropless path is held by its logits alone."""
    if cfg.num_experts and cfg.router_scoring == "softmax":
        return Routes(cfg)
    return contextlib.nullcontext()


def model_check(dev, cfg, B: int, S: int, pos: list[int], max_len: int) -> str:
    """Smoke width in float32, card against CPU on one set of seeded weights
    (QKV biases drawn, not zero, so their path computes): one prefill and
    one decode step at per-row positions ``pos``. Returns the arch's part of
    the phase's line: the worst error over the logits and every cache leaf,
    the launches per prefill, and for MoE the expert choices and drops."""
    cfg = cfg.replace(dtype="float32")
    at_phase(4, "model", f"{cfg.name} serving")
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(cfg, gen)
    for name in ("bq", "bk", "bv"):
        if name in params["layers"]:
            params["layers"][name] = 0.5 * torch.randn(params["layers"][name].shape,
                                                       generator=gen)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family in M.FRONTEND_KEYS:     # a vlm's vision or an audio arch's speech frames
        batch[M.FRONTEND_KEYS[cfg.family]] = torch.from_numpy(0.02 * rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model), dtype=np.float32))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
    res, counts, routes = {}, {}, {}
    for device in ("cpu", dev):
        p = to_device(params, device)
        with torch.inference_mode(), _maybe_routes(cfg) as r:
            reset_counts()
            logits, cache = M.prefill(p, cfg, to_device(batch, device), max_len)
            counts[str(device)] = read_counts()
            reset_counts()
            dlogits, cache = M.decode_step(p, cfg, cache, nxt.to(device),
                                           torch.tensor(pos, device=device))
            counts[f"{device} decode"] = read_counts()
        routes[str(device)] = r
        res[str(device)] = {"prefill logits": logits.cpu(), "decode logits": dlogits.cpu(),
                            **{f"cache {k}": t.cpu() for k, t in leaves(cache["layers"])}}
    cpu, card = res["cpu"], res[str(dev)]
    worst = max((card[k] - cpu[k]).abs().max().item() for k in cpu)
    launches, expect = counts[str(dev)], launches_per_prefill(cfg)
    decode, expect_decode = counts[f"{dev} decode"], launches_per_decode(cfg)
    part = (f"{cfg.name} {worst:.1e} ({len(cpu) - 2} leaves, {counts_str(launches)}"
            + (f"; decode {counts_str(decode)})" if decode != NO_LAUNCHES else ")"))
    tie = False
    if cfg.num_experts and cfg.router_scoring == "softmax":
        report, tie = compare_routes(cfg.name, routes["cpu"], routes[str(dev)])
        if sum(d for *_, d in routes["cpu"].calls) == 0:
            fail(f"{cfg.name}: the prompt of {S} dropped no token; the check needs drops")
        part += f" [{report}]"
    if not tie and not all(torch.allclose(card[k], cpu[k], **MODEL_TOL) for k in cpu):
        bad = {k: (card[k] - cpu[k]).abs().max().item() for k in cpu
               if not torch.allclose(card[k], cpu[k], **MODEL_TOL)}
        log(f"[model] {cfg.name} serving, card vs CPU: {bad} MISMATCH")
        fail(f"{cfg.name} on the card disagrees with the CPU")
    if counts["cpu"] != NO_LAUNCHES or counts["cpu decode"] != NO_LAUNCHES:
        fail(f"the CPU path launched kernels: {counts['cpu']}, {counts['cpu decode']}")
    if launches != expect:
        fail(f"{cfg.name} prefill launched {launches}, expected {expect}")
    if decode != expect_decode:
        fail(f"{cfg.name} decode step launched {decode}, expected {expect_decode}")
    return part


def train_check(dev, arch: str, steps: int) -> str:
    """``arch``'s smoke config in float32, card against CPU from one set of
    seeded params: the loss (with the MoE aux loss) and every gradient leaf
    of one step, then the loss and grad_norm of ``steps`` steps through
    make_train_step, with the kernel launches per step. Returns the arch's
    part of the phase's line."""
    cfg = configs.get_smoke(arch).replace(dtype="float32")
    at_phase(4, "model", f"{cfg.name} training")
    # ragged against mamba2-smoke's chunk of 32; past recurrentgemma-smoke's window of 32
    batches = [make_batch(cfg, 2, 100, seed=0, step=i) for i in range(steps)]
    res, counts, routes = {}, {}, {}
    for device in ("cpu", dev):
        # the same seeded draw on the CPU for each device (a train step
        # updates its state in place)
        state = to_device(init_train_state(cfg, torch.Generator().manual_seed(0)), device)
        params = state["params"]
        names, tensors = zip(*leaves(params))
        for t in tensors:
            t.requires_grad_(True)
        reset_counts()
        with _maybe_routes(cfg) as r:
            loss = M.loss_fn(params, cfg, to_device(batches[0], device))
            grads = torch.autograd.grad(loss, tensors)
            routes[str(device)] = r
            one = {"loss": loss.detach().cpu(),
                   **{f"grad {n}": g.cpu() for n, g in zip(names, grads)}}
            step = make_train_step(cfg, opt=OptConfig(warmup_steps=2))
            curve, per_step = [], []
            for b in batches:
                reset_counts()
                state, metrics = step(state, to_device(b, device))
                curve.append([metrics["loss"].item(), metrics["grad_norm"].item()])
                per_step.append(read_counts())
        res[str(device)] = (one, torch.tensor(curve))
        counts[str(device)] = per_step
    (cpu_one, cpu_curve), (card_one, card_curve) = res["cpu"], res[str(dev)]
    errs = {k: (card_one[k] - cpu_one[k]).abs().max().item() for k in cpu_one}
    worst = max((k for k in errs if k != "loss"), key=errs.get)
    expect = launches_per_train_step(cfg)
    part = (f"{cfg.name} loss {cpu_one['loss'].item():.6f} err {errs['loss']:.1e}, "
            f"{len(errs) - 1} grads worst {worst[5:]} {errs[worst]:.1e}, {steps}-step curve "
            f"{(card_curve - cpu_curve).abs().max().item():.1e} "
            f"({counts_str(counts[str(dev)][0])})")
    tie = False
    if cfg.num_experts and cfg.router_scoring == "softmax":
        report, tie = compare_routes(cfg.name, routes["cpu"], routes[str(dev)])
        part += f" [{report}]"
    if not tie and not all(torch.allclose(card_one[k], cpu_one[k], **MODEL_TOL) for k in cpu_one):
        log(f"[model] {cfg.name} training, card vs CPU: worst {worst} {errs[worst]:.3e} MISMATCH")
        fail(f"{cfg.name} training on the card disagrees with the CPU")
    if not tie and not torch.allclose(card_curve, cpu_curve, **MODEL_TOL):
        fail(f"{cfg.name} loss or grad_norm curve on the card disagrees with the CPU")
    if any(c != NO_LAUNCHES for c in counts["cpu"]):
        fail(f"the CPU path launched kernels: {counts['cpu']}")
    if any(c != expect for c in counts[str(dev)]):
        fail(f"{cfg.name} train steps launched {counts[str(dev)]}, expected {expect} each")
    return part


# Phase 4's serving checks: (config, B, S, decode positions, max_len).
# granite-smoke's and recurrentgemma-smoke's prompts are longer than the
# window of 32 (the local-attention and mixtral-smoke's swa rings roll);
# mamba2-smoke's 45 is ragged against its chunk of 32 (the plain scan pads,
# carries its state over two chunks and returns it); mistral-nemo-smoke
# with head_dim 32 has H·D = 128 against a width of 64, as the full config
# has 32 x 128 against 5120 (its smoke's 16 gives H·D = d_model); llama3-
# smoke's head_dim 8 runs the kernel at width 16. MoE prompts of 45 drop
# tokens past the capacity (28 for mixtral-smoke, 14 for moonshot-smoke);
# decode at B = 2 takes mixtral-smoke's dense path (B·k = 4 = E) and
# moonshot-smoke's gather path (4 < 8). internvl2-smoke's 8 vision
# embeddings come before the prompt, so its decode positions count them;
# seamless-smoke's 16 speech frames go through the encoder (2 launches),
# each decoder layer launches its self- and cross-attention, and a decode
# step its cross-attention (Sq = 1 against the 16 frames).
MODEL_CHECKS = [
    (configs.get_smoke("granite-8b"), 2, 37, [37, 30], 64),
    (configs.get_smoke("recurrentgemma-2b"), 2, 45, [45, 33], 64),
    (configs.get_smoke("mamba2-130m"), 2, 45, [45, 40], 64),
    (configs.get_smoke("qwen2.5-14b"), 2, 37, [37, 30], 64),
    (configs.get_smoke("mistral-nemo-12b").replace(head_dim=32), 2, 37, [37, 30], 64),
    (configs.get_smoke("llama3-405b"), 2, 45, [45, 33], 64),
    (configs.get_smoke("mixtral-8x22b"), 2, 45, [45, 33], 64),
    (configs.get_smoke("moonshot-v1-16b-a3b"), 2, 45, [45, 33], 64),
    (configs.get_smoke("moonlight-16b-a3b"), 2, 45, [45, 33], 64),
    (configs.get_smoke("internvl2-26b"), 2, 37, [45, 38], 64),
    (configs.get_smoke("seamless-m4t-large-v2"), 2, 37, [37, 30], 64),
]
# Training checks, card against CPU. tiny-smoke and granite-smoke differ
# only in name and dtype, and both run here in f32: the same computation
# (they printed the same loss and errors), so tiny-smoke stands for the
# pair (tiny is the dense arch that trains at full width).
TRAIN_CHECKS = [("mamba2-130m", 3), ("tiny", 2), ("recurrentgemma-2b", 2),
                ("qwen2.5-14b", 2), ("mixtral-8x22b", 2), ("internvl2-26b", 2),
                ("seamless-m4t-large-v2", 2)]


def phase_model(dev) -> None:
    parts = [model_check(dev, *check) for check in MODEL_CHECKS]
    log("[model] serving f32 card vs CPU, worst |err| over prefill and decode logits and "
        "every cache leaf (atol=rtol=1e-3), launches per prefill: " + "; ".join(parts))
    # the dropless experts' bf16 route (grouped GEMMs) under the graph; the
    # f32 model checks above run experts_loop, which reads the host, eagerly
    cfg = configs.get_smoke("moonlight-16b-a3b")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           M.compute_dtype(cfg), dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in (37, 20, 45, 29)]
    log(f"[graph] {cfg.name} {cfg.dtype}: {graph_check(dev, cfg, params, prompts, 128)}")
    parts = [train_check(dev, arch, steps) for arch, steps in TRAIN_CHECKS]
    log("[model] training f32 card vs CPU, batch 2 x 100, loss and every grad leaf of one "
        "step, then the steps' loss and grad_norm (atol=rtol=1e-3), launches per step: "
        + "; ".join(parts))


_SCHEDULES: dict = {}       # prompt range -> the schedule last printed for it
GRAPH_STEPS = 32            # decode steps a graphed and an eager engine are compared over


def graph_check(dev, cfg, params, prompts: list, max_len: int) -> str:
    """The graphed decode step against the eager one on the card. Two engines
    of batch 4 serve ``prompts[:4]`` for GRAPH_STEPS decode steps each, one
    through its ``ServeStep`` and one through ``M.decode_step`` called
    directly: their greedy tokens must be identical (the widest logit
    difference of a step is reported), the graphed one must capture once and
    replay every later step, and its kernel wrappers must count the prefills
    and every decode step once (the first run eagerly, the rest replayed;
    the capture not at all). Then one eager decode step runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host read inside the
    step), and the graphed engine's cache is replaced, after which it must
    capture again and still give the eager engine's tokens. Returns the
    part of the serving line."""
    def eager(p, cache, tokens, pos):
        with torch.inference_mode():
            return M.decode_step(p, cfg, cache, tokens, pos)

    runs = []
    for graphed in (True, False):
        engine = ServeEngine(cfg, params, max_batch=4, max_len=max_len, device=dev)
        inner, seen = (engine.decode if graphed else eager), []

        def spy(*args, inner=inner, seen=seen):
            logits, cache = inner(*args)
            seen.append(logits.clone())
            return logits, cache
        engine.decode = spy
        reset_counts()
        rids = [engine.submit(p, max_new_tokens=GRAPH_STEPS + 1) for p in prompts[:4]]
        engine.run()
        runs.append((engine, seen, [engine.requests[r].generated for r in rids],
                     read_counts()))
    (g, g_logits, g_tokens, g_counts), (e, e_logits, e_tokens, _) = runs
    step, n = g.serve_step, len(g_logits)
    if g_tokens != e_tokens or n != len(e_logits) or n < GRAPH_STEPS:
        fail(f"{cfg.name}: the graphed engine's tokens differ from the eager one's "
             f"({n} and {len(e_logits)} steps)")
    worst = max(float((a - b).abs().max()) for a, b in zip(g_logits, e_logits))
    if (step.captures, step.replays) != (1, n - 1):
        fail(f"{cfg.name}: {step.captures} captures and {step.replays} replays in "
             f"{n} decode steps")
    per_decode = launches_per_decode(cfg)
    expect = {k: per * len(prompts[:4]) + per_decode[k] * n
              for k, per in launches_per_prefill(cfg).items()}
    if g_counts != expect:
        fail(f"{cfg.name}: graphed engine launched {g_counts}, expected {expect}")
    tokens = torch.tensor([[r[-1]] for r in e_tokens], device=dev)
    pos = torch.tensor([len(p) + GRAPH_STEPS for p in prompts[:4]], device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager(params, e.cache, tokens, pos)
    except RuntimeError as exc:
        fail(f"{cfg.name}: an eager decode step synchronises: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    g.cache = M.init_cache(cfg, 4, max_len, dev)
    again = []
    for engine in (g, e):
        rid = engine.submit(prompts[0], max_new_tokens=9)
        engine.run()
        again.append(engine.requests[rid].generated)
    if step.captures != 2 or again[0] != again[1]:
        fail(f"{cfg.name}: after a new cache, {step.captures} captures, tokens "
             f"{again[0]} against the eager {again[1]}")
    return f"{n} x 4 tokens = eager, |dlogit| {worst:.1e}, no sync, recaptured"


def phase_serve(dev, arch: str, *, max_len: int, prompt_range: tuple[int, int]) -> dict:
    """Serve 8 requests at full width with prompt lengths drawn from
    ``prompt_range`` (the longest forced into request 0), 2-16 new tokens."""
    at_phase(5, "serving", arch)
    cfg = configs.get(arch)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           M.compute_dtype(cfg), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in leaves(params))
    setup_s = time.perf_counter() - t0
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
    step = engine.serve_step
    replays0 = step.replays
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
    schedule = (f"prompts {sorted(int(n) for n in lengths)}, max_new "
                f"{[int(n) for n in max_new]}")
    active = (f" ({cfg.active_param_count() / 1e9:.3f} B active: top-{cfg.num_experts_per_tok} "
              f"of {cfg.num_experts} experts)" if cfg.num_experts else "")
    if schedule != _SCHEDULES.get(prompt_range):     # printed once per schedule
        log(f"[serve] schedule: {len(done)} requests, {schedule}")
    _SCHEDULES[prompt_range] = schedule
    log(f"[serve] {arch} {cfg.num_layers} x {cfg.d_model}, {n_params / 1e9:.3f} B{active} "
        f"{cfg.dtype}, init {setup_s:.3f} s, wall {wall:.4f} s: "
        f"{n_prefill} prefills, mean {1e3 * statistics.mean(stats['prefill_s']):.3f} ms; "
        f"{n_steps} decode steps, mean {1e3 * statistics.mean(stats['decode_s']):.3f} ms; "
        f"{tokens} tokens, {tokens / wall:.2f}/s; peak "
        f"{peak / 2**30:.3f} GiB; launches {counts_str(launches)}; "
        f"{step.replays - replays0} replayed")
    card = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    if not all(r.done for r in done):
        fail("not every request completed")
    if not all(1 <= len(r.generated) <= n for r, n in zip(done, max_new)):
        fail("a request generated more tokens than its budget")
    if not stats["finite"]:
        fail("non-finite logits")
    per_decode = launches_per_decode(cfg)
    expect = {k: n * n_prefill + per_decode[k] * n_steps
              for k, n in launches_per_prefill(cfg).items()}
    if n_prefill != len(done) or launches != expect:
        fail(f"{arch}: launches {launches} != {expect} for {n_prefill} prefills and "
             f"{n_steps} decode steps")
    if step.replays - replays0 != (0 if moe_mod.decode_reads_host(cfg, M.compute_dtype(cfg))
                                   else n_steps):
        fail(f"{arch}: {step.replays - replays0} of {n_steps} decode steps replayed the graph")
    with torch.inference_mode():                # greedy first token, request alone
        logits, _ = M.prefill(params, cfg, engine.prefill_batch(prompts[0]), max_len)
    if int(torch.argmax(logits[0])) != done[0].generated[0]:
        fail("first token of request 0 differs from its single-request prefill")
    log(f"[graph] {arch}: {graph_check(dev, cfg, params, prompts, max_len)}")
    return {"arch": arch, "cfg": cfg, "launches": launches, "engine": engine, "prompts": prompts, "max_new": max_new, "stats": stats,
            "wall_s": wall, "tokens": tokens, "steps": n_steps, "card": card,
            "generated": [r.generated for r in done]}


def top_kernels(trace: Trace, n: int = 2) -> str:
    """The ``n`` kernels that take the most device time, on one line."""
    busy_ms = trace.busy_ms()
    top = sorted(trace.kernels.items(), key=lambda kv: -kv[1][1])[:n]
    return "; ".join(f"{ns / 1e6:.3f} ms ({ns / 1e6 / max(busy_ms, 1e-9):.1%}) x{count} "
                     f"{name[:32]}" for name, (count, ns) in top)


def phase_profile(serve: dict) -> None:
    """Serve phase 5's 8 requests again, under torch.profiler. Greedy decoding
    on the same weights repeats phase 5's schedule exactly (8 prefills, the
    same decode steps), which is checked. The device's idle share is given
    two ways: within the traced run (1 - kernel time / traced wall; tracing
    slows the host, so this overstates idling) and against phase 5's untraced
    wall for the same work (1 - kernel time / untraced wall; kernel times do
    not change under tracing)."""
    engine, stats, arch = serve["engine"], serve["stats"], serve["arch"]
    at_phase(6, "profile", arch)

    def labelled(fn, name):
        def run(*args):
            with record_function(name):
                return fn(*args)
        return run

    untraced_us = {"serve.prefill": statistics.mean(stats["prefill_s"]) * 1e6,
                   "serve.decode": statistics.mean(stats["decode_s"]) * 1e6}
    engine.prefill = labelled(engine.prefill, "serve.prefill")
    engine.decode = labelled(engine.decode, "serve.decode")
    steps0, replays0 = engine.steps_run, engine.serve_step.replays
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
    trace = Trace(prof, untraced_us)
    replayed = engine.serve_step.replays > replays0
    if replayed and not (trace.graph_kernels and trace.labels["serve.decode"]["device_ns"]):
        fail(f"{arch}: the trace gives the replayed decode steps "
             f"{trace.graph_kernels} kernels")
    busy_us = trace.busy_ms() * 1e3
    untraced_wall_us = serve["wall_s"] * 1e6
    port_us = {name: trace.matching_ms(pat) * 1e3
               for name, pat in (("flash", r"flash_fwd\w*_kernel"), ("lru", LRU_KERNELS),
                                 ("decode", r"decode_attn\w*_kernel"))}
    per_call = []
    for span, t in trace.labels.items():
        if not t["calls"]:
            fail(f"{arch}: the trace holds no {span} range")
        dev_us = t["device_ns"] / 1e3 / t["calls"]
        per_call.append(
            f"{span[6:]} x{t['calls']} {untraced_us[span] / 1e3:.3f} / "
            f"{t['host_ns'] / 1e6 / t['calls']:.3f} / {dev_us / 1e3:.3f}, "
            f"{1 - dev_us / untraced_us[span]:.1%}")
    log(f"[profile] {arch}: kernels {busy_us / 1e3:.3f} ms; device idle "
        f"{1 - busy_us / wall_us:.1%} of the traced wall {wall_us / 1e3:.3f} ms, "
        f"{1 - busy_us / untraced_wall_us:.1%} of phase 5's {untraced_wall_us / 1e3:.3f} ms; "
        + (", ".join(f"{name} {us / 1e3:.3f} ms ({us / max(busy_us, 1):.1%})"
                     for name, us in port_us.items() if us) or "no port kernel")
        + "; per call, ms untraced / traced host / kernels, idle: " + "; ".join(per_call)
        + "; top: " + top_kernels(trace)
        + f" [at {time.perf_counter() - T_START:.1f} s]")


def serve_and_profile(dev, arch: str, **kw) -> dict:
    """Phases 5 and 6 for one arch; frees its weights and cache after."""
    serve = phase_serve(dev, arch, **kw)
    result = {k: serve[k] for k in ("launches", "card", "cfg", "prompts", "max_new",
                                    "generated")}
    phase_profile(serve)
    serve.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return result


TRAIN = dict(steps=6, seq_len=2048, seed=0)
# Per arch: global batch and microbatches. recurrentgemma-2b's f32 state
# (params, two moments, gradients) is 43.1 GiB, so it takes 4 rows of 2048
# tokens as 4 microbatches of one row.
TRAIN_RUNS = {"mamba2-130m": dict(global_batch=8, microbatches=1),
              "tiny": dict(global_batch=8, microbatches=1),
              "recurrentgemma-2b": dict(global_batch=4, microbatches=4)}
# The first loss of a random init: logits z = x W, x of unit rms (the final
# norm) and W of std s (D^-0.5 unembedding, 0.02 tied embedding), so var(z) =
# D s^2 and E[logsumexp] of V such logits is ln V + var(z) / 2. The skew of
# the synthetic tokens moves the first loss from it by a few tenths at most:
# 0.2 with tied logits, 0.25 with untied ones, whose larger spread (var 1)
# lets the skew move the loss further (tiny reads 0.21 below).
def first_loss_tol(cfg) -> float:
    return 0.2 if cfg.tie_embeddings else 0.25


def first_loss_expected(cfg) -> float:
    var = cfg.d_model * 0.02 ** 2 if cfg.tie_embeddings else 1.0
    return math.log(cfg.vocab_size) + var / 2


def phase_train(dev, arch: str) -> dict:
    """``arch`` at full width through train_loop, the entry point the
    launcher and a cluster job call, on the card, 6 steps at --lr 3e-4; the
    kernel counts are set to 0 just before and read just after, and must
    match launches_per_train_step exactly. Step times come from the host
    clock between the loop's per-step metric reads, each of which
    synchronises."""
    at_phase(7, "training", arch)
    cfg, run = configs.get(arch), TRAIN_RUNS[arch]
    opt = OptConfig(lr=3e-4)
    stamps, history = [], []

    def on_metrics(step, m):
        stamps.append(time.perf_counter())
        history.append(m)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                        # count the main path's run only
    t0 = time.perf_counter()
    result = train_loop(cfg, opt=opt, log_every=1, on_metrics=on_metrics, device=dev,
                        **run, **TRAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in history]
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    steady = step_s[1:]                   # step 0 also pays cuBLAS and allocator set-up
    tokens = run["global_batch"] * TRAIN["seq_len"]
    expect = {k: n * TRAIN["steps"]
              for k, n in launches_per_train_step(cfg, run["microbatches"]).items()}
    log(f"[train] {arch} {cfg.num_layers} x {cfg.d_model}, {cfg.param_count():,} params "
        f"(f32 masters, moments), {cfg.dtype} activations, {TRAIN['steps']} steps of "
        f"{run['global_batch']} x {TRAIN['seq_len']} in {run['microbatches']} "
        f"microbatch(es): wall {wall:.4f} s with init; step 0 "
        f"{1e3 * step_s[0]:.3f} ms; steps 1-{len(steady)} mean "
        f"{1e3 * statistics.mean(steady):.3f} ms, median "
        f"{1e3 * statistics.median(steady):.3f} ms per step, "
        f"{tokens / statistics.mean(steady):.1f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB; launches {counts_str(launches)}")
    log(f"[train] {arch} losses {[round(x, 6) for x in losses]} (first expected "
        f"{first_loss_expected(cfg):.4f}), grad_norm "
        f"{[round(m['grad_norm'], 4) for m in history]}, lr {history[-1]['lr']:.3e}")
    card = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    if result.status != "done" or result.step != TRAIN["steps"] or len(losses) != TRAIN["steps"]:
        fail(f"{arch} training ended {result.status} at step {result.step}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{arch}: non-finite loss: {losses}")
    if abs(losses[0] - first_loss_expected(cfg)) > first_loss_tol(cfg):
        fail(f"{arch}: first loss {losses[0]:.4f} is not within {first_loss_tol(cfg)} of "
             f"ln V + var(logits)/2 = {first_loss_expected(cfg):.4f}")
    if not losses[-1] < losses[0]:
        fail(f"{arch}: the loss curve does not fall: {losses}")
    if launches != expect:
        fail(f"{arch} training launched {launches}, expected {expect}")
    return {"arch": arch, "launches": launches, "cfg": cfg, "opt": opt, **run,
            "step_ms": statistics.mean(steady) * 1e3, "card": card, "losses": losses,
            "peak_gib": peak / 2**30}


# Phase 7, chunked: the reference's chunked attention (ModelConfig.attn_chunked)
# trains at full width on CHUNKED_SEQ tokens a row, with the flag on and off
# from one seed, TRAIN's 6 steps each: (arch, global batch and microbatches,
# the peak must fall).
# tiny's flash rule holds its peak without the flag (8 x 8 x 4096^2 f32
# scores, several at once); recurrentgemma-2b's 43.1 GiB of f32 state and
# its 256,000-word logits hold it either way, so there the peak may rise by
# no more than what the flag adds (chunked_slack). recurrentgemma-2b runs
# D = 256, window 2048 and K = 1 at full width.
CHUNKED_RUNS = (("tiny", dict(global_batch=8, microbatches=1), True),
                ("recurrentgemma-2b", dict(global_batch=4, microbatches=4), False))
# Every step's loss, flag on against off, relative: step 0 runs the same
# kernels; later steps see gradients that differ by the backward kernel's
# f32 sums against the plain rule's, which in f32 (tiny) moves the losses
# far inside TOL's rtol, and in bf16 (recurrentgemma-2b) also by the one
# bf16 rounding of dq, dk and dv, where MODEL_TOL's rtol holds.
CHUNKED_LOSS_REL = {"float32": TOL[torch.float32]["rtol"], "bfloat16": MODEL_TOL["rtol"]}


def chunked_run(dev, cfg, run: dict) -> dict:
    """TRAIN's steps of ``cfg`` at CHUNKED_SEQ through train_loop, the
    counts set to 0 just before and read just after: losses, ms/step (steps
    after the first), peak GiB, launches."""
    history, stamps = [], []

    def on_metrics(step, m):
        stamps.append(time.perf_counter())
        history.append(m)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                        # count the main path's run only
    result = train_loop(cfg, opt=OptConfig(lr=3e-4), log_every=1, on_metrics=on_metrics,
                        device=dev, steps=TRAIN["steps"], seq_len=CHUNKED_SEQ,
                        seed=TRAIN["seed"], **run)
    torch.cuda.synchronize()
    launches = read_counts()
    losses = [m["loss"] for m in history]
    if result.status != "done" or len(losses) != TRAIN["steps"] or \
            not all(math.isfinite(x) for x in losses):
        fail(f"{cfg.name} attn_chunked={cfg.attn_chunked} training ended {result.status} "
             f"at step {result.step}, losses {losses}")
    expect = {k: n * TRAIN["steps"] for k, n in
              launches_per_train_step(cfg, run["microbatches"]).items()}
    if launches != expect:
        fail(f"{cfg.name} attn_chunked={cfg.attn_chunked} launched {launches}, "
             f"expected {expect}")
    return {"losses": losses, "launches": launches,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "step_ms": 1e3 * statistics.mean(b - a for a, b in zip(stamps, stamps[1:])),
            "card": nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")}


def chunked_slack(cfg, run: dict) -> int:
    """Bytes that attn_chunked may add to a step's peak where the flag takes
    no S x S scores away: the output o that each chunked attention saves for
    its backward (B S H D in the model's dtype, every attention of the pass
    counted, as without remat), and the backward kernel's row statistics L
    and Delta of one call (2 B H S f32), at the microbatch's rows."""
    B = run["global_batch"] // run["microbatches"]
    n = launches_per_train_step(cfg)["flash_attention_bwd"]
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    return (n * B * CHUNKED_SEQ * cfg.num_heads * cfg.head_dim * itemsize
            + 2 * B * cfg.num_heads * CHUNKED_SEQ * 4)


def phase_train_chunked(dev) -> list:
    """CHUNKED_RUNS, each with attn_chunked on, then off, from one seed:
    every step's loss within CHUNKED_LOSS_REL, launches as
    launches_per_train_step counts them (the backward kernel once per
    attention per microbatch with the flag, none without), the peak lower
    with the flag where CHUNKED_RUNS says so, elsewhere higher by no more
    than chunked_slack; one line per arch. Returns the runs with the flag,
    (name, cfg, {"launches"}), and their card readings."""
    runs, cards = [], []
    for arch, run, lower in CHUNKED_RUNS:
        at_phase(7, "training, attn_chunked", arch)
        base = configs.get(arch)
        on, off = (chunked_run(dev, base.replace(attn_chunked=flag), run)
                   for flag in (True, False))
        worst = max(abs(a - b) / abs(b) for a, b in zip(on["losses"], off["losses"]))
        tol = CHUNKED_LOSS_REL[base.dtype]
        slack = 0.0 if lower else chunked_slack(base.replace(attn_chunked=True), run) / 2**30
        log(f"[train] attn_chunked {arch} {run['global_batch']} x {CHUNKED_SEQ} in "
            f"{run['microbatches']} mb, {TRAIN['steps']} steps, on | off: {on['step_ms']:.3f} | "
            f"{off['step_ms']:.3f} ms/step, peak {on['peak_gib']:.3f} | {off['peak_gib']:.3f} "
            f"GiB{f' (may rise {slack:.3f})' if slack else ''}, launches {counts_str(on['launches'])} | {counts_str(off['launches'])}; "
            f"losses {[round(x, 6) for x in on['losses']]}, rel diff {worst:.1e} (limit "
            f"{tol:g})")
        if worst > tol:
            fail(f"{arch}: losses with attn_chunked {on['losses']} against {off['losses']}")
        if (lower and not on["peak_gib"] < off["peak_gib"]) or \
                on["peak_gib"] > off["peak_gib"] + slack:
            fail(f"{arch}: peak {on['peak_gib']:.3f} GiB with attn_chunked against "
                 f"{off['peak_gib']:.3f} without" + (f" (slack {slack:.3f})" if slack else ""))
        runs.append((f"{arch} training, attn_chunked, {CHUNKED_SEQ} tokens a row",
                     base.replace(attn_chunked=True), on))
        cards += [on["card"], off["card"]]
    return runs, cards


# Gradient rules, each timed on the device under a label for the profiled step.
RULES = ((ssd_ops, "ssd_vjp", "ssd_rule"), (flash_ops, "flash_vjp", "flash_rule"),
         (lru_ops, "lru_scan_vjp", "lru_rule"))
# The port's kernels by name: the SSD and flash forwards (their rules launch
# none), and every scan (the forward and, in the rule, the reversed one).
PORT_KERNELS = (("ssd_fwd", r"ssd_\w+_kernel"), ("flash_fwd", r"flash_fwd\w*_kernel"),
                ("lru_scans", LRU_KERNELS))


def _labelled(fn, label):
    def run(*args, **kw):
        with record_function(label):
            return fn(*args, **kw)
    return run


def phase_train_profile(dev, train: dict) -> None:
    """One train step of phase 7's arch at full width under torch.profiler,
    after one untraced warm-up step of the same state and batch shape:
    kernel time, the port kernels' time by name and each gradient rule's
    device time (under a label put around it for this run), and the
    device's idle share of the traced step and of phase 7's untraced mean
    step. Frees its state after."""
    cfg, opt, arch, mb = train["cfg"], train["opt"], train["arch"], train["microbatches"]
    at_phase(7, "training", f"{arch} profile")
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(1),
                             opt=opt, device=dev)
    step = make_train_step(cfg, opt=opt, microbatches=mb)
    batch = to_device(make_batch(cfg, train["global_batch"], TRAIN["seq_len"],
                                 seed=1, step=0), dev)
    if mb > 1:
        batch = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:]) for k, v in batch.items()}
    step(state, batch)[1]["loss"].item()
    rules = [(mod, name, getattr(mod, name)) for mod, name, _ in RULES]
    for (mod, name, fn), (_, _, label) in zip(rules, RULES):
        setattr(mod, name, _labelled(fn, label))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("train.step"):
                t0 = time.perf_counter()
                step(state, batch)[1]["loss"].item()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in rules:
            setattr(mod, name, fn)
    trace = Trace(prof, ("train.step",) + tuple(label for *_, label in RULES))
    busy_ms = trace.busy_ms()
    shares = {name: trace.matching_ms(pat) for name, pat in PORT_KERNELS}
    shares.update({label: trace.labels[label]["device_ns"] / 1e6 for *_, label in RULES})
    used = {k: v for k, v in shares.items() if v > 0}
    log(f"[profile] {arch} train step ({mb} x {train['global_batch'] // mb} x "
        f"{TRAIN['seq_len']}): kernels busy {busy_ms:.3f} ms; traced wall {wall_ms:.3f} ms "
        f"(device idle {1 - busy_ms / wall_ms:.1%}); untraced mean step (phase 7) "
        f"{train['step_ms']:.3f} ms (device idle {1 - busy_ms / train['step_ms']:.1%}); "
        + ", ".join(f"{k} {v:.3f} ms ({v / busy_ms:.1%})" for k, v in used.items())
        + "; top kernels: " + top_kernels(trace)
        + f" [at {time.perf_counter() - T_START:.1f} s]")
    kinds = set(tfm.layer_kinds(cfg))
    need = {"ssm": ("ssd_fwd", "ssd_rule"), "rglru": ("lru_scans", "lru_rule"),
            **{k: ("flash_fwd", "flash_rule") for k in ATTENTION_KINDS}}
    missing = [n for k in kinds for n in need[k] if n not in used]
    if missing:
        fail(f"the profiled {arch} train step shows no device time for {missing}")
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()


def train_and_profile(dev, arch: str) -> dict:
    """Phase 7 and its profile for one arch."""
    train = phase_train(dev, arch)
    phase_train_profile(dev, train)
    return train


# ------------------------------------------------------------------ runner
# tiny at full width as OAR jobs, the model examples/cluster_train.py
# schedules: the best-effort job takes 12 steps and checkpoints every 4, the
# regular job that preempts it 4 steps.
RUNNER_SPEC = {"kind": "train", "arch": "tiny", "smoke": False, "global_batch": 8,
               "seq_len": 2048, "log_every": 1}
RUNNER_STEPS = {"besteffort": 12, "regular": 4}
RUNNER_JOIN_S = 300.0
# The clone resumes from f32 leaves restored bit for bit and from the
# batches the uninterrupted run sees at those steps; the card may only sum
# in another order. A resume that went wrong (the data from step 0, the
# moments lost) moves the loss by tenths: tiny's loss falls 0.1-0.5 a step.
RUNNER_LOSS_TOL = 1e-4


class JobsTable:
    """What the runner reads of OAR's database: an in-memory sqlite table
    jobs(idJob, state, toCancel) behind ``query_one``. Runner threads query
    it, so one lock serialises the connection; it counts each job's queries
    (one preempt check per step)."""

    def __init__(self):
        self.conn = sqlite3.connect(":memory:", check_same_thread=False)
        self.conn.row_factory = sqlite3.Row
        self.conn.execute("CREATE TABLE jobs (idJob INTEGER PRIMARY KEY, state TEXT, "
                          "toCancel INTEGER)")
        self.lock = threading.Lock()
        self.checks: dict[int, int] = {}

    def query_one(self, sql, args=()):
        with self.lock:
            self.checks[args[0]] = self.checks.get(args[0], 0) + 1
            return self.conn.execute(sql, args).fetchone()

    def running(self, job_id: int) -> None:
        with self.lock:
            self.conn.execute("INSERT INTO jobs VALUES (?, 'Running', 0)", (job_id,))

    def cancel(self, job_id: int) -> int:
        """Sets toCancel=1, as OAR's scheduler does first when a regular job
        needs a best-effort job's resources; returns the job's checks so far,
        read under the same lock."""
        with self.lock:
            self.conn.execute("UPDATE jobs SET toCancel=1 WHERE idJob=?", (job_id,))
            return self.checks.get(job_id, 0)


class Completions:
    """What the runner calls of OAR's executor: records ``complete``."""

    def __init__(self):
        self.calls = []

    def complete(self, job_id, *, ok=True, message=""):
        self.calls.append((job_id, ok, message))


def _join(runner, job_id: int) -> TrainResult:
    runner.threads[job_id].join(RUNNER_JOIN_S)
    if runner.threads[job_id].is_alive():
        fail(f"runner job {job_id} did not end within {RUNNER_JOIN_S} s")
    result = runner.results[job_id]
    if not isinstance(result, TrainResult):
        fail(f"runner job {job_id} failed: {result!r}")
    return result


def _steady_ms(result: TrainResult) -> float:
    """Mean ms of steps after the first, from the loop's cumulative
    sec_per_step at the first and last logged steps (log_every=1)."""
    first, last = result.history[0], result.history[-1]
    n = last["step"] - first["step"] + 1
    return 1e3 * (last["sec_per_step"] * n - first["sec_per_step"]) / (n - 1)


def phase_runner(dev) -> dict:
    """Phase 8: ClusterRunner with OAR's two-step preemption, tiny at full
    width. Jobs 1 (best-effort) and 2 (regular) overlap on the card, as OAR
    launches the regular job as soon as it flags the best-effort one; job 3
    is the clone OAR resubmits, job 4 the same spec run without a break
    (and without checkpoints, which change nothing it computes)."""
    at_phase(8, "runner", "tiny")
    db, done = JobsTable(), Completions()
    runner = ClusterRunner(db, done, device=dev)
    cfg = configs.get("tiny").replace(dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_ckpt_", dir=ROOT) as tmp:
        be = {**RUNNER_SPEC, "steps": RUNNER_STEPS["besteffort"], "ckpt_every": 4,
              "ckpt_dir": f"{tmp}/besteffort"}
        reg = {**RUNNER_SPEC, "steps": RUNNER_STEPS["regular"], "ckpt_dir": f"{tmp}/regular"}
        reset_counts()                        # count the main path's run only
        t0 = time.perf_counter()
        db.running(1)
        runner({**be, "idJob": 1}, ["host0"])
        while not ckpt.list_steps(be["ckpt_dir"]):
            if not runner.threads[1].is_alive() or time.perf_counter() - t0 > RUNNER_JOIN_S:
                fail(f"the best-effort job wrote no checkpoint: {runner.results.get(1)!r}")
            time.sleep(0.005)
        checks = db.cancel(1)
        t_cancel = time.perf_counter()
        db.running(2)
        runner({**reg, "idJob": 2}, ["host0"])
        preempted = _join(runner, 1)
        yield_ms = 1e3 * (time.perf_counter() - t_cancel)
        kept = ckpt.list_steps(be["ckpt_dir"])
        regular = _join(runner, 2)
        db.running(3)
        runner({**be, "idJob": 3}, ["host0"])
        clone = _join(runner, 3)
        db.running(4)
        runner({**be, "ckpt_dir": None, "idJob": 4}, ["host0"])
        whole = _join(runner, 4)
        wall = time.perf_counter() - t0
        launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps_run = preempted.step + regular.step + (clone.step - clone.history[0]["step"]) \
        + whole.step
    expect = {k: n * steps_run for k, n in launches_per_train_step(cfg).items()}
    same = {m["step"]: m["loss"] for m in whole.history}
    loss_err = max(abs(m["loss"] - same[m["step"]]) for m in clone.history)
    log(f"[runner] tiny {RUNNER_SPEC['global_batch']} x {RUNNER_SPEC['seq_len']} via "
        f"ClusterRunner: best-effort job flagged after its first checkpoint, at its "
        f"check {checks}: {preempted.status} at step {preempted.step} "
        f"({preempted.step - checks + 1} step after the flag) in {yield_ms:.3f} ms, "
        f"checkpoints {kept}; regular job beside it: {regular.status} at {regular.step}; "
        f"clone from step {clone.history[0]['step']}: {clone.status} at {clone.step}; "
        f"complete calls {[(j, ok) for j, ok, _ in done.calls]}")
    log(f"[runner] final loss {clone.metrics['loss']:.6f}, uninterrupted "
        f"{whole.metrics['loss']:.6f}, worst |diff| over the clone's steps "
        f"{loss_err:.3e} (tol {RUNNER_LOSS_TOL:g}); ms/step (steps after the first) "
        f"uninterrupted {_steady_ms(whole):.3f}, clone {_steady_ms(clone):.3f}; peak "
        f"{peak / 2**30:.3f} GiB; launches {counts_str(launches)} for {steps_run} steps; wall "
        f"{wall:.3f} s [at {time.perf_counter() - T_START:.1f} s]")
    if preempted.status != "preempted" or preempted.step != checks or kept[-1] != preempted.step:
        fail(f"the best-effort job did not yield within one step with a checkpoint: "
             f"{preempted.status} at {preempted.step} after {checks} checks, kept {kept}")
    want = [(2, True, f"trained to step {RUNNER_STEPS['regular']}")] + [
        (j, True, f"trained to step {RUNNER_STEPS['besteffort']}") for j in (3, 4)]
    if done.calls != want:
        fail(f"complete calls {done.calls}, expected {want}")
    if not 0 < clone.history[0]["step"] == preempted.step:
        fail(f"the clone started at step {clone.history[0]['step']}, not at the checkpoint")
    if not all(math.isfinite(m["loss"]) for m in clone.history + whole.history):
        fail("non-finite loss in the runner's jobs")
    if loss_err > RUNNER_LOSS_TOL:
        fail(f"the resumed clone's losses differ from the uninterrupted run's by {loss_err:.3e}")
    if launches != expect:
        fail(f"the runner's jobs launched {launches}, expected {expect}")
    return {"launches": launches,
            "card": nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")}


# ----------------------------------------------------------------- sharded
# Phase 9: the sharded path on a one-rank group and a 1 x 1 mesh, against
# phases 7 and 5 on the same seeds; then the dry-run of three production
# cells on the meta device under a fake 256-rank group.
SHARDED_TRAIN = ("recurrentgemma-2b", "fsdp")
SHARDED_SERVE = ("granite-8b", "tp2d")
SHARDED_LOSS_REL = 1e-5
# (arch, shape, rules kind, chunked): the last is qwen2.5-14b's train_4k under
# --chunked, the cell whose peak the flash rule set (PERF.md).
DRYRUN_CELLS = (("llama3-405b", "train_4k", None, False),
                ("mixtral-8x22b", "decode_32k", "tp2d", False),
                ("recurrentgemma-2b", "long_500k", None, False),
                ("qwen2.5-14b", "train_4k", None, True))


def phase_sharded(dev, train: dict, serve: dict) -> list:
    """recurrentgemma-2b trained at full width under the fsdp rules (remat
    on) through train_loop on a one-rank nccl group's 1 x 1 DeviceMesh:
    every step's loss within SHARDED_LOSS_REL of phase 7's on the same seed,
    the launches per step equal to phase 7's; granite-8b serving phase 5's 8
    requests through ServeEngine under the tp2d rules: the same greedy
    tokens; then the dry-run's three cells, one line. Returns the two
    sharded runs' launches, (name, cfg, {"launches"}) as the kernels line
    lists its paths."""
    import logging

    import torch.distributed as dist
    # DTensor warns at every two-step redistribution on the dry-run's 2-D mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    arch, rules = SHARDED_TRAIN
    at_phase(9, "sharded", f"{arch} training, {rules}")
    mesh = make_local_mesh(1, dev)
    cfg, run = configs.get(arch), TRAIN_RUNS[arch]
    history = []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                        # count the main path's run only
    t0 = time.perf_counter()
    result = train_loop(cfg, opt=train["opt"], log_every=1, device=dev, mesh=mesh,
                        rules=SHARDING_RULES[rules],
                        on_metrics=lambda step, m: history.append((time.perf_counter(), m)),
                        **run, **TRAIN)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for _, m in history]
    stamps = [t0] + [t for t, _ in history]
    steady = [b - a for a, b in zip(stamps[1:-1], stamps[2:])]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, train["losses"]))
    msg = (f"[sharded] 1 x 1 mesh ({dist.get_backend()}): {arch} {rules}+remat "
           f"{1e3 * statistics.mean(steady):.3f} ms/step (phase 7 {train['step_ms']:.3f}), "
           f"peak {peak:.3f} GiB ({train['peak_gib']:.3f}), loss rel err {worst:.1e} (limit "
           f"{SHARDED_LOSS_REL:g}), launches {counts_str(launches)} (= phase 7's)")
    expect = {k: n * TRAIN["steps"]
              for k, n in launches_per_train_step(cfg, run["microbatches"]).items()}
    if result.status != "done" or len(losses) != TRAIN["steps"]:
        fail(f"{arch} sharded training ended {result.status} at step {result.step}")
    if worst > SHARDED_LOSS_REL:
        fail(f"{msg}: losses {losses} vs {train['losses']}")
    if launches != train["launches"] or launches != expect:
        fail(f"{msg}: launches differ from phase 7's {train['launches']}")
    runs = [(f"{arch} training, {rules} (1 x 1 mesh)", cfg, {"launches": launches})]
    del result, history
    gc.collect()
    torch.cuda.empty_cache()

    arch, rules = SHARDED_SERVE
    at_phase(9, "sharded", f"{arch} serving, {rules}")
    cfg = configs.get(arch)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           M.compute_dtype(cfg), dev)
    engine = ServeEngine(cfg, params, max_batch=4, max_len=1024, device=dev, mesh=mesh,
                         rules=SHARDING_RULES[rules])
    reset_counts()
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=int(n))
            for p, n in zip(serve["prompts"], serve["max_new"])]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    tokens = [engine.requests[r].generated for r in rids]
    same = sum(a == b for a, b in zip(tokens, serve["generated"]))
    msg += (f"; {arch} {rules}: {same}/{len(rids)} token-equal to phase 5, "
            f"{sum(map(len, tokens))} tokens in {wall:.3f} s, {counts_str(launches)} "
            f"(eager; phase 5 graphed {counts_str(serve['launches'])})")
    if same != len(rids) or launches != serve["launches"]:
        fail(msg)
    runs.append((f"{arch} serving, {rules} (1 x 1 mesh)", cfg, {"launches": launches}))
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()

    at_phase(9, "sharded", "dry-run")
    dist.destroy_process_group()          # the dry-run's group is a fake one
    cells, t = [], time.perf_counter()
    for arch, shape, kind, chunked in DRYRUN_CELLS:
        r = dryrun.run_cell(arch, shape, rules_kind=kind, chunked=chunked, verbose=False)
        m = r["memory"]
        cells.append(f"{arch} {shape} {r['rules']} {m['total_gb']:.1f} GiB/dev "
                     f"{'fits' if m['fits'] else 'no fit'} {r['terms']['dominant']} "
                     f"useful {r['useful_ratio']:.3f}")
    log(msg + "; dry-run (meta, 16 x 16 fake ranks, H100 spec): " + "; ".join(cells)
        + f" ({time.perf_counter() - t:.1f} s) [at {time.perf_counter() - T_START:.1f} s]")
    return runs


def card_range(readings: list) -> str:
    """nvidia-smi's 'clocks.sm, power.draw, power.limit, temperature.gpu'
    readings of several runs on one line: each field's range (one value
    when they agree), and the count of runs; the readings as they are when
    one does not parse (nvidia-smi failed, or printed [N/A])."""
    rows = [r.split(", ") for r in readings]
    if not rows or any(len(r) != 4 for r in rows):
        return "; ".join(readings)
    parts = []
    for field in zip(*rows):
        values = [re.fullmatch(r"([\d.]+)( .+)?", v) for v in field]
        if not all(values):
            return "; ".join(readings)
        nums = sorted(float(m.group(1)) for m in values)
        unit = values[0].group(2) or ""
        fmt = "{:.2f}" if "W" in unit else "{:g}"
        lo, hi = fmt.format(nums[0]), fmt.format(nums[-1])
        parts.append((lo if lo == hi else f"{lo}-{hi}") + unit)
    return (f"{parts[0]}, {parts[1]} drawn, limit {parts[2]}, {parts[3]} C "
            f"({len(readings)} runs)")


def significant(x, digits: int = 6):
    """``x`` with every float to ``digits`` significant digits (a time to
    0.1 ns at most), which keeps the kernels line short; ints, strings and
    None unchanged."""
    if isinstance(x, dict):
        return {k: significant(v, digits) for k, v in x.items()}
    if isinstance(x, list):
        return [significant(v, digits) for v in x]
    return float(f"{x:.{digits}g}") if isinstance(x, float) else x


def _measured(x):
    """``x`` without the old design's timings that were not measured (no
    --old-src): keys ``old_*`` whose value is None, at any depth."""
    if isinstance(x, dict):
        return {k: _measured(v) for k, v in x.items()
                if not (k.startswith("old") and v is None)}
    if isinstance(x, list):
        return [_measured(v) for v in x]
    return x


def record(name: str, source: str, replaces: str, rec: dict, paths: dict, **extra) -> dict:
    """One entry of the kernels line: ``launches`` sums the main paths' runs
    (``paths``: {path: launches}), the numbers are ``rec``'s (phase 3); the
    other shapes phase 3 timed are in the build record (``summary``)."""
    return _measured({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": sum(paths.values()), "max_abs_err": rec["max_abs_err"],
                      "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                      "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                      "library_ms": rec["library_ms"], "shape": rec["shape"],
                      "old_design_ms": rec.get("old_ms"), "launches_by_path": paths, **extra})


def dynamic_smem() -> dict:
    """Dynamic shared memory per CTA of the bf16 routes, from the kernels'
    own C functions (ptxas reports static shared memory only)."""
    flash = flash_module._library().repro_flash_attention_smem_bytes
    flash.argtypes, flash.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    ssd = ssd_module._library()
    ssd.repro_ssd_bf16_smem_bytes.argtypes = [ctypes.c_int]
    ssd.repro_ssd_bf16_smem_bytes.restype = ctypes.c_longlong
    ssd.repro_ssd_bf16_state_smem_bytes.restype = ctypes.c_longlong
    bwd = flash_module._bwd_library().repro_flash_attention_bwd_smem_bytes
    decode = decode_module._library().repro_decode_attention_smem_bytes
    return {"decode_attn_kernel<bf16,128,4>": decode(128, 4, 1),"flash_fwd_tc_kernel<128,128>": flash(128, 1),
            "flash_fwd_tc_kernel<256,256>": flash(256, 1),
            "flash_bwd_dkdv_tc_kernel<64,64>": bwd(64, 1),
            "flash_bwd_dkdv_tc_kernel<256,256>": bwd(256, 1),
            "flash_bwd_dkdv_kernel<64,64>": bwd(64, 0),
            "ssd_chunk_tc_kernel": ssd.repro_ssd_bf16_smem_bytes(256),
            "ssd_state_tc_kernel": ssd.repro_ssd_bf16_state_smem_bytes()}


def bwd_kernels(info: dict) -> str:
    """The backward library's kernels by name, each name's HMMA and LDGSTS
    summed: the tensor-core kernels' registers/spill bytes at each head_dim
    (the last template argument), the others' register range and most
    spill bytes."""
    names = {}
    for fn, i in info.items():
        name, _, targs = fn.partition("<")
        names.setdefault(name.removeprefix("flash_bwd_").removesuffix("_kernel"), []).append(
            (targs.rstrip(">").split(",")[-1], i))
    parts = []
    for name, items in names.items():
        if name.endswith("_tc"):
            regs = " ".join(f"{label}:{i['registers']}/{i['spill_bytes']}" for label, i in
                            sorted(items, key=lambda item: int(item[0])))
        else:
            r = sorted(i["registers"] or 0 for _, i in items)
            regs = f"{r[0]}-{r[-1]}/{max(i['spill_bytes'] for _, i in items)}"
        parts.append(f"{name} {regs}, {sum(i.get('hmma', 0) for _, i in items)}, "
                     f"{sum(i.get('ldgsts', 0) for _, i in items)}")
    return "; ".join(parts)


def _old(ms) -> str:
    """The old design's time beside the new one's, when --old-src gave one."""
    return "" if ms is None else f" (old {ms:.4f})"


def summary(built: dict, recs: dict, timings: dict) -> None:
    """The build and the kernels in brief, just before the kernels line (the
    serving, training and runner numbers are on their phases' lines); the
    registers of every kernel and ``timings`` (each kernel's other timed
    shapes and its gradient rule's) go to the build record."""
    log(f"[summary] card {nvidia_smi('name,power.limit')}; build {built['seconds']:.3f} s")
    smem = dynamic_smem()
    detail = build.BUILD_DIR / "chip_smoke_build.json"
    detail.write_text(json.dumps({"info": built["info"], "dynamic_smem": smem,
                                  "timings": timings}, indent=1))
    log(f"[summary] per library (each kernel, and the other timings, in "
        f"{os.path.relpath(detail, ROOT)}): kernels, "
        "registers, spill bytes, HMMA, LDGSTS: " + "; ".join(
            f"{name} {len(k)}, {min(i['registers'] or 0 for i in k.values())}-"
            f"{max(i['registers'] or 0 for i in k.values())}, "
            f"{max(i['spill_bytes'] for i in k.values())}, "
            f"{sum(i.get('hmma', 0) for i in k.values())}, "
            f"{sum(i.get('ldgsts', 0) for i in k.values())}"
            for name, k in built["info"].items() if name != "flash_attention_bwd")
        + "; dynamic shared memory " + ", ".join(f"{fn} {b}" for fn, b in smem.items()))
    log("[summary] flash_attention_bwd by kernel, registers/spill bytes (tensor-core kernels: "
        "at each head_dim), HMMA, LDGSTS: " + bwd_kernels(built["info"]["flash_attention_bwd"]))
    rows = {"flash_attention": recs["flash"].values(), "lru_scan": recs["lru"].values(),
            "ssd_scan": [recs["ssd"]]}
    log("[summary] bf16 kernel ms (old design), share of the bound (causal unless full); "
        "plain, library and bound ms in the kernels line: " + "; ".join(
            f"{name} " + ", ".join(f"{t['shape'][5:].replace(' B=1 ', ' ').replace('causal ', '')} "
                                   f"{t['ms']:.4f}{_old(t['old_ms'])} {t['bound_ms'] / t['ms']:.1%}"
                                   for t in ts) for name, ts in rows.items()))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for S, t in recs["lru"].items():
        L, V, chunk, carry, apply = recs["lru_launch"][S]
        log(f"[summary] lru_scan S={S}: launched L={L}, V={V}, CTAs {chunk}/{carry}/{apply} "
            f"on {sms} SMs; device ms L2 flushed {t['ms']:.4f}{_old(t['old_ms'])}, "
            f"back to back {t['warm_ms']:.4f}{_old(t['old_warm_ms'])}; CUDA events "
            f"{t['events_ms']:.4f}{_old(t['old_events_ms'])}")
    g = recs["ssd_grad"]
    rules = [f"ssd_scan (plain recompute) {g['shape']}: {g['ms']:.4f} | none | "
             f"{g['bound_ms']:.4f} {g['bound_by']}"]

    def short(shape: str) -> str:
        return (shape.replace("float32 ", "f32 ").replace("bfloat16 ", "bf16 ")
                .replace("causal ", "").replace(" window=None", "").replace("window=", "w="))

    rules.append("flash_attention (plain recompute) " + ", ".join(
        f"{short(t['shape'])}: {t['ms']:.4f} | SDPA backward {t['library_ms']:.4f} | "
        f"{t['bound_ms']:.4f} {t['bound_by']}" for t in recs["flash_grad"]))
    rules.append("flash_attention_bwd kernel (attn_chunked), causal, ms (old design) | "
                 "flash_bwd_ref, flash_vjp, SDPA backward | bound: " + ", ".join(
                     f"{short(t['shape'])} {t['ms']:.4f}{_old(t['old_ms'])} | "
                     f"{t['plain_ms']:.4f}, {t['rule_ms']:.4f}, {t['library_ms']:.4f} | "
                     f"{t['bound_ms']:.4f} {t['bound_by']}" for t in recs["flash_bwd"]))
    rules += [f"lru_scan (reversed scan) {t['shape']}: {t['ms']:.4f} (autograd through the "
              f"plain scan {t['plain_ms']:.4f}) | none | {t['bound_ms']:.4f} {t['bound_by']}"
              for t in recs["lru_grad"]]
    log("[summary] gradient rules, ms per call | library | bound: " + "; ".join(rules))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-src", type=Path, default=None,
                    help="a directory with another design's flash_attention.cu, "
                         "flash_attention_bwd.cu, ssd_scan.cu or lru_scan.cu, any of "
                         "them (the C interfaces assumed: flash and its backward as "
                         "now, the SSD's FMA-only repro_ssd_fwd "
                         "with is_bf16, the scan's one-thread-per-channel "
                         "repro_lru_scan(a, b, y, B, S, W, is_bf16, stream)), "
                         "timed in turns beside this one's")
    args = ap.parse_args()
    kind = phase_device()
    dev = torch.device("cuda")
    built = phase_build(args.old_src)
    recs = phase_kernels(dev, built["old"])
    log(f"[time] kernels checked at {time.perf_counter() - T_START:.1f} s")
    phase_model(dev)
    serves = {"granite-8b": serve_and_profile(dev, "granite-8b", max_len=1024,
                                              prompt_range=(100, 340)),
              "recurrentgemma-2b": serve_and_profile(dev, "recurrentgemma-2b", max_len=4096,
                                                     prompt_range=(100, 2500)),
              # request 0 at 2048 tokens: the prefill carries state over 8 chunks
              "mamba2-130m": serve_and_profile(dev, "mamba2-130m", max_len=4096,
                                               prompt_range=(100, 2048)),
              # granite-8b's schedule: 48 flash launches (D=128) a prefill each
              "moonshot-v1-16b-a3b": serve_and_profile(dev, "moonshot-v1-16b-a3b",
                                                       max_len=1024, prompt_range=(100, 340)),
              "qwen2.5-14b": serve_and_profile(dev, "qwen2.5-14b", max_len=1024,
                                               prompt_range=(100, 340)),
              # 256 zero vision embeddings before each prompt: prefills of
              # 356-596 positions, 48 flash launches (G=6, D=128) each
              "internvl2-26b": serve_and_profile(dev, "internvl2-26b", max_len=1024,
                                                 prompt_range=(100, 340)),
              # the encoder over 1024 zero speech frames at each prefill: 72
              # flash launches a prefill, 24 (cross, Sq=1) a decode step
              "seamless-m4t-large-v2": serve_and_profile(dev, "seamless-m4t-large-v2",
                                                         max_len=1024, prompt_range=(100, 340))}
    log(f"[serve] card after each run: {card_range([r['card'] for r in serves.values()])}")
    trains = [train_and_profile(dev, arch) for arch in TRAIN_RUNS]
    chunked, chunked_cards = phase_train_chunked(dev)
    runner = phase_runner(dev)
    log("[train] card after each run: "
        f"{card_range([t['card'] for t in trains + [runner]] + chunked_cards)}")
    sharded = phase_sharded(dev, next(t for t in trains if t["arch"] == SHARDED_TRAIN[0]),
                            serves[SHARDED_SERVE[0]])
    at_phase(10, "summary")

    def paths(kernel):
        """{path: launches} for each main path whose model has a layer of the
        kernel's kind: the launches of every such run, zeros included (the
        mamba2 prefill's plain scan launches no SSD kernel); the backward
        kernel's, the runs with attn_chunked."""
        if kernel == "flash_attention_bwd":
            return {name: r["launches"][kernel] for name, cfg, r in chunked}
        if kernel == "decode_attention":          # the serving runs' decode steps
            runs = [(f"{arch} serving", r["cfg"], r) for arch, r in serves.items()]
            runs += [run for run in sharded if "serving" in run[0]]
            return {name: r["launches"][kernel] for name, cfg, r in runs
                    if set(DECODE_KINDS) & set(tfm.layer_kinds(cfg))}
        kinds = {"flash_attention": set(ATTENTION_KINDS), "lru_scan": {"rglru"},
                 "ssd_scan": {"ssm"}}[kernel]
        runs = [(f"{arch} serving", r["cfg"], r) for arch, r in serves.items()]
        runs += [(f"{t['arch']} training", t["cfg"], t) for t in trains]
        runs += chunked
        runs.append(("tiny via ClusterRunner (4 jobs)", configs.get("tiny"), runner))
        runs += sharded
        return {name: r["launches"][kernel] for name, cfg, r in runs
                if kinds & set(tfm.layer_kinds(cfg))}

    kernels = [
        record("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:79", recs["flash"][FLASH_MAIN],
               paths("flash_attention")),
        record("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
               "none (the gradient of src/repro/kernels/flash_attention/ref.py:55 "
               "attention_chunked, under attn_chunked)", recs["flash_bwd"][0],
               paths("flash_attention_bwd")),
        record("lru_scan", "src/repro_torch/csrc/lru_scan.cu",
               "src/repro/kernels/rglru/kernel.py:49", recs["lru"][2500], paths("lru_scan")),
        record("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd/kernel.py:75", recs["ssd"], paths("ssd_scan"),
               flops=recs["ssd"]["flops"], bytes=recs["ssd"]["bytes"]),
        record("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
               "none (the plain jnp decode attention of src/repro/models/attention.py:113-114)",
               recs["decode"][DECODE_MAIN[0]], paths("decode_attention")),
    ]
    # each kernel's other timed shapes and its gradient rule's timings: in
    # the build record beside the registers, out of the kernels line
    detail = {"flash_attention": {"timings": [t for k, t in recs["flash"].items()
                                              if k != FLASH_MAIN],
                                  "gradient_rule": recs["flash_grad"]},
              "flash_attention_bwd": {"timings": recs["flash_bwd"][1:]},
              "lru_scan": {"timings": [t for S, t in recs["lru"].items() if S != 2500],
                           "gradient_rule": recs["lru_grad"]},
              "ssd_scan": {"gradient_rule": recs["ssd_grad"]},
              "decode_attention": {"timings": [t for k, t in recs["decode"].items()
                                               if k != DECODE_MAIN[0]]},
              # the latent kernel's record: its line in phase 3 has the time and bound
              "mla_decode_attention": {"timings": list(recs["mla_decode"].values())}}
    summary(built, recs, significant(_measured(detail)))
    log(f"[time] total {time.perf_counter() - T_START:.1f} s")
    log(nvidia_smi("name,power.limit"))
    log(json.dumps({"kernels": significant(kernels)}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SystemExit:
        raise                       # fail() has named the phase already
    except BaseException as exc:    # noqa: BLE001 — any cause ends the run, named
        report_exception(exc)
        code = 1
    sys.exit(code)
