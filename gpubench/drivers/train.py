"""Training: the port's train step (``parallel/steps.make_train_step``) on
one train state, as ``train_loop`` runs it on one card.

Set-up makes the state from the seed (the benchmark's weights as f32
masters, zero moments), then drives it through its first three steps with
the window's own call and feed, reading what the check compares: each step's
loss, the first gradient as the optimizer took it (from the moments after
one step) and each parameter's change over the three. The window then runs
steps on the same state until its time is up; each step ends when its loss
is read, which synchronises.
"""

from __future__ import annotations

import gc
import time
from contextlib import nullcontext

import torch

from gpubench import checks, reference, timeline
from gpubench.device import card_line, device_info, profiler, say
from gpubench.traffic import train_tokens
from gpubench.weights import flat, leaf_slices, make_weights

__all__ = ["run", "program_readings", "reference_readings", "CHECK_STEPS"]

CHECK_STEPS = 3
LABELS = ("gpubench.window", "gpubench.train_step")
SSD_OP = "repro_torch::ssd_scan"


def _opt(mix):
    from repro_torch.train.optimizer import OptConfig
    return OptConfig(**mix["optimizer"])


def build(run, device, step_fn=None):
    """The train state on the benchmark's weights, and the port's step."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.parallel.steps import make_train_step
    from repro_torch.train.optimizer import init_opt
    cfg = ModelConfig(**run.config["port"])
    if run.config.get("residual_in_fp32") and cfg.dtype != "float32":
        raise ValueError("the configuration keeps its residual stream in float32 "
                         "(residual_in_fp32); the port keeps it in its activation dtype, "
                         f"{cfg.dtype}")
    ref = reference.load(run.config["reference"])
    params = make_weights(ref.param_layout(run.config), run.seed, torch.float32, device)
    opt = _opt(run.traffic)
    state = {"params": params, "opt": init_opt(params, opt),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    return state, step_fn or make_train_step(cfg, opt=opt)


def program_readings(run, state, step_fn, device) -> dict:
    """The first three steps through ``step_fn``, and what the check reads
    of them."""
    mix, vocab = run.traffic, run.config["port"]["vocab_size"]
    b1 = mix["optimizer"]["b1"]
    out = {"losses": []}
    for s in range(CHECK_STEPS):
        state, m = step_fn(state, {"tokens": train_tokens(mix, run.seed, s, vocab, device)})
        out["losses"].append(float(m["loss"]))
        if s == 0:
            out["grad"] = checks.leaf_norms((n, t / (1 - b1))
                                            for n, t in leaf_slices(state["opt"]["mu"]))
    ref = reference.load(run.config["reference"])
    p0 = make_weights(ref.param_layout(run.config), run.seed, torch.float32, device)
    out["delta"] = checks.leaf_norms((n, a - b) for (n, a), (_, b) in
                                     zip(leaf_slices(state["params"]), leaf_slices(p0)))
    del p0
    return out


def reference_readings(run, device, matmul=None) -> dict:
    """The reference's first three steps from the same weights and batches."""
    from gpubench.reference.adamw import adamw_step
    from gpubench.reference.precision import F32, no_tf32
    no_tf32()
    ref = reference.load(run.config["reference"])
    mix, vocab = run.traffic, run.config["port"]["vocab_size"]
    layout = ref.param_layout(run.config)
    p = make_weights(layout, run.seed, torch.float32, device)
    p0 = [t.clone() for _, t in leaf_slices(p)]
    names = [n for n, _ in flat(p)]
    leaves = [t for _, t in flat(p)]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    out = {"losses": []}
    for s in range(CHECK_STEPS):
        tok = train_tokens(mix, run.seed, s, vocab, device)
        loss, grads = ref.loss_and_grads(p, run.config, tok, rows=mix["check"]["rows"],
                                         matmul=matmul or F32)
        out["losses"].append(loss)
        taken = adamw_step(leaves, [g for _, g in flat(grads)], mu, nu, s, mix["optimizer"])
        if s == 0:
            out["grad"] = checks.leaf_norms(leaf_slices(zip(names, taken)))
        del grads, taken
    out["delta"] = checks.leaf_norms((n, a - b) for (n, a), b in zip(leaf_slices(p), p0))
    return out


def train_window(run, state, step_fn, *, t0: float, device) -> None:
    mix, dev = run.traffic, torch.device(device)
    vocab = run.config["port"]["vocab_size"]
    prof = profiler(dev) if run.trace_on else None
    if prof:
        prof.__enter__()
    from torch.profiler import record_function
    w0 = time.perf_counter()
    w1 = w0 + run.seconds
    step, losses = CHECK_STEPS, []
    with record_function("gpubench.window") if prof else nullcontext():
        now = w0
        while now < w1:
            with record_function("gpubench.train_step") if prof else nullcontext():
                tok = train_tokens(mix, run.seed, step, vocab, dev)
                state, m = step_fn(state, {"tokens": tok})
                losses.append(float(m["loss"]))
            end = time.perf_counter()
            run.steps.append({"start": now, "end": end, "tokens": int(tok.numel())})
            now, step = end, step + 1
    closed = time.perf_counter()
    if prof:
        prof.__exit__(None, None, None)
        run.trace = timeline.Trace(prof.profiler.kineto_results.events(),
                                   ranges=(LABELS[1], SSD_OP), window=LABELS[0])
        run.extra["breakdown"] = {"device_ops": run.trace.top_ops(10),
                                  "idle_gaps": run.trace.idle_by(LABELS, 10)}
    run.window = (w0, closed)
    run.setup_s = w0 - t0
    run.attempted = len(losses)
    run.failed = sum(1 for x in losses if not x == x or x in (float("inf"), float("-inf")))
    say(f"window {run.seconds} s: {len(losses)} steps, losses {losses[0]:.6f} .. "
        f"{losses[-1]:.6f}" if losses else "window: no step")


def run(run, *, t0: float, device, step_fn=None) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        say(f"card: {card_line()}")
    state, step_fn = build(run, dev, step_fn)
    prog = program_readings(run, state, step_fn, dev)
    train_window(run, state, step_fn, t0=t0, device=dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run.memory_peak_bytes = peak
    say(f"setup_s {run.setup_s:.3f}; memory peak {peak} bytes")
    del state, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference_readings(run, dev)
    numbers = checks.train_numbers(prog, ref, run.traffic["check"]["moved_share"])
    run.correct, run.compared = checks.judge(numbers, run.traffic["limits"])
    run.extra["numbers"] = numbers
    say(f"check: program losses {prog['losses']}, reference {ref['losses']}; {numbers}; "
        f"in {time.perf_counter() - t:.1f} s")
    return device_info(dev, peak)
