"""Serving: the port's ``ServeEngine`` driven by the harness's own loop.

The mix gives ``max_batch`` and ``max_len``, the prompt and output lengths,
and the arrivals: an open loop (``poisson``: requests are submitted when due,
whatever the engine is doing; a pre-roll of ``preroll_s`` seconds of the same
traffic runs before the window, so that it opens in steady state) or an
offline backlog (``backlog``: every request queued before the window, and one
engine step, which fills every slot, in set-up). A request's tokens are
stamped with the time the ``step()`` that produced them returned; its wait is
counted from its due time.

With the trace on, only the window's last quarter runs under the profiler
(``TRACED_SHARE``), and the engine's ``prefill`` and ``decode`` callables are
wrapped there in spans that end in ``torch.cuda.synchronize()``. The
profiler slows the host's dispatch of every step, so a traced open loop runs
nearer its knee than an untraced one: the part before the traced quarter
runs as an untraced run does, and ``run.extra["traced"]`` says where the
traced part began and ended.
"""

from __future__ import annotations

import gc
import math
import time
from collections import deque
from contextlib import nullcontext

import torch

from gpubench import checks, reference, timeline
from gpubench.device import card_line, device_info, profiler, say
from gpubench.stats import percentile
from gpubench.traffic import make_requests
from gpubench.weights import make_weights

__all__ = ["run", "build_engine", "serve_window", "free_engine", "finished", "check"]

LABELS = ("gpubench.window", "gpubench.step", "gpubench.prefill", "gpubench.decode")
FLASH_OP = "repro_torch::flash_attention"
TRACED_SHARE = 0.25     # the share of the window, at its end, that a traced run profiles


def _rf(name, on):
    if not on:
        return None
    from torch.profiler import record_function
    r = record_function(name)
    r.__enter__()
    return r


def _close(r):
    if r is not None:
        r.__exit__(None, None, None)


def build_engine(run, device):
    """The port's engine on the benchmark's weights, and the weights."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serve.engine import ServeEngine
    ref = reference.load(run.config["reference"])
    params = make_weights(ref.param_layout(run.config), run.seed, torch.bfloat16, device)
    cfg = ModelConfig(**run.config["port"])
    mix = run.traffic
    engine = ServeEngine(cfg, params, max_batch=mix["max_batch"], max_len=mix["max_len"],
                         device=device)
    return engine, params


def _warm(engine, mix):
    """A request of each warm-up prompt length, two tokens each, to the end:
    every kernel built and loaded before the traffic starts."""
    for n in mix["warmup_prompts"]:
        engine.submit([1 + i % 97 for i in range(n)], max_new_tokens=2)
    while engine.step() or any(s.active for s in engine.slots):
        pass


def _spans(engine, run, sync):
    """Wrap the engine's prefill and decode in spans; returns an undo."""
    prefill, decode = engine.prefill, engine.decode
    run.spans = {"prefill": [], "decode": []}
    from torch.profiler import record_function

    def timed_prefill(params, batch):
        t = time.perf_counter()
        with record_function("gpubench.prefill"):
            out = prefill(params, batch)
            sync()
        run.spans["prefill"].append({"start": t, "end": time.perf_counter(),
                                     "prompt": int(batch["tokens"].shape[1])})
        return out

    def timed_decode(params, cache, tokens, pos):
        ctx = [s.pos + 1 for s in engine.slots if s.active]
        t = time.perf_counter()
        with record_function("gpubench.decode"):
            out = decode(params, cache, tokens, pos)
            sync()
        run.spans["decode"].append({"start": t, "end": time.perf_counter(), "contexts": ctx})
        return out

    engine.prefill, engine.decode = timed_prefill, timed_decode

    def undo():
        engine.prefill, engine.decode = prefill, decode
    return undo


def serve_window(run, engine, *, t0: float, device) -> None:
    """Set-up's traffic, then the window: fills ``run.requests``,
    ``run.steps``, ``run.window``, ``run.setup_s``, and with the trace on
    ``run.spans`` and ``run.trace``."""
    mix, dev = run.traffic, torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    arrivals = mix["arrivals"]
    backlog = arrivals["kind"] == "backlog"
    preroll = 0.0 if backlog else float(arrivals["preroll_s"])
    n = mix["requests"] if backlog else \
        math.ceil(arrivals["rate"] * (preroll + run.seconds) * 1.25) + mix["block"]
    reqs = make_requests(mix, n, run.config["port"]["vocab_size"], run.seed)
    _warm(engine, mix)
    prof = None
    if run.trace_on:
        with profiler(device):          # the profiler's own start-up, paid in set-up
            engine.submit([1, 2, 3], max_new_tokens=2)
            while engine.step() or any(s.active for s in engine.slots):
                pass
        prof = profiler(device)
    records, inflight = [], {}

    def submit(r, now, t_zero):
        rid = engine.submit(list(r.prompt), max_new_tokens=r.max_new_tokens)
        rec = {"due": t_zero + r.due_s, "submit": now, "prompt": r.prompt,
               "max_new": r.max_new_tokens, "times": [], "first_step_start": None,
               "done": False, "rid": rid}
        records.append(rec)
        inflight[rid] = rec

    def step(now):
        traced = "traced" in run.extra
        with torch.profiler.record_function("gpubench.step") if traced else nullcontext():
            engine.step()
        end = time.perf_counter()
        for rid, rec in list(inflight.items()):
            req = engine.requests[rid]
            k = len(req.generated)
            if k > len(rec["times"]):
                if not rec["times"]:
                    rec["first_step_start"] = now
                rec["times"].extend([end] * (k - len(rec["times"])))
            if req.done:
                rec["done"] = True
                del inflight[rid]
        return end

    if backlog:
        tz = time.perf_counter()
        for r in reqs:
            submit(r, tz, tz)
        step(tz)                        # admits into every slot
        sync()
        w0 = time.perf_counter()
    else:
        tz = time.perf_counter()
        w0 = tz + preroll
    w1 = w0 + run.seconds
    t_trace = w1 - TRACED_SHARE * run.seconds if prof else math.inf
    pending = deque(reqs) if not backlog else deque()
    window_rf, undo, in_window = None, None, False
    while True:
        now = time.perf_counter()
        if not in_window and now >= w0:
            in_window = True
        if in_window and undo is None and now >= t_trace:
            prof.__enter__()
            window_rf = _rf("gpubench.window", True)
            undo = _spans(engine, run, sync)
            run.extra["traced"] = [time.perf_counter(), None]
            say(f"profiler on at {now - w0:.3f} s into the window, "
                f"after {run.extra['traced'][0] - now:.4f} s to start")
        if now >= w1:
            break
        while pending and tz + pending[0].due_s <= now:
            submit(pending.popleft(), now, tz)
        if engine.queue or any(s.active for s in engine.slots):
            end = step(now)
            if in_window:
                run.steps.append({"start": now, "end": end,
                                  "active": sum(s.active for s in engine.slots)})
        else:
            nxt = tz + pending[0].due_s if pending else w1
            time.sleep(max(0.0, min(nxt, w1) - now))
    closed = time.perf_counter()
    if undo:
        sync()
        run.extra["traced"][1] = time.perf_counter()
        _close(window_rf)
        undo()
        prof.__exit__(None, None, None)
        run.trace = timeline.Trace(prof.profiler.kineto_results.events(),
                                   ranges=LABELS[1:] + (FLASH_OP,), window=LABELS[0])
        run.extra["breakdown"] = {"device_ops": run.trace.top_ops(10),
                                  "idle_gaps": run.trace.idle_by(LABELS, 10)}
    run.window = (w0, closed)
    run.setup_s = w0 - t0
    run.requests = records
    run.extra["max_batch"] = mix["max_batch"]
    run.extra["queue_left"] = len(engine.queue)
    due = [r for r in records if w0 <= r["due"] < w1]
    run.attempted = len(due) if not backlog else \
        sum(1 for r in records if any(w0 <= t <= closed for t in r["times"]))
    late = [r["submit"] - r["due"] for r in due]
    waits = [(r["times"][0] if r["times"] else closed) - r["due"] for r in due]
    gaps = [b - a for r in records for a, b in zip(r["times"], r["times"][1:]) if w0 <= b <= closed]
    if waits and gaps:
        say("tails (ms): ttft " + ", ".join(f"p{p} {1e3 * percentile(waits, p):.1f}" for p in (50, 90))
            + f" of {len(waits)}; gaps " + ", ".join(f"p{p} {1e3 * percentile(gaps, p):.1f}"
                                                   for p in (50, 90, 95, 99)) + f" of {len(gaps)}")
    say(f"window {run.seconds} s: {len(run.steps)} steps, {len(records)} requests "
        f"submitted, {len(due)} due in the window, {len(engine.queue)} queued at its close; "
        f"generator lateness p50 {percentile(late, 50) if late else 0:.4f} s, "
        f"max {max(late) if late else 0:.4f} s")


def free_engine(engine) -> None:
    engine.cache = None
    engine.prefill = engine.decode = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def finished(run, engine) -> list[dict]:
    """The requests the engine finished: their prompts and served tokens."""
    return [{"prompt": r["prompt"], "generated": list(engine.requests[r["rid"]].generated)}
            for r in run.requests if r["done"]]


def check(run, params, done, device) -> list[dict]:
    """The reference over a sample of ``done``; sets ``run.correct`` and
    ``run.compared``. Returns the sample."""
    from gpubench.reference.precision import no_tf32
    no_tf32()
    c = run.traffic["check"]
    sample = checks.sample_finished(done, run.seed, c["served_tokens"], c["most_requests"])
    t = time.perf_counter()
    ref = reference.load(run.config["reference"])
    gaps = checks.served_gaps(ref, params, run.config, sample, device)
    numbers = {"served_logit_gap": max(gaps) if gaps else float("nan")}
    run.correct, run.compared = checks.judge(numbers, run.traffic["limits"])
    say(f"check: {len(sample)} requests, {sum(len(s['generated']) for s in sample)} served "
        f"tokens, widest gaps {gaps}, in {time.perf_counter() - t:.1f} s")
    return sample


def run(run, *, t0: float, device, engine_hook=None) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        say(f"card: {card_line()}")
    engine, params = build_engine(run, dev)
    if engine_hook is not None:
        engine_hook(engine)
    serve_window(run, engine, t0=t0, device=dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run.memory_peak_bytes = peak
    say(f"setup_s {run.setup_s:.3f}; memory peak {peak} bytes")
    done = finished(run, engine)
    free_engine(engine)
    del engine
    run.extra["sample"] = check(run, params, done, dev)
    run.extra["params"] = params          # the control's reading (calibrate.py) reuses them
    return device_info(dev, peak)
