"""The serving engine's own spans in one traced run of a cell (not run by the
benchmark's own runs; it gives the readings of the engine metrics that have
no ``BENCHMARK.json`` entry yet, and the breakdowns built on the same spans):

    python3 gpubench/engine_probe.py --workload <cell> --seed <n> [--seconds 51] [--out DIR]
    python3 gpubench/engine_probe.py --cost [--out DIR]

A cell's run is the benchmark's traced run (``--trace 1``). It prints the
result line, then one JSON object: every engine metric of
``ENGINE_METRICS``; how far each mapped engine span starts from the nearest
interval of the harness's range around the same call; the traced part's
idle time split by engine span; and each request's time to first token in
its parts (the harness's submit lateness, then the engine's ``queued``,
``prefill`` and ``hold``) with the largest difference from the harness's
TTFT. ``--cost`` times the recorder on this host (ns per span, and per step
with one admission) and maps ``torch.profiler`` events' starts through it.
With ``--out`` the object, and the spans as a Chrome trace, go to files.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

T0 = time.perf_counter()

ENGINE_METRICS = ("admit_wait_p90_ms.serve", "first_token_hold_p90_ms.serve",
                  "engine_prefill_ms_per_ktok.serve", "engine_decode_step_ms.batch",
                  "decode_idle_ms.batch", "prefill_idle_share.serve")
# engine span -> the harness's range around the same call
PAIRS = (("serve.decode", "gpubench.decode"), ("serve.request.prefill", "gpubench.prefill"))


def agreement(rec, trace) -> dict:
    """Per engine span: the nearest harness interval's start minus the
    mapped span's start, in us (min, median, max) over the traced part."""
    from gpubench.engine_spans import mapped
    out = {}
    for eng, har in PAIRS:
        starts = [a for a, _ in trace.ranges.get(har, {}).get("intervals", [])]
        ds = [min(starts, key=lambda s: abs(s - a)) - a
              for a, _ in mapped(rec, eng, trace.window)] if starts else []
        out[eng] = {"n": len(ds), "us": [min(ds) / 1e3, statistics.median(ds) / 1e3,
                                         max(ds) / 1e3] if ds else None}
    return out


def idle_split(rec, trace) -> dict:
    """The traced part's idle seconds inside the mapped prefill and decode
    spans, the rest of the steps, and outside them."""
    from gpubench.engine_spans import idle_ns, mapped
    gaps = trace.idle_gaps()

    def inside(name):
        return sum(idle_ns(gaps, a, b) for a, b in mapped(rec, name, trace.window)) / 1e9
    prefill, decode, step = (inside(n) for n in
                             ("serve.request.prefill", "serve.decode", "serve.step"))
    idle = sum(b - a for a, b in gaps) / 1e9
    return {"window_s": trace.window_s, "idle_s": idle, "prefill_s": prefill,
            "decode_s": decode, "rest_of_step_s": step - prefill - decode,
            "outside_steps_s": idle - step,
            "prefill_spans": len(mapped(rec, "serve.request.prefill", trace.window)),
            "decode_spans": len(mapped(rec, "serve.decode", trace.window))}


def ttft_parts(rec, run) -> dict:
    """Time to first token in parts, ms at p50 and p90, over the requests
    due before the traced part; and the sum of the parts minus the TTFT
    over every request with a first token and all three spans."""
    from gpubench.engine_spans import by_rid, unprofiled
    from gpubench.stats import percentile
    spans = [by_rid(rec, f"serve.request.{n}") for n in ("queued", "prefill", "hold")]
    lo, hi = unprofiled(run)
    rows, diffs = [], []
    for r in run.requests:
        if not r.get("times") or any(r["rid"] not in s for s in spans):
            continue
        parts = [r["submit"] - r["due"]] + [(s[r["rid"]].end - s[r["rid"]].start) / 1e9
                                            for s in spans]
        ttft = r["times"][0] - r["due"]
        diffs.append(1e3 * (sum(parts) - ttft))
        if lo <= r["due"] < hi:
            rows.append([ttft, *parts])
    names = ("ttft", "late", "queued", "prefill", "hold")
    return {"n": len(rows),
            **({n: [1e3 * percentile([row[k] for row in rows], q) for q in (50, 90)]
                for k, n in enumerate(names)} if rows else {}),
            "sum_minus_ttft_ms": [min(diffs), max(diffs)] if diffs else None,
            "over_1ms": sum(abs(d) > 1.0 for d in diffs), "of": len(diffs)}


def analyse(bench, run, rec) -> dict:
    out = {"metrics": {m: bench.reader(m).read(run) for m in ENGINE_METRICS},
           "spans": len(rec.spans), "dropped": rec.dropped}
    if run.trace is not None:
        out["agree"] = agreement(rec, run.trace)
        out["idle_split"] = idle_split(rec, run.trace)
    if run.requests:
        out["ttft"] = ttft_parts(rec, run)
    return out


def cost(n: int = 100_000) -> dict:
    """The recorder's own cost on this host, and the profiler's clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import obs
    rec, t = obs.Recorder(), obs.now()
    a = time.perf_counter_ns()
    for _ in range(n):
        rec.record("serve.decode", t, t, parent=1, active=64, contexts=100)
    out = {"record_ns": (time.perf_counter_ns() - a) / n}
    rec = obs.Recorder()
    a = time.perf_counter_ns()
    for i in range(n // 5):            # what a step that admits one request records
        rec.anchor()
        sid, t0 = rec.new_id(), obs.now()
        t1 = obs.now()
        rec.record("serve.request.queued", t0, t1, parent=sid, rid=i)
        t2 = obs.now()
        rec.record("serve.request.prefill", t1, t2, parent=sid, rid=i, tokens=1500)
        t3 = obs.now()
        rec.record("serve.decode", t3, obs.now(), parent=sid, active=32, contexts=60000)
        t4 = obs.now()
        rec.record("serve.request.hold", t2, t4, parent=sid, rid=i)
        rec.record("serve.step", t0, t4, span_id=sid, index=i, queue=0, active=31,
                   admitted=1)
    out["step_with_one_admission_ns"] = (time.perf_counter_ns() - a) / (n // 5)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    x, rec, marks = torch.randn(1024, 1024, device=device), obs.Recorder(), []
    with profile(activities=acts) as prof:
        for i in range(30):
            rec.anchor()
            marks.append(obs.now())
            with record_function(f"engine_probe.{i}"):
                x @ x
            time.sleep(0.01)
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("engine_probe.") and e.device_type().name == "CPU"}
    ds = [(starts[f"engine_probe.{i}"] - rec.to_profiler_ns(m)) / 1e3
          for i, m in enumerate(marks)]
    out["profiler_event_minus_mapped_us"] = [min(ds), statistics.median(ds), max(ds)]
    out["torch"] = torch.__version__
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--cost", action="store_true")
    p.add_argument("--out", type=Path)
    args = p.parse_args()
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
    if args.cost:
        res = cost()
        print(json.dumps({"cost": res}), flush=True)
        if args.out:
            (args.out / "cost.json").write_text(json.dumps(res, indent=1))
        if not args.workload:
            return 0
    import importlib

    import torch

    from gpubench.bench import Bench, Run, result_line
    from repro_torch import obs
    if not torch.cuda.is_available():
        print("engine_probe: no CUDA device", file=sys.stderr)
        return 2
    bench = Bench()
    cell = bench.cell(args.workload)
    traffic = bench.traffic(cell["name"])
    run = Run(cell["name"], bench.config(cell["config"]), traffic, args.seed, args.seconds,
              True)
    driver = importlib.import_module(f"gpubench.drivers.{traffic['driver']}")
    print(json.dumps(result_line(bench, run, driver.run(run, t0=T0, device="cuda"))),
          flush=True)
    res = {"cell": cell["name"], "seed": args.seed, **analyse(bench, run, obs.RECORDER)}
    print(json.dumps(res), flush=True)
    if args.out:
        stem = f"{cell['name']}_{args.seed}"
        (args.out / f"{stem}.json").write_text(json.dumps(res, indent=1))
        with open(args.out / f"{stem}.chrome.json", "w") as f:
            json.dump({"traceEvents": obs.RECORDER.chrome_events()}, f)
    return 0


if __name__ == "__main__":
    _HERE = Path(__file__).resolve().parent
    # the script's own directory would shadow the standard library's modules
    sys.path[:] = [str(_HERE.parent), str(_HERE.parent / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != _HERE]
    sys.exit(main())
