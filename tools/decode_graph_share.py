"""Run one cell of the benchmark as ``gpubench/run.py`` does and read, from
the serving engine's own spans, how its decode steps ran:

    python3 tools/decode_graph_share.py --workload <cell> --seed <n> [--seconds 51] [--trace 0]

(on a card). Prints the cell's result line, then one JSON object over the
``serve.decode`` spans that start inside the window: their count, the share
that replayed the decode step's CUDA graph (the spans' ``graph`` attribute;
null where the engine records none), the mean span in ms (the engine's decode
step, as ``engine_decode_step_ms.batch`` reads it, here over the whole
window), and over the whole run (set-up included) the decode steps that did
not replay (run eagerly or captured), the requests left queued at the
window's close and the recorder's drops. Besides: the active rows of the
window's steps (mean and median), and in a traced run the traced part's
decode steps, their active rows, and per decode step the latent decode
kernels' device ms and the least ms their work needs (as
``mla_decode_roofline.longchat`` reads them; null without such kernels).
Temporary: a reader of the ``graph`` share under ``gpubench/metrics/`` replaces it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def decode_spans(rec, window: tuple[float, float]) -> list:
    """The ``serve.decode`` spans starting inside ``window`` (host seconds on
    ``time.perf_counter``'s clock, which the spans share in ns)."""
    lo, hi = (int(t * 1e9) for t in window)
    return [s for s in rec.spans if s.name == "serve.decode" and lo <= s.start < hi]


def summary(rec, window: tuple[float, float]) -> dict:
    spans = decode_spans(rec, window)
    graph = [s.attrs["graph"] for s in spans if "graph" in s.attrs]
    run = [s.attrs["graph"] for s in rec.spans if s.name == "serve.decode" and "graph" in s.attrs]
    return {"decode_steps": len(spans),
            "graph_share": sum(graph) / len(graph) if graph else None,
            "decode_ms_mean": (statistics.mean((s.end - s.start) / 1e6 for s in spans)
                               if spans else None),
            "not_replayed_in_run": run.count(0) if run else None, "dropped": rec.dropped}


def rows(run) -> dict:
    """Active rows per step of the window and of its traced part, and the
    latent decode kernels' ms per traced decode step beside their bound."""
    from gpubench.mla_flops import mla_decode_bound_s
    active = [s["active"] for s in run.steps if "active" in s]
    out = {"active_mean": statistics.mean(active) if active else None,
           "active_p50": statistics.median(active) if active else None}
    if run.trace is None:
        return out
    t0 = run.extra["traced"][0]
    traced = [s["active"] for s in run.steps if "active" in s and s["start"] >= t0]
    decodes = [c for c in run.spans.get("decode", []) if c["contexts"]]
    ns = sum(t for name, (_, t) in run.trace.ops.items() if "mla_decode" in name)
    out.update(traced_steps=len(traced), traced_decode_steps=len(decodes),
               traced_active_mean=statistics.mean(traced) if traced else None,
               traced_active_p50=statistics.median(traced) if traced else None)
    if ns and decodes:
        need = sum(mla_decode_bound_s(run.config, c["contexts"]) for c in decodes)
        out.update(mla_ms_per_step=ns / 1e6 / len(decodes),
                   mla_bound_ms_per_step=1e3 * need / len(decodes))
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    import torch

    from gpubench.bench import Bench, Run, result_line
    from repro_torch import obs
    if not torch.cuda.is_available():
        print("decode_graph_share: no CUDA device", file=sys.stderr)
        return 2
    bench = Bench()
    cell = bench.cell(args.workload)
    traffic = bench.traffic(cell["name"])
    run = Run(cell["name"], bench.config(cell["config"]), traffic, args.seed, args.seconds,
              bool(args.trace))
    traffic_kind = importlib.import_module(f"gpubench.drivers.{traffic['driver']}")
    device = traffic_kind.run(run, t0=T0, device="cuda")
    print(json.dumps(result_line(bench, run, device)), flush=True)
    print(json.dumps({"cell": cell["name"], "seed": args.seed, **summary(obs.RECORDER, run.window),
                      "queue_left": run.extra.get("queue_left"), **rows(run)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
