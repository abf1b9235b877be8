"""The knee of an open-loop serving cell: the highest offered rate the
engine sustains without a growing backlog (not run by the benchmark's own
runs; its result is written into the cell's traffic file as a number):

    python3 gpubench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 2 3 4 ...

One process; the weights are made once and each rate gets a fresh engine,
a pre-roll and a window of ``--seconds``. One JSON line per rate: requests
due and finished in the window, the queue at the window's close and at its
middle, time to first token (p50, p90) and the gap between tokens (p99).
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
sys.path[:] = [str(_HERE.parent), str(_HERE.parent / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != _HERE]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args()
    import torch

    from gpubench.bench import Bench, Run
    from gpubench.drivers import serve
    from gpubench.stats import percentile
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serve.engine import ServeEngine
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    bench = Bench()
    cell = bench.cell(args.workload)
    base = bench.traffic(cell["name"])
    engine = params = None
    for rate in args.rates:
        mix = copy.deepcopy(base)
        mix["arrivals"]["rate"] = rate
        run = Run(cell["name"], bench.config(cell["config"]), mix, args.seed, args.seconds, False)
        if params is None:
            engine, params = serve.build_engine(run, "cuda")
        else:
            engine = ServeEngine(ModelConfig(**run.config["port"]), params,
                                 max_batch=mix["max_batch"], max_len=mix["max_len"],
                                 device="cuda")
        serve.serve_window(run, engine, t0=time.perf_counter(), device="cuda")
        w0, closed = run.window
        due = [r for r in run.requests if w0 <= r["due"] < w0 + run.seconds]
        mid = w0 + run.seconds / 2
        waits = [(r["times"][0] if r["times"] else closed) - r["due"] for r in due]
        gaps = [b - a for r in run.requests for a, b in zip(r["times"], r["times"][1:])
                if w0 <= b <= closed]
        unserved_mid = sum(1 for r in run.requests if r["due"] <= mid and
                           not (r["times"] and r["times"][0] <= mid))
        print(json.dumps({
            "rate": rate, "due": len(due),
            "finished": sum(1 for r in run.requests if r["done"] and r["times"][-1] >= w0),
            "waiting_at_middle": unserved_mid, "queue_at_close": run.extra["queue_left"],
            "ttft_p50_ms": 1e3 * percentile(waits, 50) if waits else None,
            "ttft_p90_ms": 1e3 * percentile(waits, 90) if waits else None,
            "itl_p99_ms": 1e3 * percentile(gaps, 99) if gaps else None,
            "steps": len(run.steps), "card": torch.cuda.get_device_name(0)}), flush=True)
        serve.free_engine(engine)
        engine = None
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
