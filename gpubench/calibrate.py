"""Readings that set a cell's limits (not run by the benchmark's own runs):

    python3 gpubench/calibrate.py --workload <cell> --seconds <s> --seeds <n> ...

For every seed it runs the cell as a run does and prints the numbers the
check compares; then, on the same seed, the control: the plain reference put
in the program's place in float8 (e4m3, scaled per row and per tensor), the
step below the configurations' bfloat16. A serving cell reads the control
on the sample the run checked, at the token the control puts first; a
training cell also reads the fault of half the batch left out (the mean
taken over the rest). One JSON line per seed on standard output and in
``chiprun_out/calibrate.<cell>.jsonl`` when that directory exists.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
sys.path[:] = [str(_HERE.parent), str(_HERE.parent / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != _HERE]


def _serve(run, dev):
    from gpubench import checks, reference
    from gpubench.drivers import serve
    from gpubench.reference.precision import FP8
    serve.run(run, t0=time.perf_counter(), device=dev)
    ref = reference.load(run.config["reference"])
    control = checks.served_gaps(ref, run.extra.pop("params"), run.config,
                                 run.extra["sample"], dev, control=FP8)
    return {"program": {k: c["value"] for k, c in run.compared.items()},
            "control": {"served_logit_gap": max(control)}}


def _train(run, dev, faults: bool):
    import gc

    import torch

    from gpubench import checks
    from gpubench.drivers import train
    from gpubench.reference.precision import FP8
    share = run.traffic["check"]["moved_share"]
    state, step_fn = train.build(run, dev)
    prog = train.program_readings(run, state, step_fn, dev)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    ref = train.reference_readings(run, dev)
    out = {"program": checks.train_numbers(prog, ref, share), "losses": prog["losses"],
           "reference_losses": ref["losses"]}
    out["control"] = checks.train_numbers(train.reference_readings(run, dev, matmul=FP8),
                                          ref, share)
    if faults:
        gc.collect()
        torch.cuda.empty_cache()
        half = run.traffic["rows"] // 2

        def half_batch(state, batch):
            return step_fn(state, {"tokens": batch["tokens"][:half]})
        state, _ = train.build(run, dev, step_fn)
        out["half_batch"] = checks.train_numbers(
            train.program_readings(run, state, half_batch, dev), ref, share)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", action="store_true")
    args = p.parse_args()
    import torch

    from gpubench.bench import Bench, Run, forbidden_modules
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = Bench()
    cell = bench.cell(args.workload)
    out_dir = _HERE.parent / "chiprun_out"
    sink = (out_dir / f"calibrate.{args.workload}.jsonl").open("a") if out_dir.is_dir() else None
    for seed in args.seeds:
        run = Run(cell["name"], bench.config(cell["config"]), bench.traffic(cell["name"]),
                  seed, args.seconds, False)
        t = time.perf_counter()
        if run.traffic["driver"] == "serve":
            rec = _serve(run, "cuda")
        else:
            rec = _train(run, "cuda", args.faults)
        rec.update(seed=seed, seconds=time.perf_counter() - t,
                   card=torch.cuda.get_device_name(0))
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        del run
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    if forbidden_modules():
        print(f"calibrate: loaded {forbidden_modules()}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
