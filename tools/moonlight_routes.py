"""Count the served tokens whose expert choice differs between the program
(bf16, the port) and the plain f32 reference, on moonlight-16b-a3b at its
published widths:

    python tools/moonlight_routes.py --seed <n> [--requests 8]     (on a card)

Builds the engine as the benchmark's cell does (``gpubench``'s weights from
the seed), serves ``--requests`` requests of the cell's traffic to the end,
samples the finished ones as the cell's check does, then runs each sampled
sequence (prompt and served tokens) once through the port's prefill and
once through the reference, recording every MoE layer's top-k choice per
position. Prints one JSON line: positions and served positions compared,
and for each how many differ in any layer, and (position, layer) pairs that
differ. The port's choices are read from its prefill over the whole
sequence, the served tokens' positions included (decode steps route the same
rows one at a time).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--cell", default="moonlight-16b-a3b.serve.longchat")
    args = p.parse_args()
    import torch

    from gpubench import checks, reference
    from gpubench.bench import Bench, Run
    from gpubench.drivers import serve
    from gpubench.reference.precision import no_tf32
    from gpubench.traffic import make_requests
    from repro_torch.models import model as M
    from repro_torch.models import moe

    no_tf32()
    bench = Bench()
    cell = bench.cell(args.cell)
    run = Run(cell["name"], bench.config(cell["config"]), bench.traffic(cell["name"]),
              args.seed, 0.0, False)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    engine, params = serve.build_engine(run, dev)
    cfg = engine.cfg
    reqs = make_requests(run.traffic, args.requests, cfg.vocab_size, args.seed)
    rids = [engine.submit(list(r.prompt), max_new_tokens=r.max_new_tokens) for r in reqs]
    engine.run()
    done = [{"prompt": list(r.prompt), "generated": list(engine.requests[i].generated)}
            for r, i in zip(reqs, rids)]
    serve.free_engine(engine)
    c = run.traffic["check"]
    sample = checks.sample_finished(done, args.seed, c["served_tokens"], c["most_requests"])
    ref = reference.load(run.config["reference"])
    totals = dict(positions=0, positions_differ=0, pairs_differ=0, served=0, served_differ=0,
                  served_pairs_differ=0, layers=0)
    for r in sample:
        seq = torch.tensor(r["prompt"] + r["generated"][:-1], dtype=torch.long, device=dev)
        first = len(r["prompt"]) - 1
        ours, route = [], moe.route_sigmoid

        def recording(x, router, bias, kk, scaling):
            out = route(x, router, bias, kk, scaling)
            ours.append(out[1])
            return out
        moe.route_sigmoid = recording
        try:
            with torch.inference_mode():
                M.prefill(params, cfg, {"tokens": seq[None]}, seq.numel())
        finally:
            moe.route_sigmoid = route
        theirs = []
        ref.logits(params, run.config, seq, start=seq.numel() - 1, routes=theirs)
        a = torch.stack([s.sort(-1).values for s in ours])             # (layers, S, k)
        b = torch.stack([s.sort(-1).values for s in theirs])
        differ = (a != b).any(-1)                                      # (layers, S)
        any_layer = differ.any(0)
        totals["layers"] = a.shape[0]
        totals["positions"] += seq.numel()
        totals["positions_differ"] += int(any_layer.sum())
        totals["pairs_differ"] += int(differ.sum())
        totals["served"] += seq.numel() - first
        totals["served_differ"] += int(any_layer[first:].sum())
        totals["served_pairs_differ"] += int(differ[:, first:].sum())
    totals.update(seed=args.seed, sampled_requests=len(sample), seconds=time.perf_counter() - t0,
                  card=torch.cuda.get_device_name(0))
    print(json.dumps(totals), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
