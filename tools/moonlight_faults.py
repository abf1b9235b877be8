"""Plant faults in moonlight-16b-a3b's routed experts and read the served
check of the benchmark's cell on each, to show what that check can see:

    python tools/moonlight_faults.py --seeds <n> [<n> ...] [--scales 0.05 0.1]
        [--requests 6] [--max-new 300]                            (on a card)

For each seed and each scale of the routed experts' output projections (the
reference's ``ROUTED_OUT_SCALE``, the benchmark's weights; default the one it
has), builds the cell's weights from the seed and serves ``--requests``
requests of the cell's traffic (outputs capped at ``--max-new``) through the
port's ``ServeEngine``, once as it is and once under each fault of
``FAULTS``, planted by wrapping a function of ``repro_torch.models.moe`` for
that serve only:

  * ``routed_zero``: the routed experts' outputs are zeros (the shared
    experts stay);
  * ``half_skip``: every other token of a call (rows of a decode step,
    positions of a prefill) gets no routed experts;
  * ``expert_shift``: each chosen expert is replaced by the next one
    (e + 1 mod E), its weight kept.

Each serve's finished requests are sampled and compared with the f32
reference as the cell's check does (``gpubench.checks.sample_finished`` and
``served_gaps``, with the cell's ``check`` numbers); on the fault-free serve's
sample the float8 control is read too. One JSON line per (seed, scale): the
widest served gap of each, the cell's limit, and the tokens sampled.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _faults(moe):
    """{name: (attribute of ``moe``, wrapper of the original)}."""
    def routed_zero(experts):
        return lambda x, offs, *w: experts(x, offs, *w).zero_()

    def half_skip(route):
        def skip(x, router, bias, k, scaling):
            w, sel = route(x, router, bias, k, scaling)
            w = w.clone()
            w[::2] = 0.0
            return w, sel
        return skip

    def expert_shift(route):
        def shift(x, router, bias, k, scaling):
            w, sel = route(x, router, bias, k, scaling)
            return w, (sel + 1) % router.shape[-1]
        return shift
    return {"routed_zero": ("moe_experts", routed_zero),
            "half_skip": ("route_sigmoid", half_skip),
            "expert_shift": ("route_sigmoid", expert_shift)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--scales", type=float, nargs="*", default=None)
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--max-new", type=int, default=300)
    p.add_argument("--cell", default="moonlight-16b-a3b.serve.longchat")
    args = p.parse_args()
    import torch

    from gpubench import checks, reference
    from gpubench.bench import Bench, Run
    from gpubench.reference.precision import FP8, no_tf32
    from gpubench.traffic import make_requests
    from gpubench.weights import make_weights
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe
    from repro_torch.serve.engine import ServeEngine

    no_tf32()
    bench = Bench()
    cell = bench.cell(args.cell)
    dev = torch.device("cuda")
    faults = _faults(moe)
    for seed in args.seeds:
        run = Run(cell["name"], bench.config(cell["config"]), bench.traffic(cell["name"]),
                  seed, 0.0, False)
        ref = reference.load(run.config["reference"])
        cfg, c = ModelConfig(**run.config["port"]), run.traffic["check"]
        reqs = make_requests(run.traffic, args.requests, cfg.vocab_size, seed)
        for scale in args.scales or [ref.ROUTED_OUT_SCALE]:
            t0 = time.perf_counter()
            kept, ref.ROUTED_OUT_SCALE = ref.ROUTED_OUT_SCALE, scale
            try:
                params = make_weights(ref.param_layout(run.config), seed, torch.bfloat16, dev)
            finally:
                ref.ROUTED_OUT_SCALE = kept
            rec = {"seed": seed, "routed_out_scale": scale,
                   "limit": run.traffic["limits"]["served_logit_gap"]}
            for name in ["none", *faults]:
                attr, wrap = faults.get(name, (None, None))
                orig = getattr(moe, attr) if attr else None
                engine = ServeEngine(cfg, params, max_batch=args.requests,
                                     max_len=run.traffic["max_len"], device=dev)
                if attr:
                    setattr(moe, attr, wrap(orig))
                try:
                    rids = [engine.submit(list(r.prompt),
                                          max_new_tokens=min(r.max_new_tokens, args.max_new))
                            for r in reqs]
                    engine.run()
                finally:
                    if attr:
                        setattr(moe, attr, orig)
                done = [{"prompt": list(r.prompt), "generated": list(engine.requests[i].generated)}
                        for r, i in zip(reqs, rids)]
                engine.cache = engine.prefill = engine.decode = None
                del engine
                gc.collect()
                torch.cuda.empty_cache()
                sample = checks.sample_finished(done, seed, c["served_tokens"], c["most_requests"])
                rec[name] = max(checks.served_gaps(ref, params, run.config, sample, dev))
                rec[f"{name}_tokens"] = sum(len(r["generated"]) for r in sample)
                if name == "none":
                    rec["control"] = max(checks.served_gaps(ref, params, run.config, sample, dev,
                                                            control=FP8))
            rec.update(seconds=round(time.perf_counter() - t0, 1),
                       card=torch.cuda.get_device_name(0))
            print(json.dumps(rec), flush=True)
            del params
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
