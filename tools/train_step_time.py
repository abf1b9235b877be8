"""Time the port's training step: ms/step and peak memory of one arch
through ``train_loop`` (the entry point the launcher and a cluster job
call), as ``chip_smoke.py``'s phase 7 runs it (6 steps of 2048 tokens a
row, lr 3e-4, seed 0), once for each variant asked for.

    PYTHONPATH=src python tools/train_step_time.py --arch recurrentgemma-2b \\
        --variants remat-off remat-on remat-on+mesh

A variant is ``remat-on`` or ``remat-off``, or ``plain`` for a tree whose
``ModelConfig`` has no ``remat`` field (it never recomputes). ``+mesh``
trains under ``ClusterRunner``'s default rules (``make_rules(multi_pod=
False)``) on a 1 x 1 mesh over a one-rank group, as the runner trains each
job. With ``PYTHONPATH`` set to another tree's ``src`` it times that tree.
Each variant prints one JSON line: ms/step over steps 1-5 (step 0 also pays
the allocator's and cuBLAS's set-up), each step's ms, peak GiB and the
losses. ``--smoke --device cpu`` checks the script at smoke width.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import time

import torch

from repro_torch import configs
from repro_torch.train.loop import train_loop
from repro_torch.train.optimizer import OptConfig

# Per arch: global batch and microbatches, as chip_smoke.py's TRAIN_RUNS.
RUNS = {"mamba2-130m": dict(global_batch=8, microbatches=1),
        "tiny": dict(global_batch=8, microbatches=1),
        "recurrentgemma-2b": dict(global_batch=4, microbatches=4)}
TRAIN = dict(steps=6, seq_len=2048, seed=0)


def _config(arch: str, variant: str, smoke: bool):
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    remat = variant.split("+")[0]
    has_remat = "remat" in {f.name for f in dataclasses.fields(cfg)}
    if remat == "plain":
        if has_remat:
            raise SystemExit("this tree has cfg.remat: ask for remat-on or remat-off")
        return cfg
    if remat not in ("remat-on", "remat-off"):
        raise SystemExit(f"unknown variant {variant!r}")
    if not has_remat:
        raise SystemExit("this tree's configs have no remat field: ask for plain")
    return cfg.replace(remat=remat == "remat-on")


def _mesh_kwargs(device: str) -> dict:
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel.sharding import make_rules
    return {"mesh": make_local_mesh(1, device), "rules": make_rules(multi_pod=False)}


def time_variant(arch: str, variant: str, *, device: str, smoke: bool, seq_len: int) -> dict:
    cfg = _config(arch, variant, smoke)
    extra = _mesh_kwargs(device) if variant.endswith("+mesh") else {}
    cuda = torch.device(device).type == "cuda"
    stamps, losses = [], []

    def on_metrics(step, m):
        stamps.append(time.perf_counter())
        losses.append(m["loss"])

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train_loop(cfg, opt=OptConfig(lr=3e-4), log_every=1, on_metrics=on_metrics,
                        device=device, **RUNS[arch], **{**TRAIN, "seq_len": seq_len}, **extra)
    if cuda:
        torch.cuda.synchronize()
    if result.status != "done" or len(losses) != TRAIN["steps"]:
        raise SystemExit(f"{arch} {variant} ended {result.status} at step {result.step}")
    del result
    step_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
    return {"arch": arch, "variant": variant, "ms_per_step": statistics.mean(step_ms[1:]),
            "step_ms": step_ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
            "losses": losses}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(RUNS), required=True)
    ap.add_argument("--variants", nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    ap.add_argument("--seq-len", type=int, default=TRAIN["seq_len"])
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(json.dumps({"card": card.stdout.strip(), "torch": torch.__version__,
                          "tree": configs.__file__}), flush=True)
    for variant in args.variants:
        print(json.dumps(time_variant(args.arch, variant, device=args.device,
                                      smoke=args.smoke, seq_len=args.seq_len)), flush=True)


if __name__ == "__main__":
    main()
