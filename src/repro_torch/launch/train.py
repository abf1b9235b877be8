"""Training launcher — the end-to-end entry point behind ``--arch <id>``.

On the card, at full published width (bf16 activations over f32 master
params and moments for mamba2-130m and recurrentgemma-2b; tiny is f32):

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --full --steps 6 --global-batch 8 --seq-len 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny \\
        --full --steps 6 --global-batch 8 --seq-len 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --full --steps 6 --global-batch 4 --seq-len 2048 --microbatches 4

On the CPU in float32, as the reference launcher runs off the accelerator
(tiny, the default arch, at its published width, as the reference trains
it; every other arch at its smoke width):

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 6 \\
        --global-batch 4 --seq-len 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --device cpu --steps 6 --global-batch 4 --seq-len 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x22b \\
        --device cpu --steps 6 --global-batch 4 --seq-len 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-26b \\
        --device cpu --steps 6 --global-batch 4 --seq-len 64

Runs on the CUDA card by default; with no card and no ``--device cpu`` it
raises. ``--full`` is the published width; without it tiny still trains its
published config (as in the reference) and every other arch its smoke
config.
``--microbatches`` splits each global batch and averages the gradients.
Re-running with the same ``--ckpt-dir`` resumes from the latest step.

Sharding, with the reference's flags: ``--fsdp`` shards every param's
`embed` dim (and its moments) over the data axis, ``--model-parallel N``
makes the mesh ``(world / N, N)`` over (data, model) with heads, ff, vocab
and experts over `model`. Either flag, or a ``torchrun`` launch, runs the
step on a ``DeviceMesh`` over the world (one rank in a plain process):

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \
        --full --steps 6 --global-batch 4 --seq-len 2048 --microbatches 4 --fsdp
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --device cpu --arch tiny --steps 4 --global-batch 4 --seq-len 64 \
        --model-parallel 2 --fsdp

Without them the step runs on one device, with no process group.
Every arch of the reference trains (internvl2-26b and seamless-m4t-large-v2
with their frontend's embeddings drawn beside the tokens, as the
reference's pipeline draws them).
"""

from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.parallel.sharding import make_rules
from repro_torch.train.loop import TrainResult, train_loop
from repro_torch.train.optimizer import OptConfig


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="tiny", choices=configs.ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="full published config; default is the smoke config "
                         "(tiny always trains its published config)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="split each global batch into this many; gradients averaged")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="size of the mesh's model axis (sharded step)")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard params and moments over the data axis too")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (configs.get(args.arch) if (args.full or args.arch == "tiny")
           else configs.get_smoke(args.arch))
    if device.type == "cpu":
        cfg = cfg.replace(dtype="float32")
    mesh = rules = None
    if args.fsdp or args.model_parallel is not None or "WORLD_SIZE" in os.environ:
        mesh = make_local_mesh(args.model_parallel or 1, device)
        rules = make_rules(multi_pod=False, fsdp=args.fsdp)
    where = "" if mesh is None else \
        f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} fsdp={args.fsdp}"
    print(f"arch={cfg.name} params={cfg.param_count():,} device={device} "
          f"dtype={cfg.dtype}{where}")

    def log(step, m):
        print(f"step {step:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}  {m['sec_per_step']:.3f}s/step")

    result = train_loop(
        cfg, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, seed=args.seed,
        opt=OptConfig(lr=args.lr), microbatches=args.microbatches,
        on_metrics=log, device=device, mesh=mesh, rules=rules)
    print(f"status={result.status} final_step={result.step} "
          f"final_loss={result.metrics.get('loss', float('nan')):.4f}")
    first = result.history[0]["loss"] if result.history else float("nan")
    last = result.metrics.get("loss", float("nan"))
    print(f"loss {first:.4f} -> {last:.4f}")
    if mesh is not None:
        dist.destroy_process_group()        # the group the mesh started or joined
    return result


if __name__ == "__main__":
    main()
