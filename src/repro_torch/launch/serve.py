"""Serving launcher — continuous batching over a persistent KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --full --requests 12 --max-batch 4 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --full --max-len 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --full
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch moonshot-v1-16b-a3b --full --max-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch moonlight-16b-a3b --full --max-len 8192 --max-batch 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b \\
        --full --max-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch seamless-m4t-large-v2 --full --max-len 1024

Runs on the CUDA card by default, with weights made on the card from
``--seed`` in the config's dtype (bf16 for the served archs; ``--full`` is
the published width, otherwise the smoke width). One card holds
moonshot-v1-16b-a3b (52.3 GiB of bf16 weights), moonlight-16b-a3b (29.8
GiB; its latent cache is 31,104 bytes a token), qwen2.5-14b and
mistral-nemo-12b at full width, and internvl2-26b (37.0 GiB; each prompt
follows 256 zero vision embeddings, so give it ``--max-len`` room for them)
and seamless-m4t-large-v2 (its encoder runs over 1024 zero speech-frame
embeddings at each prefill); mixtral-8x22b and llama3-405b do not fit one
card at full width and serve at smoke width here (the dry-run,
``repro_torch.launch.dryrun``, sizes them on the production meshes).
``--device cpu`` serves on the CPU in float32, as the reference launcher
does off the accelerator. With no card and no ``--device cpu`` it raises.

``--tp2d`` serves with the reference's serving rules (resident weights,
heads and vocab over the `model` axis, the `ff` dim 2-D over data and
model, the cache by ``cache_pspecs``) on a ``DeviceMesh`` over the world
(one rank in a plain process); under ``torchrun`` the mesh spans the world
with or without it (the baseline rules without):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --full --tp2d

It prints what the engine recorded (:mod:`repro_torch.obs`): the requests,
their queue wait, prefill time per 1,000 prompt tokens, the mean decode step
and the mean queue length at a step's start. ``--trace-out PATH`` writes the
engine's spans as a Chrome trace (JSON), on the clock of ``torch.profiler``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, obs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as M
from repro_torch.parallel.sharding import make_rules
from repro_torch.serve.engine import ServeEngine


def summary(spans) -> str:
    """One line over the engine's spans (:mod:`repro_torch.serve.engine`)."""
    def dur(name):
        return [(s.end - s.start) / 1e6 for s in spans if s.name == name]
    waits, decode = dur("serve.request.queued"), dur("serve.decode")
    prefill = [s for s in spans if s.name == "serve.request.prefill"]
    queue = [s.attrs["queue"] for s in spans if s.name == "serve.step"]
    tokens = sum(s.attrs["tokens"] for s in prefill)
    line = [f"requests {len(waits)}"]
    if waits:
        p50, p90 = np.percentile(waits, [50, 90])
        line.append(f"queue wait p50 {p50:.1f} ms, p90 {p90:.1f} ms")
    if tokens:
        ms = sum(s.end - s.start for s in prefill) / 1e6
        line.append(f"prefill {1e3 * ms / tokens:.1f} ms per 1,000 prompt tokens")
    if decode:
        line.append(f"decode step {np.mean(decode):.1f} ms")
    if queue:
        line.append(f"queue {np.mean(queue):.2f} at a step's start")
    return "; ".join(line)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="granite-8b", choices=configs.ARCHS)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp2d", action="store_true",
                    help="serving rule set (resident 2-D-sharded weights)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--trace-out", metavar="PATH",
                    help="write the engine's spans as a Chrome trace (JSON)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch) if args.full else configs.get_smoke(args.arch)
    if device.type == "cpu":
        cfg = cfg.replace(dtype="float32")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, gen, M.compute_dtype(cfg), device)
    mesh = rules = None
    if args.tp2d or "WORLD_SIZE" in os.environ:
        mesh = make_local_mesh(1, device)
        rules = make_rules(multi_pod=False, tp2d=args.tp2d)
    engine = ServeEngine(cfg, params, max_batch=args.max_batch,
                         max_len=args.max_len, device=device, mesh=mesh, rules=rules)

    rng = np.random.default_rng(args.seed)
    since = obs.now()
    for _ in range(args.requests):
        plen = int(rng.integers(4, args.max_len // 3))
        engine.submit(rng.integers(0, cfg.vocab_size, plen).tolist(),
                      max_new_tokens=int(rng.integers(2, args.max_new)))
    done = engine.run()
    total = sum(len(r.generated) for r in done)
    print(f"arch={cfg.name} device={device} served {len(done)} requests, "
          f"{total} tokens in {engine.steps_run} steps")
    print(summary([s for s in obs.RECORDER.spans if s.start >= since]))
    print(f"slot efficiency {total / (engine.steps_run * args.max_batch):.1%}")
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            json.dump({"traceEvents": obs.RECORDER.chrome_events()}, f)
    if mesh is not None:
        dist.destroy_process_group()        # the group the mesh started or joined
    return done


if __name__ == "__main__":
    main()
