"""The ranks' side of ``test_torch_sharding.py``: what each of 4 spawned
gloo ranks runs on a 2 x 2 (data, model) mesh, and the one-device runs the
test holds them against. It imports torch and the port only (no JAX), so a
spawned rank starts quickly."""

import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.ssd import ssd_with_state
from repro_torch.models import model as M
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import steps
from repro_torch.parallel.ctx import sharding_ctx
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import train_loop
from repro_torch.train.optimizer import tree_leaves

WORLD = 4
B, S, CKPT_STEPS = 4, 16, 2
# "tiny+chunked": tiny-smoke with the reference's chunked attention
# (attn_chunked, blocks of 8 over S = 16): the flash gradient by the backward
# op on each rank's shards
TRAIN_GROUPS = {"tiny": [("tiny", "baseline"), ("tiny", "fsdp"), ("tiny", "zero"),
                         ("tiny+chunked", "fsdp")],
                "others": [("recurrentgemma-2b", "baseline"), ("mamba2-130m", "fsdp"),
                           ("moonshot-v1-16b-a3b", "baseline")]}
TRAIN_CASES = [c for cases in TRAIN_GROUPS.values() for c in cases]


def smoke(arch):
    if arch.endswith("+chunked"):
        return smoke(arch[:-len("+chunked")]).replace(attn_chunked=True, attn_q_block=8,
                                                      attn_k_block=8)
    return configs.get_smoke(arch).replace(dtype="float32")


def batch(cfg, step):
    return make_batch(cfg, B, S, seed=0, step=step)


def loss_and_grads(cfg, params, b, mesh=None, rules=None):
    """The loss and every gradient (full arrays) of one batch's loss."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    if mesh is None:
        loss = M.loss_fn(params, cfg, b)
        loss.backward()
    else:
        with sharding_ctx(mesh, rules), implicit_replication():
            loss = M.loss_fn(params, cfg, steps.place_batch(b, mesh, rules))
            loss.backward()
    grads = [shd.full(t.grad).detach().numpy() for t in leaves]
    return float(shd.full(loss).detach()), grads


def train_step(cfg, mesh=None, rules=None):
    """One train step from the seeded init: its loss and the updated params."""
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0), mesh=mesh,
                                   rules=rules)
    state, m = steps.make_train_step(cfg, mesh=mesh, rules=rules)(state, batch(cfg, 0))
    return float(m["loss"]), [shd.full(t).detach().numpy()
                              for t in tree_leaves(state["params"])]


def serve(cfg, params, mesh=None, rules=None):
    engine = ServeEngine(cfg, params, max_batch=2, max_len=48, device="cpu", mesh=mesh,
                         rules=rules)
    rng = np.random.default_rng(0)
    for _ in range(4):
        engine.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(3, 12))).tolist(),
                      max_new_tokens=6)
    return [r.generated for r in engine.run()]


# x's placements on the 2 x 2 mesh for the prefill's scan on shards: the
# batch and heads layouts of the SSD rule, and a sequence shard, which the
# rule never keeps (that mesh dim replicates)
SCAN_LAYOUTS = {"batch-heads": (Shard(0), Shard(2)), "heads-batch": (Shard(2), Shard(0)),
                "replicate-heads": (Replicate(), Shard(2)), "seq-heads": (Shard(1), Shard(2))}


def scan_inputs():
    """(x, dt, A, Bm, Cm) of the SSD scan, seeded: B=4, S=22 (ragged against
    chunk 8), H=4, P=8, N=8."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 22, 4, 8))
    dt = rng.uniform(0.01, 0.5, (4, 22, 4))
    A = -rng.uniform(0.5, 2.0, (4,))
    Bm, Cm = rng.standard_normal((2, 4, 22, 8))
    return [torch.from_numpy(t.astype(np.float32)) for t in (x, dt, A, Bm, Cm)]


def scan_on_shards(mesh):
    """ssd_with_state with x placed by each of SCAN_LAYOUTS (the rest
    replicated): y and the final state, gathered."""
    res = {}
    for name, layout in SCAN_LAYOUTS.items():
        x, *rest = scan_inputs()
        args = [shd.place(x, layout, mesh)] + [shd.place(t, (Replicate(),) * 2, mesh)
                                               for t in rest]
        y, state = ssd_with_state(*args, chunk=8)
        res[name] = (shd.full(y).numpy(), shd.full(state).numpy())
    return res


# the decode cache's placements on the 2 x 2 mesh for the decode-attention
# op: those of the op's sharding rule (replicate, batch, heads), and the
# slots, which cache_pspecs picks where the kv heads do not split (the op then
# combines the ranks' outputs by their log-sum-exps)
DECODE_LAYOUTS = {"replicate": (Replicate(), Replicate()), "batch": (Shard(0), Replicate()),
                  "heads": (Replicate(), Shard(2)), "batch-heads": (Shard(0), Shard(2)),
                  "slots": (Replicate(), Shard(1)), "batch-slots": (Shard(0), Shard(1))}
DECODE_WINDOWS = (None, 8)


def decode_inputs():
    """(q, cache_k, cache_v, pos) of the decode attention, seeded: B=4, a
    ring of 24 slots, H=8 over K=2 kv heads, D=16; pos at the ring's start,
    inside it, at its last slot and wrapped past it."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((4, 1, 8, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((4, 24, 2, 16)).astype(np.float32))
            for _ in range(2))
    return q, k, v, torch.tensor([0, 9, 23, 40])


def decode_on_shards(mesh):
    """The op with the cache placed by each of DECODE_LAYOUTS, with and
    without a window (q and pos replicated): the output, gathered, and the
    collectives it ran ({name: count})."""
    from torch.distributed.tensor.debug import CommDebugMode
    res = {}
    for name, layout in DECODE_LAYOUTS.items():
        for window in DECODE_WINDOWS:
            q, k, v, pos = decode_inputs()
            args = [shd.place(q, (Replicate(),) * 2, mesh), shd.place(k, layout, mesh),
                    shd.place(v, layout, mesh), shd.place(pos, (Replicate(),) * 2, mesh)]
            with CommDebugMode() as comm:
                o = decode_attention(*args, window=window)
            res[(name, window)] = (shd.full(o).numpy(),
                                   {str(op): n for op, n in comm.get_comm_counts().items()})
    return res


def _mesh(rank, init_file):
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def _run(rank, init_file, out, body):
    try:
        res = body(_mesh(rank, init_file))
        if rank == 0:
            out.put(("ok", res))
    except Exception:  # noqa: BLE001 — reported to the test, which fails on it
        out.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def train_cases(rank, init_file, tmp, out, cases=TRAIN_CASES):
    """Each train case: loss and gradients, then one train step."""
    def body(mesh):
        res = {}
        for arch, name in cases:
            cfg, rules = smoke(arch), shd.RULES[name]
            params = steps.place_params(M.init_params(cfg, torch.Generator().manual_seed(0)),
                                        cfg, mesh, rules)
            res[(arch, name)] = (*loss_and_grads(cfg, params, batch(cfg, 0), mesh, rules),
                                 *train_step(cfg, mesh, rules))
        return res
    _run(rank, init_file, out, body)


def serve_and_checkpoint(rank, init_file, tmp, out):
    """granite-smoke served under tp2d and mamba2-smoke under baseline; the
    prefill's SSD scan and the decode attention on shards; tiny-smoke
    trained under fsdp by train_loop, checkpointed into ``tmp``/ckpt."""
    def body(mesh):
        cfg = smoke("granite-8b")
        tokens = serve(cfg, M.init_params(cfg, torch.Generator().manual_seed(0)), mesh,
                       shd.RULES["tp2d"])
        m2 = smoke("mamba2-130m")
        m2_tokens = serve(m2, M.init_params(m2, torch.Generator().manual_seed(0)), mesh,
                          shd.RULES["baseline"])
        scans = scan_on_shards(mesh)
        decodes = decode_on_shards(mesh)
        train_loop(smoke("tiny"), steps=CKPT_STEPS, global_batch=B, seq_len=S,
                   ckpt_dir=f"{tmp}/ckpt", log_every=1, device="cpu", mesh=mesh,
                   rules=shd.RULES["fsdp"])
        return {"serve": tokens, "serve_mamba2": m2_tokens, "scan": scans, "decode": decodes}
    _run(rank, init_file, out, body)
