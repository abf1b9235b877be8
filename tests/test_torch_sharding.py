"""The port's sharding (``repro_torch.parallel.sharding``, ``ctx`` and the
sharded steps) against the JAX package's tables, and on real multi-rank
process groups.

Tables, in process: for every arch of the reference plus tiny at its full
config, every rule set of ``RULES`` and the production meshes (16 x 16 and
2 x 16 x 16, duck-typed: the reference's spec functions read only
``mesh.shape``), the port's partition spec of every parameter leaf, every
decode-cache leaf at decode_32k and long_500k, the batch spec and the
divisibility fit equal the reference's, as tuples.

Real groups: 4 gloo ranks, spawned (a process group is process-global, so
none starts in a pytest worker) twice, each rank joined with a timeout and
killed on expiry, on a 2 x 2 (data, model) mesh in float32 (the ranks' code
is ``_torch_sharding_ranks.py``, which imports no JAX): the loss and every
gradient leaf of one step, and one train step (its loss and the params
AdamW leaves), of tiny-smoke under
baseline, fsdp and zero, recurrentgemma-smoke under baseline (one kv head:
the flash rule gathers q's heads), mamba2-smoke under fsdp and
moonshot-smoke under baseline, each against the one-device port (loss
within 1e-5 relative, every gradient leaf within 1e-4 of its scale, the
updated params within 1e-4);
granite-smoke served under tp2d and mamba2-smoke under baseline (greedy
tokens equal); the mamba2 prefill's SSD scan with its final state on each
rank's shards, in the batch and heads layouts and with a sequence shard
(replicated), against the plain scan; the decode attention with its cache
replicated, over the batch, the heads and the ring's slots, against the
plain version; and a checkpoint saved under fsdp on
the four ranks, restored on one device.
"""

import functools
import os
import queue
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro.parallel import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel import steps as tsteps  # noqa: E402

import _torch_sharding_ranks as W  # noqa: E402  (the ranks' side, without JAX)

MESH2 = SimpleNamespace(shape={"data": 16, "model": 16})
# batch_shardings builds NamedShardings, which need a real mesh: the one CPU
# device as 1 x 1 (x 1) (the specs do not depend on the sizes)
_JAX_MESH = Mesh(np.array(jax.devices()).reshape(1, 1, 1), ("pod", "data", "model"))
MESH3 = SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})
ARCHS = jconfigs.ARCHS + ["tiny"]


def _rules_for(mesh):
    """Every rule set the mesh has the axes for."""
    return [n for n in shd.RULES if "pod" in mesh.shape or not n.endswith("_mp")]


def _trimmed(spec) -> tuple:
    """A PartitionSpec as a tuple, trailing Nones dropped (the canonical form)."""
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# ----------------------------------------------------------------- tables
def test_rule_tables_equal_the_reference():
    assert list(shd.RULES) == list(jshd.RULES)
    for name, rules in shd.RULES.items():
        assert rules == {k: tuple(v) for k, v in jshd.RULES[name].items()}, name
        assert shd.batch_pspec(rules) == tuple(jshd.batch_pspec(jshd.RULES[name])), name
        for arch in ("tiny", "internvl2-26b", "seamless-m4t-large-v2"):
            for mb in (1, 4):
                ref = jsteps.batch_shardings(jconfigs.get(arch), _JAX_MESH, jshd.RULES[name],
                                             microbatches=mb)
                got = tsteps.batch_shardings(tconfigs.get(arch), MESH2, rules, microbatches=mb)
                assert got == {k: _trimmed(v.spec) for k, v in ref.items()}, (name, arch, mb)


@pytest.mark.parametrize("mesh", [MESH2, MESH3], ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_the_reference(arch, mesh):
    jspecs = dict(_leaves(JM.param_shapes(jconfigs.get(arch))))
    tspecs = dict(_leaves(TM.param_shapes(tconfigs.get(arch))))
    assert sorted(jspecs) == sorted(tspecs)
    for name in _rules_for(mesh):
        for path, spec in tspecs.items():
            ref = tuple(jshd.spec_to_pspec(jspecs[path], jshd.RULES[name], mesh))
            assert shd.spec_to_pspec(spec, shd.RULES[name], mesh) == ref, (name, path)
            assert shd.spec_to_pspec(spec, shd.RULES[name]) == \
                tuple(jshd.spec_to_pspec(jspecs[path], jshd.RULES[name])), (name, path)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_the_reference(arch, shape):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    s = tconfigs.shape_for(shape)
    jtree = JM.cache_shapes(jcfg, s.global_batch, s.seq_len)
    ttree = TM.cache_shapes(tcfg, s.global_batch, s.seq_len)
    for mesh in (MESH2, MESH3):
        for name in _rules_for(mesh):
            ref = dict(_leaves(jshd.cache_pspecs(jtree, jshd.RULES[name], mesh, jcfg)))
            got = dict(_leaves(shd.cache_pspecs(ttree, shd.RULES[name], mesh, tcfg)))
            assert got == {k: tuple(v) for k, v in ref.items()}, (name, mesh.shape)


def test_fit_pspec_equals_the_reference():
    rng = np.random.default_rng(0)
    entries = [None, "data", "model", ("data", "model"), ("pod", "data"),
               ("pod", "data", "model")]
    for _ in range(400):
        n = int(rng.integers(1, 5))
        pspec = tuple(entries[i] for i in rng.integers(0, len(entries), n))
        used = [a for e in pspec if e for a in (e if isinstance(e, tuple) else (e,))]
        if len(used) != len(set(used)):
            continue                     # a mesh axis shards one dim at most
        shape = tuple(int(x) for x in rng.choice([1, 2, 8, 16, 24, 32, 48, 512], n))
        ref = jsteps._fit_pspec(P(*pspec), shape, MESH3)
        assert tsteps._fit_pspec(pspec, shape, MESH3) == tuple(ref), (pspec, shape)


def test_placements_nest_major_first_and_replicate_one_way_axes():
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 4))
    assert shd.to_placements((("data", "model"),), mesh) == (Shard(0), Shard(0))
    assert shd.to_placements((None, "model"), mesh) == (Replicate(), Shard(1))
    assert shd.to_placements(("data",), SimpleNamespace(
        mesh_dim_names=("data", "model"), shape=(1, 4))) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        shd.to_placements((("model", "data"),), mesh)


# ------------------------------------------------------------ real groups
JOIN_S = 120.0


def _spawn(target, tmp):
    """Run ``target(rank, init_file, tmp, out)`` on WORLD spawned ranks;
    rank 0's result, or the failing rank's traceback as a test failure.
    Each rank is joined with a timeout and killed on expiry."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, str(tmp / "init"), str(tmp), out))
             for r in range(W.WORLD)]
    for p in procs:
        p.start()
    try:
        msg = out.get(timeout=JOIN_S)
    except queue.Empty:
        msg = ("error", None, f"no result within {JOIN_S} s")
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()
    assert msg[0] == "ok", f"rank {msg[1]}:\n{msg[2]}"
    return msg[1]


@pytest.fixture(scope="module")
def train_results(tmp_path_factory):
    """Each group of train cases on its own spawn (its own timeout), run at
    its first case's test."""
    done = {}

    def result(case):
        group = next(g for g, cases in W.TRAIN_GROUPS.items() if case in cases)
        if group not in done:
            done[group] = _spawn(functools.partial(W.train_cases, cases=W.TRAIN_GROUPS[group]),
                                 tmp_path_factory.mktemp(f"gloo_{group}"))
        return done[group][case]
    return result


@pytest.fixture(scope="module")
def serve_ckpt_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_serve")
    return {**_spawn(W.serve_and_checkpoint, tmp), "ckpt": str(tmp / "ckpt")}


@pytest.mark.parametrize("arch,rules", W.TRAIN_CASES)
def test_sharded_train_step_matches_one_device(train_results, arch, rules):
    cfg = W.smoke(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    loss, grads = W.loss_and_grads(cfg, params, W.batch(cfg, 0))
    step_loss, new_params = W.train_step(cfg)
    s_loss, s_grads, s_step_loss, s_params = train_results((arch, rules))
    assert abs(s_loss - loss) <= 1e-5 * abs(loss)
    assert len(s_grads) == len(grads)
    for g, sg in zip(grads, s_grads):
        assert np.abs(sg - g).max() <= 1e-4 * max(np.abs(g).max(), 1e-12)
    assert abs(s_step_loss - step_loss) <= 1e-5 * abs(step_loss)
    for p, sp in zip(new_params, s_params):       # AdamW on the shards
        np.testing.assert_allclose(sp, p, rtol=1e-4, atol=1e-6)


def test_tp2d_serving_matches_one_device(serve_ckpt_results):
    cfg = W.smoke("granite-8b")
    tokens = W.serve(cfg, TM.init_params(cfg, torch.Generator().manual_seed(0)))
    assert serve_ckpt_results["serve"] == tokens


def test_mamba2_serving_matches_one_device(serve_ckpt_results):
    cfg = W.smoke("mamba2-130m")
    tokens = W.serve(cfg, TM.init_params(cfg, torch.Generator().manual_seed(0)))
    assert serve_ckpt_results["serve_mamba2"] == tokens


@pytest.mark.parametrize("layout", list(W.SCAN_LAYOUTS))
def test_prefill_scan_on_shards_matches_plain(serve_ckpt_results, layout):
    from repro_torch.kernels.ssd import ssd_ref
    y, state = ssd_ref(*W.scan_inputs(), chunk=8, return_state=True)
    s_y, s_state = serve_ckpt_results["scan"][layout]
    np.testing.assert_allclose(s_y, y.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s_state, state.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window", W.DECODE_WINDOWS)
@pytest.mark.parametrize("layout", list(W.DECODE_LAYOUTS))
def test_decode_attention_on_shards_matches_plain(serve_ckpt_results, layout, window):
    """The op's rule layouts (replicate, batch, heads) equal the plain
    version bit for bit; a cache sharded over its slots, combined across the
    ranks by the log-sum-exps, within f32 rounding; no layout gathers the
    cache (no all-gather runs)."""
    from repro_torch.kernels.decode_attention import decode_attention_ref
    ref = decode_attention_ref(*W.decode_inputs(), window).numpy()
    out, comm = serve_ckpt_results["decode"][(layout, window)]
    if "slots" in layout:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(out, ref)
        assert not comm
    assert not any("all_gather" in op for op in comm)


def test_fsdp_checkpoint_restores_on_one_device(serve_ckpt_results, tmp_path):
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import train_loop
    from repro_torch.train.optimizer import tree_leaves
    cfg, steps = W.smoke("tiny"), W.CKPT_STEPS
    run = dict(global_batch=W.B, seq_len=W.S, log_every=1, device="cpu")
    state, step = ckpt.restore_latest(serve_ckpt_results["ckpt"],
                                      tsteps.abstract_train_state(cfg))
    assert step == steps
    train_loop(cfg, steps=steps, ckpt_dir=str(tmp_path), **run)
    ref, _ = ckpt.restore_latest(str(tmp_path), tsteps.abstract_train_state(cfg))
    for a, b in zip(tree_leaves(state), tree_leaves(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)
    resumed = train_loop(cfg, steps=steps + 1, ckpt_dir=serve_ckpt_results["ckpt"], **run)
    assert resumed.status == "done" and resumed.history[0]["step"] == steps
    assert os.path.isdir(os.path.join(serve_ckpt_results["ckpt"], f"step_{steps + 1:08d}"))
