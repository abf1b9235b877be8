"""The port's dry-run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.roofline``) on the ``meta`` device under fake process groups,
with the configs' shapes against the JAX package's.

Every test that needs a group starts a fake one in a fixture that destroys
it (a process group is process-global; one left behind by an earlier test
in this worker is destroyed first). The step runs at the reduced depths of
``_with_depth``, so each test stays cheap:

* per-device FLOPs under the ``zero`` rules on a fake 4-rank 2 x 2 mesh are
  a quarter of the one-device FLOPs, to 1 % (the counter counts each op once,
  on the local shards; DTensor's own global-shape propagation is not
  counted);
* the argument bytes are the summed local shards of the inputs, computed
  here from the partition specs;
* llama3-405b x train_4k: the f32 state (params and two moments, 12 B a
  param) per device under fsdp on 16 x 16 is the reference's partition
  specs' local shards: 12 B x param_count() / 256 but for the kv
  projections, which shard 16 ways (8 kv heads on a 16-way model axis),
  22.0 GB, 29.3 GB with the f32 gradients; under baseline above 80 GB;
* a cell runs end to end and writes its report; an unsupported cell is
  skipped with ``cell_supported``'s reason; the report table lists both;
* collectives traced through ``CommDebugMode`` carry kind, bytes and group
  size, with the reference's ring factors.
"""

import json
import math

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import HW, make_production_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.roofline import analysis, report  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402


def _destroy():
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def fake4():
    """A fake 4-rank group and its 2 x 2 (data, model) mesh."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _destroy()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    _destroy()


@pytest.fixture
def pod():
    """The production 16 x 16 mesh over a fake 256-rank group."""
    _destroy()
    yield make_production_mesh(multi_pod=False)
    _destroy()


SMALL_TRAIN = tconfigs.ShapeConfig("small_train", 256, 8, "train")


def test_shapes_and_cell_support_equal_the_reference():
    assert {k: (s.seq_len, s.global_batch, s.kind) for k, s in tconfigs.SHAPES.items()} == \
        {k: (s.seq_len, s.global_batch, s.kind) for k, s in jconfigs.SHAPES.items()}
    for arch in jconfigs.ARCHS:
        tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
        assert tcfg.remat is jcfg.remat is True
        assert tcfg.sub_quadratic == jcfg.sub_quadratic, arch
        for name in tconfigs.SHAPES:
            assert tconfigs.cell_supported(tcfg, tconfigs.shape_for(name)) == \
                jconfigs.cell_supported(jcfg, jconfigs.shape_for(name)), (arch, name)


def test_per_device_flops_are_a_quarter_under_zero(fake4):
    cfg = dryrun._with_depth(tconfigs.get("tiny"), 1)
    one = dryrun.measure(cfg, SMALL_TRAIN, None, None)
    four = dryrun.measure(cfg, SMALL_TRAIN, fake4, shd.RULES["zero"])
    assert one["flops"] > 1e10 and one["wire_bytes"] == 0
    assert abs(4 * four["flops"] / one["flops"] - 1) <= 0.01
    assert four["wire_bytes"] > 0 and "all-gather" in four["collectives"]


def test_argument_bytes_are_the_summed_local_shards(fake4):
    cfg = dryrun._with_depth(tconfigs.get("granite-8b"), 1)
    rules = shd.RULES["fsdp"]
    sizes = shd.mesh_sizes(fake4)

    def local(shape, pspec):
        n = 1
        for d, e in zip(shape, list(pspec) + [None] * (len(shape) - len(pspec))):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= d // math.prod(sizes[a] for a in axes)
        return n

    specs = [s for _, s in _spec_leaves(TM.param_shapes(cfg))]
    per_param = sum(local(s.shape, shd.spec_to_pspec(s, rules, fake4)) for s in specs)
    batch = (SMALL_TRAIN.global_batch // 2) * SMALL_TRAIN.seq_len * 8    # int64 tokens
    expect = 3 * 4 * per_param + 4 + batch          # params, mu, nu in f32; step
    got = dryrun.measure(cfg, SMALL_TRAIN, fake4, rules)["arg_bytes"]
    assert got == expect


def _spec_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_llama3_405b_state_per_device(pod):
    """The f32 state's local shards under fsdp equal 12 B a param over the
    reference's own partition specs of every leaf; that is 12 B x
    param_count() / 256 but for the kv projections, whose 8 kv heads do not
    split 16 ways and so shard over the data axis only (4.2 B of the 405.9 B
    params): 22.0 GB of state, 29.3 GB with the f32 gradients, under 80 GB;
    above 80 GB under baseline."""
    from types import SimpleNamespace

    from repro.models import model as JM
    from repro.parallel import sharding as jshd
    cfg, shape = tconfigs.get("llama3-405b"), tconfigs.shape_for("train_4k")
    duck = SimpleNamespace(shape={"data": 16, "model": 16})
    expect = 0
    for _, spec in _spec_leaves(JM.param_shapes(jconfigs.get("llama3-405b"))):
        pspec = tuple(jshd.spec_to_pspec(spec, jshd.RULES["fsdp"], duck))
        ways = math.prod(16 for e in pspec if e is not None
                         for _ in (e if isinstance(e, tuple) else (e,)))
        expect += 12 * math.prod(spec.shape) // ways
    fsdp, _ = dryrun.input_specs(cfg, shape, pod, shd.RULES["fsdp"])
    state = sum(t.to_local().nbytes for t in tree_leaves(fsdp))
    grads = sum(t.to_local().nbytes for t in tree_leaves(fsdp["params"]))   # f32, same layout
    assert state == expect + 4                      # + the step counter
    n = cfg.param_count()
    kv = 2 * cfg.num_layers * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
    assert abs(state / (12 * (n - kv) / 256 + 12 * kv / 16) - 1) <= 0.01
    assert 29e9 < state + grads < HW["hbm_bytes"]
    base, _ = dryrun.input_specs(cfg, shape, pod, shd.RULES["baseline"])
    assert sum(t.to_local().nbytes for t in tree_leaves(base)) > HW["hbm_bytes"]


def test_cells_run_report_and_skip(pod, tmp_path):
    out = dryrun.run_cell("mamba2-130m", "long_500k", out_dir=str(tmp_path), verbose=False)
    assert not out["skipped"] and out["rules"] == "baseline" and out["devices"] == 256
    assert out["memory"]["fits"] and out["flops_per_dev"] > 0
    assert out["terms"]["dominant"] in ("compute", "memory", "collective")
    skip = dryrun.run_cell("granite-8b", "long_500k", out_dir=str(tmp_path), verbose=False)
    why = tconfigs.cell_supported(tconfigs.get("granite-8b"), tconfigs.shape_for("long_500k"))
    assert skip["skipped"] == why[1] != ""
    with open(tmp_path / "mamba2-130m__long_500k__pod16x16__baseline.json") as f:
        assert json.load(f)["arch"] == "mamba2-130m"
    assert (tmp_path / "granite-8b__long_500k__pod16x16.json").exists()
    table = report.table(report.load(str(tmp_path), "pod16x16"))
    assert "| mamba2-130m | long_500k | baseline |" in table
    assert "- granite-8b × long_500k: full-attention arch" in table


def test_collectives_are_traced_with_ring_factors(fake4):
    x = shd.placed_zeros((8, 64), torch.float32, (Shard(0), Replicate()), fake4, "meta")
    mode = analysis.CostMode()
    with mode:
        y = x.redistribute(fake4, (Replicate(), Replicate()))
    assert isinstance(y, DTensor)
    ops = analysis.parse_collectives(mode)
    assert [(o.kind, o.result_bytes, o.group_size) for o in ops] == [("all-gather", 8 * 64 * 4, 2)]
    assert ops[0].wire_bytes == 8 * 64 * 4 * janalysis._wire_factor("all-gather", 2)
    assert mode.get_total_counts() == 1
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "permute"):
        for g in (1, 2, 16):
            assert analysis._wire_factor(kind, g) == janalysis._wire_factor(kind, g)
    terms = analysis.roofline_terms(HW["peak_flops_bf16"], HW["hbm_bw"], 2 * HW["link_bw"])
    assert (terms["compute_s"], terms["memory_s"], terms["collective_s"]) == (1.0, 1.0, 2.0)
    assert terms["dominant"] == "collective"


def test_chunked_drops_the_scores_and_counts_the_backward_op(pod):
    """tiny x train_4k at depth 1 on 16 x 16 (16 rows of 4096 a card; 8 q
    heads do not split 16 ways, so every card holds all 8), with a 1,024-word
    vocabulary so that the loss's f32 logits (16 x 4096 x V) do not set the
    peak: under --chunked the flash gradient is the backward op, whose fake
    implementation holds no (S, S) scores, so the peak of live storages
    falls by at least one layer's local B x H x S x S f32 scores; the
    backward op's FLOPs are 2.5x the forward op's; a cell's rules carry the
    reference's ``_chunked`` suffix."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import ops as flash_ops
    shape = tconfigs.shape_for("train_4k")
    cfg = dryrun._with_depth(tconfigs.get("tiny").replace(vocab_size=1024), 1)
    rules = shd.make_rules(multi_pod=False)
    peak = {flag: dryrun.measure(cfg.replace(attn_chunked=flag), shape, pod, rules)["temp_bytes"]
            for flag in (False, True)}
    B, S, H = shape.global_batch // 16, shape.seq_len, cfg.num_heads
    assert peak[False] - peak[True] >= B * H * S * S * 4
    q = torch.empty((B, S, H, cfg.head_dim), device="meta")
    kv = torch.empty((B, S, cfg.num_kv_heads, cfg.head_dim), device="meta")
    with FlopCounterMode(display=False) as fwd:
        o = flash_ops._flash_op(q, kv, kv, True, 0, True, 1024, 1024)
    with FlopCounterMode(display=False) as bwd:
        flash_ops._flash_bwd_op(o, q, kv, kv, o, True, 0, 1024, 1024)
    assert fwd.get_total_flops() > 0
    assert bwd.get_total_flops() == 2.5 * fwd.get_total_flops()
    out = dryrun.run_cell("mamba2-130m", "long_500k", chunked=True, verbose=False)
    assert out["rules"] == "baseline_chunked"


def test_cost_mode_names_what_holds_the_peak():
    """With ``peak_top`` the mode keeps the op at which the peak rose last
    and the largest storages live then, each with the op that made it; a
    storage freed before the peak is not among them."""
    mode = analysis.CostMode(peak_top=2)
    with mode:
        a = torch.empty((1024,), device="meta")
        gone = torch.empty((3000,), device="meta", dtype=torch.bfloat16)
        del gone
        b = torch.zeros((4096,), device="meta")
        c = torch.empty((8,), device="meta")
    op, nbytes, live = mode.at_peak
    assert nbytes == mode.peak_bytes == 4 * (1024 + 4096 + 8)
    assert op == "empty"
    assert live == [(4 * 4096, ("zeros", (4096,), "float32")),
                    (4 * 1024, ("empty", (1024,), "float32"))]
    assert analysis.CostMode().at_peak is None
    del a, b, c
