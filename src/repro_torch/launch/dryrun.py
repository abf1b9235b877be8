"""Multi-pod dry-run on the ``meta`` device (port of ``repro.launch.dryrun``):
every (architecture × input shape) against the reference's production
meshes, with no allocation and no collective actually run.

Per cell this script:
  1. builds the mesh ((16, 16) or (2, 16, 16)) over a fake process group of
     256 or 512 ranks (:func:`repro_torch.launch.mesh.make_production_mesh`),
  2. builds the cell's inputs as meta DTensors placed by the rule set
     (``DTensor.from_local`` of meta shards: nothing allocated),
  3. runs the cell's step once, as rank 0 of the mesh —
       train_4k      → train_step (forward, backward with remat, AdamW),
       prefill_32k   → prefill_step (prompt pass building the decode cache),
       decode_*      → serve_step (one token over the persistent cache),
     which proves the sharding rules carry the whole step (every op has a
     DTensor rule or runs on shards), under
     :class:`repro_torch.roofline.CostMode`, which counts per device the
     FLOPs, bytes moved and collectives of the local ops and the peak of the
     storages they hold,
  4. reports the argument bytes (the inputs' local shards, at full depth),
     the temporary bytes, the FLOPs, bytes and collective wire bytes by kind,
     the roofline terms on an H100 (spec numbers), the dominant term,
     ``useful_ratio`` and whether the cell fits in 80 GB; and writes the
     report JSON for ``repro_torch.roofline.report``.

The step is run at two reduced depths (``_depth_pair``) and extrapolated
linearly to the full depth, as the reference does (there, because XLA's
cost analysis counts a scan body once; here, so each cell stays cheap: the
per-layer cost is exact, and every layer of a kind costs the same). The
temporary bytes are extrapolated alike. ``--no-extrapolate`` runs the full
depth once instead.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --chunked
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi   # 512 ranks
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import sys
import time
import traceback

import torch
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import steps as steps_mod
from repro_torch.roofline.analysis import CostMode, cell_report, parse_collectives
from repro_torch.train.optimizer import OptConfig, tree_leaves, tree_map

__all__ = ["ARCHS", "FSDP_REQUIRED", "input_specs", "measure", "extrapolated_costs",
           "run_cell", "main"]

# The reference's architectures, in its order (tiny is a demo, not a cell).
ARCHS = ["mamba2-130m", "granite-8b", "qwen2.5-14b", "mistral-nemo-12b", "llama3-405b",
         "recurrentgemma-2b", "internvl2-26b", "mixtral-8x22b", "moonshot-v1-16b-a3b",
         "seamless-m4t-large-v2"]

# archs whose baseline (DP×TP) state cannot fit a device: they use the FSDP
# rule set as their baseline, as the reference's dry-run does.
FSDP_REQUIRED = {"llama3-405b", "mixtral-8x22b"}


def _meta_tree(shapes, mesh, rules, dtype=None):
    """Meta tensors (DTensors placed by ``rules`` with a mesh) of a
    ParamSpec tree, in ``dtype`` (f32 unless given)."""
    dt = torch.float32 if dtype is None else dtype
    if mesh is None:
        return tree_map(lambda s: torch.empty(s.shape, dtype=dt, device="meta"), shapes)
    return tree_map(lambda s, pl: shd.placed_zeros(s.shape, dt, pl, mesh, "meta"), shapes,
                    shd.param_placements(shapes, rules, mesh))


def input_specs(cfg, shape, mesh, rules, *, microbatches: int = 1,
                moments_dtype=torch.float32) -> tuple:
    """Meta stand-ins for every input of the cell's step: placed DTensors
    with a mesh (the batch, tokens and positions stay plain: the steps place
    them), plain meta tensors without."""
    if shape.kind == "train":
        opt = OptConfig(moments_dtype="bfloat16" if moments_dtype == torch.bfloat16
                        else "float32")
        state = steps_mod.abstract_train_state(cfg, opt=opt, mesh=mesh, rules=rules)
        batch = steps_mod.abstract_batch(cfg, shape.global_batch, shape.seq_len,
                                         microbatches=microbatches)
        return state, batch
    params = _meta_tree(M.param_shapes(cfg), mesh, rules, torch.bfloat16)
    if shape.kind == "prefill":
        batch = steps_mod.abstract_batch(cfg, shape.global_batch, shape.seq_len,
                                         dtype=torch.bfloat16)
        return params, batch
    cache = steps_mod.init_cache(cfg, shape.global_batch, shape.seq_len, "meta",
                                 mesh=mesh, rules=rules)
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int64, device="meta")
    pos = torch.empty((shape.global_batch,), dtype=torch.int64, device="meta")
    return params, cache, tokens, pos


def _local_bytes(t: torch.Tensor, mesh, rules, batch_dim: int | None) -> int:
    """The bytes of this rank's shard of an input (a plain batch input as
    the step will place it)."""
    if isinstance(t, DTensor):
        t = t.to_local()
    elif mesh is not None and batch_dim is not None:
        pspec = shd.fit_pspec((None,) * batch_dim + shd.batch_pspec(rules),
                              tuple(t.shape), mesh)
        shape = shd.local_shape(tuple(t.shape), shd.to_placements(pspec, mesh), mesh)
        return math.prod(shape) * t.element_size()
    return t.numel() * t.element_size()


def argument_bytes(inputs: tuple, shape, mesh, rules, microbatches: int) -> int:
    """Summed local shards of a cell's inputs."""
    total = 0
    for i, tree in enumerate(inputs):
        plain_batch = (shape.kind in ("train", "prefill") and i == 1) or \
            (shape.kind == "decode" and i >= 2)
        bdim = (1 if microbatches > 1 and shape.kind == "train" else 0) if plain_batch else None
        leaves = tree_leaves(tree) if isinstance(tree, dict) else [tree]
        total += sum(_local_bytes(t, mesh, rules, bdim) for t in leaves)
    return total


def _step(cfg, shape, mesh, rules, *, microbatches, bf16_params, bf16_moments):
    if shape.kind == "train":
        opt = OptConfig(moments_dtype="bfloat16") if bf16_moments else None
        return steps_mod.make_train_step(cfg, opt=opt, microbatches=microbatches, mesh=mesh,
                                         rules=rules, unroll_mb=True, bf16_params=bf16_params)
    if shape.kind == "prefill":
        return steps_mod.make_prefill_step(cfg, max_len=shape.seq_len, mesh=mesh, rules=rules)
    return steps_mod.make_serve_step(cfg, mesh=mesh, rules=rules)


def measure(cfg, shape, mesh, rules, *, microbatches: int = 1, bf16_params: bool = False,
            bf16_moments: bool = False, peak_top: int = 0) -> dict:
    """Run the cell's step once on meta inputs under :class:`CostMode`.
    Returns per-device ``flops``, ``bytes``, ``wire_bytes``,
    ``collectives`` ({kind: {count, wire_bytes}}), ``arg_bytes`` and
    ``temp_bytes`` (the peak of the storages the step held); with
    ``peak_top`` > 0 also ``at_peak``, what holds that peak
    (:class:`CostMode`)."""
    mdt = torch.bfloat16 if bf16_moments else torch.float32
    inputs = input_specs(cfg, shape, mesh, rules, microbatches=microbatches,
                         moments_dtype=mdt)
    fn = _step(cfg, shape, mesh, rules, microbatches=microbatches,
               bf16_params=bf16_params, bf16_moments=bf16_moments)
    # a first run, whose counts are dropped, fills DTensor's sharding-
    # propagation caches (an op's first propagation runs it on its global
    # shapes); under the same kind of dispatch mode as the counted run, so
    # both take DTensor's Python dispatch path
    with CostMode():
        fn(*inputs)
    inputs = input_specs(cfg, shape, mesh, rules, microbatches=microbatches,
                         moments_dtype=mdt)
    mode = CostMode(peak_top)
    with mode:
        out = fn(*inputs)
    del out
    colls = parse_collectives(mode)
    by_kind: dict[str, dict] = {}
    for c in colls:
        d = by_kind.setdefault(c.kind, {"count": 0, "wire_bytes": 0.0})
        d["count"] += 1
        d["wire_bytes"] += c.wire_bytes
    return {"flops": float(mode.flops), "bytes": float(mode.bytes),
            "wire_bytes": float(sum(c.wire_bytes for c in colls)), "collectives": by_kind,
            "arg_bytes": float(argument_bytes(inputs, shape, mesh, rules, microbatches)),
            "temp_bytes": float(mode.peak_bytes), "at_peak": mode.at_peak}


def _depth_pair(cfg) -> tuple:
    """Two reduced depths for the extrapolation (pattern-aligned for
    hybrids)."""
    if cfg.family == "hybrid":
        p = len(cfg.block_pattern)
        return p, 2 * p
    return 1, 2


def _with_depth(cfg, L: int):
    kw = {"num_layers": L, "scan_layers": False}
    if cfg.is_encdec:
        kw["encoder_layers"] = L
    return cfg.replace(**kw)


_LINEAR = ("flops", "bytes", "wire_bytes", "temp_bytes")


def _chunked_cfg(cfg, chunked: bool, q_block: int, k_block: int):
    """``cfg`` with the reference's chunked attention on (``--chunked``)."""
    if not chunked:
        return cfg
    return cfg.replace(attn_chunked=True, attn_q_block=q_block, attn_k_block=k_block)


def extrapolated_costs(arch: str, shape, mesh, rules, *, microbatches: int = 1,
                       chunked: bool = False, bf16_params: bool = False,
                       bf16_moments: bool = False, q_block: int = 1024,
                       k_block: int = 1024, peak_top: int = 0) -> dict:
    """Per-device costs extrapolated to full depth from two reduced depths
    (FLOPs, bytes, wire bytes, temporary bytes, each collective kind); the
    argument bytes are the full-depth inputs' own; ``at_peak`` is what
    holds the first reduced depth's peak (``peak_top``, :func:`measure`)."""
    cfg = _chunked_cfg(configs.get(arch), chunked, q_block, k_block)
    L1, L2 = _depth_pair(cfg)
    kw = dict(microbatches=microbatches, bf16_params=bf16_params, bf16_moments=bf16_moments)
    vals = {L: measure(_with_depth(cfg, L), shape, mesh, rules, **kw,
                       peak_top=peak_top if L == L1 else 0) for L in (L1, L2)}
    L = cfg.num_layers

    def line(a: float, b: float) -> float:
        per_layer = (b - a) / (L2 - L1)
        return max(a + per_layer * (L - L1), 0.0)

    out = {k: line(vals[L1][k], vals[L2][k]) for k in _LINEAR}
    # the peak may be one layer's transient (the flash rule's recompute), the
    # same at both depths: it grows with depth, never shrinks
    out["temp_bytes"] = max(out["temp_bytes"], vals[L1]["temp_bytes"], vals[L2]["temp_bytes"])
    for k in _LINEAR:
        out[k + "_per_layer"] = (vals[L2][k] - vals[L1][k]) / (L2 - L1)
    kinds = set(vals[L1]["collectives"]) | set(vals[L2]["collectives"])
    zero = {"count": 0, "wire_bytes": 0.0}
    out["collectives"] = {
        k: {f: line(vals[L1]["collectives"].get(k, zero)[f],
                    vals[L2]["collectives"].get(k, zero)[f]) for f in ("count", "wire_bytes")}
        for k in sorted(kinds)}
    mdt = torch.bfloat16 if bf16_moments else torch.float32
    full = input_specs(cfg, shape, mesh, rules, microbatches=microbatches, moments_dtype=mdt)
    out["arg_bytes"] = float(argument_bytes(full, shape, mesh, rules, microbatches))
    out["at_peak"] = vals[L1]["at_peak"]
    return out


def _rules_for(arch: str, multi_pod: bool, fsdp, rules_kind):
    if fsdp is None:
        fsdp = arch in FSDP_REQUIRED
    if rules_kind in ("zero", "tp2d"):
        return shd.make_rules(multi_pod=multi_pod, zero=rules_kind == "zero",
                              tp2d=rules_kind == "tp2d"), rules_kind
    return shd.make_rules(multi_pod=multi_pod, fsdp=fsdp), "fsdp" if fsdp else "baseline"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             rules_name: str | None = None, out_dir: str | None = None,
             microbatches: int = 1, fsdp: bool | None = None, rules_kind: str | None = None,
             chunked: bool = False, bf16_params: bool = False, bf16_moments: bool = False,
             q_block: int = 1024, k_block: int = 1024, extrapolate: bool = True,
             verbose: bool = True, peak_top: int = 0) -> dict:
    """One cell on the production mesh: its report as a dict (with
    ``skipped`` set when ``cell_supported`` refuses the cell). ``chunked``
    turns on the reference's chunked attention (``attn_chunked``, blocks
    ``q_block`` x ``k_block``): the flash gradient is then the backward op,
    which holds no (S, S) scores. ``peak_top`` > 0 prints the largest
    storages live at the peak of the measured (first reduced) depth."""
    cfg = _chunked_cfg(configs.get(arch), chunked, q_block, k_block)
    shape = configs.shape_for(shape_name)
    ok, why = configs.cell_supported(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if not ok:
        if verbose:
            print(f"SKIP  {arch} × {shape_name} [{mesh_name}]: {why}")
        skipped = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "skipped": why}
        if out_dir:                       # the report lists it with its reason
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json"),
                      "w") as f:
                json.dump(skipped, f, indent=1)
        return skipped
    rules, base = _rules_for(arch, multi_pod, fsdp, rules_kind)
    if rules_name is None:
        rules_name = base + ("_mp" if multi_pod else "")
        if chunked:
            rules_name += "_chunked"
            if (q_block, k_block) != (1024, 1024):
                rules_name += f"_qb{q_block}kb{k_block}"
        if bf16_params:
            rules_name += "_bf16p"
        if bf16_moments:
            rules_name += "_bf16m"
        if microbatches > 1:
            rules_name += f"_mb{microbatches}"
    mesh = make_production_mesh(multi_pod=multi_pod)
    kw = dict(microbatches=microbatches, bf16_params=bf16_params, bf16_moments=bf16_moments,
              peak_top=peak_top)
    t0 = time.perf_counter()
    if extrapolate:
        cost = extrapolated_costs(arch, shape, mesh, rules, chunked=chunked, q_block=q_block,
                                  k_block=k_block, **kw)
    else:
        cost = measure(cfg, shape, mesh, rules, **kw)
    seconds = time.perf_counter() - t0
    report = cell_report(cost, arch=arch, shape=shape, mesh_name=mesh_name,
                         rules_name=rules_name, devices=mesh.size(), cfg=cfg)
    report.memory["wall_s"] = round(seconds, 3)
    if verbose:
        t, mem = report.terms, report.memory
        print(f"OK    {arch} × {shape_name} [{mesh_name}/{rules_name}] {seconds:.1f}s")
        print(f"      memory: args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB "
              f"temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB fits={mem['fits']}")
        print(f"      cost: flops/dev={report.flops_per_dev:.3e} "
              f"bytes/dev={report.bytes_per_dev:.3e} wire/dev={report.wire_bytes_per_dev:.3e}")
        print(f"      roofline: compute={t['compute_s'] * 1e3:.2f}ms "
              f"memory={t['memory_s'] * 1e3:.2f}ms collective={t['collective_s'] * 1e3:.2f}ms "
              f"→ {t['dominant']}-bound; useful_ratio={report.useful_ratio:.3f} "
              f"roofline_frac={report.roofline_fraction:.3f}")
        if cost["at_peak"]:
            op, nbytes, live = cost["at_peak"]
            print(f"      peak: {nbytes / 2**30:.2f}GiB at {op}, held by")
            for n, made in live:
                print(f"        {n / 2**30:8.2f}GiB  {made}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}__{rules_name}.json")
        with open(path, "w") as f:
            f.write(report.to_json())
    return dataclasses.asdict(report)


def main(argv=None) -> int:
    # DTensor warns at every two-step redistribution over a 2-D mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=sorted(configs.SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--rules", choices=["auto", "baseline", "fsdp", "zero", "tp2d"],
                    default="auto")
    ap.add_argument("--chunked", action="store_true",
                    help="the reference's chunked attention (attn_chunked): the flash "
                         "gradient by the backward op, no (S, S) scores")
    ap.add_argument("--bf16-params", action="store_true",
                    help="cast f32 master params to bf16 once per step")
    ap.add_argument("--bf16-moments", action="store_true",
                    help="Adam mu/nu stored in bf16 (8 B/param state)")
    ap.add_argument("--q-block", type=int, default=1024,
                    help="--chunked's q block (the reference's flag; it names the rules, "
                         "and the port's numbers do not depend on it: the dry-run's fake "
                         "ops and the card's backward kernel take no blocks)")
    ap.add_argument("--k-block", type=int, default=1024, help="--chunked's k block (as "
                    "--q-block)")
    ap.add_argument("--peak-top", type=int, default=0, metavar="N",
                    help="print the N largest storages live at each cell's peak, with the "
                         "op that made each (at the first reduced depth)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--all", action="store_true", help="run every (arch × shape) cell")
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="run the full depth once instead of two reduced depths")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("--arch/--shape required unless --all")
    cells = ([(a, s) for a in ARCHS for s in configs.SHAPES] if args.all
             else [(args.arch, args.shape)])
    fsdp = None if args.rules == "auto" else (args.rules == "fsdp")
    failures = []
    t0 = time.perf_counter()
    for multi in meshes:
        for arch, shape in cells:
            try:
                run_cell(arch, shape, multi_pod=multi, out_dir=args.out,
                         microbatches=args.microbatches, fsdp=fsdp,
                         rules_kind=args.rules if args.rules in ("zero", "tp2d") else None,
                         chunked=args.chunked, bf16_params=args.bf16_params,
                         bf16_moments=args.bf16_moments, q_block=args.q_block,
                         k_block=args.k_block, extrapolate=not args.no_extrapolate,
                         peak_top=args.peak_top)
            except Exception as exc:  # noqa: BLE001 — a cell's failure is reported, then fails the run
                failures.append((arch, shape, multi, repr(exc)))
                print(f"FAIL  {arch} × {shape} multi={multi}: {exc}")
                traceback.print_exc()
    print(f"\n{len(cells) * len(meshes)} cells in {time.perf_counter() - t0:.1f}s")
    if failures:
        print(f"{len(failures)} FAILED CELLS:")
        for f in failures:
            print("  ", f)
        return 1
    print("all requested dry-run cells ran")
    return 0


if __name__ == "__main__":
    sys.exit(main())
