"""Roofline analysis of a step traced on the ``meta`` device (port of
``repro.roofline.analysis``).

Three terms per (arch × shape × mesh), in seconds per step on one H100
(:data:`repro_torch.launch.mesh.HW`, datasheet values, spec not measured):

    compute    = FLOPs_per_device / peak bf16 FLOP/s
    memory     = bytes_per_device / HBM bandwidth
    collective = wire_bytes_per_device / NVLink bandwidth (per direction)

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and the
collectives from the optimized HLO. The port has no compiler in between: a
step runs eagerly, op by op, so :class:`CostMode` counts the ops as they
run, on each rank's local shards:

* FLOPs from ``torch.utils.flop_counter``'s formulas (the kernels' custom
  ops register theirs), counted only for ops on plain tensors: DTensor
  runs each op once on its global shape (under a fake tensor mode, for its
  sharding propagation) and once on the local shards, and only the second
  is the device's work;
* bytes moved: each op's tensor inputs read once and outputs written once
  (views and empty allocations move nothing), as eager kernels do;
* collectives from ``CommDebugMode``'s tracing of the functional
  collectives DTensor issues: kind, result bytes and group size, with the
  ring factors of :func:`_wire_factor` (:func:`parse_collectives`);
* temporary bytes: the peak of the storages the step's local ops allocate
  and still hold, tracked by weakref finalizers on the storages.

MODEL_FLOPS uses 6·N·D (train) / 2·N·D (inference) with N = (active)
params, D = tokens; the ratio MODEL_FLOPS / (FLOPs × devices) exposes
remat recompute, plain recomputes in the gradient rules and padding.
"""

from __future__ import annotations

import json
import weakref
from dataclasses import asdict, dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import HW

__all__ = ["CollectiveOp", "CostMode", "parse_collectives", "roofline_terms",
           "CellReport", "model_flops"]

_COLLECTIVES = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "detach", "alias",
               "_to_copy_meta", "lift_fresh"}


@dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    wire_bytes: float


def _wire_factor(kind: str, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind == "all-gather":
        return (g - 1) / g
    if kind == "reduce-scatter":
        return float(g - 1)
    if kind == "all-to-all":
        return (g - 1) / g
    return 1.0  # collective-permute


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args) -> int:
    name = args[-1]
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class CostMode(CommDebugMode):
    """``CommDebugMode`` that also counts, per device, the FLOPs, bytes and
    collectives of the local ops DTensor runs, and the peak of the
    storages they allocate (module docstring). With ``peak_top`` > 0 it
    also keeps what holds the peak: ``at_peak`` is (the op at which the
    peak rose last, the peak's bytes, [(bytes, (op, shape, dtype))] of the
    ``peak_top`` largest storages live then, each with the op that made
    it)."""

    def __init__(self, peak_top: int = 0):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.traced: list[tuple[str, int, int]] = []    # (kind, result bytes, group)
        self._live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_top = peak_top
        self.at_peak: tuple | None = None
        self._op = ""
        self._made: dict[int, tuple] = {}                # storage -> (op, shape, dtype)

    def _track(self, out) -> None:
        before = self.peak_bytes
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)
            if self.peak_top:
                self._made[key] = (self._op, tuple(t.shape), str(t.dtype)[6:])
        if self.peak_top and self.peak_bytes > before:
            live = sorted(self._live.items(), key=lambda kv: -kv[1])[:self.peak_top]
            self.at_peak = (self._op, self.peak_bytes,
                            [(n, self._made.get(key)) for key, n in live])

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)
        self._made.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.peak_top:
            self._op = getattr(func, "_overloadpacket", func).__name__
        leaves = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        if any(t is DTensor or issubclass(t, DTensor) for t in types) or \
                isinstance(func, torch._ops.HigherOrderOperator):
            return super().__torch_dispatch__(func, types, args, kwargs)
        if any(isinstance(a, FakeTensor) for a in leaves):
            return func(*args, **kwargs)        # DTensor's global-shape propagation
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            g = _group_size(args)
            result = _nbytes(args[0]) * (g if kind == "all-gather" else 1)
            if kind == "reduce-scatter":
                result //= g
            self.traced.append((kind, result, g))
        elif not func.is_view and name not in _NO_TRAFFIC and name != "wait_tensor":
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in leaves) + sum(_nbytes(t) for t in outs)
        self._track(out)
        return out


def parse_collectives(mode: CostMode) -> list[CollectiveOp]:
    """The collectives a :class:`CostMode` traced, with their wire bytes
    (the reference parses the same from XLA's HLO)."""
    return [CollectiveOp(kind, n, g, n * _wire_factor(kind, g)) for kind, n, g in mode.traced]


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode), N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token per row


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float) -> dict:
    t = {
        "compute_s": flops_per_dev / HW["peak_flops_bf16"],
        "memory_s": bytes_per_dev / HW["hbm_bw"],
        "collective_s": wire_bytes_per_dev / HW["link_bw"],
    }
    t["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                        key=lambda k: t[k]).replace("_s", "")
    t["bound_s"] = max(t["compute_s"], t["memory_s"], t["collective_s"])
    return t


@dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    rules: str
    devices: int
    flops_per_dev: float
    bytes_per_dev: float
    wire_bytes_per_dev: float
    collectives: dict = field(default_factory=dict)
    terms: dict = field(default_factory=dict)
    model_flops_total: float = 0.0
    useful_ratio: float = 0.0          # MODEL_FLOPS / (FLOPs × devices)
    roofline_fraction: float = 0.0     # useful compute time / bound time
    memory: dict = field(default_factory=dict)
    skipped: str = ""

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def cell_report(cost: dict, *, arch: str, shape, mesh_name: str, rules_name: str,
                devices: int, cfg) -> CellReport:
    """The report of one cell from its per-device costs (``flops``,
    ``bytes``, ``wire_bytes``, ``collectives``, ``arg_bytes``,
    ``temp_bytes``)."""
    terms = roofline_terms(cost["flops"], cost["bytes"], cost["wire_bytes"])
    mf = model_flops(cfg, shape)
    useful_time = mf / devices / HW["peak_flops_bf16"]
    total = cost["arg_bytes"] + cost["temp_bytes"]
    memory = {"argument_size_in_bytes": int(cost["arg_bytes"]),
              "temp_size_in_bytes": int(cost["temp_bytes"]),
              "total_gb": round(total / 2**30, 3),
              "fits": total <= HW["hbm_bytes"]}
    return CellReport(
        arch=arch, shape=shape.name, mesh=mesh_name, rules=rules_name, devices=devices,
        flops_per_dev=cost["flops"], bytes_per_dev=cost["bytes"],
        wire_bytes_per_dev=cost["wire_bytes"], collectives=cost["collectives"],
        terms=terms, model_flops_total=mf,
        useful_ratio=mf / max(cost["flops"] * devices, 1.0),
        roofline_fraction=useful_time / terms["bound_s"] if terms["bound_s"] > 0 else 0.0,
        memory=memory)
