"""Logical-axis sharding rules: ParamSpec.axes → a partition spec → DTensor
placements (port of ``repro.parallel.sharding``).

Every parameter, cache and activation dim carries a *logical* axis name; a
rule set maps logical names to mesh axes. The rule sets are the
reference's, table for table:

``baseline``   plain DP × TP: batch over (pod, data); vocab/heads/ff/experts
               over model; parameters replicated across the data axis.
``fsdp``       additionally shards every parameter's `embed` dim over
               (pod, data), so params and optimizer state scale with the mesh.
``zero``       pure ZeRO-3 data parallel: batch and every `embed` dim over
               the whole mesh, no tensor parallelism.
``tp2d``       serving: the `ff` dim 2-D over (data × model), heads and vocab
               over model, batch unsharded; every weight stays resident.

A partition spec here is the reference's canonical ``PartitionSpec`` as a
plain tuple: one entry per dim, ``None``, a mesh axis name, or a tuple of
axis names (major first), with trailing ``None``s trimmed. The spec
functions read only ``mesh.shape`` as {axis: size} (a ``DeviceMesh`` is
read through its dim names), so they take duck-typed meshes too.
:func:`to_placements` turns a spec into DTensor placements.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.layers import ParamSpec

__all__ = ["RULES", "make_rules", "mesh_sizes", "spec_to_pspec", "fit_pspec",
           "tree_pspecs", "batch_pspec", "cache_pspecs", "to_placements",
           "param_placements", "place", "place_tree", "placed_zeros",
           "full", "index_put_local", "reshape", "pad"]


def make_rules(*, multi_pod: bool, fsdp: bool = False, seq_shard: bool = False,
               zero: bool = False, tp2d: bool = False) -> dict:
    dp = ("pod", "data") if multi_pod else ("data",)
    if zero:
        dpz = dp + ("model",)
        return {
            "batch": dpz, "embed": dpz,
            "vocab": (), "heads": (), "kv_heads": (), "ff": (),
            "experts": (), "head": (), "layers": (), "seq": (),
            "act_embed": (), "cap": (), None: (),
        }
    if tp2d:
        return {
            "batch": (), "embed": (),
            "vocab": ("model",), "heads": ("model",), "kv_heads": ("model",),
            "ff": dp + ("model",), "experts": (),
            "head": (), "layers": (), "seq": (),
            "act_embed": (), "cap": (), None: (),
        }
    return {
        "batch": dp,
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "experts": ("model",),
        "embed": dp if fsdp else (),
        "head": (),
        "layers": (),
        "seq": dp if seq_shard else (),   # sequence parallelism (long prefill)
        "act_embed": (),                  # activation d_model dim
        "cap": (),                        # MoE capacity dim
        None: (),
    }


RULES = {
    "baseline": make_rules(multi_pod=False),
    "baseline_mp": make_rules(multi_pod=True),
    "fsdp": make_rules(multi_pod=False, fsdp=True),
    "fsdp_mp": make_rules(multi_pod=True, fsdp=True),
    "zero": make_rules(multi_pod=False, zero=True),
    "zero_mp": make_rules(multi_pod=True, zero=True),
    "tp2d": make_rules(multi_pod=False, tp2d=True),
    "tp2d_mp": make_rules(multi_pod=True, tp2d=True),
}


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of anything whose ``shape``
    is already that dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _entry(axes: tuple):
    return None if not axes else (axes[0] if len(axes) == 1 else tuple(axes))


def _trim(entries: list) -> tuple:
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def axes_to_pspec(axes, rules: dict) -> tuple:
    """The spec of logical ``axes`` under ``rules``: each dim's mesh axes,
    a mesh axis at most once per tensor (a later dim loses it)."""
    out, used = [], set()
    for ax in axes:
        mesh_axes = tuple(a for a in (rules.get(ax, ()) or ()) if a not in used)
        used.update(mesh_axes)
        out.append(_entry(mesh_axes))
    return _trim(out)


def fit_pspec(pspec: tuple, shape: tuple, mesh) -> tuple:
    """Drop the mesh axes a dim is not divisible by, dim by dim, keeping a
    dim's leading axes while the product divides it (e.g. 10 heads on a
    16-way model axis → replicate rather than fail)."""
    sizes = mesh_sizes(mesh)
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, entry in enumerate(entries):
        if entry is None:
            continue
        keep, n = [], 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if shape[i] % (n * sizes[a]) == 0:
                keep.append(a)
                n *= sizes[a]
        entries[i] = _entry(tuple(keep))
    return _trim(entries)


def spec_to_pspec(spec: ParamSpec, rules: dict, mesh=None) -> tuple:
    """The partition spec of one ParamSpec, with the divisibility fallback
    when a mesh is given."""
    pspec = axes_to_pspec(spec.axes, rules)
    return pspec if mesh is None else fit_pspec(pspec, spec.shape, mesh)


def tree_pspecs(specs, rules: dict, mesh=None):
    """A nested ParamSpec dict → the same tree of partition specs."""
    if isinstance(specs, ParamSpec):
        return spec_to_pspec(specs, rules, mesh)
    return {k: tree_pspecs(v, rules, mesh) for k, v in specs.items()}


def batch_pspec(rules: dict) -> tuple:
    """The batch dim's spec: ``(entry,)`` with entry the batch's mesh axes
    (``(None,)`` when the batch is not sharded, as ``P(None)``)."""
    return (_entry(tuple(rules["batch"])),)


def cache_pspecs(cache_shape_tree, rules: dict, mesh, cfg):
    """Specs of a decode cache ({name: (shape, dtype)} leaves): the batch dim
    over the DP axes when divisible; then a kv-head or SSM-head dim over
    `model` when divisible, else (GQA with fewer kv heads than the axis)
    the sequence-slots dim: the standard sequence-sharded KV cache. An MLA
    layer's latent slots (B, S, C + R) take the batch split only: every head
    reads every value of a slot, and the latent decode op runs on whole
    rows."""
    sizes = mesh_sizes(mesh)
    dp = tuple(rules["batch"])
    dp_n = math.prod(sizes[a] for a in dp)
    model_n = sizes["model"]

    def one(sd):
        shape, _ = sd
        entries = [None] * len(shape)
        bdim = 1 if len(shape) >= 2 and shape[0] == cfg.num_layers else 0
        if shape[bdim] % dp_n == 0:
            entries[bdim] = _entry(dp)
        if cfg.attention == "mla" and len(shape) == bdim + 3 and \
                shape[-1] == cfg.kv_lora_rank + cfg.qk_rope_head_dim:
            return _trim(entries)
        placed = False
        for i in range(bdim + 2, len(shape)):
            if shape[i] in (cfg.num_kv_heads, cfg.ssm_heads) and shape[i] % model_n == 0:
                entries[i] = "model"
                placed = True
                break
        if not placed and len(shape) >= bdim + 3 and shape[bdim + 1] % model_n == 0:
            entries[bdim + 1] = "model"
        return _trim(entries)

    def walk(tree):
        if isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[0], tuple):
            return one(tree)
        return {k: walk(v) for k, v in tree.items()}

    return walk(cache_shape_tree)


# ------------------------------------------------------------- placements
def to_placements(pspec: tuple, mesh) -> tuple:
    """DTensor placements of ``pspec`` on ``mesh`` (a ``DeviceMesh``): a
    dim over several mesh axes is ``Shard(d)`` on each of them, which
    DTensor splits in mesh-dim order, major first, as the spec orders
    them; every other mesh dim replicates, and so does a mesh dim of size
    1, where the two are the same layout (and a one-row dim "sharded" one
    way would block the reshapes that merge it)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {pspec}: dim {d}'s axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if mesh.shape[i] > 1:      # a one-way axis splits nothing: replicate
                out[i] = Shard(d)
    return tuple(out)


def param_placements(specs, rules: dict, mesh):
    """A nested ParamSpec dict → the same tree of DTensor placements."""
    if isinstance(specs, ParamSpec):
        return to_placements(spec_to_pspec(specs, rules, mesh), mesh)
    return {k: param_placements(v, rules, mesh) for k, v in specs.items()}


def _block(dim: int, placements, mesh) -> tuple[int, int]:
    """(this rank's block index, block count) of ``dim``: the mesh dims that
    shard it, major first, as DTensor nests them."""
    coord = mesh.get_coordinate()
    block, count = 0, 1
    for j, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            block, count = block * mesh.shape[j] + coord[j], count * mesh.shape[j]
    return block, count


def local_range(dim: int, size: int, placements, mesh) -> tuple[int, int]:
    """[lo, hi) of ``dim`` (of global ``size``) that this rank holds."""
    block, count = _block(dim, placements, mesh)
    if size % count:
        raise ValueError(f"dim {dim} of size {size} does not split {count} ways")
    n = size // count
    return block * n, (block + 1) * n


def place(t: torch.Tensor, placements, mesh) -> DTensor:
    """The DTensor of ``t`` (the same full values on every rank) under
    ``placements``: each rank keeps its own block, no collective runs. On
    a one-rank mesh the shard is ``t`` itself, not a copy."""
    local = t
    for d in {p.dim for p in placements if isinstance(p, Shard)}:
        lo, hi = local_range(d, t.shape[d], placements, mesh)
        local = local.narrow(d, lo, hi - lo)
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=t.shape, stride=t.stride())


def place_tree(tree, placements, mesh):
    """:func:`place` over a tree; ``placements`` mirrors ``tree``."""
    if isinstance(tree, dict):
        return {k: place_tree(v, placements[k], mesh) for k, v in tree.items()}
    return place(tree.detach(), placements, mesh).requires_grad_(tree.requires_grad)


def local_shape(shape: tuple, placements, mesh) -> tuple:
    """The shape of this rank's shard (every sharded dim divisible, as
    :func:`fit_pspec` guarantees)."""
    out = list(shape)
    for n, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            out[p.dim] //= n
    return tuple(out)


def placed_zeros(shape: tuple, dtype, placements, mesh, device) -> DTensor:
    """A zero DTensor of global ``shape``: each rank allocates only its
    shard (nothing at all on the ``meta`` device, the dry-run's stand-ins),
    no collective runs."""
    local = torch.zeros(local_shape(shape, placements, mesh), dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def full(t):
    """The full value of a DTensor (a collective), a plain tensor as is.
    For metrics, logits and checkpoints, never for a weight an op needs."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def index_put_local(dst: torch.Tensor, idx: tuple, src: torch.Tensor) -> None:
    """``dst[idx] = src`` in place, with ``idx`` integer index tensors (n,)
    on dst's leading ``len(idx)`` dims and ``src`` of shape (n, *rest).
    On a DTensor ``dst`` each rank writes the entries its shard holds into
    its local tensor, at the index mapped to the shard; ``src`` is first
    laid out as dst on the trailing dims. Nothing of ``dst`` moves: a cache
    is never gathered."""
    if not isinstance(dst, DTensor):
        dst[idx] = src.to(dst.dtype)
        return
    mesh, k = dst.device_mesh, len(idx)
    src_pl = [Shard(p.dim - k + 1) if isinstance(p, Shard) and p.dim >= k else Replicate()
              for p in dst.placements]
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim, run_check=False)
    src_local = src.redistribute(mesh, src_pl).to_local().to(dst.dtype)
    idx = [full(i).to(src_local.device).long() for i in idx]
    keep = torch.ones_like(idx[0], dtype=torch.bool)
    for d in range(k):
        lo, hi = local_range(d, dst.shape[d], dst.placements, mesh)
        keep &= (idx[d] >= lo) & (idx[d] < hi)
        idx[d] = idx[d] - lo
    if src_local.device.type == "meta":     # the dry-run: which entries are local
        dst.to_local().index_put_(tuple(idx), src_local)   # is data it has not
        return
    dst.to_local()[tuple(i[keep] for i in idx)] = src_local[keep]


def _reshape_dtensor(x: DTensor, shape: tuple) -> DTensor:
    try:
        return x.reshape(*shape)
    except RuntimeError:                    # raised by the sharding propagation,
        k = 0                               # before any data moves
        while k < min(x.ndim, len(shape)) and x.shape[k] == shape[k]:
            k += 1
        keep = [Replicate() if isinstance(p, Shard) and p.dim >= k else p
                for p in x.placements]
        return x.redistribute(x.device_mesh, keep).reshape(*shape)


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose gradient is laid out as its output was
    before it is reshaped back (a gradient may arrive sharded otherwise,
    where the reverse view would split a dim unevenly), then as its input."""

    @staticmethod
    def forward(ctx, x, shape):
        y = _reshape_dtensor(x, shape)
        ctx.shape, ctx.in_pl, ctx.out_pl = x.shape, tuple(x.placements), tuple(y.placements)
        return y

    @staticmethod
    def backward(ctx, g):
        out_pl, in_pl = _grad_layout(ctx.out_pl), _grad_layout(ctx.in_pl)
        if tuple(g.placements) != out_pl:
            g = g.redistribute(g.device_mesh, out_pl)
        gx = g.reshape(ctx.shape)
        if tuple(gx.placements) != in_pl:
            gx = gx.redistribute(gx.device_mesh, in_pl)
        return gx, None


def _grad_layout(placements: tuple) -> tuple:
    """A gradient's layout for a value laid out so: a partial value's
    gradient is whole on that mesh dim (a gradient is never made partial)."""
    return tuple(Replicate() if p.is_partial() else p for p in placements)


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``; on a DTensor whose sharded dims the reshape
    cannot keep (a dim split or merged unevenly across its mesh axis, e.g.
    24 SSM heads or 8 kv-head groups on a 16-way axis), those dims are
    first gathered (DTensor refuses such a view rather than move data), in
    the backward too."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _Reshape.apply(x, tuple(shape))


def pad(x: torch.Tensor, pads: tuple) -> torch.Tensor:
    """``F.pad(x, pads)`` with zeros; on a DTensor, on each rank's shard, a
    padded dim gathered first if it is sharded (zero padding commutes with
    every other layout, a partial sum's included)."""
    if not isinstance(x, DTensor):
        return F.pad(x, pads)
    padded = {x.ndim - 1 - i for i in range(len(pads) // 2) if pads[2 * i] or pads[2 * i + 1]}
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in padded else p
               for p in x.placements)
    return local_map(lambda t: F.pad(t, pads), out_placements=(pl,), in_placements=(pl,),
                     redistribute_inputs=True)(x)
