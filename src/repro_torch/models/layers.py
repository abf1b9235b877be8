"""Parameter metadata + common layers (port of ``repro.models.layers``).

Every model defines its parameter tree as a nested dict of
:class:`ParamSpec`; :func:`init_tree` materialises it with the reference's
init statistics (std fan_in^-0.5 for linear weights, 0.02 for ``embed``,
ones/zeros for norms/biases). The bits cannot match ``jax.random``, so the
parity tests carry JAX weights across with :mod:`repro_torch.interop`.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

__all__ = ["ParamSpec", "flatten_specs", "init_tree", "rms_norm",
           "rotary_embedding", "apply_rope", "swiglu", "take_embedding"]


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[Any, ...]          # logical axis name (or None) per dim
    init: str = "linear"           # linear | embed | zeros | ones
    fan_in_axes: tuple[int, ...] = ()   # dims contracted by the consumer

    def with_prefix(self, n: int) -> "ParamSpec":
        """Stack over layers: prepend a leading layer dim. The fan-in axes
        move with the shape, so a stacked weight draws with its own fan-in
        (the reference leaves them in place and so draws every stacked
        weight with std num_layers^-0.5; ROADMAP.md Queue 3)."""
        fan_in_axes = tuple(a + 1 for a in self.fan_in_axes) or (1,)
        return self._replace(shape=(n, *self.shape), axes=("layers", *self.axes),
                             fan_in_axes=fan_in_axes)


def flatten_specs(specs, prefix: tuple = ()) -> list[tuple[tuple, ParamSpec]]:
    """(key path, spec) pairs in sorted-key order (JAX's dict flatten order)."""
    if isinstance(specs, ParamSpec):
        return [(prefix, specs)]
    out = []
    for key in sorted(specs):
        out.extend(flatten_specs(specs[key], prefix + (key,)))
    return out


def _fan_in(spec: ParamSpec) -> int:
    if spec.fan_in_axes:
        return max(1, math.prod(spec.shape[a] for a in spec.fan_in_axes))
    return max(1, spec.shape[0] if spec.shape else 1)


# Random fill in slices of this many elements: bounds the float32 scratch at
# full width (one stacked d_ff weight of granite-8b is 2.1e9 elements).
_FILL_CHUNK = 1 << 26


def _materialize(spec: ParamSpec, generator: torch.Generator, dtype,
                 device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    scale = 0.02 if spec.init == "embed" else _fan_in(spec) ** -0.5
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), _FILL_CHUNK):
        n = min(_FILL_CHUNK, flat.numel() - start)
        noise = torch.randn(n, generator=generator, device=device,
                            dtype=torch.float32)
        flat[start:start + n] = noise.mul_(scale)
    return out


def init_tree(specs, generator: torch.Generator, dtype=torch.float32,
              device="cpu"):
    """Materialise a nested ParamSpec dict into tensors on ``device``.

    ``generator`` must live on ``device``; the tensors are drawn in float32
    and stored in ``dtype``, so a bf16 model is made on the card directly."""
    if isinstance(specs, ParamSpec):
        return _materialize(specs, generator, dtype, device)
    return {k: init_tree(specs[k], generator, dtype, device)
            for k in sorted(specs)}


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float = 1e4) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables for the given positions; shape (..., head_dim/2).
    The base stays a Python scalar: a tensor made from it on the card would
    be a blocking copy from the host, which stalls the stream every layer
    and cannot be captured in a CUDA graph. ``pow`` rounds it to float32
    first, so the tables are bitwise those of a float32 base tensor."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freqs = torch.pow(float(theta), exponent)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); sin/cos: (..., S, D/2) broadcast over heads.
    Rotates split halves (not interleaved pairs), as the reference does."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return F.silu(x_gate) * x_up


def _masked_lookup(table: torch.Tensor, ids: torch.Tensor, lo: int) -> torch.Tensor:
    """Rows ``ids`` of a vocab shard that starts at row ``lo``; an id outside
    the shard reads zeros."""
    local = ids - lo
    inside = (local >= 0) & (local < table.shape[0])
    rows = F.embedding(local.clamp(0, table.shape[0] - 1), table)
    return rows * inside[..., None].to(rows.dtype)


def take_embedding(table: torch.Tensor, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``table[ids]``. On a DTensor table whose vocab dim is sharded, the
    vocab-parallel lookup: each rank reads the ids its rows hold (zeros for
    the rest) and the rows come out partial over the vocab's mesh axes, to
    be summed where the caller constrains them; the table's rows never move.
    A table whose `embed` dim is sharded (fsdp, zero) is first gathered over
    that dim, as every FSDP weight is before its use."""
    if not isinstance(table, DTensor):
        return F.embedding(ids, table).to(compute_dtype)
    mesh = table.device_mesh
    tl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in table.placements]
    table = table.redistribute(mesh, tl)
    vocab = [i for i, p in enumerate(tl) if isinstance(p, Shard)]
    if not vocab:
        return F.embedding(ids, table).to(compute_dtype)
    ids = ids.redistribute(mesh, [Replicate() if i in vocab else p
                                  for i, p in enumerate(ids.placements)])
    from repro_torch.parallel.sharding import local_range
    lo, _ = local_range(0, table.shape[0], tl, mesh)
    out_pl = [Partial() if i in vocab else p for i, p in enumerate(ids.placements)]
    # the table's gradient is summed over the mesh dims that split the batch
    grad_pl = [Partial() if isinstance(ip, Shard) and i not in vocab else tp
               for i, (tp, ip) in enumerate(zip(tl, ids.placements))]
    rows = local_map(_masked_lookup, out_placements=(tuple(out_pl),),
                     in_placements=(tuple(tl), tuple(ids.placements), None),
                     in_grad_placements=(tuple(grad_pl), tuple(ids.placements), None),
                     redistribute_inputs=False)(table, ids, lo)
    return rows.to(compute_dtype)
