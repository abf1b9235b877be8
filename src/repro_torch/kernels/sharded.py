"""The kernels' gradient rules on DTensors: each rule runs on the local
shards, in the layout the forward's sharding rule chose.

A kernel's custom op picks one layout per mesh dim from its sharding rule
(replicate, the batch, heads or width); its output carries that choice.
:func:`layout_of` reads it back and :func:`on_shards` runs the rule under
``local_map`` with its inputs laid out so, so the rule sees plain tensors
(its autograd recompute works on them) and no op of it needs a DTensor
rule. On plain tensors both are the identity.
"""

from __future__ import annotations

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

__all__ = ["layout_of", "on_shards"]


def layout_of(output):
    """The placements of a kernel op's output, or None off DTensors."""
    return tuple(output.placements) if isinstance(output, DTensor) else None


def on_shards(rule, out_layouts: tuple, in_layouts: tuple, *args):
    """``rule(*args)`` on each rank's shards: ``args`` are redistributed to
    ``in_layouts`` (one placements tuple per arg) and the results wrapped in
    ``out_layouts``. Plain tensors go to ``rule`` as they are."""
    if not any(isinstance(a, DTensor) for a in args):
        return rule(*args)
    return local_map(rule, out_placements=out_layouts, in_placements=in_layouts,
                     redistribute_inputs=True)(*args)
