"""Sharding context: lets model code place logical-axis constraints without
threading mesh objects through every call (port of ``repro.parallel.ctx``).

The step makers of :mod:`repro_torch.parallel.steps` enter
:func:`sharding_ctx` around a sharded step; model code calls
:func:`constrain_logical(x, ("batch", "seq", "vocab"))` at activation
boundaries (embeddings, logits, MoE dispatch). On a plain tensor, or
outside any context, the call is the identity, so the one-device path pays
nothing. :func:`current` tells model code whether a sharded step is running.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.parallel.sharding import axes_to_pspec, fit_pspec, to_placements

__all__ = ["sharding_ctx", "constrain_logical", "current", "gather_for_compute"]

_TLS = threading.local()


@contextmanager
def sharding_ctx(mesh, rules: dict):
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (mesh, rules)
    try:
        yield
    finally:
        _TLS.ctx = prev


def current():
    """(mesh, rules) of the innermost :func:`sharding_ctx`, or None."""
    return getattr(_TLS, "ctx", None)


def constrain_logical(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """Redistribute the DTensor ``x`` (and its gradient) to the layout its
    logical ``axes`` take under the context's rules, dropping the mesh axes
    a dim is not divisible by (as ``spec_to_pspec`` does)."""
    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    pspec = fit_pspec(axes_to_pspec(axes, rules), tuple(x.shape), mesh)
    return _Constrain.apply(x, to_placements(pspec, mesh))


class _Constrain(torch.autograd.Function):
    """Redistribute to a layout, and the gradient to the same layout (as
    ``with_sharding_constraint`` constrains the cotangent too): a partial
    gradient is reduced here, where its layout is known, rather than
    reaching an op's backward in a layout that op cannot take."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x if tuple(x.placements) == placements else \
            x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def gather_for_compute(tree):
    """A layer's params as they compute: each DTensor gathered over the
    mesh axes that carry the batch (FSDP's gather before use: under fsdp the
    data axes, under zero every axis), keeping its tensor-parallel shards;
    under baseline and tp2d nothing moves. Outside a context, as is."""
    ctx = current()
    if ctx is None:
        return tree
    mesh, rules = ctx
    dp = {mesh.mesh_dim_names.index(a) for a in rules["batch"]}

    def one(t):
        if not isinstance(t, DTensor):
            return t
        pl = tuple(Replicate() if i in dp and isinstance(p, Shard) else p
                   for i, p in enumerate(t.placements))
        return t if pl == tuple(t.placements) else t.redistribute(t.device_mesh, pl)

    if isinstance(tree, dict):
        return {k: gather_for_compute(v) for k, v in tree.items()}
    return one(tree)
