"""AdamW with global-norm clipping over nested dicts of tensors (port of
``repro.train.optimizer``).

As written in the reference: linear warmup of the learning rate, the
gradient clipped to ``clip_norm`` by its global norm before the moments,
bias-corrected moments, decoupled weight decay on every leaf, and all the
math in f32 with the moments stored in ``moments_dtype``. The reference
returns new trees (its step donates the old ones); here the params and
moments are updated in place, which saves the copy, and returned.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["OptConfig", "init_opt", "adamw_update", "global_norm", "tree_leaves",
           "tree_unflatten", "tree_map"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    moments_dtype: str = "float32"    # storage of mu and nu; the math is f32


def tree_leaves(tree) -> list[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (JAX's flatten order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves: list):
    """A nested dict shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return _map(lambda _: next(it), like)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of nested dicts of one structure, in sorted-key
    order; ``is_leaf`` marks a non-dict leaf (e.g. a (shape, dtype) pair)."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in sorted(tree)}
    return fn(tree, *rest)


_map = tree_map


def init_opt(params, oc: OptConfig | None = None) -> dict:
    """Zero moments in ``moments_dtype``, each in its param's layout (a
    DTensor's moments are DTensors placed as it is)."""
    dt = _DTYPES[(oc or OptConfig()).moments_dtype]
    zeros = lambda p: torch.zeros_like(p, dtype=dt).detach()  # noqa: E731
    return {"mu": _map(zeros, params), "nu": _map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


def _schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1).float() / max(oc.warmup_steps, 1), max=1.0)
    return oc.lr * warm


@torch.no_grad()
def adamw_update(grads, opt_state, params, oc: OptConfig, step: torch.Tensor):
    """One AdamW step at ``step`` (a 0-d int tensor, the steps taken so far).
    ``grads`` mirrors ``params``. Updates ``params`` and ``opt_state`` in
    place and returns (params, opt_state, {"grad_norm", "lr"}), the metrics
    as 0-d f32 tensors on the params' device (no host synchronisation)."""
    gn = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    lr = _schedule(oc, step)
    t = (step + 1).float()
    c1 = 1.0 - torch.pow(oc.b1, t)
    c2 = 1.0 - torch.pow(oc.b2, t)
    flat_p = tree_leaves(params)
    flat = zip(flat_p, tree_leaves(grads), tree_leaves(opt_state["mu"]),
               tree_leaves(opt_state["nu"]))
    for p, g, mu, nu in flat:
        g = g.float() * scale
        m = oc.b1 * mu.float() + (1 - oc.b1) * g
        v = oc.b2 * nu.float() + (1 - oc.b2) * torch.square(g)
        step_dir = (m / c1) / (torch.sqrt(v / c2) + oc.eps)
        pf = p.float()
        p.copy_(pf - lr * (step_dir + oc.weight_decay * pf))
        mu.copy_(m)
        nu.copy_(v)
    return params, opt_state, {"grad_norm": gn, "lr": lr}
