"""Weights made by the benchmark from the seed, on the device, one call per
leaf, in the dtype they are used in. The layout (names, shapes, inits) is
the configuration's reference module's :func:`param_layout`; both the port
and the reference are handed these tensors."""

from __future__ import annotations

import math

import torch

__all__ = ["make_weights", "flat", "leaf_slices"]


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _leaf(spec, gen, dtype, device) -> torch.Tensor:
    shape, init = spec
    if init is None:
        return torch.ones(shape, dtype=dtype, device=device)
    if init == 0.0 and not isinstance(init, str):
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "A_log":          # A uniform on [1, 16]
        u = torch.rand(shape, generator=gen, device=device)
        return torch.log(1 + 15 * u).to(dtype)
    if init == "dt_bias":        # softplus^-1 of dt log-uniform on [1e-3, 1e-1]
        u = torch.rand(shape, generator=gen, device=device)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    out = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return out.mul_(init)


def make_weights(layout: dict, seed: int, dtype, device) -> dict:
    """The weights of ``layout`` drawn from ``seed`` with one generator on
    ``device``, leaf by leaf in sorted order: the same seed gives the same
    tensors."""
    gen = _generator(seed, device)

    def build(tree):
        return {k: build(tree[k]) if isinstance(tree[k], dict) else
                _leaf(tree[k], gen, dtype, device) for k in sorted(tree)}
    return build(layout)


def flat(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(dotted name, tensor) of every leaf, in sorted order."""
    out = []
    for k in sorted(tree):
        name = f"{prefix}{k}"
        out.extend(flat(tree[k], name + ".") if isinstance(tree[k], dict) else [(name, tree[k])])
    return out


def leaf_slices(tree) -> list[tuple[str, torch.Tensor]]:
    """The leaves the training check compares: every layer's slice of a
    stacked leaf (``layers.x[i]``) and every other leaf whole. ``tree`` is a
    nested dict or :func:`flat`'s (name, tensor) pairs."""
    out = []
    for name, t in (flat(tree) if isinstance(tree, dict) else tree):
        if name.startswith("layers."):
            out.extend((f"{name}[{i}]", t[i]) for i in range(t.shape[0]))
        else:
            out.append((name, t))
    return out
