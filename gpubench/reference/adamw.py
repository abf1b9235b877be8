"""AdamW as the training job states it (its workload file's ``optimizer``):
linear warmup of the learning rate over ``warmup_steps``, the gradient
clipped to ``clip_norm`` by its global norm, bias-corrected moments, and
decoupled weight decay on every leaf; float32 throughout."""

from __future__ import annotations

import torch

__all__ = ["adamw_step"]


@torch.no_grad()
def adamw_step(params: list, grads: list, mu: list, nu: list, step: int, hp: dict) -> list:
    """One step at ``step`` (steps taken so far) over matching lists of
    tensors, in place. Returns the gradients as the moments took them
    (after clipping)."""
    gn = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)).item()
    scale = min(1.0, hp["clip_norm"] / max(gn, 1e-9))
    lr = hp["lr"] * min(1.0, (step + 1) / max(hp["warmup_steps"], 1))
    c1, c2 = 1 - hp["b1"] ** (step + 1), 1 - hp["b2"] ** (step + 1)
    taken = []
    for p, g, m, v in zip(params, grads, mu, nu):
        g = g.float() * scale
        m.mul_(hp["b1"]).add_(g, alpha=1 - hp["b1"])
        v.mul_(hp["b2"]).add_(g * g, alpha=1 - hp["b2"])
        p.sub_(lr * ((m / c1) / (torch.sqrt(v / c2) + hp["eps"]) + hp["weight_decay"] * p))
        taken.append(g)
    return taken
