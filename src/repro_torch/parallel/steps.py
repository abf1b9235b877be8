"""Step functions on one device (port of the reference's
``parallel/steps.py``): the train step, and the prefill and decode steps.

The reference jits each step with sharded inputs and donates the state or
cache. Here a step runs eagerly; the train step updates the train state in
place and the decode step the cache, which takes the place of buffer
donation. No sharding is ported: on one card ``constrain_logical`` is the
identity.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.train.optimizer import (OptConfig, adamw_update, init_opt, tree_leaves,
                                         tree_unflatten)

__all__ = ["init_train_state", "abstract_train_state", "make_train_step",
           "make_prefill_step", "make_serve_step"]


# -------------------------------------------------------------- train state
def init_train_state(cfg, generator: torch.Generator, dtype=torch.float32,
                     opt: OptConfig | None = None, device="cpu") -> dict:
    """f32 master params drawn from ``generator`` (which lives on ``device``),
    zero moments and step 0: {"params", "opt": {"mu", "nu"}, "step"}."""
    params = M.init_params(cfg, generator, dtype, device)
    return {"params": params, "opt": init_opt(params, opt),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_train_state(cfg, dtype=torch.float32, opt: OptConfig | None = None) -> dict:
    """The train state's structure, shapes and dtypes on the ``meta`` device
    (nothing allocated), for restoring a checkpoint into."""
    return init_train_state(cfg, None, dtype, opt, device="meta")


# -------------------------------------------------------------- train step
def make_train_step(cfg, *, opt: OptConfig | None = None, microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch["tokens"]`` is (B, S), or (microbatches, B / microbatches, S)
    when ``microbatches > 1``: the loss and the gradients are then averaged
    over the microbatches, as the reference's accumulation scan does. The
    loss runs with activations in ``cfg.dtype`` on the f32 master params
    (each weight is cast where it is used, so its gradient flows back in
    f32); AdamW then updates the state in place. ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr`` as 0-d f32 tensors on the device: reading them
    is the only synchronisation, and the caller chooses when.

    Every family trains: a vlm batch carries ``vision_embeds`` and an audio
    batch ``audio_embeds`` beside the tokens (split into microbatches along
    with them), and :func:`M.loss_fn` reads them. On the card each kernel's
    autograd Function gives its gradient (flash attention and the SSD scan
    by a plain recompute, the RG-LRU scan by a reversed scan through its
    kernel). A family the port does not have raises from ``layer_kinds``."""
    tfm.layer_kinds(cfg)
    opt = opt or OptConfig()

    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        mbs = [batch] if microbatches == 1 else \
            [{k: v[i] for k, v in batch.items()} for i in range(microbatches)]
        loss = None
        for mb in mbs:
            # backward sums each microbatch's gradient into the leaf's .grad
            # as it is made, so one set of gradients is held, not two
            l = M.loss_fn(params, cfg, mb)
            l.backward()
            loss = l.detach() if loss is None else loss + l.detach()
        grads = [t.grad.float() for t in leaves]
        for t in leaves:
            t.grad = None
        if microbatches > 1:
            loss = loss * (1.0 / microbatches)
            for acc in grads:
                acc.mul_(1.0 / microbatches)
        grad_tree = tree_unflatten(params, grads)
        _, _, om = adamw_update(grad_tree, state["opt"], params, opt, state["step"])
        state["step"] += 1
        return state, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg, *, max_len: int):
    """Returns prefill_step(params, batch) -> (logits (B, V) f32, cache)."""

    def prefill_step(params, batch):
        with torch.inference_mode():
            return M.prefill(params, cfg, batch, max_len)

    return prefill_step


def make_serve_step(cfg):
    """Returns serve_step(params, cache, tokens, pos) -> (logits (B, V) f32,
    cache); ``cache`` is updated in place."""

    def serve_step(params, cache, tokens, pos):
        with torch.inference_mode():
            return M.decode_step(params, cfg, cache, tokens, pos)

    return serve_step
