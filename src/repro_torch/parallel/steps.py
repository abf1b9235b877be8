"""Serving step functions on one device (port of the reference's
``parallel/steps.py::make_prefill_step`` and ``make_serve_step``).

The reference jits each step with sharded inputs and donates the cache.
Here a step runs eagerly under ``torch.inference_mode`` and the decode step
updates the cache in place, which takes the place of buffer donation. No
sharding is ported: on one card ``constrain_logical`` is the identity.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M

__all__ = ["make_prefill_step", "make_serve_step"]


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
