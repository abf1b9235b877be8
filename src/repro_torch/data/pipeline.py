"""Synthetic data pipeline: deterministic LM batches + prefetch (port of
``repro.data.pipeline``).

Tokens are drawn per (seed, step, host) with numpy's PCG64 and the same
zipf-ish marginal as the reference, so both packages see the same tokens,
token for token, and a resumed run sees the batches it would have seen.
The vlm and audio families also get their frontend's embeddings from the
same generator, after the tokens, as the reference draws them. Batches are
CPU tensors; the loop moves them to the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.model import FRONTEND_KEYS

__all__ = ["make_batch", "synthetic_batches", "Prefetcher", "data_iterator"]


def make_batch(cfg, global_batch: int, seq_len: int, *, seed: int, step: int,
               host: int = 0, num_hosts: int = 1) -> dict:
    """One batch shard for `host` of `num_hosts` (full batch if 1 host):
    {"tokens": (b, seq_len) int64} with b = global_batch // num_hosts; for
    vlm the tokens are seq_len - frontend_tokens long and ``vision_embeds``
    (b, frontend_tokens, d_model) float32 come with them, for audio
    ``audio_embeds`` of that shape."""
    if global_batch % num_hosts:
        raise ValueError(f"global_batch {global_batch} is not a multiple of "
                         f"num_hosts {num_hosts}")
    local = global_batch // num_hosts
    rng = np.random.Generator(np.random.PCG64([seed, step, host]))
    F = cfg.frontend_tokens
    text = seq_len - F if cfg.family == "vlm" else seq_len
    z = rng.zipf(1.3, size=(local, text)).astype(np.int64)
    batch = {"tokens": torch.from_numpy((z % (cfg.vocab_size - 2)) + 1)}
    if cfg.family in FRONTEND_KEYS:
        batch[FRONTEND_KEYS[cfg.family]] = torch.from_numpy(
            rng.standard_normal((local, F, cfg.d_model), dtype=np.float32) * 0.02)
    return batch


def synthetic_batches(cfg, global_batch: int, seq_len: int, *, seed: int = 0,
                      start_step: int = 0, host: int = 0,
                      num_hosts: int = 1) -> Iterator[dict]:
    step = start_step
    while True:
        yield make_batch(cfg, global_batch, seq_len, seed=seed, step=step,
                         host=host, num_hosts=num_hosts)
        step += 1


class Prefetcher:
    """Background-thread prefetch of a batch iterator."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                if self._done:
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._done = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def data_iterator(cfg, global_batch: int, seq_len: int, *, seed: int = 0,
                  start_step: int = 0, prefetch: int = 2) -> Iterator[dict]:
    return Prefetcher(
        synthetic_batches(cfg, global_batch, seq_len, seed=seed,
                          start_step=start_step), depth=prefetch)
