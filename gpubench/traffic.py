"""The general traffic generator. A traffic mix is a file of parameters
(``gpubench/workloads/<cell>.json``); this module turns it and a seed into
requests or token batches.

Sizes and gaps are stratified: each block of ``block`` consecutive requests
holds the same multiset of values, the quantiles (i + 0.5) / block of the
stated distribution, shuffled within the block by the seed. So every seed
offers the same work in another order, and any prefix of the stream has
nearly the same mix: two seeds differ by the order and the tokens, not by
how much there is to do.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass

import numpy as np

__all__ = ["Request", "quantile_values", "stratified", "make_requests", "arrival_times",
           "train_tokens"]


@dataclass(frozen=True)
class Request:
    index: int
    due_s: float              # offset from the start of the traffic
    prompt: tuple[int, ...]
    max_new_tokens: int


def quantile_values(dist: dict, n: int) -> list[int | float]:
    """The quantiles (i + 0.5) / n, i < n, of ``dist``: ``{"lognormal":
    {"median", "sigma", "min", "max"}}`` (rounded to whole numbers, then
    clipped) or ``{"exponential": {"mean"}}``."""
    qs = [(i + 0.5) / n for i in range(n)]
    if "lognormal" in dist:
        d = dist["lognormal"]
        z = statistics.NormalDist()
        vals = [d["median"] * math.exp(d["sigma"] * z.inv_cdf(q)) for q in qs]
        return [int(min(d["max"], max(d["min"], round(v)))) for v in vals]
    if "exponential" in dist:
        mean = dist["exponential"]["mean"]
        return [-mean * math.log1p(-q) for q in qs]
    raise ValueError(f"unknown distribution {sorted(dist)}")


def stratified(dist: dict, n: int, block: int, rng: np.random.Generator) -> list:
    """``n`` values: blocks of ``quantile_values(dist, block)``, each block
    shuffled by ``rng``."""
    base = quantile_values(dist, block)
    out: list = []
    while len(out) < n:
        out.extend(base[i] for i in rng.permutation(block))
    return out[:n]


def arrival_times(arrivals: dict, n: int, block: int, rng: np.random.Generator) -> list[float]:
    """Due times (s from the traffic's start) of ``n`` requests: ``{"kind":
    "poisson", "rate": r}`` (exponential gaps of mean 1 / r, stratified) or
    ``{"kind": "backlog"}`` (all due at 0)."""
    if arrivals["kind"] == "backlog":
        return [0.0] * n
    if arrivals["kind"] == "poisson":
        gaps = stratified({"exponential": {"mean": 1.0 / arrivals["rate"]}}, n, block, rng)
        return list(np.cumsum(gaps))
    raise ValueError(f"unknown arrivals {arrivals['kind']!r}")


def make_requests(mix: dict, n: int, vocab: int, seed: int) -> list[Request]:
    """``n`` requests of a serving mix, from ``seed``: due times, prompt and
    output lengths stratified as the module says, prompt tokens uniform over
    [1, vocab - 1)."""
    rng = np.random.Generator(np.random.PCG64([seed, 0x5E12E]))
    block = mix["block"]
    due = arrival_times(mix["arrivals"], n, block, rng)
    plen = stratified(mix["prompt_len"], n, block, rng)
    olen = stratified(mix["output_len"], n, block, rng)
    tokens = rng.integers(1, vocab - 1, size=int(sum(plen)))
    out, at = [], 0
    for i in range(n):
        out.append(Request(i, float(due[i]), tuple(int(t) for t in tokens[at:at + plen[i]]),
                           int(olen[i])))
        at += plen[i]
    return out


def train_tokens(mix: dict, seed: int, step: int, vocab: int, device):
    """Step ``step``'s token batch (rows, seq) of a training mix, made on
    ``device`` from (``seed``, ``step``): every step's rows differ. Ids follow
    a Zipf-like law of exponent ``zipf`` (k = floor(u^(-1 / (zipf - 1))),
    folded into [1, vocab - 1)), as natural text's unigrams roughly do."""
    import torch
    gen = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + step) % (1 << 63))
    u = torch.rand((mix["rows"], mix["seq"]), generator=gen, device=device, dtype=torch.float64)
    k = torch.floor(u.clamp_min(1e-300) ** (-1.0 / (mix["zipf"] - 1.0)))
    return (torch.remainder(k - 1, vocab - 2) + 1).long()
