"""Serving engine: continuous batching over a persistent KV cache (port of
``repro.serve.engine``).

The engine owns ``max_batch`` decode slots. Requests queue FIFO; a free
slot triggers a batch-1 prefill whose per-layer cache is spliced into row b
of the batched cache (stacked (L, B, ...) leaves, or (B, ...) leaves per
unrolled layer); every ``step()`` advances all active slots
by one token, each at its own position. Finished slots free at once and the
next request is admitted. Decoding is greedy (first index on ties, as
``jnp.argmax``). A vlm or audio prefill gets zero frontend embeddings, as
in the reference; a vlm slot's positions count the vision prefix.

With a ``mesh`` and a rule set (the reference's serving rules are
``make_rules(multi_pod=False, tp2d=True)``) the weights are placed by their
ParamSpecs, the cache by ``cache_pspecs``, and the steps run sharded
(:mod:`repro_torch.parallel.steps`); a prefill's row is spliced into each
rank's own cache shard, so the cache is never gathered.

Each request and step is recorded in :data:`repro_torch.obs.RECORDER`:
``serve.step`` (the step's index, the queue's length and the active slots at
its start, the requests it admitted); per admitted request, children of its
step, ``serve.request.queued`` (``submit()`` to its prefill),
``serve.request.prefill`` (its batch, the prefill, the splice and the first
token read on the host) and ``serve.request.hold`` (that read to the step's
return); and ``serve.decode`` (the decode call to its tokens on the host).
Spans end at host reads the engine makes anyway or at the step's return, so
the recording adds no synchronisation and no device work.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.parallel.sharding import index_put_local
from repro_torch.parallel.steps import (init_cache, make_prefill_step, make_serve_step,
                                        place_params)

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    generated: list[int] = field(default_factory=list)
    done: bool = False


@dataclass
class _Slot:
    active: bool = False
    rid: int | None = None
    pos: int = 0                 # absolute position of the NEXT token to write
    budget: int = 0


class ServeEngine:
    def __init__(self, cfg, params, *, max_batch: int = 4, max_len: int = 256,
                 device: str | torch.device = "cuda", mesh=None, rules=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params if mesh is None else place_params(params, cfg, mesh, rules)
        self.max_batch, self.max_len = max_batch, max_len
        self.prefill = make_prefill_step(cfg, max_len=max_len, mesh=mesh, rules=rules)
        self.decode = make_serve_step(cfg, mesh=mesh, rules=rules)
        self.cache = init_cache(cfg, max_batch, max_len, self.device, mesh=mesh, rules=rules)
        self._slot_bytes = M.attended_slot_bytes(cfg, max_len)
        self.slots = [_Slot() for _ in range(max_batch)]
        self.queue: list[Request] = []
        self.requests: dict[int, Request] = {}
        self._ids = itertools.count()
        self._submitted: dict[int, int] = {}    # rid -> obs.now() at submit()
        self.steps_run = 0

    # ------------------------------------------------------------- requests
    def submit(self, prompt: list[int], *, max_new_tokens: int = 16,
               eos_id: int | None = None) -> int:
        rid = next(self._ids)
        req = Request(rid, list(prompt), max_new_tokens, eos_id)
        self.requests[rid] = req
        self.queue.append(req)
        self._submitted[rid] = obs.now()
        return rid

    # -------------------------------------------------------------- interns
    def _splice(self, row_cache: dict, b: int) -> None:
        """Copy a batch-1 prefill cache into cache row ``b``. Under
        ``cache["layers"]`` a tensor is a stacked (L, B, ...) leaf; a dict is
        one unrolled layer, whose leaves are (B, ...): K/V, conv and state
        leaves, or an MLA layer's latent slots (``ckv``, (B, max_len, C +
        R)), all alike. A sharded leaf is written on each rank's shard
        (``index_put_local``)."""
        rows = torch.tensor([b], device=self.device)
        with torch.no_grad():
            for name, full in self.cache["layers"].items():
                row = row_cache["layers"][name]
                if isinstance(full, dict):
                    for leaf, t in full.items():
                        index_put_local(t, (rows,), row[leaf][0:1])
                else:
                    L = full.shape[0]
                    index_put_local(full, (torch.arange(L, device=self.device),
                                           rows.expand(L)), row[:, 0])

    def prefill_batch(self, prompt: list[int]) -> dict:
        """A batch-1 prefill input: the prompt's tokens and, for vlm or
        audio, zero frontend embeddings (1, frontend_tokens, d_model) in
        the compute dtype."""
        batch = {"tokens": torch.tensor([prompt], dtype=torch.long, device=self.device)}
        if self.cfg.family in M.FRONTEND_KEYS:
            batch[M.FRONTEND_KEYS[self.cfg.family]] = torch.zeros((1, self.cfg.frontend_tokens, self.cfg.d_model),
                                          dtype=M.compute_dtype(self.cfg), device=self.device)
        return batch

    def _admit(self, step_id: int) -> list[tuple[int, int]]:
        """Prefill queued requests into free slots; returns (rid, time of
        its first token on the host) per request admitted."""
        rec, firsts = obs.RECORDER, []
        for slot_id, slot in enumerate(self.slots):
            if slot.active or not self.queue:
                continue
            req = self.queue.pop(0)
            t = obs.now()
            rec.record("serve.request.queued", self._submitted.pop(req.rid), t,
                       parent=step_id, rid=req.rid)
            logits, row_cache = self.prefill(self.params, self.prefill_batch(req.prompt))
            self._splice(row_cache, slot_id)
            first = int(torch.argmax(logits[0]))
            t_first = obs.now()
            rec.record("serve.request.prefill", t, t_first, parent=step_id, rid=req.rid,
                       tokens=len(req.prompt))
            firsts.append((req.rid, t_first))
            req.generated.append(first)
            F = self.cfg.frontend_tokens if self.cfg.family == "vlm" else 0
            slot.active, slot.rid = True, req.rid
            slot.pos = F + len(req.prompt)  # next write position
            slot.budget = req.max_new_tokens - 1
            if slot.budget <= 0 or first == req.eos_id:
                req.done, slot.active = True, False
        return firsts

    def _decode(self, step_id: int) -> None:
        """One decode step over every active slot."""
        tokens = np.zeros((self.max_batch, 1), np.int64)
        pos = np.zeros((self.max_batch,), np.int64)
        active = contexts = cache_bytes = 0
        for i, slot in enumerate(self.slots):
            if slot.active:
                tokens[i, 0] = self.requests[slot.rid].generated[-1]
                pos[i] = slot.pos
                active += 1
                contexts += slot.pos + 1
                cache_bytes += sum(n * (min(slot.pos + 1, cap) if cap else 1)
                                   for cap, n in self._slot_bytes.items())
        tokens = torch.from_numpy(tokens).to(self.device)
        pos = torch.from_numpy(pos).to(self.device)
        t = obs.now()
        logits, self.cache = self.decode(self.params, self.cache, tokens, pos)
        self.steps_run += 1
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        obs.RECORDER.record("serve.decode", t, obs.now(), parent=step_id, active=active,
                            contexts=contexts, cache_bytes=cache_bytes)
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            req = self.requests[slot.rid]
            tok = int(nxt[i])
            req.generated.append(tok)
            slot.pos += 1
            slot.budget -= 1
            if slot.budget <= 0 or tok == req.eos_id or \
                    slot.pos >= self.max_len - 1:
                req.done, slot.active = True, False

    # ----------------------------------------------------------------- step
    def step(self) -> bool:
        """Admit + one decode step. Returns True while work remains."""
        rec = obs.RECORDER
        rec.anchor()
        t0, step_id = obs.now(), rec.new_id()
        index, queued = self.steps_run, len(self.queue)
        active = sum(s.active for s in self.slots)
        firsts = self._admit(step_id)
        if any(s.active for s in self.slots):
            self._decode(step_id)
            more = True
        else:
            more = bool(self.queue)
        t1 = obs.now()
        for rid, t in firsts:
            rec.record("serve.request.hold", t, t1, parent=step_id, rid=rid)
        rec.record("serve.step", t0, t1, span_id=step_id, index=index, queue=queued,
                   active=active, admitted=len(firsts))
        return more

    def run(self, max_steps: int = 10_000) -> list[Request]:
        for _ in range(max_steps):
            if not self.step() and not any(s.active for s in self.slots):
                break
        return [self.requests[r] for r in sorted(self.requests)]
