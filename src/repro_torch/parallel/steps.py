"""Step functions (port of the reference's ``parallel/steps.py``): the train
step, and the prefill and decode steps, on one device or sharded over a
``DeviceMesh``.

The reference jits each step with sharded inputs and donates the state or
cache. Here a step runs eagerly; the train step updates the train state in
place and the decode step the cache, which takes the place of buffer
donation. On the card without a mesh the decode step is captured once as a
CUDA graph and replayed (:class:`ServeStep`), which takes the place of jit.

``mesh=None`` is the one-device path. With a ``mesh`` and a rule set
(:mod:`repro_torch.parallel.sharding`), the state, the batch and the cache
are DTensors placed by the rules (:func:`place_train_state`,
:func:`place_batch`, :func:`init_cache`), and the step runs inside
:func:`sharding_ctx` (so the model's ``constrain_logical`` calls take
effect) and under DTensor's implicit replication (a plain tensor the model
makes, a position table or a mask, joins as replicated). DTensor's sharding
propagation then runs each op on the local shards with the collectives the
layouts need, and the kernels through their custom ops' sharding rules.
Returned metrics and logits are gathered (the reference's replicated
outputs); nothing else is.
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.kernels.decode_attention.kernel import decode_attention_kernel
from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_kernel,
                                                        flash_attention_kernel)
from repro_torch.kernels.mla_decode.kernel import mla_decode_kernel
from repro_torch.kernels.rglru.kernel import lru_scan_kernel
from repro_torch.kernels.ssd.kernel import ssd_kernel
from repro_torch.models import model as M
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.ctx import sharding_ctx
from repro_torch.train.optimizer import (OptConfig, adamw_update, init_opt, tree_leaves,
                                         tree_map, tree_unflatten)

__all__ = ["init_train_state", "abstract_train_state", "train_state_shardings",
           "place_train_state", "batch_struct", "abstract_batch", "batch_shardings",
           "place_batch", "place_params", "init_cache", "make_train_step",
           "make_prefill_step", "make_serve_step", "ServeStep", "LAUNCH_COUNTERS"]

_fit_pspec = shd.fit_pspec       # the reference's name for the divisibility fit


def _sharded(mesh, rules):
    """The context a sharded step runs in (none without a mesh)."""
    if mesh is None:
        return contextlib.nullcontext()
    if rules is None:
        raise ValueError("a mesh needs a rule set (repro_torch.parallel.sharding.RULES)")
    stack = contextlib.ExitStack()
    stack.enter_context(sharding_ctx(mesh, rules))
    stack.enter_context(implicit_replication())
    return stack


# -------------------------------------------------------------- train state
def train_state_shardings(cfg, mesh, rules) -> dict:
    """Placements of the train state: params by their ParamSpecs, both
    moments alike, the step replicated."""
    pl = shd.param_placements(M.param_shapes(cfg), rules, mesh)
    return {"params": pl, "opt": {"mu": pl, "nu": pl},
            "step": (Replicate(),) * mesh.ndim}


def init_train_state(cfg, generator: torch.Generator, dtype=torch.float32,
                     opt: OptConfig | None = None, device="cpu", *, mesh=None,
                     rules=None) -> dict:
    """f32 master params drawn from ``generator`` (which lives on ``device``),
    zero moments and step 0: {"params", "opt": {"mu", "nu"}, "step"}. With a
    mesh, every rank draws the same full params and keeps its shards."""
    params = M.init_params(cfg, generator, dtype, device)
    state = {"params": params, "opt": init_opt(params, opt),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    return state if mesh is None else place_train_state(state, cfg, mesh, rules)


def place_train_state(state: dict, cfg, mesh, rules) -> dict:
    """A full train state (the same on every rank) as DTensors placed by
    :func:`train_state_shardings`; no collective runs."""
    return shd.place_tree(state, train_state_shardings(cfg, mesh, rules), mesh)


def abstract_train_state(cfg, dtype=torch.float32, opt: OptConfig | None = None, *,
                         mesh=None, rules=None) -> dict:
    """The train state's structure, shapes and dtypes on the ``meta`` device
    (nothing allocated), for restoring a checkpoint into; with a mesh, as
    meta DTensors carrying the state's placements."""
    state = init_train_state(cfg, None, dtype, opt, device="meta")
    if mesh is None:
        return state
    return tree_map(lambda t, pl: shd.placed_zeros(tuple(t.shape), t.dtype, pl, mesh, "meta"),
                    state, train_state_shardings(cfg, mesh, rules))


# ------------------------------------------------------------------ batches
def batch_struct(cfg, global_batch: int, seq_len: int, *, dtype=None) -> dict:
    """One training or prefill batch on the ``meta`` device: the tokens
    (vlm: seq_len - frontend_tokens of them) and a frontend's embeddings."""
    dt = M.compute_dtype(cfg) if dtype is None else dtype
    F = cfg.frontend_tokens
    text = seq_len - F if cfg.family == "vlm" else seq_len
    b = {"tokens": torch.empty((global_batch, text), dtype=torch.int64, device="meta")}
    if cfg.family in M.FRONTEND_KEYS:
        b[M.FRONTEND_KEYS[cfg.family]] = torch.empty((global_batch, F, cfg.d_model),
                                                     dtype=dt, device="meta")
    return b


def abstract_batch(cfg, global_batch: int, seq_len: int, *, microbatches: int = 1,
                   dtype=None) -> dict:
    """:func:`batch_struct`, split into (microbatches, B / microbatches, ...)."""
    b = batch_struct(cfg, global_batch, seq_len, dtype=dtype)
    if microbatches > 1:
        if global_batch % microbatches:
            raise ValueError(f"global_batch {global_batch} is not a multiple of "
                             f"microbatches {microbatches}")
        b = {k: v.reshape(microbatches, global_batch // microbatches, *v.shape[1:])
             for k, v in b.items()}
    return b


def batch_shardings(cfg, mesh, rules, *, microbatches: int = 1) -> dict:
    """Partition specs of a batch's inputs (the reference's, as canonical
    tuples): the batch dim (dim 1 under microbatches) over the batch's mesh
    axes."""
    dp = shd.batch_pspec(rules)[0]
    spec = ((None,) if microbatches > 1 else ()) + (dp,)
    while spec and spec[-1] is None:         # the canonical form
        spec = spec[:-1]
    return {k: spec for k in ["tokens"] + ([M.FRONTEND_KEYS[cfg.family]]
                                           if cfg.family in M.FRONTEND_KEYS else [])}


def place_batch(batch: dict, mesh, rules) -> dict:
    """One (micro)batch of full tensors as DTensors: the batch dim over the
    batch's mesh axes where it divides them (a batch of 1 replicates)."""
    dp = shd.batch_pspec(rules)
    return {k: shd.place(v, shd.to_placements(shd.fit_pspec(dp, tuple(v.shape), mesh),
                                              mesh), mesh)
            for k, v in batch.items()}


# -------------------------------------------------------------- train step
def make_train_step(cfg, *, opt: OptConfig | None = None, microbatches: int = 1,
                    mesh=None, rules=None, unroll_mb: bool = False,
                    bf16_params: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch["tokens"]`` is (B, S), or (microbatches, B / microbatches, S)
    when ``microbatches > 1``: the loss and the gradients are then averaged
    over the microbatches, as the reference's accumulation scan does. The
    loss runs with activations in ``cfg.dtype`` on the f32 master params
    (each weight is cast where it is used, so its gradient flows back in
    f32); AdamW then updates the state in place. ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr`` as 0-d f32 tensors on the device: reading them
    is the only synchronisation, and the caller chooses when.

    ``bf16_params`` (mixed precision, as the reference's): every f32 master
    is cast to the compute dtype once before each microbatch's forward, on
    its shard, so every weight read (and every FSDP gather) moves the
    compute dtype; the gradients flow back through the cast into the f32
    masters, which AdamW updates. ``unroll_mb`` is accepted for the
    reference's signature and changes nothing: the microbatch loop here is
    a Python loop already, which is what it asks for.

    With a ``mesh``, ``state`` is placed by :func:`place_train_state` and the
    plain batch is placed by :func:`place_batch`; each gradient is reduced
    to its param's layout before AdamW. Every family trains: a vlm batch
    carries ``vision_embeds`` and an audio batch ``audio_embeds`` beside the
    tokens. On the card each kernel's custom op gives its gradient (flash
    attention and the SSD scan by a plain recompute, the RG-LRU scan by a
    reversed scan through its kernel). A family the port does not have
    raises from ``layer_kinds``."""
    tfm.layer_kinds(cfg)
    opt = opt or OptConfig()
    cdt = M.compute_dtype(cfg)
    del unroll_mb

    def loss_of(params, mb):
        if bf16_params:
            params = tree_map(lambda p: p.to(cdt) if p.dtype == torch.float32 else p,
                              params)
        return M.loss_fn(params, cfg, mb)

    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        mbs = [batch] if microbatches == 1 else \
            [{k: v[i] for k, v in batch.items()} for i in range(microbatches)]
        loss = None
        with _sharded(mesh, rules):
            for mb in mbs:
                if mesh is not None:
                    mb = place_batch(mb, mesh, rules)
                # backward sums each microbatch's gradient into the leaf's .grad
                # as it is made, so one set of gradients is held, not two
                l = loss_of(params, mb)
                l.backward()
                loss = l.detach() if loss is None else loss + l.detach()
            grads = [_like(t.grad.float(), t) for t in leaves]
            for t in leaves:
                t.grad = None
            if microbatches > 1:
                loss = loss * (1.0 / microbatches)
                for acc in grads:
                    acc.mul_(1.0 / microbatches)
            grad_tree = tree_unflatten(params, grads)
            _, _, om = adamw_update(grad_tree, state["opt"], params, opt, state["step"])
            state["step"] += 1
            metrics = {"loss": loss, **om}
            return state, {k: shd.full(v) for k, v in metrics.items()}

    return train_step


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its param's layout: a partial sum reduced (all-reduce,
    or reduce-scatter onto a sharded param)."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


# -------------------------------------------------------------- serve steps
def init_cache(cfg, batch: int, max_len: int, device="cpu", *, mesh=None,
               rules=None) -> dict:
    """A zero decode cache; with a mesh, DTensors placed by the reference's
    ``cache_pspecs``, each rank allocating only its shard."""
    if mesh is None:
        return M.init_cache(cfg, batch, max_len, device=device)
    shapes = M.cache_shapes(cfg, batch, max_len)
    pspecs = shd.cache_pspecs(shapes, rules, mesh, cfg)
    return tree_map(lambda sd, ps: shd.placed_zeros(sd[0], sd[1], shd.to_placements(ps, mesh),
                                                    mesh, device),
                    shapes, pspecs, is_leaf=lambda x: isinstance(x, tuple))


def _grad_off(mesh):
    # inference_mode tensors may not enter a DTensor redistribution's
    # autograd-aware collectives; the sharded path turns grad off instead
    return torch.inference_mode() if mesh is None else torch.no_grad()


def make_prefill_step(cfg, *, max_len: int, mesh=None, rules=None):
    """Returns prefill_step(params, batch) -> (logits (B, V) f32, cache).
    With a mesh, ``params`` are placed (:func:`place_params`), the batch is
    placed here, the cache comes out in ``cache_pspecs``' layout and the
    logits are gathered."""

    def prefill_step(params, batch):
        with _grad_off(mesh), _sharded(mesh, rules):
            if mesh is None:
                return M.prefill(params, cfg, batch, max_len)
            logits, cache = M.prefill(params, cfg, place_batch(batch, mesh, rules), max_len)
            B = batch["tokens"].shape[0]
            pspecs = shd.cache_pspecs(M.cache_shapes(cfg, B, max_len), rules, mesh, cfg)
            cache = tree_map(lambda t, ps: t.redistribute(mesh, shd.to_placements(ps, mesh)),
                             cache, pspecs)
            return shd.full(logits), cache

    return prefill_step


def make_serve_step(cfg, *, mesh=None, rules=None) -> "ServeStep":
    """Returns serve_step(params, cache, tokens, pos) -> (logits (B, V) f32,
    cache); ``cache`` is updated in place (with a mesh, each rank writes its
    own shard; the logits are gathered). On the card without a mesh the step
    is replayed as a CUDA graph (:class:`ServeStep`)."""
    return ServeStep(cfg, mesh=mesh, rules=rules)


def _graph_key(params, cache, tokens, pos) -> tuple:
    """What a captured decode step is bound to: the input shapes and dtypes,
    the params (by identity) and the cache leaves' addresses."""
    return (id(params), tuple(t.data_ptr() for t in tree_leaves(cache)),
            tokens.device, tuple(tokens.shape), tokens.dtype, tuple(pos.shape), pos.dtype)


# The kernel wrappers' launch counters. A wrapper counts when it is called,
# so it counts a capture, which runs nothing on the card, and not a replay,
# which launches through no wrapper: ServeStep moves the capture's counts to
# its replays.
LAUNCH_COUNTERS = ((decode_attention_kernel, "launches"),
                   (decode_attention_kernel, "combine_launches"),
                   (mla_decode_kernel, "launches"), (mla_decode_kernel, "combine_launches"),
                   (flash_attention_kernel, "launches"),
                   (flash_attention_bwd_kernel, "launches"),
                   (lru_scan_kernel, "launches"), (ssd_kernel, "launches"))


def _launch_counts() -> list[int]:
    return [getattr(fn, name) for fn, name in LAUNCH_COUNTERS]


def _add_launches(counts: list[int]) -> None:
    for (fn, name), n in zip(LAUNCH_COUNTERS, counts):
        setattr(fn, name, getattr(fn, name) + n)


class ServeStep:
    """The decode step of :func:`make_serve_step`.

    On a CUDA device without a mesh, when the model's decode step reads
    nothing back on the host (``moe.decode_reads_host``), the first call for
    a key (:func:`_graph_key`) runs the step eagerly, which is the step's
    result and builds every kernel, then captures ``M.decode_step`` on static
    copies of ``tokens`` and ``pos`` into a CUDA graph. Every later call with
    that key copies its ``tokens`` and ``pos`` into those buffers, replays the
    graph, which writes the cache in place at the addresses it was captured
    on, and returns a copy of the graph's logits, so logits held across
    steps stay as they were. Another key (another cache, batch or params)
    captures again, in place of the old graph. On the CPU, with a mesh
    (DTensors), or for a decode step that reads the host, the step runs
    eagerly every call.

    ``captures`` and ``replays`` count the graph's captures and replays. The
    kernel wrappers' launch counts (``LAUNCH_COUNTERS``) count the launches
    that run: the eager step's and each replay's, not the capture's."""

    def __init__(self, cfg, *, mesh=None, rules=None):
        self.cfg, self.mesh, self.rules = cfg, mesh, rules
        self.captures = self.replays = 0
        self._key = self._graph = self._params = None

    def __call__(self, params, cache, tokens, pos):
        cfg, mesh = self.cfg, self.mesh
        with _grad_off(mesh), _sharded(mesh, self.rules):
            if mesh is not None:
                placed = place_batch({"tokens": tokens, "pos": pos}, mesh, self.rules)
                logits, cache = M.decode_step(params, cfg, cache, placed["tokens"],
                                              placed["pos"])
                return shd.full(logits), cache
            if (tokens.device.type != "cuda"
                    or moe_mod.decode_reads_host(cfg, M.compute_dtype(cfg))):
                return M.decode_step(params, cfg, cache, tokens, pos)
            key = _graph_key(params, cache, tokens, pos)
            if key != self._key:
                return self._capture(key, params, cache, tokens, pos)
            graph, static_tokens, static_pos, logits, launches = self._graph
            static_tokens.copy_(tokens)
            static_pos.copy_(pos)
            graph.replay()
            _add_launches(launches)
            self.replays += 1
            return logits.clone(), cache

    def _capture(self, key, params, cache, tokens, pos):
        self._key = self._graph = self._params = None    # the old graph's memory goes first
        logits, cache = M.decode_step(params, self.cfg, cache, tokens, pos)
        static_tokens, static_pos = tokens.clone(), pos.clone()
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static_logits, _ = M.decode_step(params, self.cfg, cache, static_tokens, static_pos)
        launches = [n - b for n, b in zip(_launch_counts(), before)]
        _add_launches([-n for n in launches])     # the capture launched nothing
        # the params are held so that their id in the key stays theirs
        self._key, self._params = key, params
        self._graph = (graph, static_tokens, static_pos, static_logits, launches)
        self.captures += 1
        return logits, cache


def place_params(params: dict, cfg, mesh, rules) -> dict:
    """Full params (the same on every rank) as DTensors placed by their
    ParamSpecs; no collective runs."""
    return shd.place_tree(params, shd.param_placements(M.param_shapes(cfg), rules, mesh),
                          mesh)
