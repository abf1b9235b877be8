"""The training loop: restore → step → checkpoint, with preemption (port of
``repro.train.loop``).

OAR-aware without importing OAR: ``preempt_check`` is any callable; a
cluster runner wires it to the job's cancel flag, so a best-effort training
job checkpoints and yields within one step of the scheduler asking for its
resources, and resumes where it stopped.

With a ``mesh`` and a rule set the state lives in DTensors placed by the
rules and the step runs sharded (:mod:`repro_torch.parallel.steps`); every
rank draws the same global batch, and the step places its shards. A
checkpoint holds the full arrays whatever the layout, so a job saved on
one mesh resumes on another, or on one device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.data.pipeline import data_iterator
from repro_torch.device import resolve_device
from repro_torch.parallel.steps import (abstract_train_state, init_train_state,
                                        make_train_step)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig

__all__ = ["TrainResult", "train_loop"]


@dataclass
class TrainResult:
    status: str                 # done | preempted
    step: int
    metrics: dict = field(default_factory=dict)
    history: list = field(default_factory=list)


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               ckpt_dir: str | None = None, ckpt_every: int = 100, keep: int = 3,
               seed: int = 0, opt: OptConfig | None = None, microbatches: int = 1,
               log_every: int = 10,
               preempt_check: Callable[[], bool] | None = None,
               on_metrics: Callable[[int, dict], None] | None = None,
               device: str | torch.device = "cuda", mesh=None, rules=None) -> TrainResult:
    """Train ``cfg`` on ``device`` up to step ``steps``. Resumes from the
    newest checkpoint in ``ckpt_dir``, else starts from params drawn by a
    ``torch.Generator`` on the device seeded with ``seed``. Metrics are read
    back (a synchronisation) only at the logged steps: every ``log_every``,
    the first and the last."""
    device = resolve_device(device)
    if global_batch % microbatches:
        raise ValueError(f"global_batch {global_batch} is not a multiple of "
                         f"microbatches {microbatches}")
    train_step = make_train_step(cfg, opt=opt, microbatches=microbatches, mesh=mesh,
                                 rules=rules)
    state, start = None, 0
    if ckpt_dir:
        state, restored = ckpt.restore_latest(
            ckpt_dir, abstract_train_state(cfg, opt=opt, mesh=mesh, rules=rules), device)
        if restored is not None:
            start = restored
    if state is None:
        state = init_train_state(cfg, torch.Generator(device=device).manual_seed(seed),
                                 opt=opt, device=device, mesh=mesh, rules=rules)

    it = data_iterator(cfg, global_batch, seq_len, seed=seed, start_step=start)
    history, metrics = [], {}
    t0 = time.perf_counter()
    try:
        for step in range(start, steps):
            if preempt_check is not None and preempt_check():
                if ckpt_dir:
                    ckpt.save(ckpt_dir, state, step, keep=keep)
                return TrainResult("preempted", step,
                                   {k: float(v) for k, v in metrics.items()}, history)
            batch = {k: v.to(device, non_blocking=True) for k, v in next(it).items()}
            if microbatches > 1:
                batch = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                      *v.shape[1:]) for k, v in batch.items()}
            state, metrics = train_step(state, batch)
            if step % log_every == 0 or step == steps - 1 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["sec_per_step"] = (time.perf_counter() - t0) / max(1, step - start + 1)
                history.append(m)
                if on_metrics:
                    on_metrics(step, m)
            if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
                ckpt.save(ckpt_dir, state, step + 1, keep=keep)
        if ckpt_dir:
            ckpt.save(ckpt_dir, state, steps, keep=keep)
        return TrainResult("done", steps,
                           {k: float(v) for k, v in metrics.items()}, history)
    finally:
        it.close()
