"""Cluster runner: the bridge between the OAR control plane and the port's
data plane (port of ``repro.launch.cluster``).

A job's ``command`` column carries a JSON spec::

    {"kind": "train", "arch": "tiny", "steps": 200, "global_batch": 8,
     "seq_len": 128, "ckpt_dir": "/tmp/job7"}

The keys the runner reads, with their defaults: ``arch`` ("tiny"),
``smoke`` (true: the arch's smoke config; false: its published width),
``steps`` (100), ``global_batch`` (8), ``seq_len`` (128), ``ckpt_dir``
(none), ``ckpt_every`` (50) and ``log_every`` (20); the Executor adds
``idJob``. A spec of another ``kind`` is not the runner's.

A :class:`ClusterRunner` is plugged into ``Executor(runner=...)`` by code
that imports both packages (``executor.runner = ClusterRunner(db,
executor)``): when the launcher moves a job to Running it hands the spec to
a worker thread of this process, which runs the port's training loop on
the runner's device. The loop's ``preempt_check`` polls the job's
``toCancel`` flag through the database, so the scheduler's §3.3
best-effort preemption checkpoints and yields within one step; completion
calls back into the Executor, which frees the resources through the
database like any other job.

The runner takes ``db`` and ``executor`` as it is given them and calls only
``db.query_one(sql, args)`` and ``executor.complete(job_id, ok=...,
message=...)``, so it imports nothing of the control plane. As the
reference's, it trains each job under its ``default_rules`` (sharding
rules; ``make_rules(multi_pod=False)`` unless given) on a ``(data, model)``
mesh over its process's ranks on its device: one rank in a plain process
(the mesh starts a one-rank group, built once and shared by the jobs),
the world under ``torchrun``.
"""

from __future__ import annotations

import threading

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.parallel.sharding import make_rules
from repro_torch.train.loop import train_loop

__all__ = ["ClusterRunner"]


class ClusterRunner:
    """Runs 'train' job specs on ``device``, one thread per job."""

    def __init__(self, db, executor, *, default_rules=None,
                 device: str | torch.device = "cuda"):
        self.db = db
        self.executor = executor
        self.rules = default_rules or make_rules(multi_pod=False)
        self.device = resolve_device(device)
        self._mesh = None
        self._mesh_lock = threading.Lock()
        self.threads: dict[int, threading.Thread] = {}
        self.results: dict[int, object] = {}

    # Executor runner entry point: (spec, hosts) -> start async work
    def __call__(self, spec: dict, hosts: list[str]) -> None:
        if spec.get("kind") != "train":
            return                       # sim payloads etc. are no-ops here
        t = threading.Thread(target=self._run, args=(spec,), daemon=True)
        self.threads[spec["idJob"]] = t
        t.start()

    def mesh(self):
        """The jobs' mesh, built at the first job's start."""
        with self._mesh_lock:
            if self._mesh is None:
                self._mesh = make_local_mesh(1, self.device)
            return self._mesh

    def _preempt_check(self, job_id: int):
        def check() -> bool:
            row = self.db.query_one(
                "SELECT toCancel, state FROM jobs WHERE idJob=?", (job_id,))
            return row is None or row["toCancel"] == 1 or \
                row["state"] not in ("Running", "Launching")
        return check

    def _run(self, spec: dict) -> None:
        job_id = spec["idJob"]
        try:
            arch = spec.get("arch", "tiny")
            cfg = configs.get_smoke(arch) if spec.get("smoke", True) else configs.get(arch)
            result = train_loop(
                cfg.replace(dtype="float32"),
                steps=spec.get("steps", 100),
                global_batch=spec.get("global_batch", 8),
                seq_len=spec.get("seq_len", 128),
                ckpt_dir=spec.get("ckpt_dir"),
                ckpt_every=spec.get("ckpt_every", 50),
                preempt_check=self._preempt_check(job_id),
                log_every=spec.get("log_every", 20),
                device=self.device, mesh=self.mesh(), rules=self.rules,
            )
            self.results[job_id] = result
            if result.status == "done":
                self.executor.complete(job_id, ok=True,
                                       message=f"trained to step {result.step}")
            # preempted: the cancellation module owns the state transition;
            # the checkpoint makes the resubmitted clone resume.
        except Exception as exc:  # noqa: BLE001 — job failure, not ours
            self.results[job_id] = exc
            try:
                self.executor.complete(job_id, ok=False, message=repr(exc))
            except Exception:  # noqa: BLE001 — the job's failure is already recorded
                pass

    def wait_all(self, timeout: float = 300.0) -> None:
        for t in list(self.threads.values()):
            t.join(timeout)
