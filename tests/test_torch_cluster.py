"""Port's cluster runner (``repro_torch.launch.cluster.ClusterRunner``)
against the reference's (``repro.launch.cluster.ClusterRunner``), side by
side on one stand-in database and executor: a job that trains to its end,
one preempted at its k-th check, one that fails; both must end with the
same status and final step and make the same ``complete`` calls. Then the
port's runner under the real OAR control plane (``repro.core``) on two
hosts, as ``examples/cluster_train.py`` runs the reference's: a regular job
preempts a best-effort training job, which checkpoints and yields; its
resubmitted clone resumes past step 0 and ends where an uninterrupted run
ends. Every wait has a deadline, so a hang fails the test instead of
stalling the suite (under OAR: a deadline that each sign of progress moves
on). The MoE smokes as runner jobs beside the reference's
runner; the runner's refusal without a card, and an arch the port has not
ported, close the file."""

import json
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch  # noqa: E402

from repro.core import CentralModule, Executor, MetaScheduler, SimTransport  # noqa: E402
from repro.core import TaktukLauncher, api, connect  # noqa: E402
from repro.launch.cluster import ClusterRunner as JaxRunner  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.cluster import ClusterRunner  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import train_loop  # noqa: E402

JOIN_S = 60.0           # deadline for each runner thread


class StandInDB:
    """Answers the runner's one query: the job is Running, with toCancel set
    from its ``cancel_at``-th check on (never, if None)."""

    def __init__(self, cancel_at: int | None = None):
        self.cancel_at = cancel_at
        self.checks = 0
        self._lock = threading.Lock()

    def query_one(self, sql, args):
        assert sql == "SELECT toCancel, state FROM jobs WHERE idJob=?", sql
        with self._lock:
            self.checks += 1
            cancel = self.cancel_at is not None and self.checks >= self.cancel_at
        return {"toCancel": int(cancel), "state": "Running"}


class Recorder:
    """The executor as the runner sees it: records ``complete`` calls."""

    def __init__(self):
        self.calls = []

    def complete(self, job_id, *, ok=True, message=""):
        self.calls.append((job_id, ok, message))


def _run(runner, spec):
    runner(spec, ["host0"])
    runner.wait_all(JOIN_S)
    assert not runner.threads[spec["idJob"]].is_alive(), "runner thread did not end"
    return runner.results[spec["idJob"]]


@pytest.mark.parametrize("case", ["done", "preempted", "failed"])
def test_port_runner_matches_reference_runner(tmp_path, case):
    spec = {"kind": "train", "idJob": 7, "arch": "tiny", "steps": 4, "global_batch": 2,
            "seq_len": 32, "ckpt_every": 2, "log_every": 1}
    cancel_at = 3 if case == "preempted" else None     # the check before step 2
    outcomes = {}
    for name, make in (("reference", lambda db, ex: JaxRunner(db, ex)),
                       ("port", lambda db, ex: ClusterRunner(db, ex, device="cpu"))):
        ckpt_dir = tmp_path / name
        if case == "failed":                    # a file where the checkpoints should go
            ckpt_dir.write_text("")
        db, ex = StandInDB(cancel_at), Recorder()
        runner = make(db, ex)
        runner({"kind": "sim", "idJob": 8}, ["host0"])          # not the runner's
        assert 8 not in runner.threads
        result = _run(runner, {**spec, "ckpt_dir": str(ckpt_dir)})
        if case == "failed":
            assert isinstance(result, OSError), result
            outcomes[name] = ("failed", None, [(j, ok) for j, ok, _ in ex.calls])
        else:
            outcomes[name] = (result.status, result.step, ex.calls)
            assert ckpt.list_steps(str(ckpt_dir))[-1] == result.step
    assert outcomes["port"] == outcomes["reference"]
    expect = {"done": ("done", 4, [(7, True, "trained to step 4")]),
              "preempted": ("preempted", 2, []),
              "failed": ("failed", None, [(7, False)])}[case]
    assert outcomes["port"] == expect


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "moonshot-v1-16b-a3b"])
def test_runner_trains_moe_smoke_jobs(tmp_path, arch):
    """The runner resolves the MoE archs (ROADMAP.md item 5) and trains
    their smoke configs to the end, as the reference's runner does: the same
    status, final step and completion, finite losses and a checkpoint."""
    spec = {"kind": "train", "idJob": 5, "arch": arch, "steps": 3, "global_batch": 2,
            "seq_len": 32, "log_every": 1}
    outcomes = {}
    for name, make in (("reference", lambda db, ex: JaxRunner(db, ex)),
                       ("port", lambda db, ex: ClusterRunner(db, ex, device="cpu"))):
        ex = Recorder()
        result = _run(make(StandInDB(), ex), {**spec, "ckpt_dir": str(tmp_path / name)})
        assert all(np.isfinite(m["loss"]) for m in result.history), name
        outcomes[name] = (result.status, result.step, ex.calls)
        assert ckpt.list_steps(str(tmp_path / name)) == [3]
    assert outcomes["port"] == outcomes["reference"] == ("done", 3, [(5, True, "trained to step 3")])


def _final_state(ckpt_dir):
    step = ckpt.latest_step(ckpt_dir)
    with np.load(f"{ckpt_dir}/step_{step:08d}/state.npz") as data:
        return step, dict(data.items())


def test_oar_preempts_best_effort_training_and_the_clone_resumes(tmp_path):
    """The port of examples/cluster_train.py on the CPU, with tiny-smoke.
    A wait fails after 50 s without progress (a job changing state, or a
    new checkpoint of the best-effort job or its clone): a hang fails as
    before, while training that other processes on a loaded machine slow
    down (about 10 s of it alone, past 50 s under a whole suite's load) is
    waited for."""
    stall_s = 50.0

    def progress():
        return ([(r["idJob"], r["state"]) for r in api.oarstat(db)],
                ckpt.list_steps(be_spec["ckpt_dir"]))

    def wait_for(cond, what):
        seen, deadline = progress(), time.monotonic() + stall_s
        while not cond():
            now = progress()
            if now != seen:
                seen, deadline = now, time.monotonic() + stall_s
            elif time.monotonic() > deadline:
                raise AssertionError(f"no progress for {stall_s} s waiting for {what}")
            central.tick()
            time.sleep(0.01)

    db = connect()
    api.add_resources(db, ["host0", "host1"], weight=1)
    executor = Executor(db, launcher=TaktukLauncher(SimTransport()), check_nodes=False)
    runner = ClusterRunner(db, executor, device="cpu")
    executor.runner = runner
    central = CentralModule(db, scheduler=MetaScheduler(db), executor=executor)
    be_spec = {"kind": "train", "arch": "tiny", "steps": 300, "global_batch": 2,
               "seq_len": 32, "ckpt_dir": str(tmp_path / "besteffort"), "ckpt_every": 4,
               "log_every": 50}
    reg_spec = {"kind": "train", "arch": "tiny", "steps": 4, "global_batch": 2,
                "seq_len": 32, "ckpt_dir": str(tmp_path / "regular")}
    be_id = api.oarsub(db, be_spec, queue="besteffort", nb_nodes=2, max_time=3600)
    wait_for(lambda: ckpt.list_steps(be_spec["ckpt_dir"]), "the best-effort job's checkpoint")
    reg_id = api.oarsub(db, reg_spec, nb_nodes=2, max_time=3600)

    def states():
        return {r["idJob"]: r for r in api.oarstat(db)}

    def settled():
        rows = states()
        done = [j for j, r in rows.items() if r["state"] == "Terminated"]
        return reg_id in done and len(done) >= 2 and \
            all(r["state"] in ("Terminated", "Error") for r in rows.values())

    wait_for(settled, "the regular job and the best-effort clone to end")
    runner.wait_all(stall_s)
    assert not any(t.is_alive() for t in runner.threads.values())

    rows = states()
    clones = [j for j in rows if j not in (be_id, reg_id)]
    assert len(clones) == 1, rows
    clone_id = clones[0]            # its message, "resubmission of ...", is now its result's
    assert rows[clone_id]["bestEffort"] == 1
    assert json.loads(rows[clone_id]["command"]) == be_spec
    assert rows[be_id]["state"] == "Error" and rows[be_id]["message"].startswith("preempted")
    assert rows[reg_id]["state"] == "Terminated"
    assert rows[reg_id]["message"] == "trained to step 4"
    assert rows[clone_id]["state"] == "Terminated"
    assert rows[clone_id]["message"] == "trained to step 300"
    preempted, clone = runner.results[be_id], runner.results[clone_id]
    assert (preempted.status, clone.status, clone.step) == ("preempted", "done", 300)
    assert 0 < preempted.step < 300
    assert clone.history[0]["step"] == preempted.step       # resumed at the checkpoint

    whole = train_loop(configs.get_smoke("tiny").replace(dtype="float32"), steps=300,
                       global_batch=2, seq_len=32, ckpt_dir=str(tmp_path / "whole"),
                       ckpt_every=4, log_every=50, device="cpu")
    assert clone.metrics["loss"] == whole.metrics["loss"]
    cstep, cstate = _final_state(be_spec["ckpt_dir"])
    wstep, wstate = _final_state(str(tmp_path / "whole"))
    assert cstep == wstep == 300 and sorted(cstate) == sorted(wstate)
    for key in wstate:
        np.testing.assert_array_equal(cstate[key], wstate[key], err_msg=key)


def test_runner_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterRunner(StandInDB(), Recorder())


def test_unported_arch_fails_the_job():
    """An arch the port's registry lacks fails its job with the registry's
    NotImplementedError (every arch of the reference is registered, so the
    name is one the reference lacks too)."""
    ex = Recorder()
    runner = ClusterRunner(StandInDB(), ex, device="cpu")
    result = _run(runner, {"kind": "train", "idJob": 3, "arch": "falcon-40b"})
    assert isinstance(result, NotImplementedError)
    assert [(j, ok) for j, ok, _ in ex.calls] == [(3, False)]
    assert "not ported yet" in ex.calls[0][2]
