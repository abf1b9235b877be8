"""CPU tests of what decides ``correct``: a run of each cell's driver at a
tiny size comes out correct; with the timed path broken underneath (a token
altered where it is produced; a step that returns its state unchanged; half
of the batch left out), or with the control in the program's place (the
reference in float8), it comes out not correct. The harness's look for a
card is skipped: the drivers run on the CPU, the port's kernels through
their plain versions. And the command refuses without a card."""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from gpubench import checks, reference
from gpubench.bench import Bench, Run
from gpubench.drivers import serve, train
from gpubench.reference.precision import FP8

HERE = Path(__file__).resolve().parent
BENCH = Bench()
SERVE = "granite-8b.serve.longprompt"
TRAIN = "mamba2-130m.train"
# A training mix for the tests alone: no cell of BENCHMARK.json trains (the
# port cannot yet run mamba2-130m's float32 residual stream in bf16).
TRAIN_MIX = {
    "driver": "train", "rows": 8, "seq": 128, "zipf": 1.3,
    "optimizer": {"lr": 0.0003, "b1": 0.9, "b2": 0.95, "eps": 1e-08, "weight_decay": 0.1,
                  "clip_norm": 1.0, "warmup_steps": 100, "moments_dtype": "float32"},
    "check": {"rows": 4, "moved_share": 0.001},
    "limits": {"grad_norm_gap_median": 0.002, "delta_norm_gap_median": 0.0006,
               "grad_norm_gap": 0.2, "delta_norm_gap": 0.1, "loss_rel": 0.001}}


def _tiny_granite():
    c = copy.deepcopy(BENCH.config("granite-8b"))
    c.update(hidden_size=128, intermediate_size=256, num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, head_dim=32, vocab_size=2048)
    c["matmul_params"] = 4 * (128 * 128 * 2 + 128 * 64 * 2 + 3 * 128 * 256) + 128 * 2048
    c["port"].update(num_layers=4, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                     d_ff=256, vocab_size=2048)
    return c


def _tiny_mamba2():
    c = copy.deepcopy(BENCH.config("mamba2-130m"))
    c.update(d_model=128, n_layer=2)
    c["assumed"].update(d_state=32, headdim=32, chunk_size=32, padded_vocab_size=512)
    c["port"].update(num_layers=2, d_model=128, vocab_size=512, ssm_state=32, ssm_head_dim=32,
                     ssm_chunk=32, dtype="float32")     # residual_in_fp32, as published
    return c


def _serve_run(seed):
    mix = BENCH.traffic(SERVE) | {
        "max_batch": 4, "max_len": 192, "block": 8, "warmup_prompts": [8, 100],
        "prompt_len": {"lognormal": {"median": 40, "sigma": 0.5, "min": 8, "max": 100}},
        "output_len": {"lognormal": {"median": 40, "sigma": 0.5, "min": 16, "max": 80}}}
    mix["arrivals"] = {"kind": "poisson", "rate": 20.0, "preroll_s": 0.3}
    return Run(SERVE, _tiny_granite(), mix, seed, 0.6, False)


def _train_run(seed):
    return Run(TRAIN, _tiny_mamba2(), copy.deepcopy(TRAIN_MIX), seed, 0.3, False)


class _Clock:
    """A stand-in for the serving driver's ``time``: ``perf_counter`` moves on
    2 ms a call and ``sleep`` by its argument, so a window holds the same
    work however loaded the machine is."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        self.t += 0.002
        return self.t

    def sleep(self, seconds):
        self.t += max(0.0, seconds)


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(serve, "time", c)
    return c


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_serving_run_is_correct(clock):
    run = _serve_run(2**31 + 17)
    serve.run(run, t0=clock.perf_counter(), device="cpu")
    assert run.correct, run.compared
    assert run.extra["sample"] and run.attempted > 0


def test_a_traced_serving_run_profiles_the_last_quarter_of_its_window(clock):
    run = _serve_run(2**31 + 19)
    run.trace_on = True
    serve.run(run, t0=clock.perf_counter(), device="cpu")
    w0, closed = run.window
    start, end = run.extra["traced"]
    assert w0 + (1 - serve.TRACED_SHARE) * run.seconds <= start < end <= closed + 0.1
    assert run.trace is not None and run.spans["decode"]
    assert all(c["start"] >= start for c in run.spans["decode"] + run.spans["prefill"])
    assert run.correct, run.compared


def test_serving_with_a_token_altered_is_not_correct(clock):
    run = _serve_run(2**31 + 18)
    calls = []

    def hook(engine):
        decode = engine.decode

        def altered(params, cache, tokens, pos):
            logits, cache = decode(params, cache, tokens, pos)
            calls.append(1)
            if len(calls) % 5 == 0:            # every fifth step, every row's token moves
                top = logits.argmax(-1)
                logits = logits.scatter(-1, ((top + 1) % logits.shape[-1])[:, None], 1e4)
            return logits, cache
        engine.decode = altered
    serve.run(run, t0=clock.perf_counter(), device="cpu", engine_hook=hook)
    assert run.extra["sample"] and run.compared["served_logit_gap"]["value"] > 1.0
    assert not run.correct, run.compared


def test_serving_control_is_not_correct(clock):
    run = _serve_run(2**31 + 19)
    serve.run(run, t0=clock.perf_counter(), device="cpu")
    assert run.extra["sample"]
    ref = reference.load(run.config["reference"])
    gaps = checks.served_gaps(ref, run.extra["params"], run.config, run.extra["sample"], "cpu",
                              control=FP8)
    ok, compared = checks.judge({"served_logit_gap": max(gaps)}, run.traffic["limits"])
    assert not ok, compared


def test_training_run_is_correct():
    run = _train_run(2**31 + 21)
    train.run(run, t0=time.perf_counter(), device="cpu")
    assert run.correct, run.compared
    assert run.attempted >= 1 and run.failed == 0


def _step_fn(run):
    return train.build(run, "cpu")[1]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_with_a_fault_is_not_correct(fault):
    run = _train_run(2**31 + 22)
    step = _step_fn(run)
    if fault == "unchanged":
        def broken(state, batch):
            before = {k: v for k, v in state.items()}
            _, m = step(copy.deepcopy(before), batch)
            return before, m
    else:
        def broken(state, batch):
            return step(state, {"tokens": batch["tokens"][:batch["tokens"].shape[0] // 2]})
    train.run(run, t0=time.perf_counter(), device="cpu", step_fn=broken)
    assert not run.correct, run.compared


def test_training_refuses_a_residual_stream_below_the_configuration():
    run = Run(TRAIN, BENCH.config("mamba2-130m"), copy.deepcopy(TRAIN_MIX), 1, 0.3, False)
    assert run.config["residual_in_fp32"] and run.config["port"]["dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="residual_in_fp32"):
        train.build(run, "cpu")


def test_training_control_is_not_correct():
    run = _train_run(2**31 + 23)
    share = run.traffic["check"]["moved_share"]
    ref = train.reference_readings(run, "cpu")
    control = train.reference_readings(run, "cpu", matmul=FP8)
    ok, compared = checks.judge(checks.train_numbers(control, ref, share), run.traffic["limits"])
    assert not ok, compared


def test_the_command_refuses_without_a_card_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", SERVE, "--seed",
                          "3", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=120, cwd=HERE.parent)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "CUDA" in out.stderr


def test_the_command_fails_in_a_checkout_without_the_port(tmp_path):
    import shutil
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", SERVE, "--seed", "3",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["gpubench"]
