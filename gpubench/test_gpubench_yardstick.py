"""CPU tests of the benchmark's yardstick: the traffic generator, the
percentile and rate arithmetic, the FLOP and byte formulas, the
configuration files, the lookup by name, and the import rules."""

from __future__ import annotations

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import flops, stats, traffic
from gpubench.bench import Bench, Run, forbidden_modules

HERE = Path(__file__).resolve().parent
BENCH = Bench()
SERVE_CELLS = ["granite-8b.serve.longprompt", "granite-8b.batch.decode"]


# ------------------------------------------------------------------ traffic
@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_requests_are_deterministic_per_seed_and_in_range(cell):
    mix = BENCH.traffic(cell)
    a = traffic.make_requests(mix, 96, 49152, 2**33 + 7)
    b = traffic.make_requests(mix, 96, 49152, 2**33 + 7)
    c = traffic.make_requests(mix, 96, 49152, 2**33 + 8)
    assert a == b and a != c
    lo, hi = mix["prompt_len"]["lognormal"]["min"], mix["prompt_len"]["lognormal"]["max"]
    assert all(lo <= len(r.prompt) <= hi for r in a)
    olo, ohi = mix["output_len"]["lognormal"]["min"], mix["output_len"]["lognormal"]["max"]
    assert all(olo <= r.max_new_tokens <= ohi for r in a)
    assert all(1 <= t < 49151 for r in a for t in r.prompt)
    # every seed offers the same work in another order
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in c)
    assert sorted(r.max_new_tokens for r in a) == sorted(r.max_new_tokens for r in c)
    med = mix["prompt_len"]["lognormal"]["median"]
    assert abs(float(np.median([len(r.prompt) for r in a])) - med) <= 0.05 * med


def test_poisson_arrivals_keep_their_rate_and_order():
    mix = BENCH.traffic("granite-8b.serve.longprompt")
    reqs = traffic.make_requests(mix, 320, 49152, 11)
    due = [r.due_s for r in reqs]
    assert due == sorted(due) and due[0] > 0
    rate = mix["arrivals"]["rate"]
    assert abs(len(due) / due[-1] - rate) < 0.02 * rate
    again = traffic.make_requests(mix, 320, 49152, 12)
    assert sorted(np.diff([0.0] + due)) == pytest.approx(sorted(np.diff([0.0] + [r.due_s for r in again])))


def test_backlog_is_due_at_once():
    mix = BENCH.traffic("granite-8b.batch.decode")
    assert {r.due_s for r in traffic.make_requests(mix, 64, 49152, 5)} == {0.0}


def test_quantiles_of_the_lognormal_are_clipped_and_centred():
    vals = traffic.quantile_values({"lognormal": {"median": 100, "sigma": 2.0, "min": 50,
                                                  "max": 150}}, 9)
    assert vals[0] == 50 and vals[-1] == 150 and vals[4] == 100


def test_train_tokens_are_deterministic_distinct_and_in_range():
    mix = {"rows": 4, "seq": 64, "zipf": 1.3}
    a = traffic.train_tokens(mix, 2**31 + 5, 0, 50288, "cpu")
    assert torch.equal(a, traffic.train_tokens(mix, 2**31 + 5, 0, 50288, "cpu"))
    assert not torch.equal(a, traffic.train_tokens(mix, 2**31 + 5, 1, 50288, "cpu"))
    assert a.shape == (4, 64) and int(a.min()) >= 1 and int(a.max()) < 50287
    assert len({tuple(r) for r in a.tolist()}) == 4


# --------------------------------------------------------------- arithmetic
def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 90) == 90 and stats.percentile(xs, 99) == 99
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)


def _serve_run(requests, window=(10.0, 20.0)):
    run = Run("granite-8b.serve.longprompt", {}, {}, 0, window[1] - window[0], False)
    run.window, run.requests = window, requests
    return run


def _req(due, times, first_step=None):
    return {"due": due, "times": times, "first_step_start": first_step, "done": True}


def test_ttft_counts_a_stall_and_requests_left_unserved():
    reqs = [_req(10.0 + i * 0.1, [10.0 + i * 0.1 + 0.2]) for i in range(8)]
    reqs += [_req(12.0, [15.0]),            # a stall of 3 s
             _req(19.0, []),                # due, never served: waited 1 s by the close
             _req(9.0, [9.5]),              # due before the window: not counted
             _req(20.5, [])]                # due after the window: not counted
    read = BENCH.reader("ttft_p90_ms").read
    # ten requests: eight of 200 ms, one of 1 s (a lower bound), one of 3 s
    assert read(_serve_run(reqs)) == pytest.approx(1000.0)
    assert read(_serve_run(reqs[:8])) == pytest.approx(200.0)
    assert BENCH.reader("ttft_p90_ms").read(_serve_run([])) is None


def test_queue_wait_counts_unadmitted_requests_to_the_close():
    reqs = [_req(10.0, [10.4], 10.1), _req(11.0, [], None)]
    assert BENCH.reader("queue_wait_p90_ms.serve").read(_serve_run(reqs)) == \
        pytest.approx(9000.0)


def test_queue_wait_leaves_out_the_traced_part_of_the_window():
    reqs = [_req(10.0 + i, [], 10.1 + i) for i in range(7)]      # waits of 100 ms
    reqs += [_req(17.0 + i, [], 19.0 + i) for i in range(3)]     # 2 s, under the profiler
    run = _serve_run(reqs)
    assert BENCH.reader("queue_wait_p90_ms.serve").read(run) == pytest.approx(2000.0)
    run.extra["traced"] = [16.5, 20.0]
    assert BENCH.reader("queue_wait_p90_ms.serve").read(run) == pytest.approx(100.0)


def test_mfu_batch_is_over_the_traced_part():
    run = _serve_run([])
    run.config = {"num_hidden_layers": 1, "hidden_size": 8, "num_attention_heads": 1,
                  "num_key_value_heads": 1, "head_dim": 8, "vocab_size": 16,
                  "matmul_params": 10**9}
    run.spans = {"prefill": [], "decode": [{"start": 18.0, "end": 18.5, "contexts": [4, 4]}]}
    run.extra["traced"] = [17.5, 20.0]
    want = 100 * 2 * flops.dense_decode_flops(run.config, 4) / (2.5 * 989e12)
    assert BENCH.reader("mfu.batch").read(run) == pytest.approx(want)


def test_itl_and_output_rate_take_every_gap_and_token_of_the_window():
    steps = [0.05] * 12 + [1.0] + [0.05] * 12 + [1.0] + [0.05] * 13 + [1.0]   # 40 gaps
    times = [9.9, 10.01]
    for g in steps:
        times.append(times[-1] + g)
    run = _serve_run([_req(9.0, times)], window=(10.0, 20.0))
    # 41 gaps end in the window (9.9 -> 10.01 too); three are 1 s stalls, and
    # the 95th percentile (the 39th of 41) is one of them
    assert BENCH.reader("itl_p95_ms").read(run) == pytest.approx(1000.0)
    run.requests.append(_req(9.0, [9.5, 9.6]))               # before the window: no gap
    assert BENCH.reader("itl_p95_ms").read(run) == pytest.approx(1000.0)
    run.requests[0]["times"] = times[:-1]                    # two stalls: under the p95
    assert BENCH.reader("itl_p95_ms").read(run) < 1000.0
    run.requests[0]["times"] = times
    assert BENCH.reader("output_tokens_per_s").read(run) == pytest.approx(41 / 10.0)


def test_train_rate_runs_to_the_last_step_and_over_all_of_it():
    run = Run("mamba2-130m.train", BENCH.config("mamba2-130m"),
              {"driver": "train", "rows": 32, "seq": 2048}, 0, 10.0, False)
    run.window = (100.0, 111.0)
    run.steps = [{"start": 100.0 + 2.2 * i, "end": 102.2 + 2.2 * i, "tokens": 65536}
                 for i in range(5)]
    assert BENCH.reader("train_tokens_per_s").read(run) == pytest.approx(5 * 65536 / 11.0)
    mfu = BENCH.reader("mfu.train").read(run)
    assert mfu == pytest.approx(100 * 5 * flops.mamba2_train_flops(run.config, 32, 2048)
                                / (11.0 * 989e12))


# ------------------------------------------------------------------- FLOPs
def test_attention_counts_by_hand():
    assert flops.attention_pairs(3, 3, True) == 6
    assert flops.attention_pairs(4, 4, True, window=2) == 7
    assert flops.attention_pairs(2, 5, False) == 10
    f, b = flops.attention_counts(2, 3, 3, 4, 2, 8, True)
    assert f == 4 * 2 * 4 * 8 * 6
    assert b == 2 * 2 * 8 * (2 * 3 * 4 + 2 * 3 * 2)
    assert flops.attention_counts(1, 50, 50, 4, 2, 8, True)[0] == \
        4 * 4 * 8 * flops.attention_pairs(50, 50, True)


def test_ssd_counts_by_hand():
    # S = 4 in chunks of 2, B = 1, H = 1, P = 1, N = 1: per chunk C B^T and
    # the scores over 3 pairs (2 x 3 each); C h^T in the second chunk, the
    # state update in the first (2 x 2 each)
    assert flops.ssd_flops(1, 4, 1, 1, 1, 2) == 2 * (6 + 6) + 4 + 4
    f, b = flops.ssd_counts(1, 4, 1, 1, 1, 2, itemsize=2)
    assert b == (2 * 4 + 2 * 4) * 2 + (4 + 1) * 4


def test_model_flops_by_hand():
    g = BENCH.config("granite-8b")
    layers = 36 * 218_103_808
    assert g["matmul_params"] == layers + 4096 * 49152
    assert flops.dense_prefill_flops(g, 10) == 2 * layers * 10 + 2 * 4096 * 49152 + \
        4 * 36 * 32 * 128 * 55
    assert flops.dense_decode_flops(g, 100) == 2 * g["matmul_params"] + 4 * 36 * 32 * 128 * 100
    m = BENCH.config("mamba2-130m")
    assert m["matmul_params"] == 24 * (768 * 3352 + 1536 * 768) + 768 * 50288
    assert flops.mamba2_train_flops(m, 2, 512) == 6 * m["matmul_params"] * 1024 + \
        3 * 24 * flops.ssd_flops(2, 512, 24, 64, 128, 256)


MATMULS = {"granite-8b": {"wq", "wk", "wv", "wo", "wi_gate", "wi_up", "wo_mlp", "unembed"},
           "mamba2-130m": {"in_proj", "out_proj", "embed"}}   # the tied head


@pytest.mark.parametrize("name", sorted(MATMULS))
def test_matmul_params_count_the_layout(name):
    from gpubench import reference
    cfg = BENCH.config(name)
    layout = reference.load(cfg["reference"]).param_layout(cfg)

    def leaves(t):
        for k, v in t.items():
            yield from leaves(v) if isinstance(v, dict) else [(k, v[0])]
    assert sum(math.prod(s) for k, s in leaves(layout) if k in MATMULS[name]) == \
        cfg["matmul_params"]


# ------------------------------------------------------------ config files
PUBLISHED = {
    "granite-8b": {"num_hidden_layers": 36, "hidden_size": 4096, "num_attention_heads": 32,
                   "num_key_value_heads": 8, "head_dim": 128, "intermediate_size": 14336,
                   "vocab_size": 49152, "max_position_embeddings": 4096,
                   "torch_dtype": "bfloat16"},
    "mamba2-130m": {"n_layer": 24, "d_model": 768, "tie_embeddings": True,
                    "assumed": {"d_state": 128, "headdim": 64, "expand": 2, "chunk_size": 256,
                                "padded_vocab_size": 50288}},
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_config_widths_are_the_published_ones(name):
    cfg = BENCH.config(name)
    for k, v in PUBLISHED[name].items():
        if isinstance(v, dict):
            assert {kk: cfg[k][kk] for kk in v} == v
        else:
            assert cfg[k] == v, k
    from repro_torch.configs.base import ModelConfig
    port = ModelConfig(**cfg["port"])
    if name == "granite-8b":
        assert (port.num_layers, port.d_model, port.num_heads, port.num_kv_heads, port.head_dim,
                port.d_ff, port.vocab_size, port.rope_theta, port.norm_eps) == \
            (36, 4096, 32, 8, 128, 14336, 49152, cfg["rope_theta"], cfg["rms_norm_eps"])
    else:
        a = cfg["assumed"]
        assert (port.num_layers, port.d_model, port.ssm_state, port.ssm_head_dim, port.ssm_expand,
                port.ssm_chunk, port.vocab_size, port.norm_eps) == \
            (24, 768, a["d_state"], a["headdim"], a["expand"], a["chunk_size"],
             a["padded_vocab_size"], a["norm_epsilon"])


def test_benchmark_json_names_files_that_exist():
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        assert (HERE.parent / c["file"]).is_file()
        assert json.loads((HERE.parent / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert (HERE / "workloads" / f"{w['name']}.json").is_file()
        assert (HERE / "drivers" / f"{BENCH.traffic(w['name'])['driver']}.py").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert hasattr(BENCH.reader(m["name"]), "read"), m["name"]


# ------------------------------------------------------------------ lookup
def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """A further workload file and metric file, in a folder the lookup is
    pointed at, are found by name; no file of the harness changes."""
    for sub in ("configs", "workloads", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "granite-8b.json").write_text(
        (HERE / "configs" / "granite-8b.json").read_text())
    extra = BENCH.traffic("granite-8b.serve.longprompt") | {"max_batch": 8}
    (tmp_path / "workloads" / "granite-8b.serve.short.json").write_text(json.dumps(extra))
    (tmp_path / "metrics" / "ttft_p50_ms.py").write_text(
        "from gpubench.stats import percentile\n"
        "def read(run):\n    return 1e3 * percentile([1.0, 2.0], 50)\n")
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "granite-8b.serve.short", "config": "granite-8b",
                              "traffic": "serve.short", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "ttft_p50_ms", "unit": "ms", "better": "lower",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["granite-8b.serve.short"]})
    bench = Bench(spec, tmp_path)
    assert bench.traffic("granite-8b.serve.short")["max_batch"] == 8
    assert bench.config(bench.cell("granite-8b.serve.short")["config"])["hidden_size"] == 4096
    assert [m["name"] for m in bench.metrics("granite-8b.serve.short", False)] == \
        ["setup_s", "ttft_p50_ms"]
    assert bench.reader("ttft_p50_ms").read(None) == 1000.0


def test_metric_selection_follows_workloads_and_moves():
    cell = "granite-8b.serve.longprompt"
    e2e = {m["name"] for m in BENCH.metrics(cell, False)}
    assert e2e == {"setup_s", "ttft_p90_ms", "itl_p95_ms"}
    layer = {m["name"] for m in BENCH.metrics(cell, True)}
    assert layer == {"queue_wait_p90_ms.serve", "prefill_ms_per_ktok.serve", "mfu.serve",
                     "flash_roofline.serve", "device_idle.serve"}
    for w in BENCH.spec["workloads"]:
        names = {m["name"] for m in BENCH.metrics(w["name"], False)}
        assert "setup_s" in names and len(names) >= 2
        assert BENCH.metrics(w["name"], True)


# ----------------------------------------------------------------- imports
def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.partition(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).partition(".")[0])
    return out


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not _imports(f) & {"jax", "jaxlib", "flax", "repro"}, f
        assert "chip_smoke" not in _imports(f) and "tools" not in _imports(f), f


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((HERE / "reference").rglob("*.py")):
        assert "repro_torch" not in _imports(f), f


def test_forbidden_modules_compare_top_level_names_whole():
    assert forbidden_modules({"repro_torch": 0, "repro_torch.models": 0, "torch": 0}) == []
    assert forbidden_modules({"jax.numpy": 0, "repro.core": 0, "flax": 0}) == \
        ["flax", "jax", "repro"]
