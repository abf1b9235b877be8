"""CPU tests of the moonlight-16b-a3b configuration and its cell: the file
holds the catalog's published numbers, ``matmul_params_active`` counts the
reference's layout, the two readers match counts made by hand, and the
benchmark's reference equals the port's plain reference at the smoke size."""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

from gpubench import mla_flops, reference
from gpubench.bench import Bench, Run
from gpubench.traffic import make_requests

HERE = Path(__file__).resolve().parent
BENCH = Bench()
NAME, CELL = "moonlight-16b-a3b", "moonlight-16b-a3b.serve.longchat"

# The catalog's config of Moonlight-16B-A3B (model-configs, architectures.jsonl),
# from https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json
CATALOG = {"attention_bias": False, "ep_size": 1, "first_k_dense_replace": 1,
           "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 11264,
           "kv_lora_rank": 512, "max_position_embeddings": 8192, "model_type": "deepseek_v3",
           "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
           "n_routed_experts": 64, "n_shared_experts": 2, "norm_topk_prob": True,
           "num_attention_heads": 16, "num_experts_per_tok": 6, "num_hidden_layers": 27,
           "num_key_value_heads": 16, "num_nextn_predict_layers": 0, "q_lora_rank": None,
           "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05,
           "rope_theta": 50000, "routed_scaling_factor": 2.446, "scoring_func": "sigmoid",
           "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
           "topk_method": "noaux_tc", "v_head_dim": 128, "vocab_size": 163840}


def _leaves(t):
    for k, v in t.items():
        yield from _leaves(v) if isinstance(v, dict) else [(k, v[0])]


def test_the_file_holds_the_catalog_and_the_port_block_is_the_registered_config():
    cfg = BENCH.config(NAME)
    assert {k: cfg[k] for k in CATALOG} == CATALOG and cfg["reduced"] == []
    from repro_torch import configs
    from repro_torch.configs.base import ModelConfig
    assert ModelConfig(**cfg["port"]) == configs.get(NAME)


def test_matmul_params_count_the_reference_layout():
    cfg = BENCH.config(NAME)
    layout = reference.load(cfg["reference"]).param_layout(cfg)
    layers = [v for k, v in layout["layers"].items()]
    matrices = [s for lay in layers for k, s in _leaves(lay)
                if k not in ("pre_norm", "mlp_norm", "kv_norm", "router_bias")]
    total = sum(math.prod(s) for s in matrices) + 2 * math.prod(layout["embed"][0])
    assert total == cfg["matmul_params"] == 15_959_982_080
    # per token: attention, the dense layer, 6 of 64 experts, the shared ones, the routers, the head
    k, E = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    active = 0
    for lay in layers:
        for name, s in _leaves(lay):
            if name in ("pre_norm", "mlp_norm", "kv_norm", "router_bias"):
                continue
            active += math.prod(s) * k // E if name.startswith("we_") else math.prod(s)
    active += math.prod(layout["unembed"][0])
    assert active == cfg["matmul_params_active"] == 2_579_103_744


def _run(spans, ops=None):
    run = Run(CELL, BENCH.config(NAME), BENCH.traffic(CELL), 0, 10.0, True)
    run.spans = spans
    if ops is not None:
        class Trace:
            pass
        run.trace = Trace()
        run.trace.ops = ops
    return run


def test_the_roofline_reader_by_hand():
    # one decode call, rows at 1000 and 3000 written slots: per layer the
    # slots' 576 values and each row's q (16 x 576) and output (16 x 512), bf16
    slots, rows = 4000, 2
    nbytes = 2 * 27 * (576 * slots + rows * 16 * (576 + 512))
    flops = 2 * 27 * 16 * (576 + 512) * slots
    assert mla_flops.mla_decode_counts(BENCH.config(NAME), [1000, 3000]) == (flops, nbytes)
    need = max(flops / 989e12, nbytes / 3.35e12)
    ops = {"void (anonymous namespace)::mla_decode_kernel<__nv_bfloat16, 512, 64>(...)": [27, 3e5],
           "(anonymous namespace)::mla_decode_combine_kernel(...)": [27, 1e5],
           "decode_attn_kernel<...>": [5, 7e9]}
    read = BENCH.reader("mla_decode_roofline.longchat").read
    run = _run({"decode": [{"start": 0.0, "end": 0.1, "contexts": [1000, 3000]}]}, ops)
    assert read(run) == pytest.approx(100 * need / 4e-4)
    assert read(_run({"decode": []}, {"flash_fwd": [1, 10]})) is None     # no latent kernel
    assert read(_run({"decode": []})) is None                             # no trace


def test_the_mfu_reader_by_hand():
    c = BENCH.config(NAME)
    width = 27 * 16 * (192 + 128)
    head = 2048 * 163840
    prefill = 2 * (2_579_103_744 - head) * 100 + 2 * head + 2 * width * (100 * 101 // 2)
    decode = 2 * 2_579_103_744 + 2 * width * 50
    assert mla_flops.mla_prefill_flops(c, 100) == prefill
    assert mla_flops.mla_decode_flops(c, 50) == decode
    run = _run({"prefill": [{"start": 0.0, "end": 0.5, "prompt": 100}],
                "decode": [{"start": 1.0, "end": 1.5, "contexts": [50, 50]}]})
    assert BENCH.reader("mfu.longchat").read(run) == \
        pytest.approx(100 * (prefill + 2 * decode) / (1.0 * 989e12))
    assert BENCH.reader("mfu.longchat").read(_run({})) is None


def test_the_traffic_fits_the_context_and_keeps_its_mix():
    mix = BENCH.traffic(CELL)
    reqs = make_requests(mix, 256, 163840, 2**33 + 5)
    assert max(len(r.prompt) + r.max_new_tokens for r in reqs) <= mix["max_len"] == 8192
    assert all(256 <= len(r.prompt) <= 7680 and 1 <= r.max_new_tokens <= 512 for r in reqs)
    assert mix["max_batch"] == 128 and mix["arrivals"]["preroll_s"] == 20.0
    # stratified in blocks of 8: every 8 requests hold the same prompt and output lengths
    b = mix["block"]
    blocks = [(sorted(len(r.prompt) for r in reqs[i:i + b]),
               sorted(r.max_new_tokens for r in reqs[i:i + b])) for i in range(0, 256, b)]
    assert b == 8 and all(x == blocks[0] for x in blocks)


def _port_reference():
    path = HERE.parent / "src" / "repro_torch" / "reference" / "deepseek_v3.py"
    spec = importlib.util.spec_from_file_location("port_reference_deepseek_v3", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_two_copies_of_the_reference_agree():
    """The port's plain reference (loaded from its file, as the port is not
    imported here) and the benchmark's, on one set of weights at a smoke
    size; the same text but for the line that names ``F32``."""
    ours, theirs = reference.load("deepseek_v3"), _port_reference()
    a = (HERE / "reference" / "deepseek_v3.py").read_text().splitlines()
    b = (HERE.parent / "src" / "repro_torch" / "reference" / "deepseek_v3.py").read_text() \
        .splitlines()
    assert len(set(b) - set(a)) <= 4 and len(set(a) - set(b)) == 1
    cfg = json.loads((HERE / "configs" / f"{NAME}.json").read_text())
    cfg.update(hidden_size=64, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
               qk_rope_head_dim=16, v_head_dim=16, n_routed_experts=8, moe_intermediate_size=32,
               intermediate_size=128, vocab_size=256, num_hidden_layers=3,
               num_experts_per_tok=2)
    from gpubench.weights import make_weights
    w = make_weights(ours.param_layout(cfg), 7, torch.float32, "cpu")
    assert ours.param_layout(cfg) == theirs.param_layout(cfg)
    toks = torch.arange(1, 30) * 7 % 255
    routes_a, routes_b = [], []
    la = ours.logits(w, cfg, toks, start=3, routes=routes_a)
    lb = theirs.logits(w, cfg, toks, start=3, routes=routes_b)
    assert torch.equal(la, lb) and la.shape == (26, 256)
    assert len(routes_a) == 2 and all(torch.equal(x, y) for x, y in zip(routes_a, routes_b))
