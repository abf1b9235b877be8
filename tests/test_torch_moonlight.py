"""moonlight-16b-a3b (DeepSeek-V3 architecture) on the CPU, against the plain
f32 reference ``repro_torch.reference.deepseek_v3`` at the smoke size:
multi-head latent attention (prefill in the published form, decode absorbed
over the latent cache), the sigmoid router with its correction bias, the
dropless experts and the shared experts, the dense first layer, the latent
decode op's CPU path, the parameter count at full width, and the engine's
``cache_bytes`` and the ``moe_experts`` op in a trace.

Tolerances: the port and the reference both compute in float32 here and
differ by the order of their sums (the port's flash call pads to a wider
head, its decode is absorbed, its experts are summed after a sort), so
logits agree to 1e-4 on logits of order 1 (2.8e-6 measured); parts compared
through one layer agree to 1e-5."""

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.kernels.decode_attention.ref import written_slots  # noqa: E402
from repro_torch.kernels.mla_decode import mla_decode_attention, mla_decode_attention_ref  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import flatten_specs  # noqa: E402
from repro_torch.reference import deepseek_v3 as ref  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "moonlight-16b-a3b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)     # whole model, f32, sums in another order
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)     # one layer, f32


def published(cfg) -> dict:
    """The ``config.json`` keys the reference reads, from a port config."""
    return dict(hidden_size=cfg.d_model, num_attention_heads=cfg.num_heads,
                kv_lora_rank=cfg.kv_lora_rank, qk_nope_head_dim=cfg.qk_nope_head_dim,
                qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
                n_routed_experts=cfg.num_experts, moe_intermediate_size=cfg.moe_d_ff,
                intermediate_size=cfg.d_ff, n_shared_experts=cfg.num_shared_experts,
                vocab_size=cfg.vocab_size, num_hidden_layers=cfg.num_layers,
                first_k_dense_replace=cfg.first_dense_layers, moe_layer_freq=1,
                num_experts_per_tok=cfg.num_experts_per_tok,
                routed_scaling_factor=cfg.routed_scaling, rms_norm_eps=cfg.norm_eps,
                rope_theta=cfg.rope_theta)


def _smoke():
    return configs.get_smoke(ARCH).replace(dtype="float32")


def _weights(cfg, seed=0) -> dict:
    """Seeded weights in the reference's layout, with the routed experts'
    output projections at the full fan-in scale (the benchmark scales them
    down against bf16 routing flips; f32 here has none to fear) and a
    correction bias whose spread moves some choices at this size."""
    g = torch.Generator().manual_seed(seed)

    def build(tree):
        return {k: build(v) if isinstance(v, dict) else
                (torch.ones(v[0]) if v[1] is None else torch.randn(v[0], generator=g) * v[1])
                for k, v in sorted(tree.items())}
    w = build(ref.param_layout(published(cfg)))
    for lay in w["layers"].values():
        if "router_bias" in lay:
            lay["router_bias"] = 0.2 * torch.randn(lay["router_bias"].shape, generator=g)
            lay["we_down"] = lay["we_down"] / ref.ROUTED_OUT_SCALE
    return w


def _tokens(n, seed=1, vocab=256):
    return torch.from_numpy(np.random.default_rng(seed).integers(1, vocab - 1, n))


# ------------------------------------------------------------------ config
def test_param_layout_is_the_ports_and_the_count_is_the_published_one():
    cfg = configs.get(ARCH)
    ours = {p: tuple(s.shape) for p, s in flatten_specs(M.param_shapes(cfg))}

    def leaves(t, pre=()):
        for k in sorted(t):
            yield from leaves(t[k], pre + (k,)) if isinstance(t[k], dict) else [(pre + (k,), t[k])]
    assert ours == {p: tuple(v[0]) for p, v in leaves(ref.param_layout(published(cfg)))}
    norms = 27 * (2048 + 2048 + 512) + 2048           # pre, mlp, kv norms; the final norm
    biases = 26 * 64                                    # the routers' correction biases
    assert cfg.param_count() == 15_959_982_080 + norms + biases
    assert not M.uniform_scan(cfg)                      # a dense layer, then 26 MoE


def test_dense_first_layer_and_shared_experts_are_present():
    cfg = configs.get(ARCH)
    assert tfm.layer_kinds(cfg) == ["mla_dense"] + ["mla_moe"] * 26
    specs = M.param_shapes(cfg)["layers"]
    assert specs["layer_0"]["wi_gate"].shape == (2048, 11264)
    assert not {"router", "we_gate", "ws_gate"} & set(specs["layer_0"])
    one = specs["layer_1"]
    assert one["we_gate"].shape == (64, 2048, 1408) and one["router_bias"].shape == (64,)
    assert one["ws_gate"].shape == (2048, 2816) and one["ws_down"].shape == (2816, 2048)
    assert one["wkv_a"].shape == (2048, 576) and one["wkv_b"].shape == (512, 16, 256)
    assert M.cache_shapes(cfg, 4, 8192)["layers"]["layer_5"] == \
        {"ckv": ((4, 8192, 576), torch.bfloat16)}
    # the shared experts add to every token's output
    small = _smoke()
    w = _weights(small)
    x = torch.randn(2, 5, small.d_model)
    lay = w["layers"]["layer_1"]
    with_shared = moe.moe_dropless(lay, x, small)
    assert not torch.allclose(with_shared, moe.moe_dropless(
        {**lay, "ws_down": torch.zeros_like(lay["ws_down"])}, x, small))


# ------------------------------------------------------------- whole model
def test_prefill_logits_match_the_reference():
    cfg = _smoke()
    w = _weights(cfg)
    toks = _tokens(40)
    want = ref.logits(w, published(cfg), toks)
    logits, aux = M.forward(w, cfg, {"tokens": toks[None]})
    torch.testing.assert_close(logits[0], want, **LOGIT_TOL)
    assert float(aux) == 0.0
    last, _ = M.prefill(w, cfg, {"tokens": toks[None]}, 64)
    torch.testing.assert_close(last[0], want[-1], **LOGIT_TOL)


def test_prefill_then_latent_decode_matches_the_reference():
    """Two rows at different positions (prompts of 17 and 9), then 12 decode
    steps through the latent cache; every step's logits against the
    reference's full forward over that row's sequence."""
    cfg = _smoke()
    w = _weights(cfg, seed=2)
    seqs = [_tokens(29, seed=3), _tokens(21, seed=4)]
    prompts = (17, 9)
    cache = M.init_cache(cfg, 2, 32)
    for b, (s, n) in enumerate(zip(seqs, prompts)):
        _, row = M.prefill(w, cfg, {"tokens": s[None, :n]}, 32)
        for name, layer in cache["layers"].items():
            layer["ckv"][b] = row["layers"][name]["ckv"][0]
    wants = [ref.logits(w, published(cfg), s) for s in seqs]
    for t in range(12):
        pos = torch.tensor([prompts[0] + t, prompts[1] + t])
        tokens = torch.stack([seqs[b][pos[b]] for b in range(2)])[:, None]
        logits, cache = M.decode_step(w, cfg, cache, tokens, pos)
        for b in range(2):
            torch.testing.assert_close(logits[b], wants[b][pos[b]], **LOGIT_TOL)


def test_absorbed_decode_equals_the_published_form():
    """One MLA layer: the full-sequence (non-absorbed) output at each
    position against decoding the positions one by one from the prefix's
    latent rows."""
    cfg = _smoke()
    p = _weights(cfg)["layers"]["layer_1"]
    x = torch.randn(1, 20, cfg.d_model)
    full, rows = mla.mla_apply(p, x, cfg)
    cache = torch.zeros(1, 24, mla.slot_width(cfg))
    cache[:, :8] = rows[:, :8]
    for t in range(8, 20):
        out = mla.mla_decode(p, x[:, t:t + 1], cache, torch.tensor([t]), cfg)
        torch.testing.assert_close(out[:, 0], full[:, t], **LAYER_TOL)
    torch.testing.assert_close(cache[:, :20], rows, **LAYER_TOL)   # the slots it wrote


# ------------------------------------------------------------------ router
def test_the_bias_chooses_but_does_not_weight():
    x = torch.eye(4)                                    # token t's logits: router row t
    router = torch.tensor([[2.0, 1.0, 0.0, -1.0]] * 4)
    bias = torch.tensor([0.0, 0.0, 0.0, 3.0])           # expert 3 is chosen, not weighted more
    w, sel = moe.route_sigmoid(x, router, bias, 2, 2.446)
    assert sorted(sel[0].tolist()) == [0, 3]
    s = torch.sigmoid(torch.tensor([2.0, -1.0]))
    torch.testing.assert_close(w[0].sort().values, (s / s.sum() * 2.446).sort().values)
    _, sel0 = moe.route_sigmoid(x, router, torch.zeros(4), 2, 2.446)
    assert sorted(sel0[0].tolist()) == [0, 1]
    torch.testing.assert_close(w.sum(-1), torch.full((4,), 2.446))


def test_dropless_dispatch_equals_a_per_token_loop():
    """Every token through its k experts, one at a time, weighted, plus the
    shared experts; one expert gets no token (its router column pushed
    down), and a decode-sized call (S = 1) takes the same path."""
    cfg = _smoke()
    p = dict(_weights(cfg)["layers"]["layer_1"])
    p["router"] = p["router"].clone()
    p["router"][:, 0] = -50.0 * p["router"][:, 0].sign() - 0.0   # expert 0's logit: very negative
    x = torch.randn(3, 7, cfg.d_model).abs() * torch.sign(p["router"][:, 0])[None, None, :] * -1
    x = x + 0.1 * torch.randn_like(x)
    out = moe.moe_dropless(p, x, cfg)
    xt = x.reshape(-1, cfg.d_model)
    w, sel = moe.route_sigmoid(xt, p["router"], p["router_bias"], cfg.num_experts_per_tok,
                                  cfg.routed_scaling)
    assert 0 not in sel.tolist() and len(set(sel.flatten().tolist())) > 2
    want = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(cfg.num_experts_per_tok):
            e = int(sel[t, j])
            h = torch.nn.functional.silu(xt[t] @ p["we_gate"][e]) * (xt[t] @ p["we_up"][e])
            want[t] += w[t, j] * (h @ p["we_down"][e])
        want[t] += (torch.nn.functional.silu(xt[t] @ p["ws_gate"]) * (xt[t] @ p["ws_up"])) \
            @ p["ws_down"]
    torch.testing.assert_close(out.reshape(-1, cfg.d_model), want, **LAYER_TOL)
    one = moe.moe_dropless(p, x[:, :1], cfg)
    torch.testing.assert_close(one.reshape(-1, cfg.d_model), want.reshape(3, 7, -1)[:, 0],
                               **LAYER_TOL)


def test_dispatch_order_and_the_grouped_product():
    sel = torch.tensor([[3, 1], [1, 0], [3, 1]])
    order, offs = moe.dispatch_order(sel, 5)
    assert sel.reshape(-1)[order].tolist() == [0, 1, 1, 1, 3, 3]
    assert offs.tolist() == [1, 4, 4, 6, 6] and offs.dtype == torch.int32   # 2 and 4 empty
    g = torch.Generator().manual_seed(0)
    x, wg, wu, wd = (torch.randn(s, generator=g) for s in ((6, 8), (5, 8, 4), (5, 8, 4),
                                                           (5, 4, 8)))
    y = moe.moe_experts(x, offs, wg, wu, wd)
    torch.testing.assert_close(y, moe.experts_loop(x, offs, wg, wu, wd))
    if hasattr(torch, "_grouped_mm"):
        try:
            h = torch._grouped_mm(x, wg, offs=offs)
        except RuntimeError:          # a build without the CPU grouped product
            return
        torch.testing.assert_close(h[1:4], x[1:4] @ wg[1], **LAYER_TOL)


# ---------------------------------------------------------- the decode op
def _plain_latent_attention(q, cache, pos, v_dim, scale):
    """Row by row, head by head, over the written slots only (wrapped rings
    included): the kernel's contract written out."""
    B, _, H, _ = q.shape
    out = torch.zeros(B, 1, H, v_dim, dtype=torch.float64)
    live = written_slots(pos, cache.shape[1])
    for b in range(B):
        rows = cache[b, live[b]].double()
        for h in range(H):
            p = torch.softmax(rows @ q[b, 0, h].double() * scale, dim=0)
            out[b, 0, h] = p @ rows[:, :v_dim]
    return out


@pytest.mark.parametrize("B,S,H,C,R", [(3, 40, 4, 32, 16), (2, 64, 16, 64, 32)])
def test_mla_decode_op_on_the_cpu_is_its_plain_version(B, S, H, C, R):
    g = torch.Generator().manual_seed(B)
    q = torch.randn(B, 1, H, C + R, generator=g)
    cache = torch.randn(B, S, C + R, generator=g)
    pos = torch.tensor([0, S + 5, S - 1][:B])
    out = mla_decode_attention(q, cache, pos, C, 0.17)
    assert torch.equal(out, mla_decode_attention_ref(q, cache, pos, C, 0.17))
    torch.testing.assert_close(out.double(), _plain_latent_attention(q, cache, pos, C, 0.17),
                               **LAYER_TOL)
    meta = mla_decode_attention(q.to("meta"), cache.to("meta"), pos.to("meta"), C, 0.17)
    assert meta.shape == (B, 1, H, C) and meta.device.type == "meta"


# ----------------------------------------------------------------- serving
def test_the_engine_serves_it_and_the_launcher_runs(capsys):
    cfg = _smoke()
    engine = ServeEngine(cfg, M.init_params(cfg, torch.Generator().manual_seed(0)),
                         max_batch=2, max_len=48, device="cpu")
    for n in (5, 3, 4):
        engine.submit(_tokens(n + 6, seed=n).tolist(), max_new_tokens=n)
    done = engine.run()
    assert [len(r.generated) for r in done] == [5, 3, 4]
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--max-len", "48"])
    assert "arch=moonlight-smoke device=cpu served 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", [ARCH, "granite-8b"])
def test_decode_span_counts_the_cache_bytes_its_attention_reads(arch, monkeypatch):
    """``cache_bytes`` of each ``serve.decode``: the active rows' written
    slots times the bytes a slot holds over the layers (MLA: the latent and
    rope values; GQA: K and V of the kv heads), in f32 here."""
    rec = obs.Recorder()
    monkeypatch.setattr(obs, "RECORDER", rec)
    cfg = configs.get_smoke(arch).replace(dtype="float32")
    per_slot = (cfg.num_layers * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 4 if arch == ARCH
                else cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 4)
    assert M.attended_slot_bytes(cfg, 48) == {48: per_slot}
    engine = ServeEngine(cfg, M.init_params(cfg, torch.Generator().manual_seed(0)),
                         max_batch=2, max_len=48, device="cpu")
    seen = []
    decode = engine.decode

    def spy(params, cache, tokens, pos):
        seen.append(sum(int(pos[i]) + 1 for i, s in enumerate(engine.slots) if s.active))
        return decode(params, cache, tokens, pos)
    engine.decode = spy
    for n in (6, 9):
        engine.submit(_tokens(n, seed=n).tolist(), max_new_tokens=4)
    engine.run()
    spans = [s for s in rec.spans if s.name == "serve.decode"]
    assert len(spans) == len(seen) > 0
    assert [s.attrs["cache_bytes"] for s in spans] == [n * per_slot for n in seen]


def test_the_experts_run_under_a_named_op_in_a_trace():
    from torch.profiler import ProfilerActivity, profile
    cfg = _smoke()
    p = _weights(cfg)["layers"]["layer_1"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        moe.moe_dropless(p, torch.randn(1, 6, cfg.d_model), cfg)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "repro_torch::moe_experts" in names


def test_a_latent_leaf_is_split_over_the_batch_only():
    from repro_torch.parallel import sharding as shd

    class Mesh:                                        # duck-typed 16 x 16
        shape = (16, 16)
        mesh_dim_names = ("data", "model")
    cfg = configs.get(ARCH)
    specs = shd.cache_pspecs(M.cache_shapes(cfg, 32, 8192), shd.RULES["baseline"], Mesh(), cfg)
    assert len(specs["layers"]) == 27
    for leaf in specs["layers"].values():
        assert tuple(leaf["ckv"])[:1] == ("data",) and all(e is None for e in tuple(leaf["ckv"])[1:])
