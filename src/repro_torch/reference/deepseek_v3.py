"""A DeepSeek-V3-architecture decoder (Moonlight-16B-A3B) in plain PyTorch,
float32 with TF32 off: no kernels, no cache, no batching. It imports nothing
of the port and no JAX, reads a configuration's published keys (the
``config.json`` names: ``hidden_size``, ``kv_lora_rank``, ...) and the
weights laid out as :func:`param_layout` says, and computes the logits of
whole sequences, one layer at a time, in the published form:

  * RMSNorm (``rms_norm_eps``) before attention and before the FFN, and at
    the end; an untied head;
  * multi-head latent attention, not absorbed, no q LoRA: q = x W_q (H x
    (nope + rope)); [c ; k_rope] = x W_kv_a; c through ``kv_norm`` (the
    published ``kv_a_layernorm``); [k_nope ; v] = c W_kv_b per head; rope on
    q_rope and on the one k_rope the heads share; causal softmax of q . k
    times (nope + rope)^-0.5 over v; then W_o;
  * the first ``first_k_dense_replace`` layers a SwiGLU of
    ``intermediate_size``; the others MoE: sigmoid scores of x W_router in
    f32, the top ``num_experts_per_tok`` of scores plus
    ``e_score_correction_bias`` chosen (one group: ``n_group`` 1), each
    weighted by its score over the chosen scores' sum (+1e-20) times
    ``routed_scaling_factor``; every chosen expert applied, none dropped;
    plus ``n_shared_experts`` shared experts as one SwiGLU of their summed
    width, for every token.

Departures, each without effect on the function computed: the rope rotates
split halves (the first rope_dim/2 values against the last), where the
published checkpoint stores the rope columns interleaved and de-interleaves
them first (a fixed permutation of those weight columns; the weights here
are random); attention is taken over blocks of heads so that it fits; the
expert outputs are summed in the order of the chosen experts.

The same module lives at ``src/repro_torch/reference/deepseek_v3.py`` (the
CPU tests' reference) and ``gpubench/reference/deepseek_v3.py`` (the
benchmark's); they differ in the one import that names ``F32``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["param_layout", "logits"]


def F32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in float32."""
    return a.float() @ w.float()


HEAD_BLOCK = 4           # heads a block of the attention takes
# The benchmark's random weights (param_layout's inits), chosen so that the
# random model is not chaotic and its served check still sees the routed
# experts: the token embedding N(0, 1), so that the residual stream does not
# start near zero; the routed experts' output projections at
# ROUTED_OUT_SCALE of the fan-in init. Random experts are unrelated
# functions: at full scale, an expert chosen on a near-tie of the router
# (bf16 and f32 choose differently for a few percent of tokens) swaps a
# token's layer output for an unrelated one, and 27 layers amplify that
# until bf16 and float8 serving read alike against the f32 reference. At
# 0.05 the served check still reads routed outputs zeroed and every choice
# shifted to the next expert as faults (tools/moonlight_faults.py); from 0.1
# up the bf16 program itself reads near the float8 control. The routing
# itself (the router and the bias) is unchanged.
EMBED_STD = 1.0
ROUTED_OUT_SCALE = 0.05
ROUTER_BIAS_STD = 0.01   # the correction bias's spread


def _dims(cfg: dict):
    H = cfg["num_attention_heads"]
    return (cfg["hidden_size"], H, cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"])


def _is_moe(cfg: dict, i: int) -> bool:
    return bool(cfg["n_routed_experts"]) and i >= cfg["first_k_dense_replace"] and \
        i % cfg["moe_layer_freq"] == 0


def param_layout(cfg: dict) -> dict:
    """{name: (shape, std)} (nested; std None = ones): the weights' names and
    shapes as the benchmark hands them to both sides, the port's names. The
    layers are ``layers.layer_{i}``, one subtree each; a projection's input
    width comes first. Linear weights N(0, fan_in^-0.5) but the routed
    experts' output projections (ROUTED_OUT_SCALE of it); the embedding
    N(0, EMBED_STD^2); the correction bias N(0, ROUTER_BIAS_STD^2)."""
    D, H, C, N, R, V = _dims(cfg)
    E, Fe, Ff = cfg["n_routed_experts"], cfg["moe_intermediate_size"], cfg["intermediate_size"]
    Fs, Vocab = cfg["n_shared_experts"] * Fe, cfg["vocab_size"]
    layers = {}
    for i in range(cfg["num_hidden_layers"]):
        lay = {"pre_norm": ((D,), None), "mlp_norm": ((D,), None), "kv_norm": ((C,), None),
               "wq": ((D, H, N + R), D ** -0.5), "wkv_a": ((D, C + R), D ** -0.5),
               "wkv_b": ((C, H, N + V), C ** -0.5), "wo": ((H, V, D), (H * V) ** -0.5)}
        if _is_moe(cfg, i):
            lay.update(router=((D, E), D ** -0.5), router_bias=((E,), ROUTER_BIAS_STD),
                       we_gate=((E, D, Fe), D ** -0.5), we_up=((E, D, Fe), D ** -0.5),
                       we_down=((E, Fe, D), ROUTED_OUT_SCALE * Fe ** -0.5))
            if Fs:
                lay.update(ws_gate=((D, Fs), D ** -0.5), ws_up=((D, Fs), D ** -0.5),
                           ws_down=((Fs, D), Fs ** -0.5))
        else:
            lay.update(wi_gate=((D, Ff), D ** -0.5), wi_up=((D, Ff), D ** -0.5),
                       wo_mlp=((Ff, D), Ff ** -0.5))
        layers[f"layer_{i}"] = lay
    return {"embed": ((Vocab, D), EMBED_STD), "final_norm": ((D,), None),
            "unembed": ((D, Vocab), D ** -0.5), "layers": layers}


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, theta):
    """x: (S, heads, R); rotation of the halves by position * theta^(-2i/R)."""
    S, _, R = x.shape
    half = R // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _swiglu(h, w_gate, w_up, w_down, matmul):
    return matmul(F.silu(matmul(h, w_gate)) * matmul(h, w_up), w_down)


def _mla(lp, h, cfg, matmul):
    D, H, C, N, R, V = _dims(cfg)
    S = h.shape[0]
    q = matmul(h, lp["wq"].reshape(D, H * (N + R))).reshape(S, H, N + R)
    kv_a = matmul(h, lp["wkv_a"])
    c = _rms(kv_a[:, :C], lp["kv_norm"], cfg["rms_norm_eps"])
    kv = matmul(c, lp["wkv_b"].reshape(C, H * (N + V))).reshape(S, H, N + V)
    theta = cfg["rope_theta"]
    q = torch.cat([q[..., :N], _rope(q[..., N:], theta)], dim=-1)
    k = torch.cat([kv[..., :N], _rope(kv_a[:, None, C:], theta).expand(S, H, R)], dim=-1)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    o = torch.empty(S, H, V, device=h.device)
    for h0 in range(0, H, HEAD_BLOCK):
        hs = slice(h0, h0 + HEAD_BLOCK)
        s = torch.einsum("qhd,khd->hqk", q[:, hs], k[:, hs]) * (N + R) ** -0.5
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o[:, hs] = torch.einsum("hqk,khd->qhd", p, kv[:, hs, N:])
        del s, p
    return matmul(o.reshape(S, H * V), lp["wo"].reshape(H * V, D))


def _moe(lp, h, cfg, matmul, routes):
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(matmul(h, lp["router"]))
    sel = torch.topk(scores + lp["router_bias"].float(), k, dim=-1).indices
    w = scores.gather(-1, sel)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    if routes is not None:
        routes.append(sel)
    parts = torch.zeros(h.shape[0], k, h.shape[1], device=h.device)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (sel == e).nonzero(as_tuple=True)
        if tok.numel():
            y = _swiglu(h[tok], lp["we_gate"][e], lp["we_up"][e], lp["we_down"][e], matmul)
            parts[tok, slot] = y * w[tok, slot, None]
    out = parts.sum(1)
    if cfg["n_shared_experts"]:
        out = out + _swiglu(h, lp["ws_gate"], lp["ws_up"], lp["ws_down"], matmul)
    return out


@torch.no_grad()
def logits(params: dict, cfg: dict, tokens: torch.Tensor, start: int = 0, matmul=F32,
           routes: list | None = None) -> torch.Tensor:
    """Logits (S - start, V) in float32 of positions start..S-1 of one
    sequence ``tokens`` (S,): position t predicts token t + 1. ``routes``,
    when a list, gets each MoE layer's chosen experts (S, k) in order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = cfg["rms_norm_eps"]
    x = params["embed"][tokens].float()
    for i in range(cfg["num_hidden_layers"]):
        lp = params["layers"][f"layer_{i}"]
        x = x + _mla(lp, _rms(x, lp["pre_norm"], eps), cfg, matmul)
        h = _rms(x, lp["mlp_norm"], eps)
        if _is_moe(cfg, i):
            x = x + _moe(lp, h, cfg, matmul, routes)
        else:
            x = x + _swiglu(h, lp["wi_gate"], lp["wi_up"], lp["wo_mlp"], matmul)
    x = _rms(x[start:], params["final_norm"], eps)
    return matmul(x, params["unembed"])
