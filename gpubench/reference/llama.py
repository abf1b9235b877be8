"""A Llama-architecture decoder (granite-8b-code) in plain PyTorch, float32:
RMSNorm, GQA self-attention with rotary embeddings on split halves
(rotate_half), SwiGLU MLP, untied unembedding; published description, no
departures. It reads a configuration's published keys and the weights the
benchmark made (laid out as :func:`param_layout` says), and computes the
logits of whole sequences, one layer at a time."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpubench.reference.precision import F32

__all__ = ["param_layout", "logits"]


def _dims(cfg: dict):
    D, H, K = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return D, H, K, cfg.get("head_dim") or D // H, cfg["intermediate_size"], cfg["vocab_size"]


def param_layout(cfg: dict) -> dict:
    """{name: (shape, std)} (nested; std None = ones): the weights' names and
    shapes as the benchmark hands them to both sides. Layers are stacked on
    a leading dim; a projection's input width comes first."""
    D, H, K, Dh, Ff, V = _dims(cfg)
    L = cfg["num_hidden_layers"]
    lin = lambda *s, fan: ((L, *s), fan ** -0.5)  # noqa: E731
    return {
        "embed": ((V, D), 0.02),
        "final_norm": ((D,), None),
        "unembed": ((D, V), D ** -0.5),
        "layers": {
            "pre_norm": ((L, D), None), "mlp_norm": ((L, D), None),
            "wq": lin(D, H, Dh, fan=D), "wk": lin(D, K, Dh, fan=D), "wv": lin(D, K, Dh, fan=D),
            "wo": lin(H, Dh, D, fan=H * Dh),
            "wi_gate": lin(D, Ff, fan=D), "wi_up": lin(D, Ff, fan=D), "wo_mlp": lin(Ff, D, fan=Ff),
        },
    }


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, theta):
    """x: (S, heads, Dh); rotation of the halves by position * theta^(-2i/Dh)."""
    S, _, Dh = x.shape
    half = Dh // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@torch.no_grad()
def logits(params: dict, cfg: dict, tokens: torch.Tensor, start: int = 0,
           matmul=F32) -> torch.Tensor:
    """Logits (S - start, V) in float32 of positions start..S-1 of one
    sequence ``tokens`` (S,): position t predicts token t + 1."""
    D, H, K, Dh, Ff, V = _dims(cfg)
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    S, G = tokens.shape[0], H // K
    lp = params["layers"]
    x = params["embed"][tokens].float()
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    for i in range(cfg["num_hidden_layers"]):
        h = _rms(x, lp["pre_norm"][i], eps)
        q = _rope(matmul(h, lp["wq"][i].reshape(D, H * Dh)).reshape(S, H, Dh), theta)
        k = _rope(matmul(h, lp["wk"][i].reshape(D, K * Dh)).reshape(S, K, Dh), theta)
        v = matmul(h, lp["wv"][i].reshape(D, K * Dh)).reshape(S, K, Dh)
        k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) * Dh ** -0.5
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * Dh)
        del s, p
        x = x + matmul(o, lp["wo"][i].reshape(H * Dh, D))
        h = _rms(x, lp["mlp_norm"][i], eps)
        x = x + matmul(F.silu(matmul(h, lp["wi_gate"][i])) * matmul(h, lp["wi_up"][i]),
                       lp["wo_mlp"][i])
    x = _rms(x[start:], params["final_norm"], eps)
    return matmul(x, params["unembed"])
