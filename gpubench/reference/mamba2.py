"""Mamba-2 (the SSD layer; no attention, no MLP) in plain PyTorch, float32:
in-projection to (z, x, B, C, dt), a causal depthwise conv over (x, B, C)
with SiLU, dt = softplus(dt + dt_bias), A = -exp(A_log), the SSD scan with
one group of B and C, the D skip, the gated RMSNorm norm(y * silu(z)), the
out-projection, pre-norm residual blocks, a final RMSNorm and the head tied
to the embedding; the next-token cross entropy. Departure: the published
model keeps the residual stream in f32 and so does this reference; the
benchmark runs the port with it in bf16 (its configuration's ``reduced``).
Gradients are autograd of this function, taken over blocks of rows so that
float32 activations fit the card."""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from gpubench.reference.precision import F32
from gpubench.reference.ssd import ssd_ref

__all__ = ["param_layout", "loss_and_grads"]


def _dims(cfg: dict):
    a = cfg["assumed"]
    D = cfg["d_model"]
    d_inner = a["expand"] * D
    H = d_inner // a["headdim"]
    return D, d_inner, H, a["headdim"], a["d_state"], a["d_conv"], a["padded_vocab_size"]


def param_layout(cfg: dict) -> dict:
    """{name: (shape, init)} (nested): init is a std for N(0, std), None for
    ones, 0.0 for zeros, or "A_log" / "dt_bias" for Mamba-2's own inits."""
    D, d_inner, H, P, N, W, V = _dims(cfg)
    L = cfg["n_layer"]
    conv = d_inner + 2 * N
    return {
        "embed": ((V, D), 0.02),
        "final_norm": ((D,), None),
        "layers": {
            "pre_norm": ((L, D), None),
            "in_proj": ((L, D, 2 * d_inner + 2 * N + H), D ** -0.5),
            "conv_w": ((L, W, conv), W ** -0.5),
            "conv_b": ((L, conv), 0.0),
            "A_log": ((L, H), "A_log"),
            "dt_bias": ((L, H), "dt_bias"),
            "D_skip": ((L, H), None),
            "gate_norm": ((L, d_inner), None),
            "out_proj": ((L, d_inner, D), d_inner ** -0.5),
        },
    }


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _layer(p, x, cfg, matmul):
    D, d_inner, H, P, N, W, _ = _dims(cfg)
    eps = cfg["assumed"]["norm_epsilon"]
    B, S, _ = x.shape
    proj = matmul(_rms(x, p["pre_norm"], eps), p["in_proj"])
    z, xbc, dt = proj.split([d_inner, d_inner + 2 * N, H], dim=-1)
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    xbc = F.silu(sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(W)) + p["conv_b"])
    xs, Bm, Cm = xbc.split([d_inner, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    xh = xs.reshape(B, S, H, P)
    y = ssd_ref(xh, dt, -torch.exp(p["A_log"]), Bm, Cm, chunk=cfg["assumed"]["chunk_size"])
    y = (y + p["D_skip"][:, None] * xh).reshape(B, S, d_inner)
    y = _rms(y * F.silu(z), p["gate_norm"], eps)
    return x + matmul(y, p["out_proj"])


def _loss_sum(params, cfg, tokens, matmul):
    """The summed next-token cross entropy of rows ``tokens`` (b, S)."""
    lp = params["layers"]
    x = params["embed"][tokens]
    for i in range(cfg["n_layer"]):
        x = torch.utils.checkpoint.checkpoint(
            _layer, {k: v[i] for k, v in lp.items()}, x, cfg, matmul, use_reentrant=False)
    x = _rms(x, params["final_norm"], cfg["assumed"]["norm_epsilon"])
    logits = matmul(x[:, :-1], params["embed"].T)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1), reduction="sum")


def loss_and_grads(params: dict, cfg: dict, tokens: torch.Tensor, *, rows: int = 4,
                   matmul=F32):
    """The mean next-token cross entropy over every prediction of ``tokens``
    (B, S) and its gradient (a tree like ``params``), float32 throughout,
    taken ``rows`` rows at a time (each block's layers recomputed in the
    backward) and summed."""
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
        t.grad = None
    n = tokens.shape[0] * (tokens.shape[1] - 1)
    total = 0.0
    for r in range(0, tokens.shape[0], rows):
        loss = _loss_sum(params, cfg, tokens[r:r + rows], matmul) / n
        loss.backward()
        total += float(loss.detach())
    grads = _unflatten(params, [t.grad for t in leaves])
    for t in leaves:
        t.requires_grad_(False)
        t.grad = None
    return total, grads


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) for k in sorted(t)} if isinstance(t, dict) else next(it)
    return build(like)
