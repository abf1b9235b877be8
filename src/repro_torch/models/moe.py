"""Mixture-of-Experts layer: top-k routing with capacity-based dense dispatch
(port of ``repro.models.moe``), and the DeepSeek-V3 form (Moonlight): a
sigmoid router with a correction bias, dropless dispatch and shared experts.

Routing: the router's logits in the compute dtype, softmax in f32, the top
k experts per token and their gates renormalised over those k. Dispatch:
each expert takes at most ``capacity`` tokens of a batch row, in sequence
order (a token's slot is the exclusive cumsum of its expert's assignments
over the row); tokens past the capacity are dropped for that expert. The
expert products are plain batched matmuls, as they are plain einsums outside
any Pallas kernel in the reference; this layer launches no kernel of its
own.

The router aux (load-balancing) loss follows Switch/Mixtral:
``E · Σ_e f_e · p_e`` with f the dispatch fraction (dropped tokens
included) and p the mean router probability per expert.

With ``router_scoring == "sigmoid"`` (``noaux_tc`` in the published
config, one expert group): scores are the sigmoid of the router's logits in
f32; the top k of score plus ``router_bias`` (the published
``e_score_correction_bias``) choose the experts, the bias weighting none;
each chosen expert's weight is its score over the k scores' sum, times
``routed_scaling``. Dispatch drops nothing, in prefill and decode alike: the
(token, expert) assignments are sorted by expert and the experts run as one
grouped GEMM over the sorted tokens (the op ``repro_torch::moe_experts``),
with the group offsets counted on the device, so no host read and no copy
of an expert's weights per token; each expert touched is read once a call.
Outputs return to their tokens' order and are summed over k in f32, then
``num_shared_experts`` experts of ``moe_d_ff`` (one SwiGLU of their summed
width) are added for every token. That path has no aux loss (its
training-time balance term is out of scope: 0 is returned).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.models.layers import ParamSpec, swiglu
from repro_torch.parallel.ctx import constrain_logical

__all__ = ["moe_specs", "route", "capacity", "slots", "moe_apply", "moe_decode_apply",
           "route_sigmoid", "dispatch_order", "moe_experts", "experts_loop", "moe_dropless"]


def moe_specs(cfg) -> dict:
    D, E, F_ = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    s = {
        "router": ParamSpec((D, E), ("embed", "experts")),
        "we_gate": ParamSpec((E, D, F_), ("experts", "embed", "ff"), fan_in_axes=(1,)),
        "we_up": ParamSpec((E, D, F_), ("experts", "embed", "ff"), fan_in_axes=(1,)),
        "we_down": ParamSpec((E, F_, D), ("experts", "ff", "embed"), fan_in_axes=(1,)),
    }
    if cfg.router_scoring == "sigmoid":
        s["router_bias"] = ParamSpec((E,), ("experts",), init="zeros")
    if cfg.num_shared_experts:
        Fs = cfg.num_shared_experts * F_
        s.update(ws_gate=ParamSpec((D, Fs), ("embed", "ff")),
                 ws_up=ParamSpec((D, Fs), ("embed", "ff")),
                 ws_down=ParamSpec((Fs, D), ("ff", "embed")))
    return s


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """x: (..., D) → (probs (..., E) f32, top-k probs (..., k), experts
    (..., k)): the router's logits in x's dtype, softmax in f32, then top-k."""
    probs = torch.softmax((x @ router.to(x.dtype)).float(), dim=-1)
    gate_vals, sel = torch.topk(probs, k, dim=-1)
    return probs, gate_vals, sel


def capacity(cfg, S: int) -> int:
    """Tokens an expert takes per batch row: evaluated in the reference's
    order in Python floats, since a reordered product can round to another
    integer."""
    return max(int(S * cfg.num_experts_per_tok / cfg.num_experts * cfg.capacity_factor), 1)


def slots(sel: torch.Tensor, E: int, C: int):
    """sel (B, S, k) → (onehot (B, S, k, E) f32, assign (B, S, E) 0/1 f32,
    pos_in_expert (B, S, E), keep (B, S, E) bool): a token's slot in its
    expert's buffer is the exclusive cumsum of ``assign`` over the row; it
    is kept iff below C."""
    onehot = F.one_hot(sel, E).float()                             # (B,S,k,E)
    assign = onehot.sum(2)
    pos_in_expert = torch.cumsum(assign, dim=1) - assign
    return onehot, assign, pos_in_expert, (assign > 0) & (pos_in_expert < C)


def moe_decode_apply(p: dict, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse decode path: gather only the top-k experts' weights per row,
    (B, k, D, F) slices, which reads fewer weights than the dense dispatch
    whenever B·k < E. Numerically the dense path at S = 1 (no drops there).
    x: (B, 1, D) → (out (B, 1, D), aux 0)."""
    k = cfg.num_experts_per_tok
    xt = x[:, 0]                                                   # (B, D)
    _, gate_vals, sel = route(xt, p["router"], k)
    gate_vals = (gate_vals / gate_vals.sum(-1, keepdim=True)).to(x.dtype)
    wg = p["we_gate"][sel].to(x.dtype)                             # (B, k, D, F)
    wu = p["we_up"][sel].to(x.dtype)
    xr = xt[:, None, None, :]                                      # (B, 1, 1, D)
    h = swiglu(xr @ wg, xr @ wu)                                   # (B, k, 1, F)
    del wg, wu
    y = (h @ p["we_down"][sel].to(x.dtype))[:, :, 0]               # (B, k, D)
    out = torch.einsum("bkd,bk->bd", y, gate_vals)
    return out[:, None, :], torch.zeros((), dtype=torch.float32, device=x.device)


def moe_apply(p: dict, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D), aux loss, a 0-d f32 tensor)."""
    if cfg.router_scoring == "sigmoid":
        return moe_dropless(p, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    if S == 1 and B * k < E:
        return moe_decode_apply(p, x, cfg)
    C = capacity(cfg, S)

    probs, gate_vals, sel = route(x, p["router"], k)               # (B,S,E), (B,S,k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    onehot, assign, pos_in_expert, keep = slots(sel, E, C)
    slot = (pos_in_expert[..., None] == torch.arange(C, device=x.device)).float()
    dispatch = torch.where(keep[..., None], slot, 0.0)             # (B,S,E,C)
    gates_e = torch.einsum("bske,bsk->bse", onehot, gate_vals)
    combine = dispatch * gates_e[..., None]                        # (B,S,E,C) f32

    xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), x)
    xin = constrain_logical(xin, ("experts", "batch", "cap", "act_embed"))
    h = swiglu(torch.einsum("ebcd,edf->ebcf", xin, p["we_gate"].to(x.dtype)),
               torch.einsum("ebcd,edf->ebcf", xin, p["we_up"].to(x.dtype)))
    hout = torch.einsum("ebcf,efd->ebcd", h, p["we_down"].to(x.dtype))
    hout = constrain_logical(hout, ("experts", "batch", "cap", "act_embed"))
    out = torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), hout)
    out = constrain_logical(out, ("batch", "seq", "act_embed"))

    # load-balancing aux loss: dropped tokens count, as `assign` holds them
    frac_dispatch = assign.mean(dim=(0, 1))                        # (E,)
    frac_prob = probs.mean(dim=(0, 1))                             # (E,)
    aux = E * (frac_dispatch * frac_prob).sum() * cfg.router_aux_coef
    return out, aux


# ------------------------------------------------ sigmoid router, dropless
def route_sigmoid(x: Tensor, router: Tensor, bias: Tensor, k: int, scaling: float):
    """x: (T, D) → (weights (T, k) f32, experts (T, k)): sigmoid of the
    logits in f32; the top k of scores + bias choose, the scores weight,
    renormalised over the k (the published 1e-20 guard) and times
    ``scaling``."""
    scores = torch.sigmoid(x.float() @ router.float())
    sel = torch.topk(scores + bias.float(), k, dim=-1).indices
    w = scores.gather(-1, sel)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * scaling, sel


def dispatch_order(sel: Tensor, E: int) -> tuple[Tensor, Tensor]:
    """sel (T, k) → (order (T·k,), offs (E,) int32): the assignments sorted
    by expert (stable: token order within an expert), and each expert's end
    in that order, counted on the device (no host read)."""
    flat = sel.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=sel.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return torch.argsort(flat, stable=True), torch.cumsum(counts, 0).to(torch.int32)


def experts_loop(x: Tensor, offs: Tensor, w_gate: Tensor, w_up: Tensor,
                 w_down: Tensor) -> Tensor:
    """The plain grouped SwiGLU: rows offs[e-1]:offs[e] of x through expert
    e, one expert at a time (reads the offsets on the host)."""
    out = x.new_empty((x.shape[0], w_down.shape[-1]))
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            xe = x[start:end]
            out[start:end] = swiglu(xe @ w_gate[e], xe @ w_up[e]) @ w_down[e]
        start = end
    return out


@torch.library.custom_op("repro_torch::moe_experts", mutates_args=())
def moe_experts(x: Tensor, offs: Tensor, w_gate: Tensor, w_up: Tensor,
                w_down: Tensor) -> Tensor:
    """The experts of the sorted assignments: x (N, D) sorted by expert,
    offs (E,) int32 the experts' ends; w_gate, w_up (E, D, F), w_down (E, F,
    D). Returns (N, D). On the card in bf16 three grouped GEMMs
    (``torch._grouped_mm``, the offsets left on the device); elsewhere (the
    CPU, f32 parity checks) :func:`experts_loop`."""
    raise ValueError(f"moe_experts: unsupported device {x.device}")


@moe_experts.register_kernel("cuda")
def _(x, offs, w_gate, w_up, w_down):
    if x.dtype != torch.bfloat16:
        return experts_loop(x, offs, w_gate, w_up, w_down)
    h = swiglu(torch._grouped_mm(x, w_gate, offs=offs), torch._grouped_mm(x, w_up, offs=offs))
    return torch._grouped_mm(h, w_down, offs=offs)


@moe_experts.register_kernel("cpu")
def _(x, offs, w_gate, w_up, w_down):
    return experts_loop(x, offs, w_gate, w_up, w_down)


@moe_experts.register_fake
def _(x, offs, w_gate, w_up, w_down):
    return x.new_empty((x.shape[0], w_down.shape[-1]))


def moe_dropless(p: dict, x: Tensor, cfg) -> Tensor:
    """Sigmoid-routed dropless experts plus the shared experts. x: (B, S, D)
    → (B, S, D), the same path for prefill (S > 1) and decode (S = 1)."""
    shape, D, k = x.shape, x.shape[-1], cfg.num_experts_per_tok
    xt = x.reshape(-1, D)
    w, sel = route_sigmoid(xt, p["router"], p["router_bias"], k, cfg.routed_scaling)
    order, offs = dispatch_order(sel, cfg.num_experts)
    ys = moe_experts(xt[order // k], offs, p["we_gate"].to(x.dtype), p["we_up"].to(x.dtype),
                     p["we_down"].to(x.dtype))
    y = torch.empty_like(ys)
    y[order] = ys                                                  # back to (token, k) order
    out = (y.reshape(-1, k, D).float() * w[..., None]).sum(1).to(x.dtype)
    if cfg.num_shared_experts:
        out = out + swiglu(xt @ p["ws_gate"].to(x.dtype),
                           xt @ p["ws_up"].to(x.dtype)) @ p["ws_down"].to(x.dtype)
    return out.reshape(shape)
