"""Mixture-of-Experts layer: top-k routing with capacity-based dense dispatch
(port of ``repro.models.moe``).

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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, swiglu
from repro_torch.parallel.ctx import constrain_logical

__all__ = ["moe_specs", "route", "capacity", "slots", "moe_apply", "moe_decode_apply"]


def moe_specs(cfg) -> dict:
    D, E, F_ = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {
        "router": ParamSpec((D, E), ("embed", "experts")),
        "we_gate": ParamSpec((E, D, F_), ("experts", "embed", "ff"), fan_in_axes=(1,)),
        "we_up": ParamSpec((E, D, F_), ("experts", "embed", "ff"), fan_in_axes=(1,)),
        "we_down": ParamSpec((E, F_, D), ("experts", "ff", "embed"), fan_in_axes=(1,)),
    }


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
