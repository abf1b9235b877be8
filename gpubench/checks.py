"""The comparisons that decide ``correct``, and the readings they take.

Serving: for each sampled finished request, the reference runs once over its
prompt and served tokens; a served token's gap is how far the reference's
logit of it lies below the reference's best at that position. The number
compared is the widest gap of the sample. The control (the reference in
float8 in the program's place) is read the same way at the token the control
puts first.

Training: the loss of each of the first three steps, the norm of the first
gradient as the optimizer took it, and the norm of each parameter's change
over the three steps, all by leaf (every layer's slice of a stacked leaf),
as a gap between the program's norm and the reference's over the larger of
the reference's norm of that leaf and of the median leaf.
"""

from __future__ import annotations

import statistics

import torch

from gpubench.reference.precision import F32

__all__ = ["sample_finished", "served_gaps", "leaf_norms", "norm_gaps", "train_numbers",
           "judge"]


def sample_finished(done: list[dict], seed: int, tokens: int, most: int) -> list[dict]:
    """From the finished requests ``done`` (each with ``prompt`` and
    ``generated``), the longest and then others drawn from ``seed`` until
    the sample holds ``tokens`` served tokens or ``most`` requests."""
    if not done:
        return []
    import numpy as np
    rng = np.random.Generator(np.random.PCG64([seed, 0xC4EC]))
    order = sorted(range(len(done)), key=lambda i: (-len(done[i]["generated"]), i))
    rest = [order[0]] + [order[1:][j] for j in rng.permutation(len(order) - 1)]
    out, served = [], 0
    for i in rest:
        if served >= tokens or len(out) >= most:
            break
        out.append(done[i])
        served += len(done[i]["generated"])
    return out


@torch.no_grad()
def served_gaps(ref, params: dict, cfg: dict, sample: list[dict], device,
                control=None) -> list[float]:
    """Per sampled request, the widest gap (in logits) below the reference's
    best at each served position: of the served token, or, with ``control``
    (a matmul precision), of the token the control puts first there."""
    widest = []
    for r in sample:
        prompt, gen = list(r["prompt"]), list(r["generated"])
        seq = torch.tensor(prompt + gen[:-1], dtype=torch.long, device=device)
        start = len(prompt) - 1
        lg = ref.logits(params, cfg, seq, start=start, matmul=F32)
        if control is None:
            pick = torch.tensor(gen, dtype=torch.long, device=device)
        else:
            pick = ref.logits(params, cfg, seq, start=start, matmul=control).argmax(-1)
        gap = lg.max(-1).values - lg.gather(-1, pick[:, None])[:, 0]
        widest.append(float(gap.max()))
        del lg
    return widest


def leaf_norms(pairs) -> dict[str, float]:
    """{name: float64 norm} of (name, tensor) pairs."""
    return {name: float(torch.linalg.vector_norm(t.detach().double())) for name, t in pairs}


def norm_gaps(prog: dict, ref: dict, names=None) -> dict[str, float]:
    """Per leaf, |prog - ref| / max(ref, median leaf's ref); over ``names``
    (default every leaf of ``ref``)."""
    names = list(ref) if names is None else list(names)
    med = statistics.median(ref.values())
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def train_numbers(prog: dict, ref: dict, moved_share: float) -> dict:
    """The training check's numbers from the readings of both sides (each
    {"losses": [3], "grad": {leaf: norm}, "delta": {leaf: norm}}): the
    losses' worst and first relative gaps, and of the norm gaps their worst
    leaf and their median leaf. Leaves whose reference gradient lies under
    ``moved_share`` of the median leaf's move by round-off alone and are
    left out of the change's gaps."""
    rel = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    med = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= moved_share * med]
    out = {"loss_rel": max(rel), "loss_rel_first": rel[0],
           "leaves_left_out": len(ref["grad"]) - len(moved)}
    for key, gaps in (("grad", norm_gaps(prog["grad"], ref["grad"])),
                      ("delta", norm_gaps(prog["delta"], ref["delta"], moved))):
        worst = max(gaps, key=gaps.get)
        out.update({f"{key}_norm_gap": gaps[worst], f"{key}_norm_gap_leaf": worst,
                    f"{key}_norm_gap_median": statistics.median(gaps.values())})
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` (every number with a limit at or under it) and the
    compared numbers as {name: {"value", "limit"}}."""
    compared = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    ok = all(isinstance(c["value"], float) and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared
