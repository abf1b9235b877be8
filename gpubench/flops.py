"""Operations and bytes: the benchmark's own, frozen, so that a later change
to the port's formulas cannot move a metric.

Copied from the port at the time the benchmark was written:
``attention_pairs`` from ``src/repro_torch/kernels/flash_attention/ops.py``,
``ssd_flops`` from ``src/repro_torch/kernels/ssd/ops.py``, and
``attention_bound`` / ``ssd_counts`` (as ``attention_counts`` and
``ssd_counts``) from ``chip_smoke.py``. The model FLOP counts are counted
from a configuration's published widths and the traffic's shapes.
"""

from __future__ import annotations

from gpubench.peaks import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

__all__ = ["attention_pairs", "attention_counts", "ssd_flops", "ssd_counts", "bound_s",
           "dense_prefill_flops", "dense_decode_flops", "mamba2_train_flops"]


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int | None = None) -> int:
    """(q, k) pairs the mask keeps, q and k positions both counted from 0."""
    total = 0
    for i in range(Sq):
        hi = min(i + 1, Sk) if causal else Sk
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def _causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def attention_counts(B, Sq, Sk, H, K, D, causal, window=None, itemsize=2) -> tuple[float, float]:
    """(FLOPs, bytes) of attention on these inputs: QK^T and PV over the
    (q, k) pairs the mask keeps; q, k, v read and the output written once."""
    pairs = _causal_pairs(Sq) if causal and Sq == Sk and not window else \
        attention_pairs(Sq, Sk, causal, window)
    flops = 4 * B * H * D * pairs
    nbytes = itemsize * B * D * (2 * Sq * H + 2 * Sk * K)
    return float(flops), float(nbytes)


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Operations of the SSD scan in its chunked form: C B^T once per
    (batch row, chunk) over the causal (i, j) pairs (B and C are shared by
    the heads), then per head the masked scores times u over the same
    pairs, the inter-chunk term C h^T (every chunk after the first) and the
    state update (every chunk before the last)."""
    flops = 0
    starts = range(0, S, min(chunk, S))
    for c, c0 in enumerate(starts):
        q = min(chunk, S - c0)
        pairs = q * (q + 1) // 2
        flops += 2 * B * pairs * N
        flops += 2 * B * H * pairs * P
        if c > 0:
            flops += 2 * B * H * q * N * P
        if c < len(starts) - 1:
            flops += 2 * B * H * q * P * N
    return flops


def ssd_counts(B, S, H, P, N, chunk, itemsize=2) -> tuple[float, float]:
    """(FLOPs, bytes) of the SSD scan: x, B, C read and y written once in
    the compute dtype, dt and A read once in f32."""
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * itemsize + (B * S * H + H) * 4
    return float(ssd_flops(B, S, H, P, N, chunk)), float(nbytes)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card needs: max(FLOPs / peak, bytes / bandwidth)."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


# ------------------------------------------------------------ model FLOPs
def _attn_width(cfg: dict) -> int:
    """num_hidden_layers x num_attention_heads x head_dim."""
    heads = cfg["num_attention_heads"]
    return cfg["num_hidden_layers"] * heads * (cfg["hidden_size"] // heads)


def dense_prefill_flops(cfg: dict, prompt_len: int) -> float:
    """A prompt's prefill: 2 x the layers' matmul parameters a token, the
    unembed on the last token only, and 4·L·H·D over the causal pairs."""
    layers = cfg["matmul_params"] - cfg["hidden_size"] * cfg["vocab_size"]
    return float(2 * layers * prompt_len + 2 * cfg["hidden_size"] * cfg["vocab_size"]
                 + 4 * _attn_width(cfg) * _causal_pairs(prompt_len))


def dense_decode_flops(cfg: dict, context: int) -> float:
    """One decoded token that attends over ``context`` positions (itself
    included): 2 x every matmul parameter, and 4·L·H·D·context."""
    return float(2 * cfg["matmul_params"] + 4 * _attn_width(cfg) * context)


def mamba2_train_flops(cfg: dict, rows: int, seq: int) -> float:
    """One training step of ``rows`` x ``seq`` tokens: 6 x the matmul
    parameters a token (the tied head included), and 3 x the SSD forward's
    operations in every layer. Remat's recompute is not counted."""
    a = cfg["assumed"]
    d_inner = a["expand"] * cfg["d_model"]
    H = d_inner // a["headdim"]
    ssd = ssd_flops(rows, seq, H, a["headdim"], a["d_state"], a["chunk_size"])
    return float(6 * cfg["matmul_params"] * rows * seq + 3 * cfg["n_layer"] * ssd)
