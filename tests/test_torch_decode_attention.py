"""The decode attention over a ring KV cache (``repro_torch::decode_attention``,
``kernels/decode_attention``): the kernel's contract (a softmax over only
each row's written slots, walked back from its newest slot, here one row at
a time) against the op's CPU path, the reference's plain decode attention,
within f32 rounding, for G = H / K of 1, 4 and 8, head_dim 8 to 256,
positions at and past the ring's length, with and without a window, in f32
and bf16; the shard-of-slots path (``decode_attention_slots``, its log-sum-exp too); the
fake implementations on ``meta``, the FLOP formula, and the wrapper's refusal
of CPU tensors. The sharding rule's layouts run on four gloo ranks in
``test_torch_sharding.py``; decode against the JAX reference stays in
``test_torch_model.py`` and ``test_torch_serve.py``. The CUDA kernel itself
is held against ``decode_attention_ref`` on the card by chip_smoke.py
(phase 3)."""

import math

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_kernel, decode_attention_slots_ref, written_slots)

SMAX = 32
POS = [0, 5, SMAX - 1, SMAX + 3, 3 * SMAX + 7]        # start, inside, last slot, wrapped
GROUPS = (1, 4, 8)
HEAD_DIMS = (8, 16, 128, 256)
WINDOWS = (None, 8)
DTYPES = (torch.float32, torch.bfloat16)
K = 2
# the contract's softmax against the plain one: f32 sums in another order;
# in bf16, the output's one rounding may fall either way (one ulp, 2^-8)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.bfloat16: dict(rtol=2 ** -7, atol=1e-6)}


def _inputs(G, D, dtype, seed=0, S=SMAX):
    """q and a cache whose every slot holds noise, the unwritten ones too."""
    gen = torch.Generator().manual_seed(seed + 31 * G + D)
    q = torch.randn((len(POS), 1, K * G, D), generator=gen).to(dtype)
    k, v = (torch.randn((len(POS), S, K, D), generator=gen).to(dtype) for _ in range(2))
    return q, k, v, torch.tensor(POS)


def _row_by_row(q, cache_k, cache_v, pos, window, slot0=0, ring=None):
    """The kernel's contract one row at a time: row b reads the slots of age
    0 .. n_b - 1, walking back from its newest slot and wrapping the ring,
    n_b = min(pos_b + 1, ring, window); of a shard holding slots slot0 ..
    slot0 + S - 1, only those. f32 softmax over them; (o f32, lse)."""
    B, _, H, D = q.shape
    S, K = cache_k.shape[1], cache_k.shape[2]
    G, ring = H // K, S if ring is None else ring
    o = torch.zeros((B, 1, H, D))
    lse = torch.full((B, H), -math.inf)
    for b in range(B):
        p = int(pos[b])
        n = min(p + 1, ring, window or ring)
        slots = [(p - a) % ring - slot0 for a in range(n)]
        slots = torch.tensor([j for j in slots if 0 <= j < S], dtype=torch.long)
        if not len(slots):
            continue
        for h in range(H):
            kk, vv = cache_k[b, slots, h // G].float(), cache_v[b, slots, h // G].float()
            s = kk @ q[b, 0, h].float() * D ** -0.5
            lse[b, h] = torch.logsumexp(s, 0)
            o[b, 0, h] = torch.softmax(s, 0) @ vv
    return o, lse


CASES = [(G, D, w, dt) for G in GROUPS for D in HEAD_DIMS for w in WINDOWS for dt in DTYPES]


def _id(case):
    G, D, w, dt = case
    return f"G{G}-D{D}-w{w}-{str(dt)[6:]}"


@pytest.mark.parametrize("G,D,window,dtype", CASES, ids=[_id(c) for c in CASES])
def test_written_slots_only_match_the_plain_softmax(G, D, window, dtype):
    """Skipping the slots the plain code gives -1e30 leaves out no
    mathematics: their weight is exactly 0, so a softmax over the written
    slots alone (the kernel's contract) matches within f32 rounding."""
    q, k, v, pos = _inputs(G, D, dtype)
    o, _ = _row_by_row(q, k, v, pos, window)
    torch.testing.assert_close(o.to(dtype).float(), decode_attention(
        q, k, v, pos, window=window).float(), **TOL[dtype])


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("slot0,S", [(0, SMAX), (0, 8), (8, 8), (24, 8), (16, 16)])
def test_slots_of_a_shard_and_their_lse(slot0, S, window):
    """``decode_attention_slots_ref`` on a shard of the ring (slots slot0 ..
    slot0 + S - 1 of 32): the written slots there and their log-sum-exp (-inf
    and a 0 output where the shard holds none of a row's slots)."""
    q, k, v, pos = _inputs(4, 16, torch.float32, seed=1, S=SMAX)
    ks, vs = k[:, slot0:slot0 + S].contiguous(), v[:, slot0:slot0 + S].contiguous()
    o, lse = decode_attention_slots_ref(q, ks, vs, pos, window, slot0, SMAX)
    o_ref, lse_ref = _row_by_row(q, ks, vs, pos, window, slot0, SMAX)
    torch.testing.assert_close(o, o_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-6)
    n_written = written_slots(pos, S, window, slot0, SMAX).sum(1)
    assert torch.isinf(lse[n_written == 0]).all() and torch.isfinite(lse[n_written > 0]).all()


def test_shards_combined_by_lse_equal_the_whole_ring():
    """Four shards of 8 slots, each one's output weighted by exp(lse - max):
    the whole ring's output (what the op does across ranks)."""
    q, k, v, pos = _inputs(4, 16, torch.float32, seed=2)
    parts = [decode_attention_slots_ref(q, k[:, s:s + 8], v[:, s:s + 8], pos, None, s, SMAX)
             for s in range(0, SMAX, 8)]
    lse = torch.stack([p[1] for p in parts])
    w = torch.exp(lse - lse.amax(0))
    o = sum(p[0] * wi[:, None, :, None] for p, wi in zip(parts, w)) / w.sum(0)[:, None, :, None]
    torch.testing.assert_close(o, decode_attention(q, k, v, pos), rtol=1e-5, atol=1e-6)


def test_written_slots_count():
    """n_b = min(pos_b + 1, Smax, window) slots a row, ending at pos_b % Smax."""
    live = written_slots(torch.tensor(POS), SMAX)
    assert live.sum(1).tolist() == [1, 6, SMAX, SMAX, SMAX]
    assert live[1].nonzero().flatten().tolist() == list(range(6))
    live = written_slots(torch.tensor(POS), SMAX, window=8)
    assert live.sum(1).tolist() == [1, 6, 8, 8, 8]
    assert live[3].nonzero().flatten().tolist() == [0, 1, 2, 3, 28, 29, 30, 31]


def test_fake_gives_shapes_on_meta():
    q = torch.empty((3, 1, 8, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((3, 64, 2, 128), dtype=torch.bfloat16, device="meta")
    pos = torch.empty((3,), dtype=torch.long, device="meta")
    out = decode_attention(q, k, k, pos, window=16)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
    o, lse = torch.ops.repro_torch.decode_attention_slots(q, k, k, pos, 0, 64, 128)
    assert o.shape == q.shape and o.dtype == torch.float32
    assert lse.shape == (3, 8) and lse.dtype == torch.float32


def test_flop_formula_counts_every_slot_as_written():
    """Shapes only: 4 B H D Smax, what the replaced einsums counted."""
    q = torch.empty((3, 1, 8, 128), device="meta")
    k = torch.empty((3, 64, 2, 128), device="meta")
    pos = torch.empty((3,), dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as counter:
        decode_attention(q, k, k, pos)
    assert counter.get_total_flops() == 4 * 3 * 8 * 128 * 64


def test_kernel_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises: no plain fallback."""
    q, k, v, pos = _inputs(4, 16, torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        decode_attention_kernel(q, k, v, pos)
    assert decode_attention_kernel.launches == 0


def test_window_must_be_positive():
    q, k, v, pos = _inputs(1, 16, torch.float32)
    with pytest.raises(ValueError, match="window"):
        decode_attention(q, k, v, pos, window=0)
