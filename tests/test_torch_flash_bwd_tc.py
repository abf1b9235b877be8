"""The bf16 route of the flash backward kernel (csrc/flash_attention_bwd.cu)
as plain torch: ``_flash_bwd_tc_emulation`` repeats its arithmetic (L by an
online max and sum over kv tiles in base 2, P and dS rounded to bf16 only
where they are a product's A operand, every sum in f32, per-q-head dK and
dV partials summed over the group in the reduce kernel's order, one
rounding of each output), and is held against ``jax.grad`` of the
reference's ``attention_chunked`` and against ``flash_bwd_ref``, the
kernel's plain version, within chip_smoke.py's ``BWD_REL`` (bf16: 1 % of
each gradient's scale). Without its roundings, in f32, it is
``flash_bwd_ref`` to the sums' order. The CUDA kernel itself is held
against ``flash_bwd_ref`` on the card by chip_smoke.py (phase 3)."""

import math

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.ref import attention_chunked as jax_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_bwd_ref  # noqa: E402

BWD_REL = 1e-2                          # chip_smoke.py's BWD_REL for bf16
F32_TOL = dict(rtol=2e-5, atol=2e-5)    # f32 sums in another order

# (B, Sq, Sk, H, K, D, causal, window, block): recurrentgemma-smoke's heads
# (K = 1, G = 4, D = 16, its window of 32); G = 2 at D = 64 over 2 q and kv
# tiles of the kernel; llama3-smoke's head_dim 8 (run at 16); a call that is
# not causal with Sq != Sk (a cross-attention's shape); recurrentgemma-2b's
# heads (G = 10, D = 256, the kernel's 8-warp dK/dV pass) with a window.
# ``block`` is the reference's q_block and k_block.
CASES = [(2, 100, 100, 4, 1, 16, True, 32, 20), (2, 130, 130, 4, 2, 64, True, None, 26),
         (2, 45, 45, 8, 2, 8, True, None, 15), (1, 48, 100, 4, 2, 32, False, None, 16),
         (1, 96, 96, 10, 1, 256, True, 40, 32)]
IDS = ["recurrentgemma-smoke", "G2-D64", "D8", "full-SqneSk", "recurrentgemma-2b-heads"]


def _inputs(B, Sq, Sk, H, K, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Sk, K, D), np.float32),
            rng.standard_normal((B, Sk, K, D), np.float32),
            rng.standard_normal((B, Sq, H, D), np.float32))


def _keep(Sq, Sk, causal, window):
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= qpos - kpos < window
    return ok


def _flash_bwd_tc_emulation(g, q, k, v, o, *, causal, window, round_bf16=True, scale=None):
    """dq, dk, dv as the bf16 route computes them. (a): S = Q K^T in f32
    (products of bf16 exact), scaled by scale log2 e; L = m + log2 l by the
    online max and sum over kv tiles of 64 keys (32 at D = 256), +inf for a
    row no key is left to; Delta = rowsum(dO o O) in f32. (b), (c): P =
    exp2(S - L) where the masks keep the pair, dP = dO V^T, dS = P o (dP -
    Delta); P and dS rounded to bf16 as the A operands of dV += P^T dO, dK
    += dS^T Q and dQ += dS K; dK and dV per q head in f32, then summed over
    the G heads of a kv head in order g = 0 .. G - 1; each output rounded
    once to the inputs' dtype. ``round_bf16=False`` keeps P and dS in f32."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = D ** -0.5 if scale is None else scale
    sl2 = scale * math.log2(math.e)
    qf, gf, of = (t.float().transpose(1, 2) for t in (q, g, o))              # (B,H,Sq,D)
    kf, vf = (t.float().repeat_interleave(G, dim=2).transpose(1, 2) for t in (k, v))
    ok = _keep(Sq, Sk, causal, window)
    s = qf @ kf.transpose(-1, -2) * sl2                                       # (B,H,Sq,Sk)

    bk = 64 if D <= 128 else 32
    m = torch.full((B, H, Sq), float("-inf"))
    l = torch.zeros((B, H, Sq))
    for k0 in range(0, Sk, bk):
        x = torch.where(ok[:, k0:k0 + bk], s[..., k0:k0 + bk], float("-inf"))
        m_new = torch.maximum(m, x.amax(-1))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        l = torch.exp2(m - m_use) * l + torch.exp2(x - m_use[..., None]).sum(-1)
        m = m_new
    lse = torch.where(l > 0, m + torch.log2(l), float("inf"))
    delta = (gf * of).sum(-1)

    p = torch.where(ok, torch.exp2(s - lse[..., None]), 0.0)
    ds = p * (gf @ vf.transpose(-1, -2) - delta[..., None])
    a_p, a_s = (x.bfloat16().float() if round_bf16 else x for x in (p, ds))
    dv_h = a_p.transpose(-1, -2) @ gf                                         # (B,H,Sk,D)
    dk_h = a_s.transpose(-1, -2) @ qf * scale
    dq = a_s @ kf * scale
    dk, dv = torch.zeros((B, K, Sk, D)), torch.zeros((B, K, Sk, D))
    for gg in range(G):                       # the reduce kernel's order
        dk += dk_h[:, gg::G]
        dv += dv_h[:, gg::G]
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _run(g, q, k, v, o, *, causal, window, round_bf16=True):
    """The emulation as the kernel is called: head_dim 8 zero-filled to the
    compute width 16, the scale kept at 8^-0.5, 8 columns returned."""
    D = q.shape[-1]
    if D >= 16:
        return _flash_bwd_tc_emulation(g, q, k, v, o, causal=causal, window=window,
                                       round_bf16=round_bf16)
    padded = [torch.nn.functional.pad(t, (0, 16 - D)) for t in (g, q, k, v, o)]
    out = _flash_bwd_tc_emulation(*padded, causal=causal, window=window,
                                  round_bf16=round_bf16, scale=D ** -0.5)
    assert all(not t[..., D:].any() for t in out)
    return tuple(t[..., :D] for t in out)


def _rel(x, ref) -> float:
    x, ref = (torch.as_tensor(np.asarray(t, dtype=np.float64)) for t in (x, ref))
    return ((x - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window,block", CASES, ids=IDS)
def test_bf16_emulation_matches_jax_grad_and_flash_bwd_ref(B, Sq, Sk, H, K, D, causal,
                                                          window, block):
    """bf16 inputs and the forward's bf16 output: the emulation's dq, dk, dv
    against jax.grad of the reference's attention_chunked (in f32 on the
    same bf16 values) and against flash_bwd_ref (which rounds its f32
    gradients once to bf16), each within 1 % of the gradient's scale."""
    arrays = _inputs(B, Sq, Sk, H, K, D, seed=Sq + 7 * H + D)
    q, k, v, g = (torch.from_numpy(a).bfloat16() for a in arrays)
    o = attention_ref(q, k, v, causal=causal, window=window)
    assert o.dtype == torch.bfloat16
    ours = _run(g, q, k, v, o, causal=causal, window=window)
    assert all(t.dtype == torch.bfloat16 for t in ours)

    jq, jk, jv, jg = (jnp.asarray(t.float().numpy()) for t in (q, k, v, g))
    _, vjp = jax.vjp(lambda *x: jax_chunked(*x, causal=causal, window=window, q_block=block,
                                            k_block=block), jq, jk, jv)
    plain = flash_bwd_ref(g, q, k, v, causal=causal, window=window)
    for name, a, r, p in zip("qkv", ours, vjp(jg), plain):
        a = a.float().numpy()
        assert _rel(a, r) <= BWD_REL, f"d{name} against jax.grad: {_rel(a, r):.3e}"
        assert _rel(a, p.float().numpy()) <= BWD_REL, f"d{name} against flash_bwd_ref"


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window,block", CASES, ids=IDS)
def test_f32_emulation_without_rounding_is_flash_bwd_ref(B, Sq, Sk, H, K, D, causal, window,
                                                         block):
    """The tiling of L, the masks, the base-2 softmax and the per-head
    partials summed in the reduce kernel's order alone, in f32 with P and dS
    unrounded: flash_bwd_ref to the sums' order."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(B, Sq, Sk, H, K, D, seed=D + Sk))
    o = attention_ref(q, k, v, causal=causal, window=window)
    ours = _run(g, q, k, v, o, causal=causal, window=window, round_bf16=False)
    plain = flash_bwd_ref(g, q, k, v, causal=causal, window=window, q_block=block,
                          k_block=block)
    for name, a, r in zip("qkv", ours, plain):
        torch.testing.assert_close(a, r, **F32_TOL, msg=lambda m, name=name: f"d{name}: {m}")
