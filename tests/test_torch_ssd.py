"""Port's SSD path against the JAX package, on the same numpy inputs and
carried weights: the plain scan (the CPU path of
``repro_torch.kernels.ssd.ssd``) vs the reference Pallas kernel in interpret
mode and vs the reference ``ssd_ref``; the final state the mamba2 prefill
takes from ``ssd_ref`` and the one-token decode step, vs the reference's;
the kernel's gradient rule vs ``jax.grad`` through the reference; the
wiring of the custom op that wraps the kernel; and the Mamba-2 mixer
``ssm_apply``. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py (phase 3)."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.ssd.ops import ssd as jax_ssd  # noqa: E402
from repro.kernels.ssd.ref import ssd_decode_step_ref as jax_ssd_decode_step  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel_module  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import (ssd, ssd_decode_step, ssd_kernel, ssd_ref,  # noqa: E402
                                     ssd_vjp)
from repro_torch.models import ssm as TS  # noqa: E402

# float32: the two sides differ by summation order only (the port sums cum in
# f64 and rounds once; the reference in f32). bf16: by the rounding of each
# output. At most 1e-4 and 2e-2.
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(B, S, H, P, N, seed):
    """Reference-test statistics: x, B, C ~ N(0, 1), dt = softplus(N(0, 1)),
    A = -exp(N(0, 1)); dt and A in f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _torch(x, dt, A, Bm, Cm, dtype):
    cast = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    return cast(x), torch.from_numpy(dt), torch.from_numpy(A), cast(Bm), cast(Cm)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 1, 2, 16, 16, 32),      # one step
    (1, 20, 3, 16, 16, 32),     # S < chunk: one short chunk
    (2, 77, 3, 16, 16, 32),     # B > 1, ragged last chunk
    (1, 100, 2, 24, 40, 32),    # P, N not powers of two, ragged
    (2, 96, 3, 12, 20, 32),     # S a multiple of chunk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ssd_matches_pallas_and_ref(B, S, H, P, N, chunk, dtype):
    x, dt, A, Bm, Cm = _inputs(B, S, H, P, N, seed=B + S + P + N)
    jin = (jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(A),
           jnp.asarray(Bm, dtype), jnp.asarray(Cm, dtype))
    pallas = jax_ssd(*jin, chunk=chunk, use_pallas=True)
    ref = jax_ssd_ref(*jin, chunk=chunk)
    before = ssd_kernel.launches
    out = ssd(*_torch(x, dt, A, Bm, Cm, dtype), chunk=chunk)
    assert ssd_kernel.launches == before          # a CPU tensor never launches
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, S, H, P)
    out = out.float().numpy()
    np.testing.assert_allclose(out, np.asarray(pallas, np.float32), **TOL[dtype])
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 1, 2, 16, 16, 32),      # one step
    (2, 77, 3, 16, 16, 32),     # ragged last chunk: the padded steps must not move h
    (2, 96, 3, 12, 20, 32),     # S a multiple of chunk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_ref_final_state_matches_reference(B, S, H, P, N, chunk, dtype):
    """``return_state``: y and the final (B, H, P, N) state, in f32, as the
    reference's ``h_final``."""
    x, dt, A, Bm, Cm = _inputs(B, S, H, P, N, seed=S + P)
    jy, jh = jax_ssd_ref(jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(A),
                         jnp.asarray(Bm, dtype), jnp.asarray(Cm, dtype), chunk=chunk,
                         return_state=True)
    y, h = ssd_ref(*_torch(x, dt, A, Bm, Cm, dtype), chunk=chunk, return_state=True)
    assert h.dtype == torch.float32 and h.shape == (B, H, P, N)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), **TOL[dtype])
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    """Three one-token steps from the state a prefill left, vs the
    reference's ``ssd_decode_step_ref``: y in x's dtype, the state in f32;
    and the steps continue the scan (the same y as ``ssd_ref`` over the
    whole sequence)."""
    B, S, H, P, N = 2, 40, 3, 16, 16
    x, dt, A, Bm, Cm = _inputs(B, S + 3, H, P, N, seed=11)
    tx, tdt, tA, tBm, tCm = _torch(x, dt, A, Bm, Cm, dtype)
    y_all = ssd_ref(tx, tdt, tA, tBm, tCm, chunk=16)
    _, state = ssd_ref(tx[:, :S], tdt[:, :S], tA, tBm[:, :S], tCm[:, :S], chunk=16,
                       return_state=True)
    jstate = jnp.asarray(state.numpy())
    for t in range(S, S + 3):
        jy, jstate = jax_ssd_decode_step(
            jstate, jnp.asarray(x[:, t], dtype), jnp.asarray(dt[:, t]), jnp.asarray(A),
            jnp.asarray(Bm[:, t], dtype), jnp.asarray(Cm[:, t], dtype))
        y, state = ssd_decode_step(state, tx[:, t], tdt[:, t], tA, tBm[:, t], tCm[:, t])
        assert y.dtype == getattr(torch, dtype) and state.dtype == torch.float32
        np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), **TOL[dtype])
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL["float32"])
        np.testing.assert_allclose(y.float().numpy(), y_all[:, t].float().numpy(),
                                   **TOL[dtype])


@pytest.mark.parametrize("what", ["P", "N", "stride"])
def test_bf16_route_refuses_what_its_tiles_cannot_take(what):
    """The bf16 route's own limits (P <= 64, N <= 128, multiples of 8, views
    16-byte aligned) are checked before any launch."""
    P, N = {"P": (12, 16), "N": (16, 136), "stride": (16, 16)}[what]
    x, _, _, Bm, Cm = _torch(*_inputs(1, 8, 2, P, N, seed=0), "bfloat16")
    if what == "stride":        # a step stride of 20 elements: rows not 16-byte aligned
        Bm = torch.zeros((1, 8, 20), dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="bf16 SSD kernel takes|16-byte aligned"):
        ssd_kernel_module._check_tensor_core_route(x, Bm, Cm)


def test_kernel_refuses_cpu_tensors():
    args = _torch(*_inputs(1, 8, 2, 16, 16, seed=0), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel(*args, chunk=32)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 77, 3, 16, 16, 32),
                                             (1, 40, 2, 24, 40, 16)])
def test_gradient_rule_matches_jax_grad(B, S, H, P, N, chunk):
    """ssd_vjp (the kernel's backward) against jax.vjp of the reference
    ssd_ref, for all five inputs, with the same cotangent."""
    x, dt, A, Bm, Cm = _inputs(B, S, H, P, N, seed=7)
    g = np.random.default_rng(8).standard_normal((B, S, H, P)).astype(np.float32)
    ref = jax.jit(lambda ct, *a: jax.vjp(lambda *b: jax_ssd_ref(*b, chunk=chunk), *a)[1](ct))(
        jnp.asarray(g), *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    ours = ssd_vjp(torch.from_numpy(g), *_torch(x, dt, A, Bm, Cm, "float32"), chunk=chunk)
    for name, o, r in zip(("x", "dt", "A", "Bm", "Cm"), ours, ref):
        r = np.asarray(r)
        assert o.shape == r.shape, name
        # A's gradient sums over every (b, t, p): scale the tolerance by its size
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(r).max()), err_msg=name)


def test_autograd_function_runs_kernel_forward_and_rule_backward(monkeypatch):
    """The custom op's wiring on the CPU: CPU tensors take the op's CUDA
    implementation for this test, with the kernel stood in for by the plain
    version. The forward calls the kernel once, the backward calls ssd_vjp
    and gives the gradients autograd gives through ssd_ref."""
    calls = {"kernel": 0, "vjp": 0}

    def fake_kernel(*a, chunk):
        calls["kernel"] += 1
        return ssd_ref(*a, chunk=chunk)

    def counted_vjp(*a, **kw):
        calls["vjp"] += 1
        return ssd_vjp(*a, **kw)

    monkeypatch.setattr(ssd_ops, "ssd_kernel", fake_kernel)
    monkeypatch.setattr(ssd_ops, "ssd_vjp", counted_vjp)
    inputs = _torch(*_inputs(2, 45, 3, 16, 16, seed=3), "float32")
    a = [t.clone().requires_grad_() for t in inputs]
    b = [t.clone().requires_grad_() for t in inputs]
    g = torch.randn(2, 45, 3, 16, generator=torch.Generator().manual_seed(0))
    ssd_ops._ssd_op.register_kernel("cpu", ssd_ops._on_cuda)
    try:
        ssd_ops.ssd(*a, chunk=32).backward(g)
    finally:
        ssd_ops._ssd_op.register_kernel("cpu", ssd_ops._on_cpu)
    ssd_ref(*b, chunk=32).backward(g)
    assert calls == {"kernel": 1, "vjp": 1}
    for ta, tb in zip(a, b):
        torch.testing.assert_close(ta.grad, tb.grad, rtol=1e-6, atol=1e-6)


def test_ssm_apply_matches_jax():
    jcfg = jconfigs.get_smoke("mamba2-130m").replace(dtype="float32")
    tcfg = tconfigs.get_smoke("mamba2-130m").replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    layer = {k: v[0] for k, v in jparams["layers"].items()}
    x = np.random.default_rng(4).standard_normal((2, 70, jcfg.d_model)).astype(np.float32)
    ref = jax.jit(JS.ssm_apply, static_argnums=2)(layer, jnp.asarray(x), jcfg)
    out = TS.ssm_apply(interop.to_torch(layer), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL["float32"])


# ---------------------------------------------------------------- rehearsal
# A plain-torch emulation of the tensor-core (bf16) route of csrc/ssd_scan.cu,
# stage by stage, with the kernel's roundings: cum in f64 in order, rounded
# once; products of two bf16 operands are exact in f32; each product with an
# f32 operand is split in two bf16 terms (hi = bf16(t), lo = bf16(t - hi)),
# both multiplied by the exact bf16 side into one f32 sum.

def _round(t: torch.Tensor, rounding: str):
    """The terms an f32 operand becomes: "split" (the kernel's two bf16
    terms), "single" (one bf16) or "none" (f32 kept)."""
    if rounding == "none":
        return (t,)
    hi = t.bfloat16().float()
    return (hi, (t - hi).bfloat16().float()) if rounding == "split" else (hi,)


def _ssd_tc_emulation(x, dt, A, Bm, Cm, *, chunk, rounding="split"):
    """y of the SSD scan through the kernel's stages. ``rounding="none"``
    keeps every operand in f32: the stage decomposition alone."""
    Bsz, S, H, P = x.shape
    Q = min(chunk, S)
    nc = -(-S // Q)
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    cum = torch.empty((Bsz, S, H))                   # the cum kernel
    for c in range(nc):
        s = slice(c * Q, min(S, (c + 1) * Q))
        cum[:, s] = torch.cumsum((dt[:, s] * A).double(), dim=1).float()
    states = []                                      # stage a: S_c, chunks < nc - 1
    for c in range(nc - 1):
        s = slice(c * Q, (c + 1) * Q)
        w = torch.exp(cum[:, s][:, -1:] - cum[:, s])                # (B,Q,H)
        v = w[..., None] * (dt[:, s][..., None] * xf[:, s])         # (B,Q,H,P)
        states.append(sum(torch.einsum("bjhp,bjn->bhpn", t, Bf[:, s])
                          for t in _round(v, rounding)))
    h = torch.zeros((Bsz, H, P, Bm.shape[-1]))       # stage b
    h_start = [h]
    for c in range(nc - 1):
        h = torch.exp(cum[:, (c + 1) * Q - 1])[..., None, None] * h + states[c]
        h_start.append(h)
    y = torch.empty((Bsz, S, H, P))                  # stage c
    for c in range(nc):
        s = slice(c * Q, min(S, (c + 1) * Q))
        q = s.stop - s.start
        cb = Cf[:, s] @ Bf[:, s].transpose(1, 2)                    # (B,i,j) exact
        cum_c = cum[:, s].transpose(1, 2)                           # (B,H,Q)
        diff = cum_c[..., :, None] - cum_c[..., None, :]
        tri = torch.ones(q, q, dtype=torch.bool).tril()
        L = torch.exp(torch.where(tri, diff, torch.tensor(float("-inf"))))
        G = cb[:, None] * L * dt[:, s].transpose(1, 2)[:, :, None, :]   # (B,H,i,j)
        xs = xf[:, s].permute(0, 2, 1, 3)                           # (B,H,j,P)
        intra = sum(g @ xs for g in _round(G, rounding))
        inter = sum(Cf[:, s][:, None] @ t.transpose(-1, -2)
                    for t in _round(h_start[c], rounding)) * torch.exp(cum_c)[..., None]
        y[:, s] = (inter + intra).permute(0, 2, 1, 3)
    return y.to(x.dtype)


@pytest.mark.parametrize("seed", [0, 1])
def test_tensor_core_rounding_stays_inside_the_card_tolerance(seed):
    """The bf16 route's roundings (split f32 operands, exact bf16 C B^T, f64
    cum) against ssd_ref on bf16 inputs with chip_smoke.py's statistics and
    its bf16 tolerance, at chunk 256 over 4 chunks."""
    x, dt, A, Bm, Cm = _torch(*_inputs(2, 1024, 4, 64, 128, seed=seed), "bfloat16")
    ref = ssd_ref(x, dt, A, Bm, Cm, chunk=256)
    out = _ssd_tc_emulation(x, dt, A, Bm, Cm, chunk=256)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), **TOL["bfloat16"])


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 1024, 4, 64, 128, 256),
                                             (2, 77, 3, 16, 16, 32),
                                             (1, 31, 2, 24, 40, 32)])
def test_tensor_core_stages_match_ref_in_f32(B, S, H, P, N, chunk):
    """The stage decomposition (cum, per-chunk states, state pass, chunk
    scan) with no rounding equals ssd_ref in f32 to summation order."""
    args = _torch(*_inputs(B, S, H, P, N, seed=S), "float32")
    out = _ssd_tc_emulation(*args, chunk=chunk, rounding="none")
    torch.testing.assert_close(out, ssd_ref(*args, chunk=chunk), **TOL["float32"])


def test_single_bf16_rounding_would_break_the_tolerance():
    """Why the split: rounding each f32 operand to one bf16 instead leaves
    the card's bf16 tolerance."""
    x, dt, A, Bm, Cm = _torch(*_inputs(2, 1024, 4, 64, 128, seed=0), "bfloat16")
    ref = ssd_ref(x, dt, A, Bm, Cm, chunk=256).float()
    split = _ssd_tc_emulation(x, dt, A, Bm, Cm, chunk=256).float()
    single = _ssd_tc_emulation(x, dt, A, Bm, Cm, chunk=256, rounding="single").float()
    limit = TOL["bfloat16"]["atol"] + TOL["bfloat16"]["rtol"] * ref.abs()
    assert ((split - ref).abs() / limit).max() < 1
    assert ((single - ref).abs() / limit).max() > 1
