"""Port's RG-LRU path against the JAX package, on the same numpy inputs and
carried weights: the plain scan (the CPU path of
``repro_torch.kernels.rglru.lru_scan``) vs the reference Pallas kernel in
interpret mode and vs ``lru_scan_ref``; an emulation of the CUDA kernel's
chunked arithmetic vs both; the scan's gradient rule (a reversed scan) vs
``jax.vjp`` of the reference scan, and the custom op's wiring; the
decode step; the recurrent mixer's training forward, prefill and decode;
and recurrentgemma-smoke's prefill and decode steps with every cache leaf.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py (phase 3)."""

import math

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.rglru.ops import lru_scan as jax_lru_scan  # noqa: E402
from repro.kernels.rglru.ref import lru_decode_step_ref as jax_decode_ref  # noqa: E402
from repro.kernels.rglru.ref import lru_scan_ref as jax_scan_ref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels.rglru import (  # noqa: E402
    lru_decode_step_ref, lru_scan, lru_scan_kernel, lru_scan_ref, lru_scan_vjp)
from repro_torch.kernels.rglru import ops as lru_ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import flatten_specs  # noqa: E402

# tests/test_kernels.py TOL: float32 differs by summation order only (the
# reference composes steps with an associative scan, the port walks them in
# order); bf16 by the rounding of each output.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)   # float32 on both sides; op order differs
# chip_smoke.py's LRU_TOL (the CUDA kernel against the plain scan on the
# card); test_chunked_emulation_* holds the kernel's arithmetic to it here.
LRU_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
           "bfloat16": dict(rtol=8e-3, atol=2e-5)}


def _coeffs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, W)))).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    return a.astype(np.float32), b


def _long_memory(kind, B, S, W, seed):
    """chip_smoke.py's long_memory_inputs from a numpy seed: a in [0.999, 1)
    ("long"), a = 1 ("one": h is the prefix sum of b), or the long draw with
    a = 0 at 2 % of steps ("reset"); b = sqrt(1 - a^2) x, x ~ N(0, 1), as the
    model's gates make it (x / sqrt(S) for a = 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, W))
    if kind == "one":
        return np.ones((B, S, W), np.float32), (x / math.sqrt(S)).astype(np.float32)
    a = 0.999 + 0.001 * rng.random((B, S, W))
    if kind == "reset":
        a = np.where(rng.random((B, S, W)) < 0.02, 0.0, a)
    return a.astype(np.float32), (np.sqrt(1 - a * a) * x).astype(np.float32)


@pytest.mark.parametrize("B,S,W,memory", [
    pytest.param(1, 1, 64, "short", id="1-1-64"),         # one step
    pytest.param(3, 5, 16, "short", id="3-5-16"),
    pytest.param(2, 77, 64, "short", id="2-77-64"),       # ragged against the 128-step chunk
    pytest.param(1, 200, 130, "short", id="1-200-130"),   # W not a multiple of 128, ragged S
    pytest.param(1, 256, 128, "short", id="1-256-128"),
    pytest.param(2, 77, 64, "long", id="2-77-64-long"),   # a in [0.999, 1): h spans chunks
    pytest.param(1, 200, 130, "long", id="1-200-130-long"),
    pytest.param(1, 256, 128, "long", id="1-256-128-long"),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_matches_pallas_and_ref(B, S, W, memory, dtype):
    if memory == "long":
        a, b = _long_memory("long", B, S, W, seed=B + S + W)
    else:
        a, b = _coeffs(B, S, W, seed=B + S + W)
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    pallas = jax_lru_scan(ja, jb, use_pallas=True)
    ref = jax_scan_ref(ja, jb)
    out = lru_scan(*(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, b)))
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, S, W)
    out = out.float().numpy()
    np.testing.assert_allclose(out, np.asarray(pallas, np.float32), **TOL[dtype])
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), **TOL[dtype])


def _chunked_emulation(a: torch.Tensor, b: torch.Tensor, L: int, G: int = 8) -> torch.Tensor:
    """The CUDA kernel's arithmetic, step for step, in f32 on the CPU (each
    product and sum rounded on its own, as the kernel's __fmul_rn and
    __fadd_rn): chunk summaries A = prod a, H = the chunk's h from 0 (pass
    1); the carry pass over the first nc - 1 summaries, cut into G segments
    that are composed, chained in order, then re-walked (pass 2); each chunk
    re-walked from its carry-in (pass 3)."""
    B, S, W = a.shape
    nc = -(-S // L)
    pad = nc * L - S                      # identity steps: exact, and never written
    af = torch.cat([a.float(), torch.ones(B, pad, W)], 1).reshape(B, nc, L, W)
    bf = torch.cat([b.float(), torch.zeros(B, pad, W)], 1).reshape(B, nc, L, W)
    A, H = torch.ones(B, nc, W), torch.zeros(B, nc, W)
    for i in range(L):
        H = af[:, :, i] * H + bf[:, :, i]
        A = A * af[:, :, i]
    n = nc - 1
    per = -(-n // G)
    segs = [(min(n, g * per), min(n, g * per + per)) for g in range(G)]
    seg_a, seg_h = [], []
    for c0, c1 in segs:
        sa, sh = torch.ones(B, W), torch.zeros(B, W)
        for c in range(c0, c1):
            sh = A[:, c] * sh + H[:, c]
            sa = sa * A[:, c]
        seg_a.append(sa)
        seg_h.append(sh)
    carry = torch.zeros(B, nc, W)
    for g, (c0, c1) in enumerate(segs):
        h = torch.zeros(B, W)
        for k in range(g):
            h = seg_a[k] * h + seg_h[k]
        for c in range(c0, c1):
            h = A[:, c] * h + H[:, c]
            carry[:, c + 1] = h
    out, h = torch.empty(B, nc, L, W), carry
    for i in range(L):
        h = af[:, :, i] * h + bf[:, :, i]
        out[:, :, i] = h
    return out.reshape(B, nc * L, W)[:, :S].to(a.dtype)


@pytest.mark.parametrize("S_of", ["1", "L", "L+1", "77", "300"])
@pytest.mark.parametrize("L", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_emulation_matches_plain_and_reference(S_of, L, dtype):
    """On inputs whose h carries across chunks (a near 1, a = 1, resets),
    the kernel's chunked arithmetic stays within chip_smoke.py's LRU_TOL of
    the sequential plain scan, and of the JAX reference's associative scan
    and Pallas kernel; one chunk equals the plain scan to the bit."""
    S = {"1": 1, "L": L, "L+1": L + 1, "77": 77, "300": 300}[S_of]
    B, W = 2, 48
    for seed, kind in enumerate(("long", "one", "reset")):
        a, b = _long_memory(kind, B, S, W, seed=100 * S + L + seed)
        ta, tb = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, b))
        out = _chunked_emulation(ta, tb, L)
        assert out.dtype == ta.dtype and out.shape == (B, S, W)
        plain = lru_scan_ref(ta, tb)
        if S <= L:
            assert torch.equal(out, plain)
        out = out.float().numpy()
        np.testing.assert_allclose(out, plain.float().numpy(), **LRU_TOL[dtype], err_msg=kind)
        ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
        for ref in (jax_scan_ref(ja, jb), jax_lru_scan(ja, jb, use_pallas=True)):
            np.testing.assert_allclose(out, np.asarray(ref, np.float32), **LRU_TOL[dtype],
                                       err_msg=kind)


def test_decode_step_matches_ref():
    a, b = _coeffs(3, 1, 32, seed=5)
    h = np.random.default_rng(6).standard_normal((3, 32)).astype(np.float32)
    ref = jax_decode_ref(jnp.asarray(h), jnp.asarray(a[:, 0]), jnp.asarray(b[:, 0]))
    out = lru_decode_step_ref(*(torch.from_numpy(np.ascontiguousarray(x))
                                for x in (h, a[:, 0], b[:, 0])))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL["float32"])


def test_kernel_refuses_cpu_tensors():
    a, b = (torch.from_numpy(x) for x in _coeffs(1, 4, 8, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        lru_scan_kernel(a, b)


# ------------------------------------------------------------ gradient rule
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)    # float32 on both sides; sum order differs


def _rule_inputs(S, seed):
    """Rows of three kinds: a in (0, 1) from sigmoid draws, a = 1 (h is the
    prefix sum of b, λ the suffix sum of g) and a = 0 (h = b, λ = g)."""
    a, b = _coeffs(3, S, 24, seed)
    a[1], a[2] = 1.0, 0.0
    g = np.random.default_rng(seed + 1).standard_normal(a.shape).astype(np.float32)
    return a, b, g


@pytest.mark.parametrize("S", [1, 2, 77, 300])
def test_reversed_scan_rule_matches_jax_grad(S):
    """lru_scan_vjp (a reversed scan through lru_scan, the plain walk on the
    CPU) against jax.vjp of the reference's associative scan."""
    a, b, g = _rule_inputs(S, seed=S)
    jda, jdb = jax.jit(lambda a, b, g: jax.vjp(jax_scan_ref, a, b)[1](g))(
        *(jnp.asarray(x) for x in (a, b, g)))
    ta, tb, tg = (torch.from_numpy(x) for x in (a, b, g))
    da, db = lru_scan_vjp(tg, ta, lru_scan_ref(ta, tb))
    assert da.dtype == db.dtype == torch.float32 and da.shape == db.shape == (3, S, 24)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), **GRAD_TOL, err_msg="db")
    np.testing.assert_allclose(da.numpy(), np.asarray(jda), **GRAD_TOL, err_msg="da")


def test_scan_function_runs_kernel_forward_and_rule_backward(monkeypatch):
    """The custom op's wiring on the CPU: CPU tensors take the op's CUDA
    implementation for this test, with the kernel stood in for by the plain
    version. The forward calls the kernel once, the backward one more scan
    (the reversed one, through lru_scan, so the kernel once more), and the
    gradients are those autograd gives through lru_scan_ref."""
    calls = {"kernel": 0, "scan": 0}
    scan = lru_ops.lru_scan

    def fake_kernel(a, b):
        calls["kernel"] += 1
        return lru_scan_ref(a, b)

    def counted_scan(a, b):
        calls["scan"] += 1
        return scan(a, b)

    monkeypatch.setattr(lru_ops, "lru_scan_kernel", fake_kernel)
    monkeypatch.setattr(lru_ops, "lru_scan", counted_scan)
    a, b, g = (torch.from_numpy(x) for x in _rule_inputs(45, seed=9))
    x = [t.clone().requires_grad_() for t in (a, b)]
    y = [t.clone().requires_grad_() for t in (a, b)]
    lru_ops._lru_op.register_kernel("cpu", lru_ops._on_cuda)
    try:
        scan(*x).backward(g)              # the op itself; lru_ops.lru_scan counts
    finally:
        lru_ops._lru_op.register_kernel("cpu", lru_ops._on_cpu)
    lru_scan_ref(*y).backward(g)
    assert calls == {"kernel": 2, "scan": 1}
    for tx, ty in zip(x, y):
        torch.testing.assert_close(tx.grad, ty.grad, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def smoke():
    jcfg = jconfigs.get_smoke("recurrentgemma-2b").replace(dtype="float32")
    tcfg = tconfigs.get_smoke("recurrentgemma-2b").replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, interop.to_torch(jparams)


def _close(ours, ref, tol=MODEL_TOL):
    np.testing.assert_allclose(interop.to_numpy(ours), np.asarray(ref), **tol)


def _close_tree(ours, ref):
    assert set(ours) == set(ref)
    for key in ours:
        if isinstance(ours[key], dict):
            _close_tree(ours[key], ref[key])
        else:
            _close(ours[key], ref[key])


def _jax_shapes(cfg):
    from repro.models.layers import ParamSpec as JSpec
    flat = jax.tree_util.tree_flatten_with_path(
        JM.param_shapes(cfg), is_leaf=lambda x: isinstance(x, JSpec))[0]
    return {tuple(k.key for k in path): tuple(spec.shape) for path, spec in flat}


@pytest.mark.parametrize("which", ["get", "get_smoke"])
def test_param_shapes_match_reference(which):
    jcfg = getattr(jconfigs, which)("recurrentgemma-2b")
    tcfg = getattr(tconfigs, which)("recurrentgemma-2b")
    ours = {path: tuple(s.shape) for path, s in flatten_specs(TM.param_shapes(tcfg))}
    assert ours == _jax_shapes(jcfg)
    assert TT.layer_kinds(tcfg) == JT.layer_kinds(jcfg)


def test_param_count_full_width():
    cfg = tconfigs.get("recurrentgemma-2b")
    assert cfg.param_count() == 2_894_481_920
    assert TT.layer_kinds(cfg).count("rglru") == 18
    assert TT.layer_kinds(cfg).count("local_attn") == 8


@pytest.mark.parametrize("S", [2, 9])      # shorter and longer than the conv tail
def test_rglru_prefill_and_decode_match(smoke, S):
    jcfg, tcfg, jparams, tparams = smoke
    jp, tp = jparams["layers"]["layer_0"], tparams["layers"]["layer_0"]
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jout, jcache = JT._rglru_prefill(jp, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        tout, tcache = TT._rglru_prefill(tp, torch.from_numpy(x), tcfg)
    _close(tout, jout)
    _close_tree(tcache, jcache)
    assert tcache["h"].dtype == torch.float32
    for step in range(3):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jout, jcache = JR.rglru_decode(jp, jnp.asarray(xt), jcache, jcfg)
        with torch.inference_mode():
            tout = TR.rglru_decode(tp, torch.from_numpy(xt), tcache, tcfg)
        _close(tout, jout)
        _close_tree(tcache, jcache)


def test_rglru_apply_matches_jax(smoke):
    """The training mixer, and its gradients with respect to the layer's
    parameters and input, against the reference on carried weights."""
    jcfg, tcfg, jparams, tparams = smoke
    names = TR.rglru_specs(tcfg)
    jp = {k: jparams["layers"]["layer_0"][k] for k in names}
    tp = {k: tparams["layers"]["layer_0"][k] for k in names}
    x = np.random.default_rng(4).standard_normal((2, 37, jcfg.d_model)).astype(np.float32)
    jout = jax.jit(JR.rglru_apply, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    jgrad = jax.jit(jax.grad(lambda p, x: JR.rglru_apply(p, x, jcfg).sum(), argnums=(0, 1)))(
        jp, jnp.asarray(x))
    tp = {k: t.clone().requires_grad_() for k, t in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tout = TR.rglru_apply(tp, tx, tcfg)
    _close(tout.detach(), jout)
    tout.sum().backward()
    _close(tx.grad, jgrad[1])
    assert set(tp) == set(jgrad[0])
    for k in tp:
        _close(tp[k].grad, jgrad[0][k])


def test_prefill_and_mixed_position_decode(smoke):
    """A prompt longer than the window of 32: the local-attention K/V cache
    rolls into its ring at prefill and wraps again in decode."""
    jcfg, tcfg, jparams, tparams = smoke
    assert jcfg.window == 32
    B, S, max_len = 2, 45, 64
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S))
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, max_len)
    with torch.inference_mode():
        tl, tc = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)}, max_len)
    _close(tl, jl)
    _close_tree(tc, jc)
    assert tc["layers"]["layer_2"]["k"].shape == (B, 32, 1, 16)
    pos = np.array([S, S - 20])                    # rows at different depths
    for step in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, (B, 1))
        jl, jc = JM.decode_step(jparams, jcfg, jc, jnp.asarray(nxt),
                                jnp.asarray(pos + step))
        with torch.inference_mode():
            tl, tc = TM.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                    torch.from_numpy(pos + step))
        _close(tl, jl)
        _close_tree(tc, jc)


def test_unrolled_cache_layout(smoke):
    _, tcfg, _, _ = smoke
    assert not TM.uniform_scan(tcfg)
    assert TM.uniform_scan(tconfigs.get_smoke("granite-8b"))
    cache = TM.init_cache(tcfg, 3, 48)["layers"]
    assert sorted(cache) == [f"layer_{i}" for i in range(5)]
    assert cache["layer_0"]["conv"].shape == (3, 3, 64)
    assert cache["layer_0"]["h"].dtype == torch.float32
    assert cache["layer_2"]["v"].shape == (3, 32, 1, 16)
