"""Port's MoE layer and family against the JAX package's, in float32 on
weights carried across with ``repro_torch.interop`` (tolerance 1e-4, as the
other parity tests: float32 on both sides, the sums' order differs).

The layer (``repro_torch.models.moe``): ``moe_apply`` on the dense dispatch
with tokens dropped past the capacity (asserted: some ``keep`` is false),
at S = 1 with B·k >= E (the dense path), and on the gather path (S = 1,
B·k < E); the aux loss; the gradients of ``out.sum() + aux`` against
``jax.grad``; the gather path against the dense path at S = 1, as the
reference's own test does; the capacity's rounding. The family: parameter
shapes and both counts (``param_count``, ``active_param_count``) of
mixtral-8x22b and moonshot-v1-16b-a3b, CONFIG and SMOKE.

Routing uses random weights and inputs: ``torch.topk`` and ``lax.top_k``
may order exact ties differently, and random draws have none."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import ParamSpec as JSpec  # noqa: E402
from repro.models.layers import init_tree as jax_init_tree  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import flatten_specs  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)    # float32 on both sides; op order differs
MOE_ARCHS = ["mixtral-8x22b", "moonshot-v1-16b-a3b"]


def _cfgs(arch):
    return (jconfigs.get_smoke(arch).replace(dtype="float32"),
            tconfigs.get_smoke(arch).replace(dtype="float32"))


def _layer(arch, seed=7):
    """One MoE layer's params (router, we_gate, we_up, we_down) drawn by the
    JAX package, and the same tensors for the port."""
    jcfg, tcfg = _cfgs(arch)
    jp = jax_init_tree(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed), jnp.float32)
    return jcfg, tcfg, jp, interop.to_torch(jp)


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


# (arch, B, S, path): the dense dispatch over a prompt, with drops; the dense
# path at S = 1 (mixtral-smoke: B·k = 2·2 = 4 = E); the gather path at S = 1
# (moonshot-smoke: B·k = 2·2 = 4 < 8 = E)
CASES = [("mixtral-8x22b", 2, 40, "dense"), ("moonshot-v1-16b-a3b", 3, 40, "dense"),
         ("mixtral-8x22b", 2, 1, "dense"), ("moonshot-v1-16b-a3b", 2, 1, "gather")]


@pytest.mark.parametrize("arch,B,S,path", CASES)
def test_moe_apply_and_aux_match_jax(arch, B, S, path):
    jcfg, tcfg, jp, tp = _layer(arch)
    x = _x(B, S, tcfg.d_model, seed=S + B)
    E, k = tcfg.num_experts, tcfg.num_experts_per_tok
    assert (S == 1 and B * k < E) == (path == "gather")
    jout, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg))(jp, jnp.asarray(x))
    tout, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert tout.shape == (B, S, tcfg.d_model) and taux.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    if path == "gather":
        assert taux.item() == 0.0
    elif S > 1:                          # the capacity bites: some token is dropped
        _, _, sel = tmoe.route(torch.from_numpy(x), tp["router"], k)
        _, assign, _, keep = tmoe.slots(sel, E, tmoe.capacity(tcfg, S))
        assert bool(((assign > 0) & ~keep).any())
        assert taux.item() > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_grads_match_jax_grad(arch):
    """Gradients of out.sum() + aux for x and every weight, over a prompt
    long enough to drop tokens, against jax.grad."""
    jcfg, tcfg, jp, tp = _layer(arch)
    x = _x(2, 40, tcfg.d_model, seed=3)

    def jloss(p, x):
        out, aux = jmoe.moe_apply(p, x, jcfg)
        return out.sum() + aux

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    for t in tp.values():
        t.requires_grad_()
    out, aux = tmoe.moe_apply(tp, tx, tcfg)
    (out.sum() + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), **TOL, err_msg="x")
    assert sorted(tp) == sorted(jg_p) == ["router", "we_down", "we_gate", "we_up"]
    for name, t in tp.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg_p[name]), **TOL,
                                   err_msg=name)


def test_moe_decode_path_matches_dense_path():
    """The gather path equals the dense dispatch at S = 1 (no drops there,
    C >= 1): the row decoded alone against the same row tiled E times, which
    takes the dense path (B·k >= E), as the reference's test does."""
    _, tcfg, _, tp = _layer("mixtral-8x22b")
    x = torch.from_numpy(_x(1, 1, tcfg.d_model, seed=8))
    E, k = tcfg.num_experts, tcfg.num_experts_per_tok
    assert 1 * k < E <= E * k
    sparse, aux = tmoe.moe_decode_apply(tp, x, tcfg)
    dense, _ = tmoe.moe_apply(tp, x.repeat(E, 1, 1), tcfg)
    torch.testing.assert_close(sparse[0, 0], dense[0, 0], rtol=1e-5, atol=1e-5)
    assert aux.item() == 0.0


@pytest.mark.parametrize("S", [1, 7, 40, 45, 340, 2048])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_rounds_as_the_reference(arch, S):
    for which in ("get", "get_smoke"):
        jcfg, tcfg = getattr(jconfigs, which)(arch), getattr(tconfigs, which)(arch)
        assert tmoe.capacity(tcfg, S) == max(
            int(S * jcfg.num_experts_per_tok / jcfg.num_experts * jcfg.capacity_factor), 1)


def _jax_shapes(cfg):
    flat = jax.tree_util.tree_flatten_with_path(
        JM.param_shapes(cfg), is_leaf=lambda x: isinstance(x, JSpec))[0]
    return {tuple(k.key for k in path): tuple(spec.shape) for path, spec in flat}


@pytest.mark.parametrize("which", ["get", "get_smoke"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_param_shapes_and_counts_match_reference(arch, which):
    jcfg, tcfg = getattr(jconfigs, which)(arch), getattr(tconfigs, which)(arch)
    assert tcfg == tcfg.replace(**{f: getattr(jcfg, f) for f in tcfg.__dataclass_fields__})
    ours = {path: tuple(s.shape) for path, s in flatten_specs(TM.param_shapes(tcfg))}
    assert ours == _jax_shapes(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert tcfg.active_param_count() < tcfg.param_count()
    if (arch, which) == ("moonshot-v1-16b-a3b", "get"):
        assert tcfg.param_count() == 28_057_995_264     # 52.3 GiB in bf16


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mistral-nemo-12b", "llama3-405b"])
def test_dense_configs_match_reference(arch):
    """The three dense configs of this slice: every field, the parameter
    shapes and count, and active == total (no experts)."""
    for which in ("get", "get_smoke"):
        jcfg, tcfg = getattr(jconfigs, which)(arch), getattr(tconfigs, which)(arch)
        assert tcfg == tcfg.replace(**{f: getattr(jcfg, f) for f in tcfg.__dataclass_fields__})
        assert tcfg.param_count() == jcfg.param_count() == tcfg.active_param_count()
        if which == "get_smoke":
            ours = {p: tuple(s.shape) for p, s in flatten_specs(TM.param_shapes(tcfg))}
            assert ours == _jax_shapes(jcfg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_jax(arch):
    """The family through prefill and two decode steps at B = 2: prefill
    logits and every cache leaf over a prompt long enough to drop tokens,
    then decode on mixtral-smoke's dense path (B·k = E) and moonshot-smoke's
    gather path (B·k < E). mixtral-smoke's window of 32 on kind attn: the
    prompt of 37 rolls its ring. The weights are the port's seeded init,
    carried to the JAX package: under the reference's stacked init (std
    num_layers^-0.5, ROADMAP.md Queue 3) float32 rounding in either package
    moves a few of mixtral-smoke's prefill logits by 2e-4 (see
    test_torch_train_dense_hybrid.py)."""
    jcfg, tcfg = _cfgs(arch)
    tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(tparams))
    B, S, max_len = 2, 37, 48
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S))
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, max_len)
    with torch.inference_mode():
        tl, tc = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)}, max_len)
    slots = min(tcfg.window, max_len) if tcfg.attention == "swa" else max_len
    assert tc["layers"]["k"].shape == (tcfg.num_layers, B, slots, tcfg.num_kv_heads,
                                       tcfg.head_dim)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["layers"][name].numpy(), np.asarray(jc["layers"][name]),
                                   **TOL, err_msg=name)
    pos = np.array([S, S - 4])
    for step in range(2):
        nxt = rng.integers(0, jcfg.vocab_size, (B, 1))
        jl, jc = JM.decode_step(jparams, jcfg, jc, jnp.asarray(nxt), jnp.asarray(pos + step))
        with torch.inference_mode():
            tl, tc = TM.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                    torch.from_numpy(pos + step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc["layers"][name].numpy(),
                                       np.asarray(jc["layers"][name]), **TOL, err_msg=name)
