"""Port's model against the JAX package's on the same weights (carried over
with ``repro_torch.interop``): parameter tree shapes and count, prefill
logits and cache, decode steps at mixed per-row positions, the ring roll of
a prompt longer than the cache, and the port's own seeded init statistics;
the first train step of the dense, hybrid, moe, vlm and audio families
against the JAX train step; mamba2's prefill, decode and cache; attention
whose head_dim is not d_model // num_heads; and a family the port does not
have, which raises naming ROADMAP.md."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import ParamSpec as JSpec  # noqa: E402
from repro.parallel import sharding as shd  # noqa: E402
from repro.parallel.steps import init_train_state as jax_init_state  # noqa: E402
from repro.parallel.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import flatten_specs  # noqa: E402
from repro_torch.parallel.steps import make_train_step  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)   # float32 on both sides; op order differs


def _jax_shapes(cfg):
    flat = jax.tree_util.tree_flatten_with_path(
        JM.param_shapes(cfg), is_leaf=lambda x: isinstance(x, JSpec))[0]
    return {tuple(k.key for k in path): tuple(spec.shape) for path, spec in flat}


@pytest.mark.parametrize("which", ["get", "get_smoke"])
def test_param_shapes_match_reference(which):
    jcfg = getattr(jconfigs, which)("granite-8b")
    tcfg = getattr(tconfigs, which)("granite-8b")
    ours = {path: tuple(s.shape) for path, s in flatten_specs(TM.param_shapes(tcfg))}
    assert ours == _jax_shapes(jcfg)


def test_param_count_full_width():
    n = tconfigs.get("granite-8b").param_count()
    assert n == sum(int(np.prod(s)) for s in _jax_shapes(jconfigs.get("granite-8b")).values())
    assert 8.2e9 < n < 8.3e9          # untied embed + unembed


@pytest.fixture(scope="module")
def smoke():
    jcfg = jconfigs.get_smoke("granite-8b").replace(dtype="float32")
    tcfg = tconfigs.get_smoke("granite-8b").replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, interop.to_torch(jparams)


def _close(ours, ref):
    np.testing.assert_allclose(interop.to_numpy(ours) if isinstance(ours, torch.Tensor)
                               else ours, np.asarray(ref), **TOL)


def _close_cache(ours, ref):
    for name in ("k", "v"):
        _close(ours["layers"][name], ref["layers"][name])


def test_prefill_and_mixed_position_decode(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    B, S, max_len = 3, 7, 16
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S))
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, max_len)
    with torch.inference_mode():
        tl, tc = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)}, max_len)
    _close(tl, jl)
    _close_cache(tc, jc)
    pos = np.array([S, S - 3, S + 2])              # rows at different depths
    for step in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, (B, 1))
        jl, jc = JM.decode_step(jparams, jcfg, jc, jnp.asarray(nxt),
                                jnp.asarray(pos + step))
        with torch.inference_mode():
            tl, tc = TM.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                    torch.from_numpy(pos + step))
        _close(tl, jl)
        _close_cache(tc, jc)


def test_prompt_longer_than_cache_rolls_into_ring(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    S, max_len = 21, 8                               # ring phase 21 % 8 = 5
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (1, S))
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, max_len)
    with torch.inference_mode():
        tl, tc = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)}, max_len)
    _close(tl, jl)
    _close_cache(tc, jc)
    nxt = np.array([[3]])
    jl, jc = JM.decode_step(jparams, jcfg, jc, jnp.asarray(nxt), jnp.asarray([S]))
    with torch.inference_mode():
        tl, tc = TM.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                torch.tensor([S]))
    _close(tl, jl)
    _close_cache(tc, jc)


def test_seeded_init_statistics():
    cfg = tconfigs.get_smoke("granite-8b").replace(num_layers=4, d_model=128, d_ff=256)
    gen = torch.Generator().manual_seed(0)
    p = TM.init_params(cfg, gen, torch.float32)
    D, H, Dh, F = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff
    expect = {"wq": D ** -0.5, "wk": D ** -0.5, "wv": D ** -0.5,
              "wo": (H * Dh) ** -0.5, "wi_gate": D ** -0.5, "wi_up": D ** -0.5,
              "wo_mlp": F ** -0.5}
    for name, std in expect.items():
        got = p["layers"][name].std().item()
        assert abs(got - std) < 0.05 * std, (name, got, std)
    assert abs(p["unembed"].std().item() - D ** -0.5) < 0.05 * D ** -0.5
    assert abs(p["embed"].std().item() - 0.02) < 0.05 * 0.02
    for name in ("pre_norm", "mlp_norm"):
        assert torch.equal(p["layers"][name], torch.ones_like(p["layers"][name]))
    assert torch.equal(p["final_norm"], torch.ones(D))
    again = TM.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    assert torch.equal(again["layers"]["wq"], p["layers"]["wq"])


def test_interop_carries_bf16_bits_and_back():
    a = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    tree = {"w": jnp.asarray(a, jnp.bfloat16), "sub": {"b": jnp.asarray(a)}}
    ours = interop.to_torch(tree)
    assert ours["w"].dtype == torch.bfloat16 and ours["sub"]["b"].dtype == torch.float32
    np.testing.assert_array_equal(ours["w"].float().numpy(),
                                  np.asarray(tree["w"], np.float32))
    back = interop.to_numpy(ours)
    np.testing.assert_array_equal(back["w"], np.asarray(tree["w"], np.float32))
    np.testing.assert_array_equal(back["sub"]["b"], a)


def test_other_families_raise_not_implemented():
    """Every family of the reference is ported (audio last, ROADMAP.md item
    6); a family that no config has raises."""
    cfg = tconfigs.get_smoke("granite-8b").replace(family="diffusion")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.param_shapes(cfg)


def test_mamba2_serving_raises_not_implemented():
    """The name dates from before ROADMAP.md item 11, when mamba2's prefill,
    decode and cache raised. Now it is that item's check: mamba2-smoke's
    prefill logits, two decode steps' logits and every cache leaf (the conv
    tail and the f32 SSM state, stacked over layers) match the JAX package
    on carried weights. The prompt of 45 tokens is ragged against the chunk
    of 32, so the plain scan pads and carries its state over two chunks."""
    jcfg = jconfigs.get_smoke("mamba2-130m").replace(dtype="float32")
    tcfg = tconfigs.get_smoke("mamba2-130m").replace(dtype="float32")
    assert jcfg.ssm_chunk == 32
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = interop.to_torch(jparams)
    B, S, max_len = 2, 45, 64
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S))
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, max_len)
    with torch.inference_mode():
        tl, tc = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)}, max_len)
    assert sorted(tc["layers"]) == sorted(jc["layers"]) == ["conv", "state"]
    assert tc["layers"]["state"].dtype == torch.float32
    assert tc["layers"]["state"].shape == (tcfg.num_layers, B, tcfg.ssm_heads,
                                           tcfg.ssm_head_dim, tcfg.ssm_state)
    for name, (shape, dtype) in TM.cache_shapes(tcfg, B, max_len)["layers"].items():
        assert tc["layers"][name].shape == shape and tc["layers"][name].dtype == dtype
    _close(tl, jl)
    for name in ("conv", "state"):
        _close(tc["layers"][name], jc["layers"][name])
    pos = np.array([S, S - 3])
    for step in range(2):
        nxt = rng.integers(0, jcfg.vocab_size, (B, 1))
        jl, jc = JM.decode_step(jparams, jcfg, jc, jnp.asarray(nxt), jnp.asarray(pos + step))
        with torch.inference_mode():
            tl, tc = TM.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                    torch.from_numpy(pos + step))
        _close(tl, jl)
        for name in ("conv", "state"):
            _close(tc["layers"][name], jc["layers"][name])


def _first_step_matches_jax(arch):
    """The port's first train step against the JAX train step's, on carried
    weights and the same batch (tokens, and a vlm's or audio arch's frontend
    embeddings): loss, grad_norm and lr."""
    jcfg = jconfigs.get_smoke(arch).replace(dtype="float32")
    tcfg = tconfigs.get_smoke(arch).replace(dtype="float32")
    jstate = jax_init_state(jcfg, jax.random.PRNGKey(0))
    tstate = interop.to_torch(jstate)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)}
    frontend = {"vlm": "vision_embeds", "audio": "audio_embeds"}.get(jcfg.family)
    if frontend:
        batch[frontend] = 0.02 * rng.standard_normal(
            (2, jcfg.frontend_tokens, jcfg.d_model)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
    _, jm = jax_make_train_step(jcfg, mesh, shd.make_rules(multi_pod=False))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = make_train_step(tcfg)(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]), **TOL, err_msg=key)
    assert int(tstate["step"]) == 1


@pytest.mark.parametrize("arch", ["granite-8b", "recurrentgemma-2b"])
def test_make_train_step_refuses_dense_and_hybrid(arch):
    """The name dates from before ROADMAP.md Queue 1 item 10, when
    make_train_step refused these families. Now it is that item's check:
    the port's step trains them, and its first step's loss and grad_norm
    match the JAX train step's on carried weights and the same tokens."""
    _first_step_matches_jax(arch)


@pytest.mark.parametrize("family,item", [("moe", "item 5 \\(moe family\\)"),
                                         ("vlm", "item 4 \\(vlm family\\)"),
                                         ("audio", "item 6 \\(audio family\\)")])
def test_make_train_step_refuses_unported_families(family, item):
    """The name and cases date from before ROADMAP.md items 5 (moe), 4
    (vlm) and 6 (audio), when make_train_step refused these families. Now
    each case is its item's check: the first train step (loss, with the aux
    loss for moe; grad_norm; lr) matches the JAX train step's, for
    mixtral-smoke and moonshot-smoke, internvl2-smoke (8 vision embeddings
    before 40 tokens, the loss over the tokens only) and seamless-smoke (16
    speech frames through the encoder and the cross-attention)."""
    archs = {"moe": ("mixtral-8x22b", "moonshot-v1-16b-a3b"), "vlm": ("internvl2-26b",),
             "audio": ("seamless-m4t-large-v2",)}[family]
    for arch in archs:
        _first_step_matches_jax(arch)


def test_head_dim_apart_from_width_matches_jax():
    """Attention whose head_dim is not d_model // num_heads, as in
    mistral-nemo-12b (32 heads of 128 in a width of 5120): the smoke config
    with head_dim 32 (4 x 32 = 128 against a width of 64). Prefill logits,
    the K/V cache, a decode step and the training forward's logits and
    loss match the JAX package on carried weights."""
    jcfg = jconfigs.get_smoke("mistral-nemo-12b").replace(dtype="float32", head_dim=32)
    tcfg = tconfigs.get_smoke("mistral-nemo-12b").replace(dtype="float32", head_dim=32)
    assert tcfg.num_heads * tcfg.head_dim != tcfg.d_model and tcfg.rope_theta == 1e6
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = interop.to_torch(jparams)
    assert tparams["layers"]["wq"].shape == (2, 64, 4, 32)
    B, S, max_len = 2, 19, 32
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S))
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, max_len)
    with torch.inference_mode():
        tl, tc = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)}, max_len)
    _close(tl, jl)
    _close_cache(tc, jc)
    nxt, pos = rng.integers(0, jcfg.vocab_size, (B, 1)), np.array([S, S - 5])
    jl, jc = JM.decode_step(jparams, jcfg, jc, jnp.asarray(nxt), jnp.asarray(pos))
    with torch.inference_mode():
        tl, tc = TM.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt), torch.from_numpy(pos))
    _close(tl, jl)
    _close_cache(tc, jc)
    jlogits, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    tlogits, _ = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens)})
    _close(tlogits.detach(), jlogits)
    _close(TM.loss_fn(tparams, tcfg, {"tokens": torch.from_numpy(tokens)}).detach(),
           JM.loss_fn(jparams, jcfg, {"tokens": jnp.asarray(tokens)}))
