"""Port's vlm and audio families against the JAX package, in float32 on
weights carried across with ``repro_torch.interop`` (tolerance 1e-4, as the
other parity tests: float32 on both sides, the sums' order differs).

internvl2-26b (vlm: precomputed vision embeddings prepended to the text)
and seamless-m4t-large-v2 (audio: an encoder over precomputed speech-frame
embeddings, read by the decoder's cross-attention, and the tanh-gelu MLP):
their configs, parameter shapes and counts; ``cross_attn_apply`` (through
the reference's plain attention and its Pallas kernel in interpret mode),
``_encoder_apply`` and the gelu MLP alone; ``make_batch`` value for value;
prefill, every cache leaf (``enc_k``/``enc_v`` too) and decode of both
smokes; and ``ServeEngine``'s positions, which count the vision prefix. The
forward, loss, gradients, training loop and first train step of both
families are in test_torch_train_dense_hybrid.py and test_torch_model.py,
their served tokens in test_torch_serve.py."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import ParamSpec as JSpec  # noqa: E402
from repro.models.layers import init_tree as jax_init_tree  # noqa: E402
from repro.parallel import sharding as shd  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import flatten_specs  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)    # float32 on both sides; op order differs
ARCHS = ["internvl2-26b", "seamless-m4t-large-v2"]
VLM, AUDIO = ARCHS


def _cfgs(arch):
    return (jconfigs.get_smoke(arch).replace(dtype="float32"),
            tconfigs.get_smoke(arch).replace(dtype="float32"))


def _close(ours, ref, msg=""):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL, err_msg=msg)


def _jax_shapes(cfg):
    flat = jax.tree_util.tree_flatten_with_path(
        JM.param_shapes(cfg), is_leaf=lambda x: isinstance(x, JSpec))[0]
    return {tuple(k.key for k in path): tuple(spec.shape) for path, spec in flat}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("which", ["get", "get_smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_shapes_match_reference(arch, which):
    """Every field (the frontend, encoder and MLP fields included), every
    parameter shape (seamless: the ``encoder`` subtree and each decoder
    layer's ``cross`` subtree, stacked) and the parameter count."""
    jcfg, tcfg = getattr(jconfigs, which)(arch), getattr(tconfigs, which)(arch)
    assert tcfg == tcfg.replace(**{f: getattr(jcfg, f) if hasattr(jcfg, f)
                                       else tcfg.__dataclass_fields__[f].default
                                    for f in tcfg.__dataclass_fields__})
    assert tcfg.is_encdec == jcfg.is_encdec == (arch == AUDIO)
    assert TT.layer_kinds(tcfg) == JT.layer_kinds(jcfg)
    assert TT.layer_kinds(tcfg, encoder=True) == JT.layer_kinds(jcfg, encoder=True)
    ours = {path: tuple(s.shape) for path, s in flatten_specs(TM.param_shapes(tcfg))}
    assert ours == _jax_shapes(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    if which == "get":
        assert tcfg.param_count() == {VLM: 19_861_260_288, AUDIO: 1_632_131_072}[arch]
    if arch == AUDIO:
        assert ("encoder", "final_norm") in ours and ("layers", "cross", "wq") in ours
        assert not any(p[-1].startswith("b") for p in ours)    # cross has no biases


def test_cross_has_no_qkv_biases_even_with_qkv_bias():
    """The reference gives a cross block's attention no biases whatever
    ``qkv_bias`` says; its self-attention takes them."""
    jcfg, tcfg = (c.replace(qkv_bias=True) for c in _cfgs(AUDIO))
    assert sorted(tattn.attn_specs(tcfg, cross=True)) == sorted(
        jattn.attn_specs(jcfg, cross=True)) == ["wk", "wo", "wq", "wv"]
    assert {"bq", "bk", "bv"} <= set(TT.block_specs(tcfg, "cross"))
    ours = {p: tuple(s.shape) for p, s in flatten_specs(TM.param_shapes(tcfg))}
    assert ours == _jax_shapes(jcfg)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("B,S", [(2, 11), (3, 1)])
def test_cross_attn_apply_matches_jax(B, S, use_pallas):
    """Cross-attention alone (seamless-smoke heads, memory of 16 frames):
    from the encoder's output and from a precomputed (mk, mv) pair, at a
    prompt (S = 11) and at a decode step (S = 1); the reference through its
    plain attention and through its Pallas kernel in interpret mode."""
    jcfg, tcfg = _cfgs(AUDIO)
    jcfg = jcfg.replace(use_pallas=use_pallas)
    jp = jax_init_tree(jattn.attn_specs(jcfg, cross=True), jax.random.PRNGKey(3), jnp.float32)
    tp = interop.to_torch(jp)
    x = _rand((B, S, jcfg.d_model), 1)
    mem = _rand((B, jcfg.frontend_tokens, jcfg.d_model), 2)
    jmk, jmv = jattn.cross_memory_kv(jp, jnp.asarray(mem))
    tmk, tmv = tattn.cross_memory_kv(tp, torch.from_numpy(mem))
    assert tmk.shape == (B, tcfg.frontend_tokens, tcfg.num_kv_heads, tcfg.head_dim)
    _close(tmk, jmk, "mk")
    _close(tmv, jmv, "mv")
    ref = jattn.cross_attn_apply(jp, jnp.asarray(x), jnp.asarray(mem), jcfg)
    _close(tattn.cross_attn_apply(tp, torch.from_numpy(x), torch.from_numpy(mem), tcfg), ref)
    ref_kv = jattn.cross_attn_apply(jp, jnp.asarray(x), (jmk, jmv), jcfg)
    _close(tattn.cross_attn_apply(tp, torch.from_numpy(x), (tmk, tmv), tcfg), ref_kv)


def test_encoder_apply_matches_jax():
    """seamless-smoke's encoder alone: two bidirectional ``enc_attn``
    blocks over 16 frames and the final norm. A causal mask would change
    every frame but the last, so this also pins ``causal=False``."""
    jcfg, tcfg = _cfgs(AUDIO)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = interop.to_torch(jparams)
    emb = _rand((2, jcfg.frontend_tokens, jcfg.d_model), 4)
    ref = JM._encoder_apply(jparams, jcfg, jnp.asarray(emb))
    out = TM._encoder_apply(tparams, tcfg, torch.from_numpy(emb))
    assert out.shape == emb.shape
    _close(out, ref)
    layer0, x = TM._layer(tparams["encoder"]["layers"], 0), torch.from_numpy(emb)
    assert not torch.allclose(TT.block_apply(layer0, x, tcfg, "enc_attn")[0],
                              TT.block_apply(layer0, x, tcfg, "attn")[0])


def test_gelu_mlp_matches_jax():
    """``mlp_variant="gelu"``: wi, tanh gelu (``jax.nn.gelu``'s default),
    wo_mlp; no gate."""
    jcfg, tcfg = _cfgs(AUDIO)
    assert tcfg.mlp_variant == "gelu"
    jp = jax_init_tree(JT.mlp_specs(jcfg), jax.random.PRNGKey(5), jnp.float32)
    assert sorted(jp) == sorted(TT.mlp_specs(tcfg)) == ["wi", "wo_mlp"]
    x = _rand((2, 9, jcfg.d_model), 6) * 3.0          # reach the tanh's curve
    _close(TT.mlp_apply(interop.to_torch(jp), torch.from_numpy(x), tcfg),
           JT.mlp_apply(jp, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_matches_reference(arch):
    """Tokens, then the frontend's embeddings, from one generator: the same
    values, key for key, for two steps and two hosts of a batch."""
    jcfg, tcfg = _cfgs(arch)
    for step, host in ((0, 0), (3, 1)):
        jb = jpipeline.make_batch(jcfg, 4, 40, seed=9, step=step, host=host, num_hosts=2)
        tb = tpipeline.make_batch(tcfg, 4, 40, seed=9, step=step, host=host, num_hosts=2)
        assert sorted(tb) == sorted(jb)
        F = tcfg.frontend_tokens
        key = "vision_embeds" if arch == VLM else "audio_embeds"
        assert tb["tokens"].shape == (2, 40 - F if arch == VLM else 40)
        assert tb[key].shape == (2, F, tcfg.d_model) and tb[key].dtype == torch.float32
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)


def _frontend(cfg, B, seed):
    key = {"vlm": "vision_embeds", "audio": "audio_embeds"}[cfg.family]
    return key, _rand((B, cfg.frontend_tokens, cfg.d_model), seed) * 0.02


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_jax(arch):
    """Prefill logits and every cache leaf (seamless: the cross K/V
    ``enc_k``/``enc_v`` of 16 frames per layer beside K/V), then two decode
    steps at per-row positions, which for vlm count the 8 vision tokens.
    The weights are the port's seeded init, carried to the JAX package:
    under the reference's stacked init (std num_layers^-0.5, ROADMAP.md
    Queue 3) float32 rounding in either package moves a few of
    seamless-smoke's decode logits by 2e-4 (as test_torch_moe.py finds for
    mixtral-smoke)."""
    jcfg, tcfg = _cfgs(arch)
    tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(tparams))
    B, S, max_len = 2, 21, 48
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S))
    key, emb = _frontend(jcfg, B, 8)
    jl, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens), key: jnp.asarray(emb)},
                        max_len)
    with torch.inference_mode():
        tl, tc = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens),
                                            key: torch.from_numpy(emb)}, max_len)
    names = ["enc_k", "enc_v", "k", "v"] if arch == AUDIO else ["k", "v"]
    assert sorted(tc["layers"]) == sorted(jc["layers"]) == names
    for name, (shape, dtype) in TM.cache_shapes(tcfg, B, max_len)["layers"].items():
        assert tc["layers"][name].shape == shape and tc["layers"][name].dtype == dtype
    _close(tl, jl, "prefill logits")
    for name in names:
        _close(tc["layers"][name], jc["layers"][name], name)
    F = tcfg.frontend_tokens if arch == VLM else 0
    pos = np.array([F + S, F + S - 5])
    for step in range(2):
        nxt = rng.integers(0, jcfg.vocab_size, (B, 1))
        jl, jc = JM.decode_step(jparams, jcfg, jc, jnp.asarray(nxt), jnp.asarray(pos + step))
        with torch.inference_mode():
            tl, tc = TM.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                    torch.from_numpy(pos + step))
        _close(tl, jl, f"decode {step} logits")
        for name in names:
            _close(tc["layers"][name], jc["layers"][name], f"decode {step} {name}")


def test_vlm_loss_skips_the_vision_prefix():
    """internvl2-smoke's loss scores the text's next tokens only: the
    logits at the 8 vision positions do not enter it (moving them moves
    nothing), and it equals the reference's."""
    jcfg, tcfg = _cfgs(VLM)
    tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(tparams))
    batch = tpipeline.make_batch(tcfg, 2, 30, seed=2, step=0)
    assert batch["tokens"].shape == (2, 22)
    loss = TM.loss_fn(tparams, tcfg, batch)
    _close(loss, JM.loss_fn(jparams, jcfg, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}))
    logits, _ = TM.forward(tparams, tcfg, batch)
    assert logits.shape == (2, 30, tcfg.vocab_size)
    text = torch.nn.functional.cross_entropy(logits[:, 8:29].reshape(-1, tcfg.vocab_size),
                                             batch["tokens"][:, 1:].reshape(-1))
    _close(loss, text.detach().numpy())


def test_engine_slot_pos_counts_the_vision_prefix():
    """A vlm slot's next position is F + prompt length after its prefill
    (the reference's ``slot.pos``), and advances by one a decode step, as
    in the JAX engine; a seamless slot's is the prompt length alone."""
    mesh = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
        jeng = JaxEngine(jcfg, mesh, shd.make_rules(multi_pod=False), jparams,
                         max_batch=2, max_len=48)
        teng = ServeEngine(tcfg, interop.to_torch(jparams), max_batch=2, max_len=48,
                           device="cpu")
        batch = teng.prefill_batch([1, 2, 3])
        key = "vision_embeds" if arch == VLM else "audio_embeds"
        assert sorted(batch) == sorted(["tokens", key])
        assert batch[key].shape == (1, tcfg.frontend_tokens, tcfg.d_model)
        assert not batch[key].any()
        for prompt in ([5, 6, 7, 8, 9], [3] * 12):
            jeng.submit(prompt, max_new_tokens=4)
            teng.submit(prompt, max_new_tokens=4)
        F = tcfg.frontend_tokens if arch == VLM else 0
        with mesh:
            jeng.step()
        teng.step()
        assert [s.pos for s in teng.slots] == [s.pos for s in jeng.slots] == [F + 6, F + 13]
        assert [r.generated for r in teng.requests.values()] == \
            [r.generated for r in jeng.requests.values()]
