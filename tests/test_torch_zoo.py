"""The rest of the model zoo against the JAX package, on the CPU in f32:
the hybrid (zamba2), MoE (dbrx; llama4's interleave), VLM (phi-3-vision,
with and without its frontend) and encoder-decoder (whisper) families, at
their SMOKE sizes and at ``tests/test_models.py``'s ``tiny`` widths.

JAX's ``init_model`` trees are carried across (``interop``); the same
numpy-seeded tokens, patch embeddings and frames go through JAX's
``prefill_forward`` and the port's, then 4 ``decode_step``s fed with JAX's
greedy tokens, and the logits and every cache stack are compared. JAX runs
its ``chunked`` route, and its ``pallas`` route (the attention kernels in
interpret mode) where its ops take the shapes: not for the audio family,
whose full-mode attention over the encoder's frames the Pallas op refuses.
The port runs its ``cuda`` route (on CPU tensors, the kernels' plain
versions) and its ``chunked`` route. Tolerance: 1e-4 rtol and atol, the
bar of ``tests/test_models.py``'s decode-consistency test.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
NEW_ARCHS = ("zamba2-2.7b", "dbrx-132b", "llama4-maverick-400b-a17b",
             "phi-3-vision-4.2b", "whisper-medium")


def _tiny(arch, **kw):
    """``tests/test_models.py``'s ``tiny`` widths, per family."""
    base = dict(name=f"tiny-{arch}", arch_type=arch, num_layers=2,
                d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                vocab_size=64, dtype="float32")
    if arch == "hybrid":
        base.update(ssm_state=8, ssm_head_dim=8, ssm_chunk=8,
                    shared_attn_every=1)
    if arch == "moe":
        base.update(num_experts=4, experts_per_token=2, capacity_factor=8.0)
    if arch == "vlm":
        base.update(frontend_tokens=4, frontend_dim=24)
    if arch == "audio":
        base.update(encoder_layers=2, encoder_seq=12, frontend_dim=16,
                    mlp="gelu", tie_embeddings=True)
    base.update(kw)
    return JConfig(**base)


# name -> (JAX config, prompt length, whether the VLM frontend is fed)
MODELS = {
    "zamba2": (jconfigs.get_smoke("zamba2-2.7b"), 20, False),
    "dbrx": (jconfigs.get_smoke("dbrx-132b"), 20, False),
    "llama4": (jconfigs.get_smoke("llama4-maverick-400b-a17b"), 20, False),
    "phi3-text": (jconfigs.get_smoke("phi-3-vision-4.2b"), 20, False),
    "phi3-image": (jconfigs.get_smoke("phi-3-vision-4.2b"), 20, True),
    "whisper": (jconfigs.get_smoke("whisper-medium"), 20, False),
    "tiny-hybrid": (_tiny("hybrid"), 12, False),
    # two groups of (2 dense + 1 MoE): the secondary stack's group order
    "tiny-moe-every3": (_tiny("moe", num_layers=6, moe_every=3), 12, False),
    # per-group capacity with drops in prefill
    "tiny-moe-grouped": (_tiny("moe", capacity_factor=1.25,
                               moe_dispatch_groups=2), 12, False),
    "tiny-vlm": (_tiny("vlm"), 12, True),
    "tiny-audio": (_tiny("audio"), 12, False),
}
JIMPLS = [(n, "chunked") for n in MODELS] + [
    (n, "pallas") for n in ("zamba2", "dbrx", "llama4", "phi3-text",
                            "phi3-image")]


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _pair(name, seed=0):
    jcfg = MODELS[name][0]
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jt.init_model(jax.random.PRNGKey(seed), jcfg)
    p = interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, p


def _inputs(name, seed=0):
    """(tokens (2, S), extra inputs as numpy: frontend or encoder_frames)."""
    cfg, S, image = MODELS[name]
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab_size, (2, S)).astype(np.int32)
    extra = {}
    if image:
        extra["frontend"] = rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.is_encdec:
        extra["encoder_frames"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)
    return toks, extra


def _assert_caches_close(got, want):
    for n in interop._CACHE_FIELDS:
        w = getattr(want, n)
        assert (getattr(got, n) is None) == (w is None), n
        if w is not None:
            np.testing.assert_allclose(getattr(got, n).numpy(),
                                       np.asarray(w), err_msg=n, **TOL)
    assert got.pos == int(want.pos)


# ---------------------------------------------------------------------------
# configs, trees, interop
# ---------------------------------------------------------------------------

def test_arch_ids_and_all_configs_match_jax():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    got, want = configs.all_configs(), jconfigs.all_configs()
    assert list(got) == list(want)
    for a in got:
        assert dataclasses.asdict(got[a]) == dataclasses.asdict(want[a])
        assert got[a].total_params() == want[a].total_params()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_model_tree_matches_jax(arch):
    """The port's own init: JAX's tree, shapes and dtypes (not its bits)."""
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    p = interop.params_to_numpy(tt.init_model(cfg, seed=0, device="cpu"))
    jp = jax.eval_shape(lambda: jt.init_model(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(p) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for name, n in tt.stack_sizes(cfg).items():
        assert p[name]["ln1"]["w"].shape[0] == n


@pytest.mark.parametrize("name", ["zamba2", "llama4", "phi3-image",
                                  "whisper"])
def test_interop_round_trip(name):
    """Every family's tree and caches both ways, exactly (the caches: JAX's
    zero stacks of every kind the family holds, filled from a seed); a
    tree whose stacks do not fit the config raises."""
    jcfg, jp, cfg, p = _pair(name, seed=2)
    jp = jax.tree.map(np.asarray, jp)
    back = interop.params_to_numpy(p)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    bad = dict(cfg=dataclasses.replace(cfg, num_layers=cfg.num_layers * 2))
    if cfg.is_encdec:
        bad["enc"] = dataclasses.replace(cfg, encoder_layers=1)
    for wrong in bad.values():
        with pytest.raises(ValueError):
            interop.params_from_numpy(jp, wrong, "cpu")
    rng = np.random.default_rng(2)
    jc = jt.init_caches(jcfg, 2, 24, enc_seq=10)
    held = {n for n in interop._CACHE_FIELDS if getattr(jc, n) is not None}
    jc = jc._replace(pos=jnp.int32(17), **{
        n: rng.standard_normal(getattr(jc, n).shape).astype(np.float32)
        for n in held})
    c = interop.caches_from_numpy(jc, "cpu")
    out = interop.caches_to_numpy(c)
    assert set(out) == held | {"pos"}
    for n in held:
        np.testing.assert_array_equal(out[n], getattr(jc, n))
    assert interop.caches_from_numpy(out, "cpu").pos == c.pos == 17


def test_shared_attn_must_be_one_block():
    cfg = ModelConfig(**dataclasses.asdict(MODELS["tiny-hybrid"][0]))
    tree = interop.params_to_numpy(tt.init_model(cfg, device="cpu"))
    interop.params_from_numpy(tree, cfg, "cpu")
    tree["shared_attn"] = jax.tree.map(lambda a: a[None],
                                       tree["shared_attn"])
    with pytest.raises(ValueError, match="shared_attn"):
        interop.params_from_numpy(tree, cfg, "cpu")


# ---------------------------------------------------------------------------
# prefill / decode against JAX
# ---------------------------------------------------------------------------

def _jax_fns(name, jimpl, cache_len):
    jcfg = MODELS[name][0]
    return (jax.jit(functools.partial(jt.prefill_forward, cfg=jcfg,
                                      cache_len=cache_len, impl=jimpl)),
            jax.jit(functools.partial(jt.decode_step, cfg=jcfg, impl=jimpl)))


@pytest.mark.parametrize("name,jimpl", JIMPLS)
def test_prefill_and_decode_match_jax(name, jimpl):
    """prefill_forward's logits and every cache stack, then 4 decode steps
    fed with JAX's greedy tokens (every stack again after them). Prompts
    of 20 / 12 tokens are ragged against the SSD chunk (16 / 8)."""
    jcfg, jp, cfg, p = _pair(name)
    toks, extra = _inputs(name)
    S = toks.shape[1] + (jcfg.frontend_tokens if "frontend" in extra else 0)
    jprefill, jdecode = _jax_fns(name, jimpl, S + 6)
    jl, jc = jprefill(jp, tokens=jnp.asarray(toks),
                      **{k: jnp.asarray(v) for k, v in extra.items()})
    textra = {k: _t(v) for k, v in extra.items()}
    for impl in ("cuda", "chunked"):
        logits, c = tt.prefill_forward(p, cfg, _t(toks), cache_len=S + 6,
                                       impl=impl, **textra)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        _assert_caches_close(c, jc)
    assert c.pos == S
    logits, c = tt.prefill_forward(p, cfg, _t(toks), cache_len=S + 6,
                                   **textra)                   # default
    jcur = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    for _ in range(4):
        jl, jc = jdecode(jp, token=jcur, caches=jc)
        logits, c = tt.decode_step(p, cfg, _t(jcur), c)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        jcur = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    _assert_caches_close(c, jc)


@pytest.mark.parametrize("name", [n for n in MODELS if n != "tiny-moe-grouped"])
def test_prefill_oracle_matches_prefill_forward(name):
    """The token-by-token oracle against the batched prefill on the port's
    own weights: logits, every cache stack, and one more decode step from
    each. (The MoE models' capacity keeps every copy here: a prompt routed
    at once may drop copies that one token at a time never does, in both
    packages.)"""
    jcfg = MODELS[name][0]
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    p = tt.init_model(cfg, seed=3, device="cpu")
    toks, extra = _inputs(name, seed=3)
    extra = {k: _t(v) for k, v in extra.items()}
    S = toks.shape[1] + (cfg.frontend_tokens if "frontend" in extra else 0)
    l1, c1 = tt.prefill_forward(p, cfg, _t(toks), cache_len=S + 3, **extra)
    l2, c2 = tt.prefill(p, cfg, _t(toks), cache_len=S + 3, **extra)
    torch.testing.assert_close(l1, l2, **TOL)
    for n in interop._CACHE_FIELDS:
        a, b = getattr(c1, n), getattr(c2, n)
        assert (a is None) == (b is None), n
        if a is not None:
            torch.testing.assert_close(a, b, **TOL)
    assert c1.pos == c2.pos == S
    cur = l1.argmax(-1)[:, None]
    torch.testing.assert_close(tt.decode_step(p, cfg, cur, c1)[0],
                               tt.decode_step(p, cfg, cur, c2)[0], **TOL)


@pytest.mark.parametrize("name", ["tiny-vlm", "tiny-audio"])
def test_prefill_oracle_matches_jax(name):
    """The oracle's own semantics against JAX's: the frontend's pseudo-
    tokens first, and caches of the text's length by default (so the
    VLM's ring wraps over the image), or the encoder's cross K/V."""
    jcfg, jp, cfg, p = _pair(name)
    toks, extra = _inputs(name)
    jl, jc = jt.prefill(jp, jcfg, jnp.asarray(toks),
                        **{k: jnp.asarray(v) for k, v in extra.items()})
    logits, c = tt.prefill(p, cfg, _t(toks),
                           **{k: _t(v) for k, v in extra.items()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(c, jc)


def test_encoder_decoder_needs_frames():
    """Whisper's prefill names the missing frames (``ServedModel.generate``
    passes none; the JAX package fails there with an AttributeError);
    decode without cross K/V and embedded prefill outside the VLM
    refuse."""
    _, _, cfg, p = _pair("tiny-audio")
    toks = _t(_inputs("tiny-audio")[0])
    for fn in (tt.prefill_forward, tt.prefill):
        with pytest.raises(ValueError, match="encoder_frames"):
            fn(p, cfg, toks)
    caches = tt.init_caches(cfg, 2, 16, device="cpu")
    assert caches.cross_k.shape == (2, 2, 0, 2, 8)
    with pytest.raises(ValueError, match="cross-attention"):
        tt.decode_step(p, cfg, toks[:, :1], caches._replace(cross_k=None))
    with pytest.raises(NotImplementedError):
        tt._decode_embedded(p, cfg, torch.zeros(2, 1, 32), caches, None)


@pytest.mark.parametrize("name", ["zamba2", "llama4", "dbrx", "whisper"])
def test_init_caches_match_jax(name):
    """Stack sizes and dtypes of every family's zero caches: the hybrid's
    secondary stack (one entry per shared-block application, no primary
    K/V), the interleaved MoE's (the dense layers), the cross stack."""
    jcfg = MODELS[name][0]
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jc = jt.init_caches(jcfg, 2, 24, enc_seq=10)
    c = tt.init_caches(cfg, 2, 24, enc_seq=10, device="cpu")
    for n in interop._CACHE_FIELDS:
        w = getattr(jc, n)
        assert (getattr(c, n) is None) == (w is None), n
        if w is not None:
            assert tuple(getattr(c, n).shape) == w.shape, n
            assert str(getattr(c, n).dtype).split(".")[1] == str(w.dtype)


@pytest.mark.parametrize("name", ["dbrx", "tiny-moe-every3", "zamba2"])
def test_decoder_stack_matches_jax(name):
    """The blocks over a full sequence: activations and the mean MoE
    load-balance loss over the MoE layers (0 for the hybrid)."""
    jcfg, jp, cfg, p = _pair(name)
    x = np.random.default_rng(1).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    pos = np.arange(12)
    jx, jaux = jt.decoder_stack(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, aux = tt.decoder_stack(p, cfg, _t(x), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert (float(aux) > 0) == cfg.is_moe
