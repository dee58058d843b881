"""The port's dense and SSM models against the JAX package's, on the CPU
in f32.

JAX's ``init_model`` weights are carried across (``interop``), then the
layers, ``prefill_forward`` (logits and the caches: ring-buffer K/V, or
the SSM conv windows and states) and N ``decode_step``s are compared with
JAX running its ``chunked`` route and its ``pallas`` route (the Pallas
attention kernels in interpret mode; JAX's SSM prefill runs
``ssd_chunked`` on both). The port runs its ``cuda`` route, which on CPU
tensors is the kernels' plain versions, and its ``chunked`` route.
Tolerance: 1e-4 rtol and atol, the bar of ``tests/test_models.py``'s
decode-consistency test; layers 2e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import prefill_forward as jprefill_forward  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step, init_caches, init_model, layers, prefill, prefill_forward,
)
from repro_torch.models.config import ModelConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=2e-6, atol=2e-6)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_match_jax(arch):
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke, jconfigs.get_smoke)):
        cfg, jcfg = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.active_params() == jcfg.active_params()
        assert cfg.total_params() == jcfg.total_params()
        assert cfg.layer_kinds() == jcfg.layer_kinds()
        assert str(cfg.torch_dtype).split(".")[1] == str(jcfg.dtype_jnp)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    cases = [
        (layers.rms_norm(_t(x), None), jlayers.rms_norm(x, None)),
        (layers.rms_norm(_t(x), _t(w)), jlayers.rms_norm(x, w)),
        (layers.layer_norm(_t(x), _t(w), _t(bias)),
         jlayers.layer_norm(x, w, bias)),
        (layers.apply_norm("nonparametric", {}, _t(x)),
         jlayers.apply_norm("nonparametric", {}, x)),
        (layers.rope_frequencies(32, 10_000.0),
         jlayers.rope_frequencies(32, 10_000.0)),
    ]
    q = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.arange(3, 10)[None].repeat(2, 0)
    cases.append((layers.apply_rope(_t(q), _t(pos), 10_000.0),
                  jlayers.apply_rope(q, pos, 10_000.0)))
    for kind in ("swiglu", "gelu"):
        jp = jlayers.init_mlp(jax.random.PRNGKey(1), kind, 64, 96)
        p = {k: _t(v) for k, v in jp.items()}
        cases.append((layers.apply_mlp(kind, p, _t(x)),
                      jlayers.apply_mlp(kind, jp, x)))
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LAYER_TOL)


def test_init_model_shapes_and_scales():
    """Not bitwise (torch.Generator is not threefry): same tree, shapes and
    dtypes as JAX's, and the same distributions."""
    cfg, jcfg = configs.get_smoke("deepseek-67b"), jconfigs.get_smoke(
        "deepseek-67b")
    p = interop.params_to_numpy(init_model(cfg, seed=0, device="cpu"))
    jp = jax.tree.map(np.asarray, jinit_model(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(p) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    w = p["blocks"]["mlp"]["w_gate"]
    assert abs(w.std() * np.sqrt(cfg.d_model) - 1) < 0.02
    assert abs(p["embed"].std() / 0.02 - 1) < 0.02
    bf = init_model(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    assert bf["embed"].dtype == torch.bfloat16


def test_interop_round_trip():
    cfg, jcfg = configs.get_smoke("olmo-1b"), jconfigs.get_smoke("olmo-1b")
    jp = jax.tree.map(np.asarray, jinit_model(jax.random.PRNGKey(2), jcfg))
    back = interop.params_to_numpy(interop.params_from_numpy(jp, cfg, "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        interop.params_from_numpy(
            jp, dataclasses.replace(cfg, num_layers=3), "cpu")
    toks = jnp.asarray(np.arange(2, 22, dtype=np.int32)[None])
    _, jc = jprefill_forward(jp, jcfg, toks, cache_len=24)
    c = interop.caches_from_numpy(jc, "cpu")
    assert c.pos == 20 and tuple(c.k.shape) == jc.k.shape
    out = interop.caches_to_numpy(c)
    np.testing.assert_array_equal(out["k"], np.asarray(jc.k))
    np.testing.assert_array_equal(out["v"], np.asarray(jc.v))
    assert int(out["pos"]) == 20


def test_interop_round_trip_ssm():
    """An SSM tree (``blocks.mixer.*``) and SSM caches (``ssm_conv``,
    ``ssm_h``; ``k``/``v`` None) both ways; decoding from the carried
    caches matches JAX's."""
    cfg = configs.get_smoke("mamba2-370m")
    jcfg = jconfigs.get_smoke("mamba2-370m")
    jp = jax.tree.map(np.asarray, jinit_model(jax.random.PRNGKey(4), jcfg))
    p = interop.params_from_numpy(jp, cfg, "cpu")
    assert set(p["blocks"]["mixer"]) == set(jp["blocks"]["mixer"])
    back = interop.params_to_numpy(p)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    toks = jnp.asarray(np.arange(2, 21, dtype=np.int32)[None])
    _, jc = jprefill_forward(jp, jcfg, toks)
    c = interop.caches_from_numpy(jc, "cpu")
    assert c.k is None and c.v is None and c.pos == 19
    out = interop.caches_to_numpy(c)
    assert set(out) == {"ssm_conv", "ssm_h", "pos"}
    np.testing.assert_array_equal(out["ssm_conv"], np.asarray(jc.ssm_conv))
    np.testing.assert_array_equal(out["ssm_h"], np.asarray(jc.ssm_h))
    jl, _ = jdecode_step(jp, jcfg, toks[:, :1], jc)
    logits, c = decode_step(p, cfg, _t(toks[:, :1]), c)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert c.pos == 20


# ---------------------------------------------------------------------------
# prefill / decode against JAX
# ---------------------------------------------------------------------------

def _sliding(jcfg):
    return dataclasses.replace(jcfg, name=jcfg.name + "-sliding", window=8)


MODELS = {
    "olmo-1b": lambda: jconfigs.get_smoke("olmo-1b"),            # MHA, tied
    "deepseek-67b": lambda: jconfigs.get_smoke("deepseek-67b"),  # GQA G = 4
    "sliding": lambda: _sliding(jconfigs.get_smoke("deepseek-7b")),  # W < S
    "mamba2-370m": lambda: jconfigs.get_smoke("mamba2-370m"),    # SSM, Q 16
}


def _assert_caches_close(got, want):
    """Every cache stack the JAX caches hold (K/V, or SSM conv windows
    and states) and ``pos``."""
    for n in ("k", "v", "ssm_conv", "ssm_h"):
        w = getattr(want, n)
        assert (getattr(got, n) is None) == (w is None), n
        if w is not None:
            np.testing.assert_allclose(getattr(got, n).numpy(),
                                       np.asarray(w), **TOL)
    assert got.pos == int(want.pos)


def _pair(name, seed=0):
    jcfg = MODELS[name]()
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jinit_model(jax.random.PRNGKey(seed), jcfg)
    p = interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, p


def _tokens(cfg, B=2, S=20, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("jimpl", ["chunked", "pallas"])
@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_and_decode_match_jax(name, jimpl):
    """prefill_forward's logits and caches, then 4 decode steps fed with
    JAX's greedy tokens; the sliding variant's W = 8 < S = 20 exercises
    _place_kv's ring placement and, in decode, a wrapped ring. For the
    SSM, S = 20 is not a multiple of the 16-row chunk."""
    jcfg, jp, cfg, p = _pair(name)
    toks = _tokens(cfg)
    jl, jc = jprefill_forward(jp, jcfg, jnp.asarray(toks), cache_len=26,
                              impl=jimpl)
    assert int(jc.pos) == 20
    for impl in ("cuda", "chunked"):
        logits, c = prefill_forward(p, cfg, _t(toks), cache_len=26,
                                    impl=impl)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        _assert_caches_close(c, jc)
    if name == "sliding":
        assert c.k.shape[2] == 8
    logits, c = prefill_forward(p, cfg, _t(toks), cache_len=26)  # default
    jcur = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    for _ in range(4):
        jl, jc = jdecode_step(jp, jcfg, jcur, jc, impl=jimpl)
        logits, c = decode_step(p, cfg, _t(jcur), c)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        jcur = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    _assert_caches_close(c, jc)
    assert c.pos == 24


@pytest.mark.parametrize("name", ["deepseek-67b", "sliding", "mamba2-370m"])
def test_prefill_forward_matches_token_by_token(name):
    """The batched prefill against the port's own decode_step oracle, on
    the port's own random weights (S = 19: a ragged SSM chunk)."""
    cfg = ModelConfig(**dataclasses.asdict(MODELS[name]()))
    p = init_model(cfg, seed=3, device="cpu")
    toks = _t(_tokens(cfg, S=19, seed=3))
    l1, c1 = prefill_forward(p, cfg, toks, cache_len=23)
    l2, c2 = prefill(p, cfg, toks, cache_len=23)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), **TOL)
    for n in ("k", "v", "ssm_conv", "ssm_h"):
        a, b = getattr(c1, n), getattr(c2, n)
        assert (a is None) == (b is None) == (n in (
            ("k", "v") if cfg.arch_type == "ssm" else ("ssm_conv", "ssm_h")))
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    assert c1.pos == c2.pos == 19
    cur = l1.argmax(-1)[:, None]
    a, _ = decode_step(p, cfg, cur, c1)
    b, _ = decode_step(p, cfg, cur, c2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("arch_type,extra", [
    ("dense", dict(kv_dtype="float8_e4m3fn")),
])
def test_unported_families_raise(arch_type, extra):
    """A KV cache in another dtype than the model's (fp8) is not ported;
    every family is (``tests/test_torch_zoo.py``)."""
    cfg = ModelConfig(name="x", arch_type=arch_type, num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64, dtype="float32", **extra)
    with pytest.raises(NotImplementedError):
        init_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        init_caches(cfg, 1, 8, device="cpu")
