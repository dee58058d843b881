"""fp8 KV caches against the JAX package, on the CPU.

The cast into a cache (``layers.astype``) gives ``jnp.astype``'s bits,
NaN on an e4m3fn overflow included; ``init_caches`` allocates every
family's stacks as JAX's does; olmo-1b, dbrx-132b and whisper-medium at
SMOKE run the port's ``prefill`` + 4 ``decode_step``s on fp8 caches
against JAX's, whose ``pallas`` route runs the decode kernel in interpret
mode, and against its ``einsum`` route; ``prefill_forward`` keeps
compute-dtype caches; the SSM families raise ``ValueError`` where JAX
does; the caches cross ``interop`` both ways; the plain decode on an fp8
cache is the plain decode on the upcast cache, bit for bit.

Tolerances: logits rtol 2e-4 / atol 2e-5, the f32 attention bar of
``tests/test_kernels.py:29``; each fp8 cache element within one fp8 step
of JAX's (a one-ulp difference in an f32 K/V value can flip a rounding),
with every bit equal expected on these seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref,
)
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

FP8 = {"float8_e4m3fn": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
       "float8_e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
EDGES = np.array([448, 464, 465, 480, 1e4, -1e4, np.inf, -np.inf, np.nan,
                  -np.nan, 0.0, -0.0, 2.0 ** -9, -(2.0 ** -9), 2.0 ** -10,
                  2.0 ** -16, 2.0 ** -17, 57344, 61439, 61440, 61441, 1e6,
                  240, 232, 3e-3, -7.5e-4], np.float32)


def _sources(n=100_000, seed=0):
    """(f32 values, bf16 bits as uint16): the edges, random magnitudes
    1e-4..1e2 of either sign, and random bit patterns (NaN payloads,
    infinities, subnormals)."""
    rng = np.random.default_rng(seed)
    mags = (10.0 ** rng.uniform(-4, 2, n)
            * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    f32 = np.concatenate([EDGES, mags, bits.view(np.float32)])
    bf16 = np.concatenate([EDGES.astype(ml_dtypes.bfloat16).view(np.uint16),
                           mags.astype(ml_dtypes.bfloat16).view(np.uint16),
                           (bits >> 16).astype(np.uint16)])
    return f32, bf16


@pytest.mark.parametrize("name", list(FP8))
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_cast_matches_jnp_astype_bit_for_bit(name, src):
    jdt, tdt = FP8[name]
    f32, bf16 = _sources()
    if src == "float32":
        jx, tx = f32, torch.from_numpy(f32)
    else:
        jx = bf16.view(ml_dtypes.bfloat16)
        tx = torch.from_numpy(bf16.view(np.int16)).view(torch.bfloat16)
    want = np.asarray(jnp.asarray(jx).astype(jdt)).view(np.uint8)
    got = layers.astype(tx, tdt).view(torch.uint8).numpy()
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (f"{bad.size} casts differ, e.g. {jx[bad[:4]]} "
                           f"-> {got[bad[:4]]} vs {want[bad[:4]]}")
    # What torch's own cast gets wrong there: saturation (e4m3fn) or the
    # NaN encoding (e5m2).
    bare = tx.to(tdt).view(torch.uint8).numpy()
    assert (bare != want).any()


def _pair(arch, kv_dtype, seed=0):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), kv_dtype=kv_dtype)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jt.init_model(jax.random.PRNGKey(seed), jcfg)
    p = interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, p


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_init_caches_match_jax(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               kv_dtype="float8_e4m3fn")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    enc = jcfg.encoder_seq if jcfg.is_encdec else 0
    want = jt.init_caches(jcfg, 2, 24, enc_seq=enc)
    got = tt.init_caches(cfg, 2, 24, enc_seq=enc, device="cpu")
    for n in interop._CACHE_FIELDS:
        w, g = getattr(want, n), getattr(got, n)
        assert (w is None) == (g is None), n
        if w is not None:
            assert tuple(g.shape) == w.shape, n
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), n
            assert not g.any() if g.dtype == torch.float32 else True


def _fp8_close(got: torch.Tensor, want, name):
    """Every element within one fp8 step of JAX's (the codes of one sign
    differ by at most 1); returns the count of elements whose bits
    differ."""
    g = got.view(torch.uint8).numpy().astype(np.int16)
    w = np.asarray(want).view(np.uint8).astype(np.int16)
    assert g.shape == w.shape, name
    same_sign = (g >> 7) == (w >> 7)
    assert ((np.abs(g - w) <= 1) & same_sign | (g == w)).all(), name
    return int((g != w).sum())


def _inputs(jcfg, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, jcfg.vocab_size, (2, S)).astype(np.int32)
    frames = (rng.standard_normal((2, jcfg.encoder_seq, jcfg.frontend_dim))
              .astype(np.float32) if jcfg.is_encdec else None)
    return toks, frames


# JAX's decode step, compiled once per (config, route): eager, its Pallas
# kernel in interpret mode runs op by op.
_jdecode = jax.jit(jt.decode_step, static_argnums=(1,),
                   static_argnames=("impl",))

FP8_RUNS = [(a, "float8_e4m3fn", impl)
            for a in ("olmo-1b", "dbrx-132b", "whisper-medium")
            for impl in ("pallas", "einsum")] + [
    ("olmo-1b", "float8_e5m2", "pallas")]


@pytest.mark.parametrize("arch,kv_dtype,jimpl", FP8_RUNS)
def test_fp8_prefill_and_decode_match_jax(arch, kv_dtype, jimpl):
    """Port ``prefill`` and 4 ``decode_step``s on fp8 caches against JAX's;
    the port's ``cuda`` route runs the kernel's plain version on the CPU
    against JAX's Pallas kernel, ``einsum`` against ``einsum``. Each
    decode step starts both packages from JAX's caches (carried across by
    ``interop``), so a rounding flipped in an earlier write does not
    compound; the written caches are held to one fp8 step, and the flips
    counted."""
    jcfg, jp, cfg, p = _pair(arch, kv_dtype)
    timpl = "cuda" if jimpl == "pallas" else "einsum"
    toks, frames = _inputs(jcfg, 8)
    extra_j = {} if frames is None else {"encoder_frames": jnp.asarray(frames)}
    extra_t = {} if frames is None else {
        "encoder_frames": torch.from_numpy(frames)}
    jl, jc = jt.prefill(jp, jcfg, jnp.asarray(toks), cache_len=12,
                        impl=jimpl, **extra_j)
    tl, tc = tt.prefill(p, cfg, torch.from_numpy(toks), cache_len=12,
                        impl=timpl, **extra_t)
    flips = written = 0
    for step in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {step}", **LOGIT_TOL)
        for n in ("k", "v", "shared_k", "shared_v"):
            w = getattr(jc, n)
            if w is not None:
                assert getattr(tc, n).dtype == FP8[kv_dtype][1], n
                flips += _fp8_close(getattr(tc, n), w, n)
                written += w.size * (8 if step == 0 else 1) // 12
        if step == 4:
            break
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        tc = interop.caches_from_numpy(jax.tree.map(np.asarray, jc._asdict()),
                                       "cpu")
        jl, jc = _jdecode(jp, jcfg, jnp.asarray(tok), jc, impl=jimpl)
        tl, tc = tt.decode_step(p, cfg, torch.from_numpy(tok), tc,
                                impl=timpl)
    assert tc.pos == int(jc.pos) == 12
    # A flip needs an f32 K/V value within a few f32 ulps of an fp8
    # rounding edge: about 2^-20 of the values a write rounds.
    assert flips <= max(1, written // 1000), (flips, written)


def test_prefill_forward_keeps_compute_dtype_caches():
    """JAX's served prefill ignores ``kv_dtype``; so does the port's."""
    jcfg, jp, cfg, p = _pair("olmo-1b", "float8_e4m3fn")
    toks, _ = _inputs(jcfg, 8)
    _, jc = jt.prefill_forward(jp, jcfg, jnp.asarray(toks))
    _, tc = tt.prefill_forward(p, cfg, torch.from_numpy(toks))
    assert jc.k.dtype == jnp.float32
    assert tc.k.dtype == tc.v.dtype == torch.float32
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_fp8_ssm_decode_raises_where_jax_does(arch):
    """Traced on shapes (JAX's ``eval_shape``, the port's ``meta``): the
    decode of an fp8 conv state raises ValueError in both packages."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               kv_dtype="float8_e4m3fn")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jax.eval_shape(lambda: jt.init_model(jax.random.PRNGKey(0), jcfg))
    jc = jax.eval_shape(lambda: jt.init_caches(jcfg, 2, 8))
    tok = jax.ShapeDtypeStruct((2, 1), jnp.int32)
    with pytest.raises(ValueError):
        jax.eval_shape(lambda p, t, c: jt.decode_step(p, jcfg, t, c), jp,
                       tok, jc)
    caches = tt.init_caches(cfg, 2, 8, device="cpu")
    assert caches.ssm_conv.dtype == torch.float8_e4m3fn
    assert caches.ssm_h.dtype == torch.float32
    with pytest.raises(ValueError, match="conv state"):
        tt.decode_step(tt.init_model(cfg, device="meta"), cfg,
                       torch.ones((2, 1), dtype=torch.int32, device="meta"),
                       tt.init_caches(cfg, 2, 8, device="meta"))


@pytest.mark.parametrize("name", list(FP8))
def test_fp8_caches_cross_interop_both_ways(name):
    jcfg, jp, cfg, p = _pair("olmo-1b", name)
    toks, _ = _inputs(jcfg, 6)
    _, jc = jt.prefill(jp, jcfg, jnp.asarray(toks), cache_len=8,
                       impl="einsum")
    tc = interop.caches_from_numpy(jax.tree.map(np.asarray, jc._asdict()),
                                   "cpu")
    assert tc.k.dtype == FP8[name][1] and tc.pos == 6
    back = interop.caches_to_numpy(tc)
    assert back["k"].dtype == np.uint8
    np.testing.assert_array_equal(back["k"], np.asarray(jc.k).view(np.uint8))
    np.testing.assert_array_equal(
        back["v"].view(FP8[name][0]), np.asarray(jc.v))
    again = interop.caches_from_numpy(back, "cpu", kv_dtype=FP8[name][1])
    assert again.k.dtype == FP8[name][1]
    assert torch.equal(again.k.view(torch.uint8), tc.k.view(torch.uint8))


@pytest.mark.parametrize("name", list(FP8))
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_plain_decode_on_fp8_equals_decode_on_upcast_cache(name, qdt):
    """The upcast is exact, so every plain decode route gives the same
    bits on the fp8 cache and on ``cache.to(q.dtype)``."""
    g = torch.Generator().manual_seed(0)
    B, W, KV, G, hd = 2, 40, 2, 4, 32
    q = torch.randn(B, 1, KV * G, hd, generator=g).to(qdt)
    kc = layers.astype(torch.randn(B, W, KV, hd, generator=g) * 4,
                       FP8[name][1])
    vc = layers.astype(torch.randn(B, W, KV, hd, generator=g) * 4,
                       FP8[name][1])
    valid = attention.ring_valid(35, W, 0, "cpu")
    up = (kc.to(qdt), vc.to(qdt))
    for fn in (decode_attention_ref, attention._einsum_decode,
               lambda *a: attention._masked_decode(*a, 16)):
        a = fn(q, kc, vc, valid)
        b = fn(q, *up, valid)
        assert a.dtype == qdt
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,code", [("float8_e4m3fn", 2),
                                       ("float8_e5m2", 3)])
def test_fp8_cache_reaches_the_kernel_uncast(monkeypatch, name, code):
    """The CUDA route's wrapper on a stand-in library: the launch gets
    the fp8 cache's own storage and its dtype code (nothing casts it
    first), the counters count it by dtype, and a cache of the other
    compute dtype is refused."""
    from repro_torch.kernels import build, checks
    from repro_torch.kernels.decode_attention import kernel, ops

    seen = []

    class Lib:
        def decode_attention_launch(self, *args):
            seen.append(args)
            return 0

    monkeypatch.setattr(build, "library", Lib)
    monkeypatch.setattr(ops, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    q = torch.zeros((1, 1, 4, 64), dtype=torch.bfloat16)
    kc = torch.zeros((1, 40, 2, 64), dtype=FP8[name][1])
    valid = torch.ones(40, dtype=torch.bool)
    before = ops.KV_DTYPE_LAUNCHES[name]
    ops._launch(q, kc, kc, valid)
    (args,) = seen
    assert args[1] == args[2] == kc.data_ptr()
    assert args[-3:-1] == (kernel.DTYPES[torch.bfloat16], code)
    assert ops.KV_DTYPE_LAUNCHES[name] == before + 1
    with pytest.raises(TypeError, match="cache"):
        ops._launch(q, kc.float(), kc.float(), valid)
    assert checks.kv_cache_dtype("t", torch.float32, FP8[name][1]) \
        == FP8[name][1]
