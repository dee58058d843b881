"""The port's threefry generator against ``jax.random``, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import router as jrouter  # noqa: E402
from repro.core.types import RouterConfig as JConfig  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import router as trouter  # noqa: E402
from repro_torch.core.types import HyperParams, RouterConfig  # noqa: E402

SEEDS = (0, 1, 7, 123456, 2**31 - 1)


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)),
                          prng.PRNGKey(seed).numpy())


def test_prng_key_stack_matches_vmapped_keys():
    """make_states' per-seed keys: vmap(PRNGKey) over uint32 seeds."""
    seeds = [0, 3, 2**32 - 1]
    want = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))
    got = torch.stack([prng.PRNGKey(s) for s in seeds])
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chain_and_uniform(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for _ in range(12):
        nj, sj = jax.random.split(kj)
        pt = prng.split(kt)
        assert np.array_equal(np.asarray(nj), pt[0].numpy())
        assert np.array_equal(np.asarray(sj), pt[1].numpy())
        for shape in ((8,), (3,), (2, 5)):
            assert np.array_equal(
                _bits(jax.random.uniform(sj, shape)),
                _bits(prng.uniform(pt[1], shape).numpy()))
        kj, kt = nj, pt[0]


@pytest.mark.parametrize("num", [3, 5])
def test_split_many(num):
    k = jax.random.PRNGKey(42)
    assert np.array_equal(np.asarray(jax.random.split(k, num)),
                          prng.split(prng.PRNGKey(42), num).numpy())


def test_random_bits_vectorised_over_leading_axes():
    keys = torch.stack([prng.PRNGKey(s) for s in (5, 6, 7)])
    got = prng.random_bits(keys, (4,))
    for i, s in enumerate((5, 6, 7)):
        want = jax.random.bits(jax.random.PRNGKey(s), (4,), jnp.uint32)
        assert np.array_equal(np.asarray(want).astype(np.int64),
                              got[i].numpy())


@pytest.mark.parametrize("B,K", [(1, 8), (13, 3), (64, 8)])
def test_block_tiebreak_noise(B, K):
    """The (B, K) tiebreak noise of one block, and the advanced key, for a
    stack of states: equal to the JAX chain of each seed."""
    seeds = (0, 11)
    tcfg = RouterConfig(d=4, max_arms=K)
    jcfg = JConfig(d=4, max_arms=K)
    hp = HyperParams().as_leaves(len(seeds), "cpu")
    key, noise = trouter._tiebreak_noise(
        tcfg, hp, torch.stack([prng.PRNGKey(s) for s in seeds]), B)
    for i, s in enumerate(seeds):
        jkey, jnoise = jrouter._tiebreak_noise(
            jcfg, jcfg.hyper.as_leaves(), jax.random.PRNGKey(s), B)
        assert np.array_equal(np.asarray(jkey), key[i].numpy())
        assert np.array_equal(_bits(jnoise), _bits(noise[i].numpy()))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(-2.0, 3.0), (0.5, 0.7), (-1e-3, 2e-3),
                                   (float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_range_bitwise(seed, lo, hi):
    """``uniform(minval, maxval)``: XLA fuses the scale and shift into one
    rounding; the port matches it bit for bit."""
    want = jax.random.uniform(jax.random.PRNGKey(seed), (3, 64), minval=lo,
                              maxval=hi)
    got = prng.uniform(prng.PRNGKey(seed), (3, 64), minval=lo, maxval=hi)
    assert np.array_equal(_bits(want), got.numpy().view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_matches_jax(seed):
    """Same uniforms bit for bit; the two logs may differ by an ulp."""
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (4, 256)))
    got = prng.gumbel(prng.PRNGKey(seed), (4, 256)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
