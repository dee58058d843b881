"""The port's Mixture-of-Experts layer against the JAX package's, on the
CPU in f32.

JAX's ``init_moe`` weights are carried across and the same numpy-seeded
activations go through both ``apply_moe``s, flat and grouped, with and
without capacity drops, and under a uniform router (every probability
ties). Besides the outputs and the aux loss, each case checks that both
packages route every copy to the same experts and keep and drop the same
copies. Tolerance: 1e-4 rtol and atol, the bar of ``tests/test_models.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(**kw):
    base = dict(name="tiny-moe", arch_type="moe", num_layers=2, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
                num_experts=4, experts_per_token=2, capacity_factor=8.0,
                dtype="float32")
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def _carry(jp):
    return {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}


def _routing(jcfg, cfg, jp, p, x):
    """Both packages' (experts, kept) per routed copy: top-k of the same
    router probabilities, then the per-group arrival positions against
    the group's capacity."""
    N = x.shape[0] * x.shape[1]
    G = cfg.moe_dispatch_groups if N % cfg.moe_dispatch_groups == 0 else 1
    C = moe.capacity(cfg, N // G)
    jprobs = jax.nn.softmax(x.reshape(N, -1) @ jp["router"], -1)
    _, jeids = jax.lax.top_k(jprobs, cfg.experts_per_token)
    jeids = np.asarray(jeids)
    jpos = jax.vmap(lambda e: jmoe._positions_in_expert(e, cfg.num_experts))(
        jnp.asarray(jeids.reshape(G, -1)))
    probs = torch.softmax(torch.as_tensor(x).reshape(N, -1) @ p["router"],
                          -1)
    _, eids = moe._top_k(probs, cfg.experts_per_token)
    pos = moe._positions_in_expert(eids.reshape(G, -1), cfg.num_experts)
    return (jeids, np.asarray(jpos) < C), (eids.numpy(), (pos < C).numpy())


CASES = {
    "flat": dict(),
    "flat-drops": dict(capacity_factor=0.1),
    "flat-cf1.25": dict(capacity_factor=1.25),
    "grouped": dict(moe_dispatch_groups=2),
    "grouped-drops": dict(moe_dispatch_groups=4, capacity_factor=0.1),
    "grouped-cf1.25": dict(moe_dispatch_groups=2, capacity_factor=1.25),
    "top1-8experts": dict(num_experts=8, experts_per_token=1,
                          capacity_factor=0.5, moe_dispatch_groups=2),
}


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_jax(case, uniform):
    """Output and aux loss within 1e-4, the same experts and the same
    kept copies. ``uniform`` zeroes the router: every probability ties,
    and both packages must send every token to the lowest expert indices
    (so the first experts overflow)."""
    jcfg, cfg = _cfgs(**CASES[case])
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    if uniform:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = _carry(jp)
    x = np.random.default_rng(4).standard_normal((2, 48, 32)).astype(
        np.float32)
    jout, jaux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x))
    out, aux = moe.apply_moe(p, cfg, torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    (jeids, jkeep), (eids, keep) = _routing(jcfg, cfg, jp, p, x)
    np.testing.assert_array_equal(eids, jeids)
    np.testing.assert_array_equal(keep, jkeep)
    if uniform:
        K = cfg.experts_per_token
        assert (eids == np.arange(K)).all()
        np.testing.assert_allclose(float(aux), 1.0, **TOL)
    if "drops" in case:
        # Some expert overflows, so a dropped copy shares the last slot of
        # its expert's buffer with the kept copy that filled it.
        assert not keep.all() and keep.any()


def test_grouped_dispatch_differs_from_flat_when_dropping():
    """Per-group capacity: with drops, G = 4 keeps other copies than the
    flat dispatch (both matched against JAX above); without drops they
    agree."""
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (2, 48, 32)).astype(np.float32))
    outs = {}
    for cf in (0.1, 8.0):
        for G in (1, 4):
            jcfg, cfg = _cfgs(capacity_factor=cf, moe_dispatch_groups=G)
            p = _carry(jmoe.init_moe(jax.random.PRNGKey(3), jcfg))
            outs[cf, G] = moe.apply_moe(p, cfg, x)[0]
    assert not torch.allclose(outs[0.1, 1], outs[0.1, 4], **TOL)
    torch.testing.assert_close(outs[8.0, 1], outs[8.0, 4], **TOL)


def test_high_capacity_moe_is_dense_mixture():
    """With capacity above the tokens, the layer is the gate-weighted sum
    of the chosen experts' FFNs (``tests/test_models.py``'s reference)."""
    _, cfg = _cfgs(capacity_factor=50.0)
    p = moe.init_moe(torch.Generator().manual_seed(3), cfg, device="cpu")
    x = torch.randn((2, 16, 32), generator=torch.Generator().manual_seed(4))
    out, aux = moe.apply_moe(p, cfg, x)
    toks = x.reshape(-1, 32)
    gates, eids = torch.topk(torch.softmax(toks @ p["router"], -1), 2)
    gates = gates / gates.sum(-1, keepdim=True)
    ref = torch.zeros_like(toks)
    for e in range(cfg.num_experts):
        h = (torch.nn.functional.silu(toks @ p["w_gate"][e])
             * (toks @ p["w_up"][e]))
        ref += (h @ p["w_down"][e]) * ((eids == e) * gates).sum(-1)[:, None]
    torch.testing.assert_close(out.reshape(-1, 32), ref, rtol=2e-4,
                               atol=2e-4)
    assert torch.isfinite(aux)


def test_top_k_breaks_ties_toward_the_lowest_index():
    """``jax.lax.top_k``'s order among equal values, on rows with ties of
    every kind (all equal, ties at the cut, ties above it)."""
    rows = np.array([[0.25, 0.25, 0.25, 0.25],
                     [0.1, 0.3, 0.3, 0.3],
                     [0.4, 0.1, 0.4, 0.1],
                     [0.2, 0.3, 0.2, 0.3]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        v, i = moe._top_k(torch.as_tensor(rows), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("cf,n", [(1.25, 1), (1.25, 1024), (0.1, 96),
                                  (8.0, 96), (1.25, 40)])
def test_capacity_matches_jax(cf, n):
    jcfg, cfg = _cfgs(capacity_factor=cf)
    assert moe.capacity(cfg, n) == jmoe.capacity(jcfg, n)
    assert moe.capacity(cfg, n) % 8 == 0


def test_init_moe_tree_and_scales():
    """JAX's shapes; not its bits (torch.Generator is not threefry)."""
    jcfg, cfg = _cfgs(d_model=64, d_ff=256)
    cfg = dataclasses.replace(cfg, num_experts=8)
    jcfg = dataclasses.replace(jcfg, num_experts=8)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu",
                     lead=(3,))
    jp = jax.vmap(lambda k: jmoe.init_moe(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), 3))
    assert set(p) == set(jp)
    for k in p:
        assert tuple(p[k].shape) == jp[k].shape
    assert abs(float(p["w_gate"].std()) * 8 - 1) < 0.02
    assert abs(float(p["w_down"].std()) * 16 - 1) < 0.02
