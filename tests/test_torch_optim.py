"""The port's optimizer and schedule against the JAX package's, on the CPU.

Twins of ``tests/test_substrates.py``'s AdamW and schedule tests, then
the same numpy-seeded parameters and gradients through both packages'
``adamw_update`` for three steps, f32 and bf16 trees, with and without
clipping. The update is the same f32 arithmetic in the same order, so
the moments and parameters agree bit for bit, except after a step whose
global norm, a sum each library orders its own way, differs by one ulp.
``warmup_cosine`` holds to 1e-7, the cosine being each library's own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import warmup_cosine as jwarmup  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update, warmup_cosine  # noqa: E402
from repro_torch.optim.adamw import global_norm  # noqa: E402


class TestAdamW:
    def test_converges_on_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        opt = adamw_init(params)
        for _ in range(300):
            g = {"w": 2 * params["w"]}
            params, opt, _ = adamw_update(params, g, opt, torch.tensor(0.05),
                                          weight_decay=0.0)
        assert float(params["w"].abs().max()) < 0.05

    def test_grad_clipping(self):
        params = {"w": torch.zeros(3)}
        opt = adamw_init(params)
        g = {"w": torch.tensor([1e6, 1e6, 1e6])}
        _, _, m = adamw_update(params, g, opt, torch.tensor(0.1),
                               clip_norm=1.0)
        assert float(m["grad_norm"]) > 1e5  # reported pre-clip

    def test_moments_fp32(self):
        params = {"w": torch.zeros(3, dtype=torch.bfloat16)}
        opt = adamw_init(params)
        assert opt.mu["w"].dtype == torch.float32
        assert opt.step.dtype == torch.int32 and opt.step.shape == ()
        new, opt, _ = adamw_update(params, {"w": torch.ones(
            3, dtype=torch.bfloat16)}, opt, torch.tensor(0.1))
        assert new["w"].dtype == torch.bfloat16
        assert opt.nu["w"].dtype == torch.float32 and int(opt.step) == 1

    def test_schedule_shape(self):
        lrs = [float(warmup_cosine(s, peak_lr=1.0, warmup_steps=10,
                                   total_steps=100)) for s in range(100)]
        assert lrs[0] < lrs[5] < lrs[10]          # warmup rises
        assert abs(lrs[10] - 1.0) < 0.01          # hits peak
        assert lrs[50] > lrs[99]                  # cosine decays
        assert lrs[99] >= 0.1 - 1e-6              # min ratio


def _tree(rng, scale=1.0):
    """A nested tree of numpy f32 leaves (an empty subtree included, as
    OLMo's parameter-free norms give)."""
    return {"embed": rng.standard_normal((8, 4)).astype(np.float32) * scale,
            "final_norm": {},
            "blocks": {"w": rng.standard_normal((2, 4, 6)).astype(np.float32)
                       * scale,
                       "b": rng.standard_normal((2, 6)).astype(np.float32)
                       * scale}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-2, 10.0], ids=["unclipped",
                                                          "clipped"])
def test_adamw_three_steps_match_jax(dtype, grad_scale):
    """Bit for bit while the two global norms are equal. XLA and torch
    sum each leaf's squares in their own order, so a norm may differ by
    one ulp (here in the clipped f32 case's second step); from that step
    on, each leaf is held to 4 ulps of its largest element."""
    rng = np.random.default_rng(0)
    p_np = _tree(rng)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    tp = tree.map_tree(lambda a: torch.as_tensor(a).to(tdt), p_np)
    jopt, topt = jadamw.adamw_init(jp), adamw_init(tp)
    exact = True
    for step in range(3):
        g_np = _tree(rng, grad_scale)
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g_np)
        tg = tree.map_tree(lambda a: torch.as_tensor(a).to(tdt), g_np)
        lr = 1e-2 * (step + 1)
        jp, jopt, jm = jadamw.adamw_update(jp, jg, jopt, jnp.float32(lr))
        tp, topt, tm = adamw_update(tp, tg, topt,
                                    torch.tensor(lr, dtype=torch.float32))
        gn, tgn = float(jm["grad_norm"]), float(tm["grad_norm"])
        assert abs(tgn - gn) <= np.spacing(np.float32(gn)), step
        exact = exact and tgn == gn
        assert int(topt.step) == int(jopt.step) == step + 1
        for name, j, t in (("params", jp, tp), ("mu", jopt.mu, topt.mu),
                           ("nu", jopt.nu, topt.nu)):
            for a, b in zip(jax.tree.leaves(j), tree.leaves(t)):
                assert b.dtype == (tdt if name == "params"
                                   else torch.float32)
                a32, b32 = np.asarray(a, np.float32), b.float().numpy()
                if exact:
                    assert np.array_equal(a32, b32), (step, name)
                else:
                    bar = 4 * np.spacing(np.abs(a32).max())
                    assert np.abs(a32 - b32).max() <= bar, (step, name)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    g = _tree(rng, 3.0)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(global_norm(tree.map_tree(torch.as_tensor, g)))
    assert abs(got - want) <= np.spacing(np.float32(want))
    bf = tree.map_tree(lambda a: torch.as_tensor(a).bfloat16(), g)
    assert global_norm(bf).dtype == torch.float32


def test_warmup_cosine_matches_jax():
    kw = dict(peak_lr=3e-3, warmup_steps=10, total_steps=100)
    got = warmup_cosine(torch.arange(121), **kw)
    want = np.asarray(jwarmup(jnp.arange(121), **kw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    for s in (0, 5, 10, 57, 100, 120):     # scalar steps, as the step calls
        assert abs(float(warmup_cosine(s, **kw)) - float(want[s])) <= 1e-7
