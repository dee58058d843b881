"""The port's training path against the JAX package's, on the CPU in f32.

JAX's ``init_model`` trees are carried across (``interop``) and the same
numpy-seeded batches go through both packages: ``forward_train``'s loss
and every gradient leaf against ``jax.value_and_grad(forward_train)`` for
each family at SMOKE (the MoE aux loss and capacity drops, the VLM's
label mask, whisper's frames), three ``make_train_step`` steps against
JAX's jitted step, the synthetic LM stream bit for bit, and a JAX
``TrainState`` checkpoint in the port and back. Tolerances: the loss
within 1e-5 relative, each gradient leaf's max |diff| within 1e-4
(``backend.EQUIV_TOL``) of that leaf's max |g|; a train step's loss and
grad norm within 1e-4 relative. Both packages train on ``chunked``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.data import SyntheticLMDataset as JSyntheticLMDataset  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import train_state_init as jtrain_state_init  # noqa: E402
from repro_torch import configs, interop, tree  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import chunked_cross_entropy, forward_train  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.training import (  # noqa: E402
    load_checkpoint, make_train_step, save_checkpoint, train_state_init,
)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_RTOL = 1e-4

# name -> JAX config: one SMOKE config per family, and dbrx with a
# capacity that drops routed copies
FAMILIES = {
    "dense": jconfigs.get_smoke("olmo-1b"),
    "ssm": jconfigs.get_smoke("mamba2-370m"),
    "hybrid": jconfigs.get_smoke("zamba2-2.7b"),
    "moe": jconfigs.get_smoke("dbrx-132b"),
    "moe-drops": dataclasses.replace(jconfigs.get_smoke("dbrx-132b"),
                                     capacity_factor=0.5),
    "moe-every2": jconfigs.get_smoke("llama4-maverick-400b-a17b"),
    "vlm": jconfigs.get_smoke("phi-3-vision-4.2b"),
    "audio": jconfigs.get_smoke("whisper-medium"),
}


def _batch(jcfg, seed=0, B=2, S=32):
    """numpy tokens / labels (next tokens), and the VLM's patch
    embeddings or the encoder's frames."""
    rng = np.random.default_rng(seed)
    b = {}
    if jcfg.frontend_tokens > 0 and not jcfg.is_encdec:
        b["frontend"] = rng.standard_normal(
            (B, jcfg.frontend_tokens, jcfg.frontend_dim)).astype(np.float32)
    if jcfg.is_encdec:
        b["encoder_frames"] = rng.standard_normal(
            (B, jcfg.encoder_seq, jcfg.frontend_dim)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    b["tokens"], b["labels"] = toks[:, :-1], toks[:, 1:]
    return b


def _pair(jcfg, seed=0):
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jt.init_model(jax.random.PRNGKey(seed), jcfg)
    return cfg, jp, interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                              cfg, "cpu")


def _port_grads(params, cfg, batch, **kw):
    params = tree.map_tree(lambda p: p.detach().requires_grad_(), params)
    loss, m = forward_train(params, cfg, batch, **kw)
    grads = torch.autograd.grad(loss, list(tree.leaves(params)),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), m, grads


def _t(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _assert_grads_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        bar = GRAD_TOL * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= bar


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_train_loss_and_grads_match_jax(family):
    jcfg = FAMILIES[family]
    cfg, jp, p = _pair(jcfg)
    b = _batch(jcfg)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda pp, bb: jt.forward_train(pp, jcfg, bb), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, m, grads = _port_grads(p, cfg, _t(b))
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert float(m["tokens"]) == float(jm["tokens"])   # the label mask
    assert abs(float(m["aux"].detach()) - float(jm["aux"])) <= 1e-5
    _assert_grads_close(grads, jax.tree.leaves(jg))
    if family == "vlm":
        assert float(m["tokens"]) == b["labels"].size


@pytest.mark.parametrize("family", ["dense", "hybrid", "moe-every2",
                                    "audio"])
def test_remat_is_bit_for_bit(family):
    """Per-layer checkpointing recomputes the same operations: loss and
    every gradient leaf equal to the run without it."""
    jcfg = FAMILIES[family]
    cfg, _, p = _pair(jcfg)
    b = _t(_batch(jcfg, seed=3))
    l0, _, g0 = _port_grads(p, cfg, b, remat=False)
    l1, _, g1 = _port_grads(p, cfg, b, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(x, y) for x, y in zip(g0, g1))


@pytest.mark.parametrize("block", [512, 8])
def test_chunked_cross_entropy_matches_full_logits(block):
    """Blocks of 8 of S = 32 (four checkpointed blocks) and one block:
    (nll sum, mask sum) and the gradients against one full-logit CE."""
    g = torch.Generator().manual_seed(0)
    B, S, D, V = 2, 32, 16, 40
    h = torch.randn(B, S, D, generator=g, requires_grad=True)
    w = torch.randn(D, V, generator=g, requires_grad=True)
    labels = torch.randint(0, V, (B, S), generator=g)
    mask = (torch.rand(B, S, generator=g) > 0.3).float()
    nll, m = chunked_cross_entropy(h, w, labels, mask, block=block)
    logits = h @ w
    want = (torch.nn.functional.cross_entropy(
        logits.reshape(-1, V), labels.reshape(-1), reduction="none")
        * mask.reshape(-1)).sum()
    torch.testing.assert_close(nll, want, rtol=1e-6, atol=1e-5)
    assert float(m) == float(mask.sum())
    got = torch.autograd.grad(nll, (h, w))
    ref = torch.autograd.grad(want, (h, w))
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)
    jn, jm = jt.chunked_cross_entropy(
        jnp.asarray(h.detach().numpy()), jnp.asarray(w.detach().numpy()),
        jnp.asarray(labels.numpy()), jnp.asarray(mask.numpy()), block=block)
    assert abs(float(nll.detach()) - float(jn)) <= 1e-5 * abs(float(jn))
    assert float(m) == float(jm)
    with pytest.raises(AssertionError):
        chunked_cross_entropy(h[:, :30], w, labels[:, :30], mask[:, :30],
                              block=8)


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m",
                                  "llama4-maverick-400b-a17b"])
def test_train_steps_match_jax(arch):
    """Three steps of each package's make_train_step (remat on, as both
    default) on the same batches of the synthetic stream: loss, grad norm
    and lr per step."""
    jcfg = jconfigs.get_smoke(arch)
    cfg, jp, p = _pair(jcfg)
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jmake_train_step(jcfg, **kw))
    step = make_train_step(cfg, **kw)
    jstate, state = jtrain_state_init(jp), train_state_init(p)
    ds = iter(SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32,
                                 batch_size=2))
    for i, b in zip(range(3), ds):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, _t(b))
        for k in ("loss", "grad_norm", "lr"):
            want = float(jm[k])
            assert abs(float(m[k]) - want) <= STEP_RTOL * abs(want), (i, k)
        assert all(v.device.type == "cpu" and isinstance(v, torch.Tensor)
                   for v in m.values())
    assert int(state.opt.step) == int(jstate.opt.step) == 3


def test_kernel_route_refused_under_autograd():
    """The kernels have no backward: impl="cuda" with parameters that
    require grad raises before anything runs; without grads it is the
    forward of the served path. None means chunked."""
    jcfg = FAMILIES["hybrid"]
    cfg, _, p = _pair(jcfg)
    b = _t(_batch(jcfg))
    before = (flash_ops.LAUNCHES[0], ssd_ops.LAUNCHES[0])
    grad_p = tree.map_tree(lambda t: t.detach().requires_grad_(), p)
    with pytest.raises(NotImplementedError, match="no backward"):
        forward_train(grad_p, cfg, b, impl="cuda")
    with pytest.raises(NotImplementedError, match="chunked"):
        make_train_step(cfg, impl="cuda")(train_state_init(p), b)
    assert (flash_ops.LAUNCHES[0], ssd_ops.LAUNCHES[0]) == before
    chunked, _ = forward_train(p, cfg, b, impl="chunked")
    default, _ = forward_train(p, cfg, b, impl=None)
    assert torch.equal(chunked, default)
    served, _ = forward_train(p, cfg, b, impl="cuda")   # no grads: allowed
    torch.testing.assert_close(served, chunked, rtol=1e-4, atol=1e-4)


def test_encoder_decoder_needs_frames():
    jcfg = FAMILIES["audio"]
    cfg, _, p = _pair(jcfg)
    b = _t(_batch(jcfg))
    del b["encoder_frames"]
    with pytest.raises(ValueError, match="encoder_frames"):
        forward_train(p, cfg, b)


@pytest.mark.parametrize("vocab,seq,batch,seed", [(64, 16, 2, 0),
                                                  (50304, 128, 8, 0),
                                                  (256, 32, 4, 7)])
def test_synthetic_lm_dataset_matches_jax(vocab, seq, batch, seed):
    kw = dict(vocab_size=vocab, seq_len=seq, batch_size=batch, seed=seed)
    for a, b, _ in zip(iter(SyntheticLMDataset(**kw)),
                       iter(JSyntheticLMDataset(**kw)), range(3)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["tokens"][:, 1:],
                                      a["labels"][:, :-1])


def test_lm_learnable():
    """A tiny model's loss should drop markedly on the Markov stream (the
    twin of tests/test_substrates.py's)."""
    cfg = ModelConfig(name="t", arch_type="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
                      vocab_size=128, dtype="float32")
    ds = iter(SyntheticLMDataset(vocab_size=128, seq_len=32, batch_size=8))
    state = train_state_init(init_model(cfg, seed=0, device="cpu"))
    step = make_train_step(cfg, remat=False, peak_lr=1e-2, warmup_steps=5,
                           total_steps=60)
    losses = []
    for _, batch in zip(range(60), ds):
        state, m = step(state, _t(batch))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


def test_jax_train_state_checkpoint_round_trip(tmp_path):
    """A JAX TrainState saved by the JAX package loads into the port's
    (keys params/..., opt/step, opt/mu/..., opt/nu/...), and the port's
    save loads back into JAX's, every leaf equal."""
    jcfg = FAMILIES["moe-every2"]
    cfg, jp, p = _pair(jcfg)
    b = _batch(jcfg)
    jstate, _ = jax.jit(jmake_train_step(jcfg, total_steps=10))(
        jtrain_state_init(jp), {k: jnp.asarray(v) for k, v in b.items()})
    path = os.path.join(tmp_path, "jax.npz")
    jckpt.save_checkpoint(path, jstate, step=1)
    keys = np.load(path).files
    assert "opt/step" in keys and "params/embed" in keys
    assert "opt/mu/blocks/moe/w_up" in keys and "opt/nu/embed" in keys
    template = train_state_init(tree.map_tree(torch.zeros_like, p))
    got = load_checkpoint(path, template)
    want = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          cfg, "cpu")
    assert int(got.opt.step) == 1 and got.opt.step.dtype == torch.int32
    for a, w in zip(tree.leaves({"p": got.params, "m": got.opt.mu,
                                 "v": got.opt.nu}),
                    tree.leaves({"p": want.params, "m": want.opt.mu,
                                 "v": want.opt.nu})):
        assert torch.equal(a, w)
    back = os.path.join(tmp_path, "port.npz")
    save_checkpoint(back, got, step=1)
    restored = jckpt.load_checkpoint(
        back, jax.tree.map(jnp.zeros_like, jstate))
    for a, w in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
        assert np.array_equal(np.asarray(a), np.asarray(w))
    # interop's numpy form is JAX's structure
    d = interop.train_state_to_numpy(got)
    for part, want in ((d["params"], jstate.params),
                       (d["opt"], dataclasses.asdict(jstate.opt))):
        for a, w in zip(jax.tree.leaves(part), jax.tree.leaves(want)):
            assert np.array_equal(a, np.asarray(w))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_smoke_train_step(arch):
    """Every architecture's SMOKE config: a finite loss in (1, 12) and one
    step that moves the parameters (tests/test_arch_smoke.py's twins)."""
    cfg = configs.get_smoke(arch)
    b = _t(_batch(cfg, seed=1))
    state = train_state_init(init_model(cfg, seed=0, device="cpu"))
    loss, _ = forward_train(state.params, cfg, b)
    assert loss.shape == () and 1.0 < float(loss) < 12.0
    new, m = make_train_step(cfg, remat=False, total_steps=10)(state, b)
    assert bool(torch.isfinite(m["loss"])) and bool(
        torch.isfinite(m["grad_norm"]))
    assert max(float((a - c).abs().max()) for a, c in zip(
        tree.leaves(state.params), tree.leaves(new.params))) > 0


def test_launch_train_main_on_cpu(tmp_path, capsys, monkeypatch):
    path = os.path.join(tmp_path, "ckpt.npz")
    state = launch_train.main(["--arch", "olmo-1b", "--steps", "3",
                               "--device", "cpu", "--ckpt", path])
    out = capsys.readouterr().out
    assert "training olmo-1b-smoke" in out and "step    2 loss" in out
    assert int(state.opt.step) == 3
    back = load_checkpoint(path, train_state_init(
        tree.map_tree(torch.zeros_like, state.params)))
    for a, w in zip(tree.leaves({"p": back.params, "m": back.opt.mu}),
                    tree.leaves({"p": state.params, "m": state.opt.mu})):
        assert torch.equal(a, w)
    assert int(back.opt.step) == 3
    # --dry-run runs the dry run at train_4k, as the JAX driver does
    # (tests/test_torch_dryrun.py runs it for real).
    import subprocess
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd: calls.append(cmd[1:]) or 0)
    with pytest.raises(SystemExit) as ex:
        launch_train.main(["--arch", "olmo-1b", "--dry-run"])
    assert ex.value.code == 0
    assert calls == [["-m", "repro_torch.launch.dryrun", "--arch", "olmo-1b",
                      "--shape", "train_4k"]]
