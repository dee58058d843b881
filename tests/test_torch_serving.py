"""The port's serving slice against the JAX package's, on the CPU.

Tokenizer, request stream, sampler, telemetry and feedback stores are held
equal call for call; ``ServedModel.generate`` gives JAX's tokens with the
weights carried across; and the slice as a whole, a 3-arm SMOKE
``PortfolioServer`` behind the gateway with JAX's whitener carried
across, routes, generates, judges and paces as JAX's does: equal arms,
generated tokens, rewards and costs, and the pacer's lambda within 1e-4
after every window. On the CPU every kernel wrapper runs its plain
version.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core.costs import ArmPricing as JPricing  # noqa: E402
from repro.core.features import fit_pca_whitener, hash_encode_batch  # noqa: E402
from repro.core.types import HyperParams as JHyper  # noqa: E402
from repro.core.types import RouterConfig as JConfig  # noqa: E402
from repro.data import make_request_stream as jstream  # noqa: E402
from repro.serving import PortfolioServer as JServer  # noqa: E402
from repro.serving import ServedModel as JModel  # noqa: E402
from repro.serving import feedback_store as jfs  # noqa: E402
from repro.serving.sampler import sample_token as jsample  # noqa: E402
from repro.serving.telemetry import Telemetry as JTelemetry  # noqa: E402
from repro.serving.tokenizer import HashTokenizer as JTok  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.costs import ArmPricing  # noqa: E402
from repro_torch.core.features import PCAWhitener  # noqa: E402
from repro_torch.core.types import HyperParams, RouterConfig  # noqa: E402
from repro_torch.data import make_request_stream  # noqa: E402
from repro_torch.serving import PortfolioServer, ServedModel  # noqa: E402
from repro_torch.serving import feedback_store as fs  # noqa: E402
from repro_torch.serving.sampler import sample_token  # noqa: E402
from repro_torch.serving.telemetry import Telemetry  # noqa: E402
from repro_torch.serving.tokenizer import HashTokenizer  # noqa: E402

ARCHS = ("olmo-1b", "mamba2-370m", "deepseek-67b")   # the JAX driver's trio
TIERS = ("budget", "mid", "frontier")
# Per-request prices near the realised cost of a ~16-token request, and a
# budget below the cheapest, so the pacer binds and lambda moves; alpha
# 0.5 and lambda_c 0 spread the first windows over all three arms.
PRICES = (1e-2, 4e-2, 2e-1)
BUDGET = 1.5e-4
HYPER = dict(alpha=0.5, lambda_c=0.0)


def test_tokenizer_and_request_stream_match_jax():
    reqs = make_request_stream(40, seed=3)
    assert reqs == jstream(40, seed=3)
    texts = [r["prompt"] for r in reqs] + ["", "Mixed CASE words  here"]
    for vocab in (256, 512, 50304, 102400):
        tok, jtok = HashTokenizer(vocab), JTok(vocab)
        for t in texts:
            ids = tok.encode(t)
            assert ids.dtype == np.int32
            np.testing.assert_array_equal(ids, jtok.encode(t))
        assert tok.decode([1, 5]) == jtok.decode([1, 5])


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.7, 0), (1.0, 5),
                                               (1.3, 40)])
def test_sample_token_matches_jax(temperature, top_k):
    """Greedy (ties to the first index) and categorical sampling through
    the port's bitwise threefry: equal tokens on every test seed."""
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    for seed in range(12):
        logits = (rng.standard_normal((3, 256)) * 2).astype(np.float32)
        logits[0, [7, 9]] = logits[0].max() + 1.0      # an exact tie
        want = jsample(logits, jax.random.PRNGKey(seed), temperature, top_k)
        got = sample_token(torch.as_tensor(logits), prng.PRNGKey(seed),
                           temperature, top_k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_telemetry_matches_jax():
    tels = (Telemetry(4, window=8), JTelemetry(4, window=8))
    for tel in tels:
        for i in range(12):
            tel.record_route([i % 4, 1, 1], 10.0 + i, 0.1 * i, forced=i % 2,
                             version=i // 3)
            tel.record_admission(i % 5, 3, 8)
            tel.record_feedback_version(i // 4, i // 3)
            tel.record_publish(i // 3 + 1, n_feedback=3, n_blocks=1)
        tel.inc("dropped_feedback", 2)
    (a, b) = tels
    assert a.metrics() == b.metrics()
    assert a.prometheus_text() == b.prometheus_text()
    np.testing.assert_array_equal(a.lam_trajectory(), b.lam_trajectory())


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("kind", ["InMemoryFeedbackStore",
                                  "SQLiteFeedbackStore"])
def test_feedback_stores_match_jax(kind):
    rng = np.random.default_rng(0)
    ctx = rng.standard_normal((6, 5)).astype(np.float32)
    logs = []
    for mod in (fs, jfs):
        clock = _Clock()
        store = getattr(mod, kind)(ttl=10.0, clock=clock)
        log = []
        store.put_block([0, 1, 2], ctx[:3], [2, 0, 1], version=1)
        store.put(3, ctx[3], 1, version=2)
        log.append(len(store))
        log.append(store.pop(1))
        log.append(store.pop_record(3))
        log.append(store.pop_block([0, 7, 0]))
        clock.t += 11.0
        store.put(4, ctx[4], 2, version=3)
        log.append(store.sweep_expired())
        log.append((len(store), store.expired_total))
        clock.t += 5.0
        store.put(5, ctx[5], 0)
        clock.t += 6.0
        log.append(store.pop_block([4, 5, 2]))
        log.append((len(store), store.expired_total))
        logs.append(log)
    assert repr(logs[0]) == repr(logs[1])


@pytest.fixture(scope="module")
def jax_models():
    """JAX's SMOKE arms, random weights from seeds 0..2."""
    return [JModel.init(jconfigs.get_smoke(a),
                        JPricing(TIERS[i], PRICES[i], 20.0), TIERS[i],
                        seed=i) for i, a in enumerate(ARCHS)]


def _carry(jm: JModel) -> ServedModel:
    arch = next(a for a in configs.ARCH_IDS
                if configs.get_smoke(a).name == jm.cfg.name)
    cfg = configs.get_smoke(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jm.cfg)
    params = interop.params_from_numpy(
        jax.tree.map(np.asarray, jm.params), cfg, "cpu")
    pricing = ArmPricing(jm.pricing.name, jm.pricing.price_per_1k,
                         jm.pricing.mean_req_tokens)
    return ServedModel(name=jm.name, cfg=cfg, params=params, pricing=pricing,
                       tier=jm.tier)


@pytest.mark.parametrize("n_prompt", [5, 33, 140])
def test_generate_matches_jax(jax_models, n_prompt):
    """Greedy and sampled generation, with BOS left-padding to the
    32-token bucket and the 128-token cut (140 tokens)."""
    jm = jax_models[2]                                 # GQA
    m = _carry(jm)
    toks = np.random.default_rng(n_prompt).integers(
        2, m.cfg.vocab_size, n_prompt).astype(np.int32)
    np.testing.assert_array_equal(m.generate(toks, 6), jm.generate(toks, 6))
    for seed in (0, 5):
        got = m.generate(toks, 6, key=prng.PRNGKey(seed), temperature=0.9)
        want = jm.generate(toks, 6, key=jax.random.PRNGKey(seed),
                           temperature=0.9)
        np.testing.assert_array_equal(got, want)


def _record_tokens(server):
    """Wrap every arm's ``generate`` to record the tokens it returns."""
    seen = []
    for m in server.models:
        if m is None:
            continue
        inner = m.generate

        def gen(*a, _inner=inner, _name=m.name, **kw):
            out = _inner(*a, **kw)
            seen.append((_name, np.asarray(out).tolist()))
            return out
        m.generate = gen
    return seen


def test_portfolio_server_matches_jax(jax_models):
    """16 requests in windows of 8 with deferred feedback (as
    ``launch/serve.py`` drives the gateway), then the control plane:
    duplicate feedback, a hyper-parameter retune, a budget change and a
    removed arm, then one more window."""
    _serve_against_jax(jax_models)


ZOO_ARCHS = ("zamba2-2.7b", "dbrx-132b", "llama4-maverick-400b-a17b")


def test_zoo_portfolio_server_matches_jax():
    """The same run with a hybrid, an MoE and an interleaved-MoE arm
    (SMOKE, seeds 0..2): every generated token equal to JAX's."""
    _serve_against_jax([
        JModel.init(jconfigs.get_smoke(a), JPricing(TIERS[i], PRICES[i],
                                                    20.0), TIERS[i], seed=i)
        for i, a in enumerate(ZOO_ARCHS)])


def _serve_against_jax(jax_models):
    corpus = [r["prompt"] for r in jstream(120, seed=9)]
    jw = fit_pca_whitener(hash_encode_batch(corpus))
    w = PCAWhitener(*(torch.as_tensor(np.array(getattr(jw, n)))
                      for n in ("mean", "components", "scale")))
    models = [_carry(jm) for jm in jax_models]
    jsrv = JServer(list(jax_models), jw, budget=BUDGET,
                   router_cfg=JConfig(hyper=JHyper(**HYPER)),
                   max_new_tokens=4, seed=0)
    srv = PortfolioServer(models, w, budget=BUDGET,
                          router_cfg=RouterConfig(hyper=HyperParams(**HYPER)),
                          max_new_tokens=4, seed=0, device="cpu")
    jtoks, toks = _record_tokens(jsrv), _record_tokens(srv)
    stream = make_request_stream(24, seed=11)
    arms_seen, lams = set(), []

    def window(reqs):
        arms_seen.clear()
        out = []
        for s in (srv, jsrv):
            res = s.serve_batch(reqs, defer_feedback=True)
            s.feedback_batch([r.request_id for r in res],
                             [r.arm for r in res], [r.reward for r in res],
                             [r.cost for r in res])
            out.append(res)
        got, want = out
        for g, x in zip(got, want):
            assert (g.request_id, g.model, g.arm, g.tokens_out) == (
                x.request_id, x.model, x.arm, x.tokens_out)
            assert g.reward == x.reward and g.cost == x.cost
            assert abs(g.lam - x.lam) <= 1e-4
            arms_seen.add(g.arm)
        lam, jlam = (float(srv.state.pacer.lam[0]),
                     float(jsrv.state.pacer.lam))
        assert abs(lam - jlam) <= 1e-4
        lams.append(lam)
        assert toks == jtoks

    window(stream[:8])
    first = set(arms_seen)
    window(stream[8:16])
    assert first | arms_seen == {0, 1, 2} and lams[-1] > lams[0] > 0
    for s in (srv, jsrv):                              # a replayed reward
        s.feedback(3, reward=1.0, cost=1e-4)
    assert srv.dropped_feedback == jsrv.dropped_feedback == 1
    hp = srv.set_hyperparams(alpha=0.05)
    assert dataclasses.asdict(hp) == pytest.approx(dataclasses.asdict(
        jsrv.set_hyperparams(alpha=0.05)))
    for s in (srv, jsrv):
        s.set_budget(3e-4)
        s.remove_model(2)
    window(stream[16:24])
    assert 2 not in arms_seen
    m, jm = srv.metrics(), jsrv.metrics()
    for k in ("decisions_total", "blocks_total", "publishes_total",
              "feedback_applied_total", "dropped_feedback", "store_depth",
              "snapshot_version", "pull_rate_0", "pull_rate_1",
              "pull_rate_2"):
        assert m[k] == jm[k], k
    assert abs(m["lam"] - jm["lam"]) <= 1e-4


def test_gateway_refuses_what_is_not_ported(tmp_path):
    """An empty portfolio refuses to serve; tenant ids without a table
    raise JAX's ``ValueError``; tenant routing is not ported to the
    kernels (the default ``fused`` backend raises, as JAX's Pallas
    kernels do); ``save`` / ``restore`` round-trip the snapshot."""
    from repro_torch.core import tenancy

    corpus = [r["prompt"] for r in make_request_stream(60, seed=9)]
    from repro_torch.core.features import fit_pca_whitener as fit
    w = fit(hash_encode_batch(corpus), device="cpu")
    srv = PortfolioServer([], w, budget=BUDGET, device="cpu")
    with pytest.raises(RuntimeError):
        srv.serve({"id": 0, "prompt": "hi"})
    gw = srv.gateway
    with pytest.raises(ValueError, match="tenant table"):
        gw.route_block([0], np.zeros((1, 26), np.float32), tenant_ids=[0])
    tenanted = dataclasses.replace(gw.live_state, tenants=tenancy.expand(
        tenancy.make_table([1e-4, 2e-4], device="cpu"), 1))
    gw.apply_control(lambda st: tenanted)
    with pytest.raises(NotImplementedError, match="backend='torch'"):
        gw.route_block([0], np.zeros((1, 26), np.float32), tenant_ids=[1])
    path = str(tmp_path / "snap")
    saved = gw.save(path)
    restored = gw.restore(path, elapsed=3)
    assert restored.version == saved.version == gw.version
    assert restored.step == saved.step + 3
    assert torch.equal(gw.live_state.tenants.budget, tenanted.tenants.budget)
    assert int(gw.live_state.t[0]) == int(saved.state.t[0]) + 3


def test_gateway_admission_window_matches_jax(jax_models):
    """Requests admitted one by one through the micro-batch window: a full
    window routes as one block, ``drain`` routes the rest, and the
    learner tick publishes; arms and versions equal JAX's."""
    corpus = [r["prompt"] for r in jstream(120, seed=9)]
    jw = fit_pca_whitener(hash_encode_batch(corpus))
    w = PCAWhitener(*(torch.as_tensor(np.array(getattr(jw, n)))
                      for n in ("mean", "components", "scale")))
    jsrv = JServer(list(jax_models), jw, budget=BUDGET,
                   router_cfg=JConfig(hyper=JHyper(**HYPER)), seed=1)
    srv = PortfolioServer([_carry(jm) for jm in jax_models], w,
                          budget=BUDGET,
                          router_cfg=RouterConfig(hyper=HyperParams(**HYPER)),
                          seed=1, device="cpu")
    reqs = make_request_stream(5, seed=4)
    routed = []
    for s in (srv, jsrv):
        gw = s.gateway
        gw.batcher.max_batch = 2
        X = np.asarray(s.featurize_batch([r["prompt"] for r in reqs]))
        blocks = [gw.submit(r["id"], x) for r, x in zip(reqs, X)]
        blocks.append(gw.drain())
        blocks = [b for b in blocks if b is not None]
        assert [len(b.request_ids) for b in blocks] == [2, 2, 1]
        ids = [i for b in blocks for i in b.request_ids]
        arms = np.concatenate([b.arms for b in blocks])
        assert gw.enqueue_feedback(ids, arms, np.full(5, 0.9),
                                   np.full(5, 1e-4)) == 5
        snap = gw.learn_tick()
        routed.append((ids, arms.tolist(), [b.version for b in blocks],
                       snap.version, gw.metrics()["decisions_total"]))
    assert routed[0] == routed[1]


def test_serve_driver_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve

    snap = str(tmp_path / "router")
    serve.main(["--device", "cpu", "--requests", "8", "--window", "4",
                "--prom", "--snapshot", snap])
    out = capsys.readouterr().out
    assert "served 8 requests" in out and "traffic:" in out
    assert f"(t=8) -> {snap}" in out
    assert (tmp_path / "router.npz").exists()
    assert (tmp_path / "router.manifest.json").exists()
    assert "arm 1: mamba2-370m" in out
    assert "decisions_total 8" in out.replace("paretobandit_", "")
    with pytest.raises(NotImplementedError):
        serve.main(["--dry-run"])


def test_serve_driver_serves_the_zoo_on_cpu(capsys):
    """``--arch`` takes the hybrid, MoE and VLM ids; whisper-medium's
    prefill needs frames that ``generate`` does not pass, and says so."""
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "8", "--window", "4",
                "--arch", "zamba2-2.7b", "--arch", "phi-3-vision-4.2b",
                "--arch", "llama4-maverick-400b-a17b"])
    out = capsys.readouterr().out
    assert "served 8 requests" in out
    assert "arm 0: zamba2-2.7b" in out and "arm 2: llama4" in out
    cfg = configs.get_smoke("whisper-medium")
    whisper = ServedModel.init(cfg, ArmPricing("w", 1e-3, 20.0), "mid",
                               device="cpu")
    with pytest.raises(ValueError, match="encoder_frames"):
        whisper.generate(np.arange(2, 10, dtype=np.int32), 2)
