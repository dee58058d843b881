"""The port's ``RouterGateway`` under its concurrency contract: twins of the
JAX package's race and ordering tests (``tests/test_race_stress.py``,
``tests/test_gateway.py``), at their sizes, on the CPU.

The gateway keeps JAX's lock / epoch / publish design: selection and
control ops swap the live state under one lock, the learner folds
feedback off the lock and merges only the learn leaves, retrying when a
control op bumped the epoch in between. These tests hammer it from
router, learner, control and reader threads, and force the learner's
race with a control op deterministically. Where the JAX tests wrap the
gateway's compiled ``_update``, these wrap ``router.update_batch``, the
function the port's learner calls.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import prng, registry, router  # noqa: E402
from repro_torch.core.types import (  # noqa: E402
    LEARN_LEAVES, SELECT_LEAVES, RouterConfig, init_state,
)
from repro_torch.serving.feedback_store import (  # noqa: E402
    InMemoryFeedbackStore, SQLiteFeedbackStore,
)
from repro_torch.serving.gateway import RouterGateway  # noqa: E402

# tests/test_gateway.py's and tests/test_race_stress.py's configurations
CFG = RouterConfig(d=8, max_arms=4, forced_pulls=6)
STRESS_CFG = RouterConfig(d=8, max_arms=4, forced_pulls=0)
STORES = [InMemoryFeedbackStore,
          lambda: SQLiteFeedbackStore(":memory:")]
STORE_IDS = ["inmemory", "sqlite"]

N_ROUTER_THREADS = 3
BLOCKS_PER_THREAD = 12
B = 8


def mk_state(cfg=CFG, prices=(0.1, 1.0, 10.0, 1e9), active=(1, 1, 1, 0),
             budget=1.0, seed=0):
    prices = np.asarray(prices[: cfg.max_arms], np.float32)
    return init_state(cfg, prices, prices, budget,
                      active=np.asarray(active[: cfg.max_arms], bool),
                      key=prng.PRNGKey(seed, device="cpu")[None],
                      device="cpu")


def blocks_of(n_blocks, B, d=CFG.d, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    rid = 0
    for _ in range(n_blocks):
        ids = list(range(rid, rid + B))
        rid += B
        X = rng.standard_normal((B, d)).astype(np.float32)
        r = rng.uniform(0.2, 0.9, B).astype(np.float32)
        c = rng.uniform(1e-5, 1e-3, B).astype(np.float32)
        out.append((ids, X, r, c))
    return out


def _stage(a, dtype=None):
    return torch.as_tensor(np.asarray(a, dtype))[None]


def sync_fold(state, stream, feedback_order):
    """Select every block in order, then fold their feedback in
    ``feedback_order``, through the entry points the gateway calls, with
    its staging (state axis S = 1 in front)."""
    decs = []
    for _ids, X, r, c in stream:
        dec, state = router.select_batch(CFG, state, _stage(X))
        decs.append((dec.arms[0].numpy(), X, r, c))
    for i in feedback_order:
        arms, X, r, c = decs[i]
        state = router.update_batch(
            CFG, state, _stage(arms, np.int32), _stage(X, np.float32),
            _stage(r, np.float32), _stage(c, np.float32))
    return state


def assert_states_equal(a, b, leaves=LEARN_LEAVES + SELECT_LEAVES):
    def flat(x):
        if x is None:
            return []
        if isinstance(x, torch.Tensor):
            return [x]
        return [getattr(x, f.name) for f in dataclasses.fields(x)]

    for name in leaves:
        for x, y in zip(flat(getattr(a, name)), flat(getattr(b, name))):
            np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                          err_msg=name)


def _stress_blocks(thread_idx, rng):
    """Disjoint request-id ranges per thread."""
    base = thread_idx * BLOCKS_PER_THREAD * B
    out = []
    for j in range(BLOCKS_PER_THREAD):
        ids = list(range(base + j * B, base + (j + 1) * B))
        X = rng.standard_normal((B, STRESS_CFG.d)).astype(np.float32)
        r = rng.uniform(0.2, 0.9, B).astype(np.float32)
        c = rng.uniform(1e-5, 1e-3, B).astype(np.float32)
        out.append((ids, X, r, c))
    return out


def _wrap_update(monkeypatch, before=None, after=None):
    """``router.update_batch`` with a hook before or after the real call,
    the first time the learner calls it."""
    real = router.update_batch
    fired = []

    def update(*args, **kwargs):
        first = not fired
        fired.append(True)
        if first and before is not None:
            before()
        out = real(*args, **kwargs)
        if first and after is not None:
            after()
        return out

    monkeypatch.setattr(router, "update_batch", update)
    return fired


class TestGatewayRaceStress:
    def test_no_torn_snapshots_under_contention(self):
        gw = RouterGateway(STRESS_CFG, mk_state(cfg=STRESS_CFG))
        errors = []
        stop = threading.Event()
        seen = []            # (version, step) pairs the reader observed

        def guard(fn):
            def run():
                try:
                    fn()
                except BaseException as e:  # noqa: BLE001 - reraised below
                    errors.append(e)
                    stop.set()
            return run

        def router_role(idx):
            blocks = _stress_blocks(idx, np.random.default_rng(100 + idx))

            def run():
                for ids, X, r, c in blocks:
                    if stop.is_set():
                        return
                    res = gw.route_block(ids, X)
                    gw.enqueue_feedback(ids, res.arms, r, c)
            return run

        def learner_role():
            while not stop.is_set():
                gw.learn_tick()
                time.sleep(0.0005)

        def control_role():
            for a in [0.02, 0.05, 0.1, 0.02, 0.05]:
                if stop.is_set():
                    return
                gw.apply_control(
                    lambda s, a=a: dataclasses.replace(
                        s, hyper=dataclasses.replace(
                            s.hyper,
                            alpha=torch.full_like(s.hyper.alpha, a))))
                time.sleep(0.002)

        def reader_role():
            while not stop.is_set():
                snap = gw.handle.read()
                seen.append((snap.version, snap.step))
                time.sleep(0.0001)  # bound the sample list, stay hot

        threads = [threading.Thread(target=guard(router_role(i)))
                   for i in range(N_ROUTER_THREADS)]
        threads.append(threading.Thread(target=guard(learner_role),
                                        daemon=True))
        threads.append(threading.Thread(target=guard(control_role)))
        threads.append(threading.Thread(target=guard(reader_role),
                                        daemon=True))
        for t in threads:
            t.start()
        # Routers and control run to completion; then quiesce the
        # learner / reader loops.
        for t in threads[:N_ROUTER_THREADS]:
            t.join(timeout=60)
        threads[N_ROUTER_THREADS + 1].join(timeout=60)  # control
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "stress hung"
        assert not errors, f"thread raised: {errors[0]!r}"

        # Final tick applies any feedback still pending at stop time.
        gw.learn_tick()

        # -- no torn version: the reader saw a non-decreasing sequence
        versions = [v for v, _ in seen]
        assert versions == sorted(versions), (
            "snapshot versions regressed under contention")
        by_version = {}
        for v, s in seen:
            by_version.setdefault(v, set()).add(s)
        assert all(len(s) == 1 for s in by_version.values()), (
            "one version published with two different steps (torn)")
        steps = [max(by_version[v]) for v in sorted(by_version)]
        assert steps == sorted(steps)

        # -- host / device clocks agree once quiesced
        routed = N_ROUTER_THREADS * BLOCKS_PER_THREAD * B
        assert gw._t_host == routed
        assert int(gw.live_state.t[0]) == routed

        # -- learned statistics stay finite
        final = gw.handle.read().state
        for leaf in (final.A_inv, final.theta, final.b):
            assert torch.isfinite(leaf).all()

        # -- the learner plane actually ran under contention
        m = gw.telemetry.metrics()
        assert m.get("publishes_total", 0) >= 1
        assert gw.handle.version == int(m["publishes_total"]) + 5, (
            "every publish (learn ticks + 5 control ops) bumps exactly "
            "one version")

    def test_epoch_retry_never_clobbers_control_write(self, monkeypatch):
        """A learn tick racing a control op must retry, not merge a result
        computed against the pre-op state, forced here by a control op
        between the learner's grab and its merge."""
        gw = RouterGateway(STRESS_CFG, mk_state(cfg=STRESS_CFG))
        rng = np.random.default_rng(7)
        ids = list(range(B))
        X = rng.standard_normal((B, STRESS_CFG.d)).astype(np.float32)
        res = gw.route_block(ids, X)
        gw.enqueue_feedback(ids, res.arms,
                            rng.uniform(0.2, 0.9, B).astype(np.float32),
                            rng.uniform(1e-5, 1e-3, B).astype(np.float32))
        fired = _wrap_update(monkeypatch, after=lambda: gw.apply_control(
            lambda s: dataclasses.replace(s, pacer=dataclasses.replace(
                s.pacer, budget=torch.full_like(s.pacer.budget, 0.25)))))
        snap = gw.learn_tick()
        assert fired
        assert snap is not None
        # ``pacer`` is a learn leaf: a merge of the pre-op result would
        # have clobbered the control write, so the budget that survives
        # shows the retry.
        assert gw.telemetry.metrics()["learn_retries_total"] >= 1
        assert float(gw.live_state.pacer.budget[0]) == pytest.approx(0.25)


class TestFeedbackOrderingAcrossTicks:
    @pytest.mark.parametrize("mk_store", STORES, ids=STORE_IDS)
    def test_late_and_out_of_order_feedback(self, mk_store):
        """Block A routed under v0, its feedback arriving after block B's
        publish, applies deterministically against current statistics:
        equal to the fold select(A), select(B), update(B), update(A)."""
        stream = blocks_of(2, B=4, seed=5)
        ref_state = sync_fold(mk_state(), stream, feedback_order=[1, 0])
        gw = RouterGateway(CFG, mk_state(), store=mk_store())
        (ids_a, X_a, r_a, c_a), (ids_b, X_b, r_b, c_b) = stream
        res_a = gw.route_block(ids_a, X_a)
        assert res_a.version == 0
        res_b = gw.route_block(ids_b, X_b)
        gw.enqueue_feedback(ids_b, res_b.arms, r_b, c_b)
        gw.learn_tick()                       # publish v1 before A's rows
        assert gw.version == 1
        gw.enqueue_feedback(ids_a, res_a.arms, r_a, c_a)   # late: v0 -> v1
        gw.learn_tick()
        assert_states_equal(gw.live_state, ref_state)
        assert gw.telemetry.counter("feedback_late_total") == len(ids_a)
        assert gw.metrics()["feedback_version_lag_max"] >= 1.0

    @pytest.mark.parametrize("mk_store", STORES, ids=STORE_IDS)
    def test_duplicate_feedback_across_ticks_drops(self, mk_store):
        (ids, X, r, c), = blocks_of(1, B=4, seed=9)
        gw = RouterGateway(CFG, mk_state(), store=mk_store())
        res = gw.route_block(ids, X)
        assert gw.enqueue_feedback(ids, res.arms, r, c) == 4
        gw.learn_tick()
        before = gw.live_state
        # redelivery after the publish: the store's entries are consumed
        assert gw.enqueue_feedback(ids, res.arms, r, c) == 0
        assert gw.learn_tick() is None        # nothing pending, no publish
        assert gw.telemetry.counter("dropped_feedback") == 4
        assert_states_equal(gw.live_state, before)
        assert gw.version == 1


class TestHotSwapAtomicity:
    def test_swap_racing_selection_never_routes_retired(self):
        """add / remove hammering slot 2 while another thread routes:
        every decision lands on a slot that was active in some published
        state; slot 3 is never active, so it is never routed."""
        gw = RouterGateway(CFG, mk_state())   # slots 0..2 active, 3 never
        stop = threading.Event()
        routed, errors = [], []

        def pound():
            rng = np.random.default_rng(0)
            rid = 0
            try:
                while not stop.is_set():
                    ids = list(range(rid, rid + 8))
                    rid += 8
                    X = rng.standard_normal((8, CFG.d)).astype(np.float32)
                    routed.append(gw.route_block(ids, X).arms)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        th = threading.Thread(target=pound)
        th.start()
        for _ in range(60):
            gw.apply_control(lambda s: registry.delete_arm(CFG, s, 2))
            gw.apply_control(lambda s: registry.add_arm(
                CFG, s, 2, 10.0, 10.0, forced_exploration=False))
        stop.set()
        th.join(timeout=30)
        assert not th.is_alive()
        assert not errors, errors
        assert len(routed) > 0
        all_arms = np.concatenate(routed)
        assert all_arms.min() >= 0 and all_arms.max() <= 2  # never slot 3

    def test_learner_retries_after_control_op(self, monkeypatch):
        """A control op landing between the learner's state grab and its
        merge is not clobbered: the tick discards and retries."""
        (ids, X, r, c), = blocks_of(1, B=4, seed=21)
        gw = RouterGateway(CFG, mk_state())
        res = gw.route_block(ids, X)
        gw.enqueue_feedback(ids, res.arms, r, c)
        _wrap_update(monkeypatch, before=lambda: gw.apply_control(
            lambda s: registry.set_price(CFG, s, 0, 0.2, 0.2)))
        snap = gw.learn_tick()
        monkeypatch.undo()
        assert snap is not None
        assert gw.telemetry.counter("learn_retries_total") == 1
        # the control write survived the publish...
        assert float(gw.live_state.price[0, 0]) == np.float32(0.2)
        # ...and the feedback was applied (stats moved off the prior)
        assert not torch.allclose(gw.live_state.b,
                                  torch.zeros_like(gw.live_state.b))

    def test_forced_exploration_counters_survive_publish(self):
        gw = RouterGateway(CFG, mk_state())
        gw.apply_control(lambda s: registry.add_arm(
            CFG, s, 3, 0.5, 0.5, forced_exploration=True))
        assert int(gw.live_state.force_left[0]) == CFG.forced_pulls  # 6
        (ids, X, r, c), = blocks_of(1, B=4, seed=2)
        res = gw.route_block(ids, X)
        np.testing.assert_array_equal(res.arms, [3, 3, 3, 3])
        gw.enqueue_feedback(ids, res.arms, r, c)
        gw.learn_tick()                        # the publish must not clobber
        assert int(gw.live_state.force_left[0]) == CFG.forced_pulls - 4
        res2 = gw.route_block([100, 101], np.asarray(X[:2]))
        np.testing.assert_array_equal(res2.arms, [3, 3])  # still forced
        assert int(gw.live_state.force_left[0]) == 0
