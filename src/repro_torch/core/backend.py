"""Batched routing backends of the data plane.

``select_batch`` scores an (S, B, d) block of request contexts against
every arm through a backend, chosen by ``RouterConfig.backend``:

  * ``torch`` — the einsum oracle (``linucb.ucb_scores_batch``); the
                numerical reference, chosen only explicitly.
  * ``score`` — the ``linucb_score`` CUDA kernel: grid (row tiles, S),
                one arm's (d x d) inverse staged in shared memory at a
                time.
  * ``fused`` — the ``linucb_step`` CUDA kernel (the default): score ->
                hard-ceiling select -> chosen-arm decay +
                Sherman-Morrison + pacer fold -> theta refresh, with the
                statistics updated in device memory. ``router.step_batch``
                dispatches to its ``step_block``; select-only serving
                uses the inherited scoring kernel.

On CPU tensors the kernel wrappers run their plain versions, which is
how the CPU tests reach the ``score`` and ``fused`` code paths.

Numerical-equivalence contract: every backend agrees with the torch
oracle to ``EQUIV_TOL`` max abs diff on scores, and the fused backend on
the post-block statistics as well.
"""
from __future__ import annotations

import torch

from repro_torch.core import linucb
from repro_torch.core import pacer as pacer_lib
from repro_torch.core.types import HyperParams, RouterConfig, RouterState
from repro_torch.kernels.linucb_score.ops import linucb_score
from repro_torch.kernels.linucb_step.ops import linucb_step

Tensor = torch.Tensor

# Max abs score divergence a kernel is allowed against the torch oracle.
EQUIV_TOL = 1e-4


class TorchBackend:
    name = "torch"

    def score(self, cfg: RouterConfig, hp: HyperParams, theta, A_inv,
              c_tilde, X, dt, lam) -> Tensor:
        return linucb.ucb_scores_batch(
            cfg, hp, theta, A_inv, c_tilde, X, dt, lam)


class ScoreBackend:
    name = "score"

    def score(self, cfg: RouterConfig, hp: HyperParams, theta, A_inv,
              c_tilde, X, dt, lam) -> Tensor:
        pen = (hp.lambda_c + lam)[:, None] * c_tilde
        infl = linucb.staleness_inflation(cfg, hp, dt)
        return linucb_score(X, theta, A_inv, pen, infl, hp.alpha)


class FusedBackend(ScoreBackend):
    """The step kernel backend: ``score`` is inherited (select-only
    serving still runs the scoring kernel); ``router.step_batch`` sees
    ``fused_step`` and routes the whole block through ``step_block``."""

    name = "fused"
    fused_step = True

    def step_block(
        self,
        cfg: RouterConfig,
        state: RouterState,
        X: Tensor,        # (S, B, d) contexts
        rewards: Tensor,  # (S, B, K) environment reward matrix
        costs: Tensor,    # (S, B, K) environment cost matrix
        noise: Tensor,    # (S, B, K) pre-drawn tiebreak noise
        farm: Tensor,     # (S,) i32 clipped forced-exploration target
        forced: Tensor,   # (S, B) bool forced-override mask
    ):
        """One fused block step on the state's leaves: the block-entry
        quantities of ``select_batch`` (hard-ceiling mask, staleness,
        Eq. 2 penalty / inflation) plus the kernel. Returns
        (A', A_inv', b', theta', last_upd', arms, r, c, lam', c_ema'),
        the pacer outputs ungated (the router applies ``enabled``)."""
        hp = state.hyper
        p = state.pacer
        cand = pacer_lib.hard_ceiling_mask(p, state.price, state.active)
        dt = state.t[:, None] - torch.maximum(state.last_upd,
                                              state.last_play)
        pen = (hp.lambda_c + p.lam)[:, None] * state.c_tilde
        infl = linucb.staleness_inflation(cfg, hp, dt)
        t_sel = state.t + X.shape[1]
        return linucb_step(
            state.A, state.A_inv, state.b, state.theta, state.last_upd,
            X, rewards, costs, noise, cand, pen, infl,
            hp.alpha, hp.gamma, hp.eta, hp.alpha_ema, hp.lambda_bar,
            p.lam, p.c_ema, p.budget, t_sel, farm, forced,
            dt_max=cfg.dt_max,
        )


_BACKENDS = {
    "torch": TorchBackend(),
    "score": ScoreBackend(),
    "fused": FusedBackend(),
}


def get_backend(name: str):
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown routing backend {name!r}; have "
                       f"{sorted(_BACKENDS)}") from None


def score_divergence(cfg: RouterConfig, hp: HyperParams, theta, A_inv,
                     c_tilde, X, dt, lam) -> float:
    """Max abs score diff between the scoring kernel and the oracle on one
    block (the equivalence contract, for benchmarks and monitoring)."""
    a = get_backend("torch").score(cfg, hp, theta, A_inv, c_tilde, X, dt, lam)
    b = get_backend("score").score(cfg, hp, theta, A_inv, c_tilde, X, dt, lam)
    return float((a - b).abs().max())
