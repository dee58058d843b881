"""Scenario Monte Carlo over randomized timelines (DESIGN.md §12).

The paper's §4.2-4.5 adaptation numbers are single-timeline point
estimates: one hand-picked step for the repricing, one for the
regression. Randomizing *when* a shift arrives gives bands instead: with
the masked timeline runner (``sweep.run_scenario_grid(timelines=...)``)
thousands of sampled timelines of one spec run as one state stack
through one cached runner. This module is the statistical layer on top:

  * ``sample_timelines`` — draw N valid ``scenario.Timeline``s with
    uniform-random event steps (and optionally random effective
    horizons), aligned to the batched plane's block size, by rejection
    against the retimed spec's own validation;
  * ``adaptation_lag`` — steps after an event until the seed-averaged
    rolling reward recovers;
  * ``run_monte_carlo`` — run them all as one grid and reduce to
    per-timeline metrics (adaptation lag per event, quality lift, budget
    compliance);
  * ``MonteCarloResult`` — percentile bands over those metrics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import scenario, sweep
from repro_torch.core.scenario import ScenarioSpec, Timeline
from repro_torch.core.types import RouterConfig


def _align_down(t: int, align: int) -> int:
    return max(align, (int(t) // align) * align)


def sample_timelines(
    spec: ScenarioSpec,
    n: int,
    seed: int = 0,
    *,
    t_lo: Optional[Sequence[int]] = None,
    t_hi: Optional[Sequence[int]] = None,
    align: int = 1,
    horizons: Optional[Tuple[int, int]] = None,
    max_tries: int = 200,
) -> Tuple[Timeline, ...]:
    """Draw ``n`` valid Timelines for ``spec`` with uniform-random event
    steps.

    Per event ``i`` the step is uniform on ``[t_lo[i], t_hi[i])``
    (defaults: the spec's full ``[0, horizon)`` window), rounded down to
    a multiple of ``align`` (pass the batched plane's block size so the
    draws satisfy ``validate_timeline_alignment``). ``horizons=(lo, hi)``
    additionally draws a random effective horizon on ``[lo, hi]``
    (align-rounded); events must land before it. Draws that violate the
    spec's own validity rules are redrawn — up to ``max_tries`` per
    timeline, then ValueError.
    """
    E = len(spec.events)
    lo = [0] * E if t_lo is None else [int(t) for t in t_lo]
    hi = [spec.horizon] * E if t_hi is None else [int(t) for t in t_hi]
    if len(lo) != E or len(hi) != E:
        raise ValueError(f"t_lo/t_hi must give one bound per event ({E})")
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        for attempt in range(max_tries):
            h = None
            if horizons is not None:
                h = _align_down(int(rng.integers(horizons[0],
                                                 horizons[1] + 1)), align)
            cap = spec.horizon if h is None else h
            ts = tuple(
                (int(rng.integers(lo[i], hi[i])) // align) * align
                for i in range(E))
            if any(t >= cap for t in ts):
                continue
            tl = Timeline(ts, horizon=h)
            try:
                scenario.retime(spec, tl)
            except (ValueError, AssertionError):
                continue
            out.append(tl)
            break
        else:
            raise ValueError(
                f"could not draw a valid timeline for {spec} within "
                f"{max_tries} tries (bounds lo={lo}, hi={hi}, "
                f"align={align}, horizons={horizons})")
    return tuple(out)


def adaptation_lag(res, boundary: int, window: int = 32,
                   frac: float = 0.95) -> float:
    """Steps after ``boundary`` until the seed-averaged rolling mean
    reward (window ``window``) of ``res`` (an ``evaluate.RunResult``)
    first reaches ``frac`` of the post-event steady state (the run's
    final-window mean). Returns the full remaining span when the router
    never recovers."""
    r = np.asarray(res.rewards, np.float64).mean(axis=0)
    post = r[int(boundary):]
    if post.shape[0] <= window:
        return float(post.shape[0])
    steady = post[-window:].mean()
    roll = np.convolve(post, np.ones(window) / window, mode="valid")
    hit = np.nonzero(roll >= frac * steady)[0]
    return float(hit[0]) if hit.size else float(post.shape[0])


@dataclasses.dataclass(frozen=True)
class MonteCarloResult:
    """Per-timeline metrics plus the grid they came from."""
    grid: "sweep.GridResult"
    timelines: Tuple[Timeline, ...]
    budget: float
    lags: np.ndarray        # (N, E) adaptation lag after each event
    lifts: np.ndarray       # (N,) final-segment minus opening-segment reward
    compliance: np.ndarray  # (N,) realised mean cost / ceiling

    @property
    def n_timelines(self) -> int:
        return len(self.timelines)

    def bands(self, qs: Sequence[float] = (5, 25, 50, 75, 95)) -> dict:
        """Percentile bands across sampled timelines, JSON-friendly."""
        def pct(a):
            return {f"p{q:g}": np.percentile(a, q, axis=0).tolist()
                    for q in qs}
        return {
            "n_timelines": self.n_timelines,
            "adaptation_lag": pct(self.lags),
            "quality_lift": pct(self.lifts),
            "budget_compliance": pct(self.compliance),
        }


def run_monte_carlo(
    cfg: RouterConfig,
    spec: ScenarioSpec,
    env,
    budget: float,
    timelines: Sequence[Timeline],
    seeds: Sequence[int] = (0,),
    *,
    lag_window: int = 32,
    lag_frac: float = 0.95,
    **grid_kwargs,
) -> MonteCarloResult:
    """All sampled timelines of one spec as one grid, reduced to
    percentile-band metrics.

    Each timeline is a condition of ``sweep.run_scenario_grid`` at the
    same initial ``budget`` (``grid_kwargs`` — priors, n_eff, batch_size,
    devices, chunk_size, device — pass through). Metrics are computed on
    the effective (padding-trimmed) per-condition slices: ``lags[i, j]``
    is the windowed-recovery lag after event ``j`` of timeline ``i``;
    ``lifts[i]`` the final-segment minus opening-segment mean reward;
    ``compliance[i]`` the realised mean cost over the ceiling."""
    tls = tuple(timelines)
    grid = sweep.run_scenario_grid(
        cfg, spec, env, [budget] * len(tls), seeds=seeds,
        timelines=tls, **grid_kwargs)
    E = len(spec.events)
    lags = np.empty((len(tls), E), np.float64)
    lifts = np.empty(len(tls), np.float64)
    comp = np.empty(len(tls), np.float64)
    for i, tl in enumerate(tls):
        res = grid.condition(i)
        for j, t in enumerate(tl.event_ts):
            lags[i, j] = adaptation_lag(res, t, window=lag_window,
                                        frac=lag_frac)
        segs = [res.segment(j) for j in range(res.n_segments)]
        nonempty = [s for s in segs if s.arms.shape[1] > 0]
        lifts[i] = nonempty[-1].mean_reward - nonempty[0].mean_reward
        comp[i] = res.mean_cost / budget
    return MonteCarloResult(grid=grid, timelines=tls, budget=budget,
                            lags=lags, lifts=lifts, compliance=comp)
