"""Scenario Monte Carlo over randomized timelines (DESIGN.md §12): the
host statistics.

The paper's §4.2-4.5 adaptation numbers are single-timeline point
estimates; randomizing *when* a shift arrives gives bands instead. This
module holds the parts that need no fused grid:

  * ``sample_timelines`` — draw N valid ``scenario.Timeline``s with
    uniform-random event steps (and optionally random effective
    horizons), aligned to the batched plane's block size, by rejection
    against the retimed spec's own validation;
  * ``adaptation_lag`` — steps after an event until the seed-averaged
    rolling reward recovers.

Running all timelines as one fused grid (``run_monte_carlo``,
``MonteCarloResult``) comes with the sweep fabric (``core/sweep.py``),
which is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import scenario
from repro_torch.core.scenario import ScenarioSpec, Timeline


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
