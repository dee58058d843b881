"""Data sources: synthetic token streams for LM training, request
streams for serving experiments, and tenant-id overlays for the tenant
plane (DESIGN.md §15).

The LM dataset is the JAX package's deterministic Zipf-ish Markov token
source with sequence packing, copied in numpy, so one seed gives the
same batches bit for bit in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    """Packed next-token-prediction batches from a Markov chain."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branching: int = 16   # successors per state -> learnable structure

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse successor table with Zipf-weighted choices
        self._succ = rng.integers(
            0, self.vocab_size, size=(self.vocab_size, self.branching)
        )
        w = 1.0 / np.arange(1, self.branching + 1) ** 1.2
        self._probs = w / w.sum()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + 1)
        state = rng.integers(0, self.vocab_size, size=(self.batch_size,))
        while True:
            toks = np.empty((self.batch_size, self.seq_len + 1), np.int32)
            toks[:, 0] = state
            for t in range(1, self.seq_len + 1):
                choice = rng.choice(self.branching, size=self.batch_size,
                                    p=self._probs)
                toks[:, t] = self._succ[toks[:, t - 1], choice]
            state = toks[:, -1]
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# serving request streams
# ---------------------------------------------------------------------------

_TEMPLATES = {
    "math": "solve the equation {a} x plus {b} equals {c} step by step",
    "code": "write a python function that returns the {a} th fibonacci number",
    "knowledge": "which element has atomic number {a} and why is it notable",
    "commonsense": "if it rains and {a} forgets an umbrella what happens next",
    "reasoning": "alice has {a} boxes each with {b} items how many in total",
}


def make_request_stream(
    n: int, seed: int = 0, families: Sequence[str] = tuple(_TEMPLATES),
) -> List[Dict]:
    """Text prompts tagged with a task family, for the live serving demo."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fam = families[int(rng.integers(len(families)))]
        vals = {k: int(rng.integers(2, 99)) for k in ("a", "b", "c")}
        out.append({
            "id": i,
            "family": fam,
            "prompt": _TEMPLATES[fam].format(**vals),
        })
    return out


# ---------------------------------------------------------------------------
# tenant-mix streams (DESIGN.md §15)
#
# A tenant-id overlay for a request stream: (L,) int32 tags drawn from a
# time-varying categorical over T tenants. The overlay is independent of
# WHICH prompts are drawn (tenants share the portfolio's traffic), so it
# composes with any prompt stream — scenario segments, shuffled splits,
# the gateway's live feed — by zipping per index.
# ---------------------------------------------------------------------------


def _normalized_weights(weights, T: int) -> np.ndarray:
    w = (np.ones(T, np.float64) if weights is None
         else np.asarray(weights, np.float64))
    if w.shape != (T,):
        raise ValueError(f"weights must be ({T},); got shape {w.shape}")
    if np.any(w < 0.0) or not w.sum() > 0.0:
        raise ValueError(f"weights must be >= 0 with a positive sum: {w}")
    return w / w.sum()


def tenant_mix_stream(
    n: int, T: int, weights=None, seed: int = 0,
) -> np.ndarray:
    """(n,) tenant ids drawn i.i.d. from one fixed mix (None = uniform)."""
    rng = np.random.default_rng(seed)
    return rng.choice(T, size=n, p=_normalized_weights(weights, T)).astype(
        np.int32)


def diurnal_tenant_stream(
    n: int, T: int, *, period: int = 512, sharpness: float = 2.0,
    seed: int = 0,
) -> np.ndarray:
    """(n,) tenant ids under a diurnal mix: each tenant's share follows a
    phase-shifted sinusoid of the given ``period`` (tenant i peaks at
    phase i/T of the cycle), so traffic leadership rotates smoothly —
    the workload that makes per-tenant duals breathe out of phase.
    ``sharpness`` >= 0 scales how peaked each tenant's day is."""
    if period < 1:
        raise ValueError(f"period={period}: must be >= 1")
    rng = np.random.default_rng(seed)
    steps = np.arange(n)[:, None]                       # (n, 1)
    phase = np.arange(T)[None, :] / T                   # (1, T)
    w = 1.0 + sharpness * 0.5 * (
        1.0 + np.cos(2.0 * np.pi * (steps / period - phase)))
    w = w / w.sum(axis=1, keepdims=True)                # (n, T)
    u = rng.random(n)
    return (np.cumsum(w, axis=1) < u[:, None]).sum(axis=1).astype(np.int32)


def flash_crowd_tenant_stream(
    n: int, T: int, *, hot: int = 0, start: int = 0, stop=None,
    boost: float = 8.0, base_weights=None, seed: int = 0,
) -> np.ndarray:
    """(n,) tenant ids where tenant ``hot`` flash-crowds in
    ``[start, stop)``: its mix weight is multiplied by ``boost`` inside
    the window and reverts outside — the §4 non-stationarity stressor
    ported to the tenant axis (one contract's traffic spikes while the
    others keep their baseline share)."""
    if not 0 <= hot < T:
        raise ValueError(f"hot={hot}: need 0 <= hot < T={T}")
    if boost <= 0.0:
        raise ValueError(f"boost={boost}: must be > 0")
    stop = n if stop is None else stop
    if not 0 <= start <= stop <= n:
        raise ValueError(f"window [{start}, {stop}) out of range for n={n}")
    base = _normalized_weights(base_weights, T)
    hot_w = base.copy()
    hot_w[hot] *= boost
    hot_w /= hot_w.sum()
    rng = np.random.default_rng(seed)
    out = np.empty(n, np.int32)
    for lo, hi, w in ((0, start, base), (start, stop, hot_w),
                      (stop, n, base)):
        if hi > lo:
            out[lo:hi] = rng.choice(T, size=hi - lo, p=w)
    return out


def tenant_stream_for_spec(
    spec, T: int, seed: int = 0, weights=None,
) -> np.ndarray:
    """(spec.horizon,) tenant ids honouring the spec's ``TenantMixShift``
    events: the draw starts from ``weights`` (None = uniform) and
    switches to each event's mix at its step, None restoring the initial
    mix. One ``default_rng(seed)`` is consumed segment-by-segment in
    time order, so retiming an event changes which steps use which mix
    but not the generator's identity."""
    # lazy: this module stays numpy-only at import
    from repro_torch.core import scenario as scenario_lib

    shifts = sorted(
        ((e.t, e.weights) for e in spec.events
         if isinstance(e, scenario_lib.TenantMixShift)),
        key=lambda p: p[0])
    base = _normalized_weights(weights, T)
    bounds = [0] + [t for t, _ in shifts] + [spec.horizon]
    mixes = [base] + [
        base if w is None else _normalized_weights(w, T) for _, w in shifts]
    rng = np.random.default_rng(seed)
    out = np.empty(spec.horizon, np.int32)
    for lo, hi, w in zip(bounds[:-1], bounds[1:], mixes):
        if hi > lo:
            out[lo:hi] = rng.choice(T, size=hi - lo, p=w)
    return out
