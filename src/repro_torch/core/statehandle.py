"""Double-buffered, versioned ``RouterState`` publication.

The serving gateway decouples the request path from learning: selection
reads an immutable, stale-by-one-tick snapshot while a learner applies
feedback blocks off the request path and *publishes* a fresh snapshot
atomically.

  * ``Snapshot``     — an immutable (state, version) pair. Versions are a
    monotonically increasing publish counter; every routed decision
    carries the version it was scored under, so late feedback can be
    attributed across publish ticks.
  * ``StateHandle``  — the double buffer. ``read()`` is wait-free (one
    attribute load; the GIL makes the swap atomic), ``publish()`` swaps
    the fresh state in under a tiny lock and bumps the version.
  * ``decay_on_restore`` — §3.3's gamma^Δt forgetting applied eagerly at
    restore time, so a router restarted after Δt offline steps resumes
    with correctly aged sufficient statistics (and tenant duals).
  * ``save_snapshot``/``load_snapshot`` — persistence via
    ``training/checkpoint.py`` (.npz + manifest; the snapshot version
    rides in the manifest's ``step`` field), in the JAX package's leaf
    names, shapes and dtypes: a snapshot saved by either package loads
    in the other.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Optional

import torch

from repro_torch.core import linucb, tenancy
from repro_torch.core.types import RouterConfig, RouterState
from repro_torch.training import checkpoint


def _step(state: RouterState) -> int:
    """The first state's global step (one host sync)."""
    return int(state.t.reshape(-1)[0])


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """An immutable published view of the router state. ``version`` is
    the publish counter (0 = initial state); ``step`` is the router's
    global step ``t`` at publish time, recorded host-side."""

    state: RouterState
    version: int
    step: int = 0


class StateHandle:
    """Double-buffered publication point for ``RouterState``: one writer
    (the learner / control plane, externally serialised), many readers.
    ``read()`` never blocks on a publish in progress."""

    def __init__(self, state: RouterState, *, version: int = 0,
                 step: Optional[int] = None):
        if step is None:
            step = _step(state)
        self._lock = threading.Lock()
        self._snap = Snapshot(state=state, version=version, step=step)

    def read(self) -> Snapshot:
        """The current snapshot: wait-free, always complete."""
        return self._snap

    @property
    def version(self) -> int:
        return self._snap.version

    def publish(self, state: RouterState, *,
                step: Optional[int] = None) -> Snapshot:
        """Swap ``state`` in as the new snapshot; returns it with the
        bumped version. Concurrent ``read()`` sees either the old or the
        new snapshot, never a mixture."""
        if step is None:
            step = _step(state)
        with self._lock:
            snap = Snapshot(state=state, version=self._snap.version + 1,
                            step=step)
            self._snap = snap
        return snap


def decay_on_restore(cfg: RouterConfig, state: RouterState,
                     elapsed: int) -> RouterState:
    """Age a restored state by ``elapsed`` offline steps (§3.3).

    Applies gamma^min(elapsed, dt_max) to every arm's (A, A_inv, b)
    eagerly, recomputes theta, and shifts the whole step clock — ``t``,
    ``last_upd``, ``last_play`` — forward by ``elapsed``, which keeps the
    lazy decay exact: at the next update of arm ``a`` the live path
    applies gamma^(t_now - last_upd[a]) on top, and the composition
    equals the single gamma^(elapsed + gap) a never-restarted router
    would have applied, up to float associativity (the 1e-6 round-trip
    bound; exact equality also needs elapsed + gap <= cfg.dt_max).

    The portfolio pacer (lam, c_ema) survives unchanged: Eqs. 3-4 track
    the operator's budget, which does not decay with idleness. The
    tenant table, when present, relaxes by ``tenancy.decay_table`` on the
    same clock (lam toward 0, c_ema toward its budget; DESIGN.md §15).
    """
    elapsed = int(elapsed)
    if elapsed < 0:
        raise ValueError(f"decay_on_restore: elapsed={elapsed} must be >= 0")
    if elapsed == 0:
        return state
    dt = torch.full_like(state.last_upd, elapsed)
    g = linucb.forgetting_factor(cfg, state.hyper, dt)            # (S, K)
    A = state.A * g[..., None, None]
    A_inv = state.A_inv / g[..., None, None]
    b = state.b * g[..., None]
    theta = (A_inv @ b[..., None])[..., 0]
    tenants = state.tenants
    if tenants is not None:
        tenants = tenancy.decay_table(cfg, state.hyper, tenants, elapsed)
    return dataclasses.replace(
        state,
        A=A, A_inv=A_inv, b=b, theta=theta,
        last_upd=state.last_upd + elapsed,
        last_play=state.last_play + elapsed,
        t=state.t + elapsed,
        tenants=tenants,
    )


def save_snapshot(path: str, snap: Snapshot) -> None:
    """Persist a snapshot as .npz + manifest (training/checkpoint.py).

    A one-state stack is written in the JAX package's shapes (the state
    axis dropped) and dtypes (the PRNG key as uint32); a stack of S > 1
    keeps its leading axis. The publish version rides in the manifest
    ``step`` field; the router's global step is a state leaf (``t``)."""
    from repro_torch import interop

    tree = interop.state_to_numpy(snap.state,
                                  stacked=snap.state.num_states != 1)
    checkpoint.save_checkpoint(path, tree, step=snap.version)


def load_snapshot(path: str, template: RouterState) -> Snapshot:
    """Restore a snapshot saved by ``save_snapshot`` (either package's).

    ``template`` supplies the structure, shapes and device (e.g. a fresh
    ``init_state`` for the same statics, with a tenant table of the same
    T to restore one); shape mismatches raise in ``load_checkpoint``."""
    from repro_torch import interop

    stacked = template.num_states != 1
    tree = checkpoint.load_checkpoint(
        path, interop.state_to_numpy(template, stacked=stacked))
    state = interop.state_from_numpy(tree, template.A.device)
    # save_checkpoint writes the manifest at ``path + ".manifest.json"``
    # for the same path string it was given — mirror that here.
    with open(path + ".manifest.json") as f:
        version = int(json.load(f)["step"])
    return Snapshot(state=state, version=version, step=_step(state))
