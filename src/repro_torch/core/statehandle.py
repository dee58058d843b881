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

The JAX package's ``save_snapshot``/``load_snapshot`` and
``decay_on_restore`` need its checkpoint module and tenant plane, which
are not ported yet.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from repro_torch.core.types import RouterState


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
