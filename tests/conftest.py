"""Shared fixtures: sanitizer wiring for the hot-path tests.

``no_implicit_transfers`` runs a test under
``jax.transfer_guard("disallow")``: any *implicit* host->device
transfer inside the block — a numpy array silently mixed into a device
computation, a Python-int index materialised per call — raises instead
of costing a hidden sync on the serving hot path. Explicit conversions
(``jnp.asarray(np_array)``, ``np.asarray(device_array)``,
``jax.device_get``) remain allowed: the gateway's host edges are
deliberate and spelled out, the guard exists to catch the accidental
ones.

``no_leaked_tracers`` wraps a test in ``jax.checking_leaks()`` so a
traced value escaping its trace (stashed on an object, closed over by a
later call) fails the test at the leak site rather than surfacing as an
inscrutable ``UnexpectedTracerError`` three calls later.

Both are opt-in via ``@pytest.mark.usefixtures(...)`` on hot-path test
classes (router step/select, sweep fabric, gateway routing) — not
autouse, because scaffolding-heavy tests legitimately bounce values
between host and device.
"""
from __future__ import annotations

import jax
import pytest


@pytest.fixture
def no_implicit_transfers():
    with jax.transfer_guard("disallow"):
        yield


@pytest.fixture
def no_leaked_tracers():
    with jax.checking_leaks():
        yield


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
