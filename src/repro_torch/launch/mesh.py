"""Device meshes for the sweep fabric's grid split.

The JAX package shards a grid's flattened (condition x seed) axis over a
1-D ``grid`` mesh. Here a mesh is the tuple of devices that take a part:
each device runs one contiguous part of the state stack from its own
thread, and the parts are joined on the host. Nothing is touched at
import time.
"""
from __future__ import annotations

import concurrent.futures
from typing import Callable, Optional, Sequence, Tuple

import torch


def make_grid_mesh(n: int, devices: Optional[Sequence] = None
                   ) -> Tuple[torch.device, ...]:
    """The devices of an embarrassingly parallel sweep of ``n`` elements:
    the first ``m`` of ``devices`` (default every visible CUDA device),
    with ``m`` the largest device count that divides ``n``, so every part
    holds ``n / m`` elements. A device may be listed more than once; each
    entry takes a part."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_grid_mesh needs at least one device")
    use = max(m for m in range(1, min(n, len(devices)) + 1) if n % m == 0)
    return tuple(devices[:use])


def part_bounds(n: int, mesh: Sequence) -> Tuple[Tuple[int, int], ...]:
    """Each mesh entry's contiguous [start, stop) of the ``n`` elements."""
    step = n // len(mesh)
    return tuple((i * step, (i + 1) * step) for i in range(len(mesh)))


def run_parts(fn: Callable, mesh: Sequence[torch.device]) -> list:
    """``fn(i, device)`` for every entry of ``mesh``, one thread per entry
    (inline for a mesh of one), each with its device current; returns the
    results in mesh order and raises the first part's error."""
    def one(i, dev):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return fn(i, dev)
        return fn(i, dev)

    if len(mesh) == 1:
        return [one(0, mesh[0])]
    with concurrent.futures.ThreadPoolExecutor(len(mesh)) as pool:
        futures = [pool.submit(one, i, dev) for i, dev in enumerate(mesh)]
        return [f.result() for f in futures]
