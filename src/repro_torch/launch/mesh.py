"""Device meshes: the production mesh and the sweep fabric's grid split.

The production mesh is a ``torch.distributed`` ``DeviceMesh`` of 16 x 16
= 256 ranks on ``("data", "model")``, or of 2 x 16 x 16 = 512 on
``("pod", "data", "model")``, the JAX package's shapes and axis names.
It is built over a world that the caller has initialised, as JAX's is
built over the devices the runtime already has.

The JAX package shards a grid's flattened (condition x seed) axis over a
1-D ``grid`` mesh. Here a grid mesh is the tuple of devices that take a
part: each device runs one contiguous part of the state stack from its
own thread, and the parts are joined on the host.

Every mesh is made by a function, so importing this module touches no
device and no process group.
"""
from __future__ import annotations

import concurrent.futures
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.partition import axis_sizes, data_axis_names


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks when ``multi_pod``.

    The mesh takes the world's first 256 (512) ranks, as ``jax.make_mesh``
    takes the first devices. It needs that world to be initialised
    already (``torch.distributed.init_process_group``); without one, or
    with fewer ranks, it raises ValueError rather than wait on a
    rendezvous or build a smaller mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 0)
    if have < need:
        raise ValueError(
            f"the production mesh {shape} on {axes} needs an initialised "
            f"world of {need} ranks; the world has {have}")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def data_parallel_size(mesh) -> int:
    """The product of the data axes' sizes."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[n] for n in data_axis_names(mesh))


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
