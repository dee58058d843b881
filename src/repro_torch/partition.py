"""Partition specs and their DTensor placements on a named ``DeviceMesh``:
the layer under both the launch layer's sharding rules and the model
code's activation hints.

Torch has no ``PartitionSpec``, so the port keeps its own: a tuple of
one entry per tensor dimension, each ``None``, a mesh axis name or a
tuple of names, canonicalised as JAX's is. ``NamedSharding(mesh, spec)``
turns it into one DTensor placement per mesh dimension. An entry naming
several axes shards its dimension over each of them, major to minor in
mesh order, as JAX flattens the tuple; an entry whose axes are not in
mesh order has no DTensor form and raises. ``drop_indivisible`` replaces
every axis that does not divide its dimension with replication, so a
tensor placed under the specs it gives is never sharded unevenly.

Everything here reads only a mesh's axis names and sizes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

from torch.distributed.tensor import Replicate, Shard

DATA_AXES = ("pod", "data")


def axis_sizes(mesh) -> dict:
    """A named mesh's size by axis name."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axis_names(mesh) -> tuple:
    """The mesh's batch-sharding axes (``pod`` and ``data``), in mesh
    order."""
    return tuple(n for n in mesh.mesh_dim_names if n in DATA_AXES)


def _canonical(entry):
    """An entry as JAX canonicalises it: a tuple of one name is the name,
    an empty one is None."""
    if entry is None or isinstance(entry, str):
        return entry
    entry = tuple(entry)
    if not entry:
        return None
    return entry[0] if len(entry) == 1 else entry


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class PartitionSpec(tuple):
    """One entry per tensor dimension (missing trailing entries are
    None); equal to the tuple of its entries, as ``tuple(jax_spec)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` on a named ``DeviceMesh``."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """One ``Shard(dim)`` or ``Replicate()`` per mesh dimension."""
        names = tuple(self.mesh.mesh_dim_names)
        owner: Dict[str, int] = {}
        for dim, entry in enumerate(self.spec):
            axes = _axes(entry)
            unknown = [a for a in axes if a not in names]
            if unknown:
                raise ValueError(f"{self.spec}: no mesh axis {unknown} in "
                                 f"{names}")
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(
                    f"{self.spec}: the axes {axes} of dimension {dim} are not "
                    f"in mesh order {names}; DTensor shards one dimension "
                    f"over several mesh dimensions major to minor in mesh "
                    f"order only")
            for a in axes:
                if a in owner:
                    raise ValueError(f"{self.spec}: mesh axis {a!r} shards "
                                     f"dimensions {owner[a]} and {dim}")
                owner[a] = dim
        return tuple(Shard(owner[n]) if n in owner else Replicate()
                     for n in names)

    def shard_shape(self, global_shape) -> tuple:
        """The shape each device holds of a tensor of ``global_shape``;
        raises ValueError where an axis does not divide its dimension."""
        global_shape = tuple(global_shape)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"{self.spec} has more entries than the shape "
                             f"{global_shape} has dimensions")
        sizes = axis_sizes(self.mesh)
        padded = tuple(self.spec) + (None,) * (len(global_shape)
                                               - len(self.spec))
        out = []
        for dim, (n, entry) in enumerate(zip(global_shape, padded)):
            parts = math.prod(sizes[a] for a in _axes(entry))
            if n % parts:
                raise ValueError(
                    f"{self.spec} splits dimension {dim} of {global_shape} "
                    f"into {parts} parts, which do not divide {n}")
            out.append(n // parts)
        return tuple(out)


def drop_indivisible(mesh, spec: P, shape) -> P:
    """Replace axis assignments whose size doesn't divide the dim (e.g.
    vocab 50280 on a 16-way 'model' axis) with replication."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, s in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        size = math.prod(sizes[a] for a in _axes(s))
        out.append(s if s is not None and dim % size == 0 else None)
    return P(*out)
