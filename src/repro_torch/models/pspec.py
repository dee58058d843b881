"""Activation-sharding hints, decoupled from model code.

Model code calls ``hint(x, "moe_buffer")`` etc.; the launch layer installs
a mapping from hint names to PartitionSpecs for the active mesh
(``launch.sharding.activation_hint_specs``). On a single device (tests,
benchmarks) hints are no-ops. With a mesh, a hint redistributes a DTensor
to its placements; a plain tensor, which no mesh holds, passes unchanged.
"""
from __future__ import annotations

from typing import Dict, Optional

from torch.distributed.tensor import DTensor

from repro_torch.partition import (NamedSharding, data_axis_names,
                                   drop_indivisible)

_MESH = None
_SPECS: Dict[str, tuple] = {}


def set_mesh(mesh, specs: Optional[Dict[str, tuple]] = None):
    global _MESH, _SPECS
    _MESH = mesh
    _SPECS = dict(specs or {})


def hint(x, name: str):
    if _MESH is None:
        return x
    spec = _SPECS.get(name)
    if spec is None or not isinstance(x, DTensor):
        return x
    # Drop axis assignments that don't divide the dimension (e.g. a
    # 50280-vocab logits tensor on a 16-way model axis): replicate instead.
    spec = drop_indivisible(_MESH, spec, x.shape)
    return x.redistribute(_MESH, NamedSharding(_MESH, spec).placements)


def data_axes():
    """Name(s) of the batch-sharding mesh axes for the active mesh."""
    if _MESH is None:
        return None
    return data_axis_names(_MESH) or None
