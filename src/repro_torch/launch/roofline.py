"""Roofline terms of a dry-run on one H100, as the JAX package's
``launch/roofline.py`` computes them for its TPU mesh.

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = HBM_bytes_per_device / HBM_BW
  collective = wire_bytes_per_device / LINK_BW

The peaks are NVIDIA's H100 SXM5 data sheet's: dense bf16 on the tensor
cores 989 TFLOP/s, HBM3 3.35 TB/s, and NVLink's 900 GB/s per card, 450
GB/s each way, in the place of the TPU's per-link ICI rate.

The wire bytes are counted where DTensor issues its collectives:
``count_collectives`` sees each collective op that a step traced on
placed arguments runs, and converts its result bytes to per-device wire
bytes with the JAX package's ring models (``_wire_bytes``: all-gather
(g-1)/g, all-reduce 2(g-1)/g, reduce-scatter (g-1), all-to-all (g-1)/g,
permute 1). The port makes no HLO, so it has no HLO parser.
"""
from __future__ import annotations

import contextlib
import os
import traceback
from typing import Dict, List, Optional

from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12     # bf16 dense, tensor cores
HBM_BW = 3.35e12        # bytes/s
LINK_BW = 450e9         # bytes/s, NVLink each way

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# The collective ops DTensor lowers into, by their schema name (the
# functional collectives under either namespace, and DTensor's own
# all-to-all of a Shard -> Shard move), and the kind each one is.
_OP_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
# Ops of those namespaces that move nothing.
_FREE = {"wait_tensor", "_wrap_tensor_autograd"}
_NAMESPACES = {"_c10d_functional", "c10d_functional", "c10d", "_dtensor"}


def _wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(result_bytes) * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)  # collective-permute


def empty_collectives() -> Dict[str, Dict[str, float]]:
    """``parse_collectives``'s dict with nothing counted: every kind with
    a zero ``count``, ``result_bytes`` and ``wire_bytes``."""
    return {k: {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0}
            for k in _COLL_KINDS}


def _group_size(func, args, kwargs) -> int:
    """The size of the group ``func`` runs over: its ``group_size``
    argument, else the process group its ``group_name`` names."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a.name for a in func._schema.arguments]
    bound = dict(zip(names, args), **kwargs)
    if "group_size" in bound:
        return int(bound["group_size"])
    group = bound["group_name"]
    if isinstance(group, str):
        group = _resolve_process_group(group)
    return group.size()


# The records of ``record_sites`` while one is open, else None.
_SITES: Optional[List[dict]] = None
_MODELS = os.path.join("repro_torch", "models")


def _site() -> tuple:
    """(the innermost frame of the model code on the stack, as "file:line
    function", or "backward" where there is none; the outermost ``pspec``
    helper on it, or None)."""
    frames = [f for f in traceback.extract_stack() if _MODELS in f.filename]
    helper = next((f.name for f in frames
                   if f.filename.endswith("pspec.py")), None)
    model = [f for f in frames if not f.filename.endswith("pspec.py")]
    where = (f"{os.path.basename(model[-1].filename)}:{model[-1].lineno} "
             f"{model[-1].name}" if model else "backward")
    return where, helper


@contextlib.contextmanager
def record_sites():
    """Records each collective that ``count_collectives`` counts inside
    the block into the list it yields, one dict each: ``kind``,
    ``shape`` and ``result_bytes`` (its result's on this rank),
    ``wire_bytes``, ``site`` and ``helper`` (``_site``) and ``op``, the
    last aten op DTensor was handed before it (the op whose inputs it
    redistributed; the only witness in the backward, where no model
    frame is on the stack)."""
    global _SITES
    prev, _SITES = _SITES, []
    try:
        yield _SITES
    finally:
        _SITES = prev


class _CollectiveCounter(TorchDispatchMode):
    """Counts the collectives below DTensor. An op with a DTensor among
    its types is handed back (``NotImplemented``), so DTensor's own
    dispatch runs its local ops and collectives, which come through here
    on plain tensors."""

    def __init__(self, out):
        super().__init__()
        self.out = out
        self.last_op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            self.last_op = func
            return NotImplemented
        kwargs = kwargs or {}
        result = func(*args, **kwargs)
        if func.namespace in _NAMESPACES:
            self._count(func, args, kwargs, result)
        return result

    def _count(self, func, args, kwargs, result) -> None:
        name = func._schema.name.split("::")[-1]
        if name in _FREE:
            return
        kind = _OP_KINDS.get(name)
        if kind is None:
            raise NotImplementedError(
                f"collective op {func} has no kind in the wire-bytes "
                "model; it must not count as zero")
        outs = result if isinstance(result, (list, tuple)) else (result,)
        rb = sum(t.numel() * t.element_size() for t in outs)
        g = _group_size(func, args, kwargs)
        wire = _wire_bytes(kind, rb, g)
        c = self.out[kind]
        c["count"] += 1
        c["result_bytes"] += rb
        c["wire_bytes"] += wire
        if _SITES is not None:
            site, helper = _site()
            _SITES.append({"kind": kind, "shape": tuple(outs[0].shape),
                           "result_bytes": rb, "wire_bytes": wire,
                           "site": site, "helper": helper,
                           "op": str(self.last_op)})


@contextlib.contextmanager
def count_collectives():
    """Counts the collectives run inside the block, per kind, into the
    dict it yields (``parse_collectives``'s: ``count``, ``result_bytes``
    and ``wire_bytes`` of each of the five kinds). Result bytes are the
    op's output on this rank, the wire bytes per device ``_wire_bytes``
    of them over the op's group. A collective op it has no kind for
    raises ``NotImplementedError``."""
    out = empty_collectives()
    with _CollectiveCounter(out):
        yield out


def roofline_terms(flops: float, hbm_bytes: float,
                   wire_bytes: float) -> Dict[str, float]:
    """The three terms, the dominant one's name and ``bound_s``, its
    time: the least time the card could take."""
    terms = {"compute_s": flops / PEAK_FLOPS,
             "memory_s": hbm_bytes / HBM_BW,
             "collective_s": wire_bytes / LINK_BW}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs (global): 6·N·D to train, 2·N·D to infer, N the
    active parameters and D the tokens (one a sequence to decode)."""
    n_act = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n_act * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.seq_len * shape.global_batch
    return 2.0 * n_act * shape.global_batch
