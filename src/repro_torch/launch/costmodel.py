"""FLOP and HBM-byte accounting of a traced step, with the JAX package's
rules (``src/repro/launch/costmodel.py``), and the step's live memory.

The step runs once under a ``TorchDispatchMode``, as a rule on ``meta``
tensors, so nothing is computed or allocated; every aten op it reaches is
counted as it passes:

  * matmul-class ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``: what ``@``,
    ``matmul`` and ``einsum`` come down to, forward and backward) take
    2·M·N·K FLOPs, and their inputs and outputs count as bytes (JAX's
    ``dot_general``); the bias add of ``addmm`` / ``baddbmm`` is one FLOP
    per output element;
  * views, reshapes, transposes, dtype casts (``_to_copy``), copies,
    ``expand``, ``slice`` and the creation ops are free (JAX's cheap set);
  * gathers and scatters (``embedding``, ``index``, ``index_select``,
    ``gather``, ``scatter``, ``index_add_``, ``index_put``), ``cat``,
    ``stack`` and ``sort`` move their inputs and outputs, and so does
    ``copy_``, the port's cache update in place (JAX's
    ``dynamic_update_slice``): the update read and the slice written,
    what the card moves (JAX counts the whole operand in and out, as its
    functional update would copy it);
  * every other op is math: one FLOP per output element, no bytes (fused
    into its producer).

Python loops (over layers, query blocks, cache blocks) are counted once per
trip, which is what JAX's scan multiplication does; the recompute of a
``torch.utils.checkpoint`` region is counted in the backward, where it
runs. ``fn_cost`` adds the bytes of the top-level arguments and outputs.

A DTensor counts in bytes and memory by its local tensor, the shard this
rank holds, so a step traced on placed arguments gives per-device
memory; its FLOPs, which count global shapes, are not per device.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Mapping, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten

_DOTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
_CHEAP = {
    aten._to_copy, aten._unsafe_view, aten.alias, aten.arange, aten.clone,
    aten.detach, aten.empty, aten.empty_like, aten.empty_strided,
    aten.expand, aten.full, aten.full_like, aten.lift_fresh, aten.new_empty,
    aten.new_full, aten.new_ones, aten.new_zeros, aten.ones, aten.ones_like,
    aten.permute, aten.scalar_tensor, aten.select, aten.slice, aten.split,
    aten.split_with_sizes, aten.squeeze, aten.t, aten.transpose,
    aten.unbind, aten.unsqueeze, aten.view, aten.zeros, aten.zeros_like,
    aten.as_strided, aten._reshape_alias, aten.lift_fresh_copy,
}
_MATERIALIZING = {
    aten.embedding, aten.embedding_dense_backward, aten.index,
    aten.index_select, aten.gather, aten.scatter, aten.scatter_add,
    aten.index_add, aten.index_add_, aten.index_put, aten.index_put_,
    aten.cat, aten.stack, aten.sort,
}


def _local(t):
    """A DTensor's local shard, any other tensor itself."""
    return t._local_tensor if isinstance(t, DTensor) else t


def nbytes(t) -> int:
    """Bytes of a tensor's elements, a DTensor's local ones (0 for
    anything else)."""
    if not isinstance(t, torch.Tensor):
        return 0
    t = _local(t)
    return t.numel() * t.element_size()


def tensors(x):
    """The tensors of an op's arguments or results, or of a step's
    arguments or result: nested tuples (``DecodeCaches``), lists,
    mappings (parameter trees) and dataclasses (``TrainState``)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, Mapping):
        for y in x.values():
            yield from tensors(y)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from tensors(getattr(x, f.name))
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from tensors(y)


@dataclasses.dataclass
class Cost:
    """What one traced call took. ``flops`` / ``hbm_bytes`` as JAX's
    ``fn_cost`` counts them, ``dot_flops`` the matmul-class share of
    ``flops``; ``temp_bytes`` the high-water mark of the intermediate
    tensors alive at once (every storage an op created, until it is
    freed)."""
    flops: float = 0.0
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    temp_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    flop_counter: int = 0


class _Counter(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self.live = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, func, out) -> None:
        """Adds each storage ``func`` created to the live bytes until it
        is freed. Outputs that alias an input (views, in-place results)
        are not new."""
        returns = func._schema.returns
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for i, t in enumerate(outs):
            if not isinstance(t, torch.Tensor):
                continue
            r = returns[min(i, len(returns) - 1)]
            if r.alias_info is not None:
                continue
            st = _local(t).untyped_storage()
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, n)
        self.cost.temp_bytes = max(self.cost.temp_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, out)
        self._track(func, out)
        return out

    def _count(self, func, args, out) -> None:
        c = self.cost
        packet = func.overloadpacket
        outs = list(tensors(out))
        if packet in _DOTS:
            a, b = (args[1], args[2]) if packet in (aten.addmm,
                                                    aten.baddbmm) else args[:2]
            f = 2.0 * outs[0].numel() * a.shape[-1]
            c.dot_flops += f
            c.flops += f
            if packet in (aten.addmm, aten.baddbmm):
                c.flops += outs[0].numel()
            c.hbm_bytes += (sum(nbytes(t) for t in tensors(args))
                            + sum(nbytes(t) for t in outs))
        elif packet in _CHEAP:
            return
        elif packet in _MATERIALIZING:
            c.hbm_bytes += (sum(nbytes(t) for t in tensors(args))
                            + sum(nbytes(t) for t in outs))
        elif packet is aten.copy_:
            c.hbm_bytes += nbytes(args[1]) + nbytes(args[0])
        else:
            c.flops += sum(t.numel() for t in outs)


def trace_cost(fn, *args) -> Tuple[Any, Cost]:
    """Runs ``fn(*args)`` under the counter (and ``FlopCounterMode``, an
    independent count of the matmul-class FLOPs) and returns (its result,
    the ``Cost``). The arguments should be ``meta`` tensors, so that
    nothing is computed or allocated; they are counted in
    ``argument_bytes`` and the result's tensors in ``output_bytes`` (those
    that alias an argument, the caches a decode step updates in place,
    only in the arguments)."""
    cost = Cost()
    arg_leaves = list(tensors(args))
    cost.argument_bytes = sum(nbytes(t) for t in arg_leaves)
    with FlopCounterMode(display=False) as fc, _Counter(cost):
        out = fn(*args)
    cost.flop_counter = int(fc.get_total_flops())
    arg_storages = {id(_local(t).untyped_storage()) for t in arg_leaves}
    out_leaves = list(tensors(out))
    cost.output_bytes = sum(
        nbytes(t) for t in out_leaves
        if id(_local(t).untyped_storage()) not in arg_storages)
    # fn_cost's top-level traffic: every argument and output leaf once.
    cost.hbm_bytes += cost.argument_bytes + sum(nbytes(t)
                                                for t in out_leaves)
    return out, cost


def fn_cost(fn, *args) -> Tuple[float, float]:
    """(flops, hbm_bytes) of ``fn`` traced at the arguments' shapes, the
    JAX package's ``fn_cost``: on one device these are its totals."""
    _, cost = trace_cost(fn, *args)
    return cost.flops, cost.hbm_bytes

