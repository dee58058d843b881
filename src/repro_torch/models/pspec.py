"""Activation-sharding hints, decoupled from model code.

Model code calls ``hint(x, "moe_buffer")`` etc.; the launch layer installs
a mapping from hint names to PartitionSpecs for the active mesh
(``launch.sharding.activation_hint_specs``). On a single device (tests,
benchmarks) hints are no-ops. With a mesh, a hint redistributes a DTensor
to its placements; a plain tensor, which no mesh holds, passes unchanged.

Where GSPMD reshards silently and DTensor has no rule, the model code
makes the reshard explicit with ``gathered`` (dimensions replicated),
``reshaped`` (a reshape that keeps, in its input and its gradient, only
the shards that divide the reshaped dimension), ``grad_gathered`` (a
gradient gathered) and ``reduced`` (pending partial sums completed);
``index_add`` is the scatter out of place on a DTensor, and
``take_last`` is a gather along the last dimension that stays on each
device's shard.
On a plain tensor each is what it was without a mesh.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

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


def gathered(x, *dims: int):
    """``x`` with dimensions ``dims`` replicated on every mesh axis that
    shards them (an all-gather where DTensor has no rule and GSPMD
    reshards silently)."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.dim() for d in dims}
    pl = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def _dividing(x, d: int, n: int) -> tuple:
    """``x``'s placements with the mesh axes that shard dimension ``d``
    kept, major to minor, while their product divides ``n``; the others
    replicated."""
    parts, out = 1, []
    for size, p in zip(x.device_mesh.shape, x.placements):
        if isinstance(p, Shard) and p.dim == d:
            if n % (parts * size):
                out.append(Replicate())
                continue
            parts *= size
        out.append(p)
    return tuple(out)


class _GradPlaced(torch.autograd.Function):
    """The identity, whose gradient keeps on dimension ``d`` only the
    shards that divide ``n`` and is gathered on the dimensions
    ``whole``."""

    @staticmethod
    def forward(ctx, x, d, n, whole):
        ctx.d, ctx.n, ctx.whole = d, n, whole
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor):
            pl = grad.placements if ctx.d is None else _dividing(
                grad, ctx.d, ctx.n)
            pl = tuple(Replicate() if isinstance(p, Shard)
                       and p.dim in ctx.whole else p for p in pl)
            if pl != grad.placements:
                grad = grad.redistribute(grad.device_mesh, pl)
        return grad, None, None, None


def reshaped(x, shape, dim: int, lead: int):
    """``x.reshape(shape)``, a reshape that splits dimension ``dim`` into
    (``lead``, rest), or merges it, of size ``lead``, with the next. On a
    mesh, the axes that shard ``dim`` are kept only while their product
    divides ``lead`` (8 KV heads, or 40 heads a DTensor rule split
    unevenly, on a 16-way ``model`` axis are gathered), as GSPMD reshards
    before such a reshape; DTensor cannot reshape an uneven shard. The
    result's gradient, placed by the ops downstream, is held to the same
    rule before the reshape's backward (a batch of 256 rows merged with
    the sequence comes back sharded over all 512 devices), and a split's
    inner dimensions are gathered in it."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    d = dim % x.dim()
    pl = _dividing(x, d, lead)
    out = (x if pl == x.placements
           else x.redistribute(x.device_mesh, pl)).reshape(shape)
    if out.requires_grad:
        inner = tuple(range(d + 1, d + 1 + max(0, out.dim() - x.dim())))
        out = _GradPlaced.apply(out, d, lead, inner)
    return out


def grad_gathered(x, dim: int):
    """``x`` itself, whose gradient has dimension ``dim`` gathered before
    it flows on: for an op whose backward reshapes the gradient in a way
    its shards do not divide (GQA's ``repeat_interleave`` folds 48 heads
    sharded 16 ways back into (8, 6))."""
    if not isinstance(x, DTensor):
        return x
    return _GradPlaced.apply(x, None, 0, (dim % x.dim(),))


def reduced(x):
    """``x`` with the partial sums a DTensor rule left pending completed
    (XLA's all-reduce). torch 2.11 cannot turn a shard into a partial
    sum, which its rule for an op on a partial and a sharded operand
    asks for."""
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])


def index_add(buf, idx, src):
    """``buf.index_add_(0, idx, src)``; out of place on a DTensor, for
    which torch 2.11 has no rule of the in-place op."""
    if isinstance(buf, DTensor):
        return torch.index_add(buf, 0, idx, src)
    return buf.index_add_(0, idx, src)


def take_last(x, idx):
    """``x.gather(-1, idx[..., None])[..., 0]``: each row's entry at
    ``idx``. For a DTensor, a sum of ``x`` masked to ``idx`` against a
    column index placed as ``x``'s last dimension is: XLA's
    vocabulary-parallel gather, each device reading its own columns,
    completed over the shards. (DTensor's gather would differentiate
    into zeros of the global shape, replicated on every device.)"""
    if not isinstance(x, DTensor):
        return x.gather(-1, idx[..., None])[..., 0]
    last, mesh = x.dim() - 1, x.device_mesh
    cols = distribute_tensor(
        torch.arange(x.shape[-1], device=x.device), mesh,
        [Shard(0) if isinstance(p, Shard) and p.dim == last else Replicate()
         for p in x.placements], src_data_rank=None)
    # The sum over the sharded columns is partial: XLA's all-reduce.
    return reduced((x * (cols == idx[..., None])).sum(-1))
