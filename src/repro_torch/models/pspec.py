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
gradient gathered), ``reduced`` (pending partial sums completed) and
``grad_reduced`` (a gradient's pending partial sums completed);
``index_add`` is the scatter out of place on a DTensor,
``take_last`` is a gather along the last dimension that stays on each
device's shard, and ``on_shards`` runs a blocked op on each device's
shards (the chunked attention, ``on_head_shards``; the SSD scan,
``on_ssd_shards``). The sharded forms keep a sharded dimension on its
shards where DTensor would gather it: ``write_slot`` (the decode's
cache write of one slot), ``softmax_last`` (the decode's softmax over a
sharded last dimension), ``embed_lookup`` (the decode's
vocabulary-parallel lookup) and ``logsumexp_last`` (the cross-entropy's
over vocabulary-sharded logits).
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


def _moved(pl: tuple, dims: dict) -> tuple:
    """Placements ``pl`` of a tensor sharded only on the keys of ``dims``,
    as those of another whose dimension ``dims[d]`` is the first's ``d``:
    each shard moved there, every other placement replicated."""
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in pl)


def on_shards(fn, mesh, args: tuple, outs: tuple):
    """``fn`` on each device's shards: ``args`` are (tensor, placements)
    pairs, each tensor placed so (a plain tensor or None passes as it
    is) and handed to ``fn`` as its local shard, and ``outs`` the
    placements of ``fn``'s results, which it returns as a tuple. The
    shards are even, as the rules guarantee. An input replicated on a
    mesh axis that shards a result gets a gradient that is a partial sum
    there (each device's shard of the result draws on it). For an op
    independent across its sharded dimensions, XLA's local computation;
    DTensor would reshard each step of a blocked loop, forward and
    backward."""
    split = [any(isinstance(o[md], Shard) for o in outs)
             for md in range(mesh.ndim)]

    def local(t, pl: tuple):
        if not isinstance(t, DTensor):
            return t
        grad = tuple(Partial() if s and isinstance(p, Replicate) else p
                     for s, p in zip(split, pl))
        return (t if t.placements == pl else t.redistribute(mesh, pl)
                ).to_local(grad_placements=grad)

    res = fn(*(local(t, pl) for t, pl in args))
    return tuple(DTensor.from_local(r, mesh, pl, run_check=False)
                 for r, pl in zip(res, outs))


def on_head_shards(fn, q, k, v):
    """``fn(q, k, v)``, an attention over q (B, S, H, hd) and k, v (B, T,
    KV, hd) that is independent across batch rows and heads. On a mesh
    it runs on each device's shards, placed as q (``on_shards``): pending
    sums are completed and the sequence and the head dimension gathered
    first, and k and v are repeated to H heads first where their head
    shards do not line up with q's (K/V heads the model axis does not
    divide)."""
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    q = gathered(reduced(q), 1, 3)
    pl = q.placements

    def like_q(t):
        t = gathered(reduced(t), 1, 3)
        g = q.shape[2] // t.shape[2]
        if t.placements != pl and g > 1:
            t = grad_gathered(t.repeat_interleave(g, dim=2), 2)
        return t, pl

    return on_shards(lambda *a: (fn(*a),), q.device_mesh,
                     ((q, pl), like_q(k), like_q(v)), (pl,))[0]


def on_ssd_shards(fn, x, dt, A, B_in, C_in, D_skip, h0):
    """``fn(x, dt, A, B_in, C_in, D_skip, h0)``, the SSD scan over x (B,
    L, H, P), dt (B, L, H), A and D_skip (H,), B_in and C_in (B, L, N)
    and h0 (B, H, N, P) or None, which returns y like x and the state
    like h0, independent across batch rows and heads. On a mesh it runs
    on each device's shards (``on_shards``), placed by x's batch and head
    shards, after x's pending sums are completed and its sequence and
    head dimension gathered."""
    if not isinstance(x, DTensor):
        return fn(x, dt, A, B_in, C_in, D_skip, h0)
    x = gathered(reduced(x), 1, 3)
    pl = x.placements
    state = _moved(pl, {0: 0, 2: 1})
    return on_shards(fn, x.device_mesh, (
        (x, pl), (dt, _moved(pl, {0: 0, 2: 2})), (A, _moved(pl, {2: 0})),
        (B_in, _moved(pl, {0: 0})), (C_in, _moved(pl, {0: 0})),
        (D_skip, _moved(pl, {2: 0})), (h0, state)), (pl, state))


class _GradReduced(torch.autograd.Function):
    """The identity, whose gradient has its pending partial sums
    completed."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return reduced(grad)


def grad_reduced(x):
    """``x`` itself, whose gradient's partial sums are completed before it
    flows on: the input of column-parallel projections, whose gradient
    is a partial sum over the model axis (Megatron's all-reduce in the
    backward). DTensor would carry it on into the norm and the residual
    stream and complete it there, in f32, for each use."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _GradReduced.apply(x)


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


def _local_range(size: int, mesh, placements, dim: int) -> tuple:
    """(start, size) of this rank's shard of a dimension ``dim`` of
    ``size`` under ``placements``: the mesh axes that shard it split it
    evenly, major to minor, as the rules guarantee (they drop an axis
    that does not divide)."""
    start, coord = 0, mesh.get_coordinate()
    for md, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            n = mesh.size(md)
            assert size % n == 0, (size, placements)
            size //= n
            start += coord[md] * size
    return start, size


def _shards(x, dim: int) -> bool:
    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and p.dim == dim for p in x.placements)


def write_slot(cache, slot: int, row) -> None:
    """``cache[:, slot] = row`` for a cache (B, W, ...) and a row (B,
    ...). On a mesh that shards W, only the shard holding ``slot`` writes
    it, into its local tensor (XLA's local dynamic-update-slice); the row
    is first brought to the cache's placements on every other dimension,
    a small move. DTensor's own rule would gather the whole cache."""
    if not isinstance(cache, DTensor):
        cache[:, slot].copy_(row)
        return
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1
          else Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
          else p for p in cache.placements]
    row = row.redistribute(cache.device_mesh, pl)
    start, size = _local_range(cache.shape[1], cache.device_mesh,
                               cache.placements, 1)
    if start <= slot < start + size:
        cache.to_local()[:, slot - start].copy_(row.to_local())


def softmax_last(s):
    """``torch.softmax(s, dim=-1)``. On a mesh that shards the last
    dimension the max and the sum are reductions over it, each completed
    by a small all-reduce, and exp and divide stay on the shards; DTensor's
    softmax would gather ``s``."""
    if not _shards(s, s.dim() - 1):
        return torch.softmax(s, dim=-1)
    e = torch.exp(s - reduced(s.amax(-1, keepdim=True)))
    return e / reduced(e.sum(-1, keepdim=True))


def logsumexp_last(x):
    """``torch.logsumexp(x, dim=-1)``. On a mesh that shards the last
    dimension it is the max plus the log of the sum of exponentials, each
    completed by a small all-reduce (the max held constant, whose
    gradient is zero), as XLA computes it on vocabulary-sharded logits;
    DTensor's logsumexp would gather ``x``."""
    if not _shards(x, x.dim() - 1):
        return torch.logsumexp(x, dim=-1)
    m = reduced(x.detach().amax(-1, keepdim=True))
    return (m + torch.log(reduced(torch.exp(x - m).sum(-1, keepdim=True)))
            )[..., 0]


def embed_lookup(table, ids):
    """``table[ids]``: rows of a (V, D) table. On a mesh that shards the
    vocabulary, each shard looks up the ids it holds, zeros the others,
    and the partial rows are summed by one all-reduce of the result (XLA's
    vocabulary-parallel gather). DTensor would move the table to D
    shards, an all-to-all of the whole table. ``ids`` is replicated."""
    if not _shards(table, 0):
        return table[ids]
    mesh = table.device_mesh
    start, size = _local_range(table.shape[0], mesh, table.placements, 0)
    rel = (ids.full_tensor() if isinstance(ids, DTensor) else ids) - start
    hit = (rel >= 0) & (rel < size)
    rows = table.to_local()[rel.clamp(0, size - 1)]
    rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
    out = rows.dim() - 1
    pl = [Partial() if isinstance(p, Shard) and p.dim == 0
          else Shard(out) if isinstance(p, Shard) else p
          for p in table.placements]
    return reduced(DTensor.from_local(rows, mesh, pl, run_check=False))
