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
gradient gathered), ``reduced`` (pending partial sums completed),
``grad_reduced`` (a gradient's pending partial sums completed),
``grad_like`` (a gradient placed as its input), ``placed_like`` and
``rows_like`` (a tensor, or its rows, placed as another's). ``on_shards``
runs an op on each device's shards: the chunked attention
(``on_head_shards``), the SSD scan (``on_ssd_shards``), the SSM conv
(``on_conv_shards``), a top-k along the last dimension (``on_rows``).
The sharded forms keep a sharded dimension on its shards where DTensor
would gather it, or where its rule differs between torch 2.11 and 2.13:
``write_slot`` (the decode's cache write of one slot), ``softmax_last``
(the decode's softmax over a sharded last dimension), ``embed_lookup``
(the vocabulary-parallel lookup, forward and backward),
``scatter_rows`` and ``take_rows`` (the MoE's scatter of the routed
copies and its gather back), ``take_last`` (the labels' logits),
``logsumexp_last`` (the cross-entropy's over vocabulary-sharded logits)
and ``mean_last`` (a mean over a sharded last dimension).
On a plain tensor each is what it was without a mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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


class _GradLike(torch.autograd.Function):
    """The identity, whose gradient takes the input's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and grad.placements != ctx.placements:
            grad = _placed(grad, ctx.placements)
        return grad


def grad_like(x):
    """``x`` itself, whose gradient is placed as ``x`` before it flows on
    (a local slice where it arrives replicated): for a tensor whose uses'
    gradients would otherwise meet with placements that the torches add
    in different ways."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _GradLike.apply(x)


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


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def on_shards(fn, mesh, args: tuple, outs: tuple):
    """``fn`` on each device's shards: ``args`` are (tensor, placements)
    pairs, each tensor placed so (a plain tensor or None passes as it
    is) and handed to ``fn`` as its local shard, and ``outs`` the
    placements of ``fn``'s results, which it returns as a tuple. The
    shards are even, as the rules guarantee. An input replicated on a
    mesh axis that shards a result, or on which a result is a partial
    sum, gets a gradient that is a partial sum there (each device's shard
    or summand of the result draws on it). For an op
    independent across its sharded dimensions, XLA's local computation;
    DTensor would reshard each step of a blocked loop, forward and
    backward."""
    split = [any(isinstance(o[md], (Shard, Partial)) for o in outs)
             for md in range(mesh.ndim)]

    def local(t, pl: tuple):
        if not isinstance(t, DTensor):
            return t
        grad = tuple(Partial() if s and isinstance(p, Replicate) else p
                     for s, p in zip(split, pl))
        return _ContiguousGrad.apply((
            t if t.placements == pl else t.redistribute(mesh, pl)
        ).to_local(grad_placements=grad))

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


def on_conv_shards(fn, x, w, b):
    """``fn(x, w, b)``, a depthwise causal conv over x (B, L, C) with
    weights w (W, C) and bias b (C,), independent across batch rows and
    channels. On a mesh it runs on each device's shards (``on_shards``),
    placed by x's batch and channel shards, after x's pending sums are
    completed and its sequence gathered: the rules never shard the
    sequence, whose shard would need the W - 1 rows before it. DTensor
    pads a sharded input in its own way on each torch (2.11 fails
    redistributing it)."""
    if not isinstance(x, DTensor):
        return fn(x, w, b)
    x = gathered(reduced(x), 1)
    pl = x.placements
    return on_shards(lambda *a: (fn(*a),), x.device_mesh, (
        (x, pl), (w, _moved(pl, {2: 1})), (b, _moved(pl, {2: 0}))),
        (pl,))[0]


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


def take_last(x, idx):
    """``x.gather(-1, idx[..., None])[..., 0]``: each row's entry at
    ``idx``. On a mesh each device sums its shard of ``x`` masked to the
    columns it holds that ``idx`` names, and the partial sums are
    completed over the shards: XLA's vocabulary-parallel gather. (DTensor's
    gather would differentiate into zeros of the global shape, replicated
    on every device, and its rule for the mask's comparison of a
    column-sharded index with ``idx`` differs between torches.)"""
    if not isinstance(x, DTensor):
        return x.gather(-1, idx[..., None])[..., 0]
    last, mesh = x.dim() - 1, x.device_mesh
    x = reduced(x)
    start, size = _local_range(x.shape[-1], mesh, x.placements, last)
    rows = tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                 else p for p in x.placements)
    out = tuple(Partial() if isinstance(p, Shard) and p.dim == last
                else p for p in x.placements)

    def pick(xl, il):
        cols = torch.arange(start, start + size, device=xl.device)
        return ((xl * (cols == il[..., None])).sum(-1),)

    return reduced(on_shards(pick, mesh, ((x, x.placements), (idx, rows)),
                             (out,))[0])


def mean_last(x):
    """``x.mean(-1, keepdim=True)``. On a mesh that shards the last
    dimension the partial means are completed by one all-reduce; DTensor
    would carry them on into the ops that use them, where the torches'
    rules differ."""
    if not _shards(x, x.dim() - 1):
        return x.mean(-1, keepdim=True)
    return reduced(x.mean(-1, keepdim=True))


def on_rows(fn, x, n: int):
    """``fn(x)``, an op along x's last dimension, independent across the
    others, that returns ``n`` tensors of x's leading shape (a top-k). On
    a mesh it runs on each device's shards of the leading dimensions,
    after x's pending sums are completed and its last dimension gathered;
    the torches' rules for a sort and its backward (a scatter) differ."""
    if not isinstance(x, DTensor):
        return fn(x)
    x = gathered(reduced(x), x.dim() - 1)
    return on_shards(fn, x.device_mesh, ((x, x.placements),),
                     (x.placements,) * n)


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


def _on_mesh(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor is replicated."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _row_lookup(fn, buf, idx, *extra):
    """``fn(local buf, idx - start, size, *extra)`` on each device's
    shards, for a (M, ...) ``buf`` whose rows ``idx`` selects: ``start``
    and ``size`` are the rows this device holds, and ``fn`` zeros what
    ``idx`` asks of the rows it does not. ``idx`` and ``extra`` (tensors
    of ``idx``'s leading shape) stay on their shards of their first
    dimension, and the result takes those placements there, a partial
    sum on the axes that shard ``buf``'s rows, completed by one
    reduction. Where one axis shards both, ``idx`` and ``extra`` are
    gathered on it and the reduction scatters the result back to its
    shards. ``buf``'s other dimensions and ``idx``'s are gathered (the
    rules shard neither)."""
    mesh = buf.device_mesh
    buf = gathered(reduced(buf), *range(1, buf.dim()))
    idx = _on_mesh(idx, mesh)
    both = {md for md, (b, i) in enumerate(zip(buf.placements,
                                               idx.placements))
            if _shard0(b) and _shard0(i)}
    ipl = tuple(Shard(0) if _shard0(p) and md not in both else Replicate()
                for md, p in enumerate(idx.placements))
    out = tuple(Partial() if _shard0(b) else p
                for b, p in zip(buf.placements, ipl))
    start, size = _local_range(buf.shape[0], mesh, buf.placements, 0)
    res = on_shards(lambda b, i, *x: (fn(b, i - start, size, *x),), mesh,
                    ((buf, buf.placements), (idx, ipl),
                     *((_on_mesh(t, mesh), ipl) for t in extra)),
                    (out,))[0]
    if both:
        res = res.redistribute(mesh, tuple(
            Shard(0) if md in both else p for md, p in enumerate(out)))
    return reduced(res)


def _shard0(p) -> bool:
    """Whether placement ``p`` shards dimension 0."""
    return p == Shard(0)


def _masked_rows(b, rel, size):
    """The rows ``rel`` of ``b``, zeros where ``rel`` is not in [0,
    size)."""
    hit = (rel >= 0) & (rel < size)
    rows = b[rel.clamp(0, size - 1)]
    return torch.where(hit[..., None], rows, torch.zeros_like(rows))


def embed_lookup(table, ids, dtype=None):
    """``table[ids]``: rows of a (V, D) table for ids of any shape, cast to
    ``dtype`` if one is given. On a mesh the table is cast first, on its
    shards, so that the rows' reduction moves the compute dtype. Each
    device looks up, in the rows of the table it holds, the ids it holds,
    zeros the ids it does not hold, and the partial rows are summed by
    one reduction (XLA's vocabulary-parallel gather): the rows
    are sharded as the ids are (a batch on the data axes) and complete
    on the vocabulary's axis. The backward is a local index_add into
    each table shard. DTensor would move the table to D shards (an
    all-to-all of the whole table) or, on torch 2.11, fail on ids
    sharded on several axes and in the backward."""
    if not isinstance(table, DTensor):
        return table[ids] if dtype is None else table[ids].to(dtype)
    if dtype is not None:
        table = table.to(dtype)
    return _row_lookup(_masked_rows, table, ids)


def take_rows(buf, idx, w, k: int):
    """``(buf[idx] * w[:, None]).reshape(-1, k, D).sum(1)``: the rows of a
    (M, D) buffer that ``idx`` (R,) selects, weighted by ``w`` (R,), summed
    over each run of ``k`` (the MoE's gather back of each token's k
    routed copies). On a mesh each device reads the rows it holds for
    the indices it holds, weights and sums them there, and the partial
    sums (N, D) are completed by one reduction (``_row_lookup``): the
    result has ``idx``'s placements on its rows. DTensor's index rule for
    a buffer sharded on its rows depends on the torch: 2.13 moves it to
    D shards by an all-to-all, 2.11 gathers it whole."""
    if not isinstance(buf, DTensor):
        return (buf[idx] * w[:, None]).reshape(-1, k, buf.shape[1]).sum(1)

    def fn(b, rel, size, wl):
        rows = _masked_rows(b, rel, size) * wl[:, None]
        return rows.reshape(-1, k, b.shape[1]).sum(1)

    # w's gradient is a partial sum where the rows are: completed at once.
    return _row_lookup(fn, buf, idx, grad_reduced(w))


def rows_like(x, ref):
    """``x`` on ``ref``'s shards of their first dimension, which they
    share, and replicated on every other axis: a local slice where ``x``
    is replicated. A plain ``ref`` leaves ``x`` as it is."""
    if not isinstance(ref, DTensor):
        return x
    mesh = ref.device_mesh
    pl = tuple(Shard(0) if _shard0(p) else Replicate()
               for p in ref.placements)
    x = _on_mesh(x, mesh)
    return x if x.placements == pl else x.redistribute(mesh, pl)


def placed_like(x, ref):
    """``x`` placed as ``ref``, a tensor of its shape: a local slice where
    ``x`` is replicated and ``ref`` sharded. A plain tensor is left as
    it is."""
    if not isinstance(x, DTensor) or not isinstance(ref, DTensor):
        return x
    return _placed(x, ref.placements)


def _placed(x, pl: tuple):
    """``x`` redistributed to ``pl``, the shards it can cut locally
    (replicated to sharded) cut first, so that the reductions that follow
    move only those shards."""
    cut = tuple(t if isinstance(p, Replicate) and isinstance(t, Shard)
                else p for p, t in zip(x.placements, pl))
    if cut != x.placements:
        x = x.redistribute(x.device_mesh, cut)
    return x if x.placements == pl else x.redistribute(x.device_mesh, pl)


def scatter_rows(idx, src, hint_name: str, shape: tuple):
    """``src.new_zeros((n, D)).index_add_(0, idx, src)``: a buffer of n =
    prod(``shape[:-1]``) rows with each row of ``src`` (R, D) added at row
    ``idx`` (R,) (the MoE's scatter of the routed copies), placed as the
    hint ``hint_name`` places it reshaped to ``shape``, whose first
    dimension is the outermost of the rows. On a mesh it is the transpose
    of ``take_rows``: each device adds, into the rows of the buffer it
    holds under the hint, the copies it holds whose ``idx`` falls there,
    a partial sum on the axes that shard ``src``'s rows, completed by one
    reduction of its shard (XLA's scatter of each shard's rows and its
    all-reduce of the buffer). On an axis that shards the hint's rows
    too, the copies are gathered first: they are fewer than the buffer's
    rows by the capacity factor. No device holds the whole buffer, and
    the backward reads each shard's rows locally; the copies' gradient,
    a partial sum on the axes that shard only the buffer, is completed
    by one reduction of (R, D)."""
    n = math.prod(shape[:-1])
    if not isinstance(src, DTensor):
        return src.new_zeros((n, src.shape[1])).index_add_(0, idx, src)
    mesh = src.device_mesh
    src = grad_reduced(gathered(reduced(src), 1))
    spec = _SPECS.get(hint_name) if _MESH is not None else None
    target = tuple(
        Shard(0) if _shard0(t) else Replicate() for t in (
            NamedSharding(mesh, drop_indivisible(mesh, spec, shape))
            .placements if spec is not None else (Replicate(),) * mesh.ndim))
    pl = tuple(Replicate() if _shard0(p) and _shard0(t) else p
               for p, t in zip(src.placements, target))
    out = tuple(t if _shard0(t) else Partial() if _shard0(p) else p
                for p, t in zip(pl, target))
    start, size = _local_range(n, mesh, target, 0)

    def add(i, s):
        rel = i - start
        hit = ((rel >= 0) & (rel < size))[:, None]
        s = torch.where(hit, s, torch.zeros_like(s))
        return (s.new_zeros((size, s.shape[1])).index_add_(
            0, rel.clamp(0, size - 1), s),)

    return reduced(on_shards(add, mesh, ((idx, pl), (src, pl)), (out,))[0])
