"""The dry run's collective estimate (``launch/roofline.py``'s counter and
wire-bytes model, ``launch/dryrun.py::collective_estimate``) and the
sharded decode step it exposed (``models/pspec.py``'s ``write_slot``,
``softmax_last`` and ``embed_lookup``).

(a) ``_wire_bytes`` kind by kind against the JAX package's. (b) The
counter on a fake world of 16 ranks with a 4 x 4 ``"cuda"`` mesh on
``meta``: each redistribution's kind, count, result bytes and group, the
counts equal to ``CommDebugMode``'s, an unknown collective raising. (c)
The depth fit equals a whole trace. (e) The decode step's three sites
issue no gather of the cache, the scores or the table; the prefill's and
the train step's blocked loops (chunked attention, SSD scan) issue no
collective; on plain tensors the helpers are the old expressions bit for
bit. (f) The sharded decode step's values, and the sharded prefill's and
train step's, on a real 2 x 2 gloo world of four processes equal the
plain ones. (d), against XLA's collectives, and phase 18's pins are in
``tests/test_torch_dryrun_mesh.py``, beside the runs they share.
"""
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import (  # noqa: E402
    Partial, Replicate, Shard, distribute_tensor,
)
from torch.distributed.tensor.debug import CommDebugMode  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import (  # noqa: E402
    attention, decode_step, init_model, layers, moe, pspec, ssm, transformer,
)
from repro_torch.training import train_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.fixture(scope="module", autouse=True)
def no_world_left():
    assert not dist.is_initialized()
    yield
    pspec.set_mesh(None)
    assert not dist.is_initialized(), "a test left a process group"


# ---- (a) the wire-bytes model, against JAX's -------------------------------

@pytest.mark.parametrize("g", [1, 2, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_equal_jax(kind, g):
    for rb in (0, 8, 16 * 4096 * 128 * 2, 256 * 1024 * 4):
        assert rl._wire_bytes(kind, rb, g) == jroofline._wire_bytes(
            kind, rb, g)
    assert rl._COLL_KINDS == jroofline._COLL_KINDS == KINDS


def test_empty_collectives_has_parse_collectives_keys():
    assert rl.empty_collectives() == jroofline.parse_collectives("")


def test_roofline_collective_term():
    t = rl.roofline_terms(0.0, 0.0, rl.LINK_BW)
    assert t["collective_s"] == 1.0 and t["dominant"] == "collective_s"


# ---- (b) the counter on a fake world of 16 ---------------------------------

@pytest.fixture()
def mesh16():
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    try:
        yield init_device_mesh("cuda", (4, 4),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _placed(mesh, placements, shape=(64, 32)):
    return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                             placements, src_data_rank=None)


def _partial(mesh, placements, shape=(64, 32)):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(torch.empty(shape, device="meta"), mesh,
                              placements, run_check=False)


# (source placements, target placements, partial source, kind, result
# shape on rank 0): a (64, 32) f32 tensor, each move on one axis of 4.
MOVES = {
    "shard_to_replicate": ([Shard(0), Replicate()], [Replicate()] * 2,
                           False, "all-gather", (64, 32)),
    "partial_to_shard": ([Partial(), Replicate()], [Shard(0), Replicate()],
                         True, "reduce-scatter", (16, 32)),
    "partial_to_replicate": ([Replicate(), Partial()], [Replicate()] * 2,
                             True, "all-reduce", (64, 32)),
    "shard0_to_shard1": ([Replicate(), Shard(0)], [Replicate(), Shard(1)],
                         False, "all-to-all", (64, 8)),
}


@pytest.mark.parametrize("move", sorted(MOVES))
def test_counter_on_each_redistribution(mesh16, move):
    src, dst, partial, kind, out_shape = MOVES[move]
    x = (_partial if partial else _placed)(mesh16, src)
    with rl.count_collectives() as got:
        y = x.redistribute(mesh16, dst)
    assert tuple(y.to_local().shape) == out_shape
    rb = 4 * out_shape[0] * out_shape[1]
    want = rl.empty_collectives()
    want[kind] = {"count": 1, "result_bytes": rb,
                  "wire_bytes": jroofline._wire_bytes(kind, rb, 4)}
    assert got == want
    with CommDebugMode() as comm:
        x.redistribute(mesh16, dst)
    assert comm.get_total_counts() == 1


def test_counts_equal_comm_debug_mode(mesh16):
    """A block of several moves and ops with DTensor's own collectives in
    them: the counter's total equals CommDebugMode's, kind for kind."""
    def block():
        a = _placed(mesh16, [Shard(0), Shard(1)])
        w = _placed(mesh16, [Replicate(), Shard(0)], (32, 16))
        z = a @ w                                   # partial on 'model'
        z = z.redistribute(mesh16, [Replicate(), Replicate()])
        b = a.redistribute(mesh16, [Shard(1), Shard(0)])
        return torch.softmax(b, dim=0) + z.sum()

    with rl.count_collectives() as got:
        block()
    with CommDebugMode() as comm:
        block()
    by_kind = {}
    for op, n in comm.get_comm_counts().items():
        name = str(op).split(".")[-1].split("'")[0]
        k = rl._OP_KINDS[name]
        by_kind[k] = by_kind.get(k, 0) + n
    assert {k: v["count"] for k, v in got.items() if v["count"]} == by_kind
    assert sum(by_kind.values()) >= 4


def test_an_unknown_collective_raises(mesh16):
    x = torch.empty(8, 4, device="meta")
    group = mesh16.get_group("model").group_name
    with pytest.raises(NotImplementedError, match="no kind"):
        with rl.count_collectives():
            torch.ops._c10d_functional.broadcast(x, 0, group)


def test_the_production_mesh_keeps_all_to_all():
    """The production mesh is a ``"cuda"`` mesh: DTensor issues its
    Shard -> Shard all-to-all there (on a ``"cpu"`` mesh it would gather
    and chunk instead), so the CPU and the card count the same op."""
    with dryrun._world(256):
        mesh = make_production_mesh()
        assert mesh.device_type == "cuda"
        x = _placed(mesh, [Replicate(), Shard(0)])
        with rl.count_collectives() as got:
            x.redistribute(mesh, [Replicate(), Shard(1)])
    assert got["all-to-all"]["count"] == 1
    assert got["all-gather"]["count"] == 0


# ---- (c) the depth fit is exact --------------------------------------------

@pytest.mark.parametrize("arch,kind", [("olmo-1b", "decode"),
                                       ("olmo-1b", "train"),
                                       ("mamba2-370m", "decode")])
def test_depth_fit_equals_the_whole_trace(arch, kind):
    """At SMOKE widths and 5 layer units, the estimate fitted from the
    traces at 2 and 3 units equals the count of a whole trace, kind by
    kind; so do the fitted argument and output bytes."""
    cfg = dryrun._depth_variant(configs.get_smoke(arch), 5)
    shape = InputShape("s", *{"decode": (64, 32),
                              "train": (32, 256)}[kind], kind)
    with dryrun._world(256):
        mesh = make_production_mesh()
        pspec.set_mesh(mesh, sharding.activation_hint_specs(mesh))
        try:
            est, total = dryrun.collective_estimate(cfg, shape, mesh, True)
            whole, colls = dryrun._mesh_trace(cfg, shape, mesh, True, "",
                                              "tp", "model")
            fit, _ = dryrun.mesh_cost(cfg, shape, mesh)
        finally:
            pspec.set_mesh(None)
    assert est == colls
    assert total == sum(c["wire_bytes"] for c in colls.values()) > 0
    assert (fit.argument_bytes, fit.output_bytes) == (
        whole.argument_bytes, whole.output_bytes)


# ---- (e) the decode step's three sites -------------------------------------

def test_the_sharded_decode_gathers_no_cache_score_or_table():
    """SMOKE olmo-1b's decode step on the 16 x 16 fake mesh, its caches'
    W and its table's vocabulary sharded on 'model': no all-to-all; every
    all-gather is an explicit one of ``pspec`` (the token, the heads
    before a split, a K/V row), none in the softmax or the lookup, and
    each smaller than the gather of a layer's cache the slot write used
    to make; the lookup's one all-reduce is of (B, 1, D)."""
    cfg = configs.get_smoke("olmo-1b")
    shape = InputShape("d", 64, 32, "decode")
    with dryrun._world(256), rl.record_sites() as records:
        mesh = make_production_mesh()
        pspec.set_mesh(mesh, sharding.activation_hint_specs(mesh))
        try:
            _, colls = dryrun._mesh_trace(cfg, shape, mesh, True, "", "tp",
                                          "model")
        finally:
            pspec.set_mesh(None)
    seen = [(r["kind"], r["shape"], r["helper"]) for r in records]
    B, W = shape.global_batch, shape.seq_len
    gathered_cache = (B // 16) * W * cfg.num_kv_heads * cfg.hd * 4
    gathers = [(s, w) for k, s, w in seen if k == "all-gather"]
    assert colls["all-to-all"]["count"] == 0
    assert gathers and all(4 * torch.Size(s).numel() < gathered_cache
                           for s, _ in gathers)
    assert {w for _, w in gathers} <= {"gathered", "reshaped", "write_slot"}
    assert [s for k, s, w in seen if w == "embed_lookup"] == [
        (B, 1, cfg.d_model)]
    assert [k for k, _, w in seen if w == "embed_lookup"] == ["all-reduce"]
    # The max and the sum of each layer's softmax, and its P.V.
    assert [k for k, _, w in seen if w == "softmax_last"] == [
        "all-reduce"] * 2 * cfg.num_layers


# ---- a version guard: the ops whose rules differ between torches ----------

# The aten ops whose DTensor rules place a sharded operand differently on
# torch 2.11 (the card's) and 2.13: the model runs each of them on local
# shards, so neither torch's rule decides a collective.
VERSIONED = ("aten.index.Tensor", "aten.index_put.default",
             "aten.index_put_.default", "aten._index_put_impl_.default",
             "aten.index_add.default", "aten.index_add_.default",
             "aten.constant_pad_nd.default")


@pytest.mark.parametrize("arch,kind,multi_pod,ep_axis", [
    ("dbrx-132b", "decode", False, "model"),
    ("dbrx-132b", "decode", True, "data"),
    ("mamba2-370m", "decode", False, "model"),
    ("olmo-1b", "prefill", True, "model"),
    ("mamba2-370m", "prefill", False, "model"),
    ("zamba2-2.7b", "train", False, "model"),
    ("dbrx-132b", "train", False, "model"),
    ("olmo-1b", "train", True, "model")])
def test_no_versioned_op_sees_a_sharded_operand(monkeypatch, arch, kind,
                                                multi_pod, ep_axis):
    """Every aten op that reaches DTensor's sharding propagation in the
    decode (the MoE's and the SSM's), prefill and train step (the lookup
    and its backward, the SSM conv, the MoE dispatch, forward and
    backward) at FULL widths and two layer units, on small shapes of the
    fake production meshes (the rules shard what they shard at full
    size): none of ``VERSIONED`` sees an operand with a ``Shard``
    placement. The propagator is spied on where torch 2.13 runs it
    (``propagate_op_sharding_non_cached``, behind its cache, which is
    cleared)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.utils._pytree import tree_leaves

    prop = DTensor._op_dispatcher.sharding_propagator
    real = prop.propagate_op_sharding_non_cached
    seen = []

    def spy(op_schema):
        specs = [a for a in tree_leaves((op_schema.args_schema,
                                         op_schema.kwargs_schema))
                 if isinstance(a, DTensorSpec)]
        seen.append((str(op_schema.op), any(
            isinstance(p, Shard) for a in specs for p in a.placements)))
        return real(op_schema)

    monkeypatch.setattr(prop, "propagate_op_sharding_non_cached", spy)
    prop.propagate_op_sharding.cache_clear()
    cfg = dryrun._depth_variant(configs.get_config(arch), 2)
    shape = InputShape("s", *{"decode": (64, 32), "prefill": (64, 32),
                              "train": (32, 256)}[kind], kind)
    try:
        with dryrun._world(512):
            mesh = make_production_mesh(multi_pod=multi_pod)
            pspec.set_mesh(mesh, sharding.activation_hint_specs(
                mesh, "tp", ep_axis))
            try:
                dryrun._mesh_trace(cfg, shape, mesh, True, "", "tp", ep_axis)
            finally:
                pspec.set_mesh(None)
    finally:
        prop.propagate_op_sharding.cache_clear()
    assert any(op == "aten.mm.default" for op, _ in seen)
    assert [op for op, sharded in seen if sharded and op in VERSIONED] == []


def test_the_site_probe_names_each_collectives_site():
    """``launch/sites.py`` on SMOKE olmo-1b's decode on the 16 x 16 fake
    mesh: its total is the counter's, each kind's bytes are the sum over
    its sites, and the lookup's all-reduce is named by its helper."""
    from repro_torch.launch import sites

    r = sites.probe("olmo-1b", "decode_32k", seq_len=64, batch=32,
                    smoke=True)
    assert r["ok"] and r["total_wire_bytes"] == sum(r["wire_bytes"].values())
    for kind, wire in r["wire_bytes"].items():
        assert wire == pytest.approx(sum(
            x["wire_bytes"] for x in r["sites"] if x["kind"] == kind),
            rel=1e-12)
    assert any(x["kind"] == "all-reduce" and "[embed_lookup]" in x["site"]
               for x in r["sites"])


# ---- the sequence forms: no collective inside a blocked loop ----------------

def _meta(mesh, shape, placements):
    return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                             placements, src_data_rank=None)


@pytest.mark.parametrize("op", ["attention", "ssd"])
def test_blocked_loops_issue_no_collective(op):
    """The chunked attention (4 x 4 blocks of 512 positions) and the SSD
    scan (8 chunks) on DTensors placed as the model's projections leave
    them on the 16 x 16 fake mesh (batch on 'data', heads on 'model'; the
    SSD's B and C whole on 'model'), forward and backward: no collective
    at all (DTensor resharded every (q, kv) block pair and every chunk,
    each way). The gradients take the inputs' placements, but for a
    partial sum on each mesh axis an input is whole on and a result is
    sharded on."""
    with dryrun._world(256):
        mesh = make_production_mesh()
        bh, b = [Shard(0), Shard(2)], [Shard(0), Replicate()]
        if op == "attention":
            S = 2048
            ins = [_meta(mesh, (32, S, 16, 8), bh) for _ in range(3)]
            pos = torch.arange(S, device="meta")

            def run(q, k, v):
                return (attention.chunked_attention(q, k, v, pos, pos),)
        else:
            L, H, P, N = 128, 16, 8, 4
            ins = [_meta(mesh, (32, L, H, P), bh),
                   _meta(mesh, (32, L, H), bh),
                   _meta(mesh, (H,), [Replicate(), Shard(0)]),
                   _meta(mesh, (32, L, N), b), _meta(mesh, (32, L, N), b),
                   _meta(mesh, (H,), [Replicate(), Shard(0)])]

            def run(*a):
                return ssm.ssd_chunked(*a, chunk=16)
        ins = [t.requires_grad_() for t in ins]
        with rl.count_collectives() as got:
            outs = run(*ins)
            grads = torch.autograd.grad([o.sum() for o in outs], ins)
        placements = [t.placements for t in ins]
    assert got == rl.empty_collectives()
    assert outs[0].placements == tuple(bh)
    if op == "ssd":
        # A and D are the same on every batch shard, B and C on every
        # head shard: their gradients are partial sums there.
        placements[2] = placements[5] = (Partial(), Shard(0))
        placements[3] = placements[4] = (Shard(0), Partial())
    assert [g.placements for g in grads] == placements


@pytest.mark.parametrize("arch,lengths", [("olmo-1b", (1024, 2048)),
                                          ("mamba2-370m", (64, 128))])
def test_prefill_collectives_do_not_grow_with_the_blocks(arch, lengths):
    """SMOKE prefill on the 16 x 16 fake mesh: each kind's count of
    collectives is the same at two sequence lengths with twice as many
    attention blocks or SSD chunks, and the all-reduces are Megatron's,
    one where each sub-block ends, the SSM's gated norm's mean square
    over its channel shards, and the lookup's one (a vocabulary-parallel
    gather, which moves no table)."""
    cfg = configs.get_smoke(arch)
    counts = []
    with dryrun._world(256):
        mesh = make_production_mesh()
        pspec.set_mesh(mesh, sharding.activation_hint_specs(mesh))
        try:
            for seq in lengths:
                _, colls = dryrun._mesh_trace(
                    cfg, InputShape("s", seq, 32, "prefill"), mesh, True,
                    "", "tp", "model")
                counts.append({k: c["count"] for k, c in colls.items()})
        finally:
            pspec.set_mesh(None)
    assert counts[0] == counts[1]
    per_layer = 2  # attention and MLP; or the SSM block and its norm
    assert counts[0]["all-reduce"] == per_layer * cfg.num_layers + 1
    assert counts[0]["all-to-all"] == 0


def _old_write(cache, slot, row):
    cache[:, slot] = row


def _old_scatter(idx, src, hint_name, shape):
    n = math.prod(shape[:-1])
    zeros = torch.zeros_like(src[:1].expand(n, src.shape[1]),
                             memory_format=torch.contiguous_format)
    return zeros.index_add_(0, idx, src)


def _old_take(buf, idx, w, k):
    return (buf[idx] * w[:, None]).reshape(-1, k, buf.shape[1]).sum(1)


def _old_lookup(table, ids, dtype=None):
    rows = table[ids]
    return rows if dtype is None else rows.to(dtype)


def _old_cross_entropy(h, w_head, labels, mask, block=512):
    S = h.shape[1]
    block = min(block, S)
    assert S % block == 0, (S, block)
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, block):
        sl = slice(i, i + block)
        nll, m = torch.utils.checkpoint.checkpoint(
            transformer._ce_block, h[:, sl], w_head, labels[:, sl],
            mask[:, sl], use_reentrant=False)
        nll_sum = nll_sum + nll
        m_sum = m_sum + m
    return nll_sum, m_sum


def _old_padded_scan(scan):
    """``scan`` (``ssd_chunked``) called as the SSM block called it: its
    flat input, dt, B and C padded to a chunk multiple outside it, and y
    cut back after."""
    def padded(x, dt, A, B_in, C_in, D_skip, chunk, h0=None):
        Bb, L, H, P = x.shape
        pad = (-L) % chunk
        xs, B_in, C_in, dt = (F.pad(t, (0, 0, 0, pad)) for t in (
            x.reshape(Bb, L, H * P), B_in, C_in, dt))
        y, h = scan(xs.reshape(Bb, L + pad, H, P), dt, A, B_in, C_in,
                    D_skip, chunk, h0)
        return y[:, :L], h
    return padded


def _old_expressions(monkeypatch):
    """Every site of the model code that runs through a ``pspec`` helper
    for the sharded model on either torch replaced by the expression it
    replaced: the lookups (index, then cast), the SSM conv and the scan's
    padding outside it, the skip term's product, the MoE's top-k, aux
    loss, scatter into zeros and gather back, the norm's mean square, the
    cross-entropy's sums from zeros, and the train step's gradients."""
    identity = lambda x: x  # noqa: E731
    monkeypatch.setattr(transformer, "embed_lookup", _old_lookup)
    monkeypatch.setattr(transformer, "reduced", identity)
    monkeypatch.setattr(transformer, "chunked_cross_entropy",
                        _old_cross_entropy)
    monkeypatch.setattr(ssm, "on_conv_shards", lambda fn, *a: fn(*a))
    monkeypatch.setattr(ssm, "ssd_chunked", _old_padded_scan(ssm.ssd_chunked))
    monkeypatch.setattr(ssm, "placed_like", lambda x, ref: x)
    monkeypatch.setattr(moe, "on_rows", lambda fn, x, n: fn(x))
    monkeypatch.setattr(moe, "reduced", identity)
    monkeypatch.setattr(moe, "grad_like", identity)
    monkeypatch.setattr(moe, "scatter_rows", _old_scatter)
    monkeypatch.setattr(moe, "take_rows", _old_take)
    monkeypatch.setattr(moe, "rows_like", lambda x, ref: x)
    monkeypatch.setattr(layers, "mean_last",
                        lambda x: x.mean(-1, keepdim=True))
    monkeypatch.setattr(layers, "grad_reduced", identity)
    monkeypatch.setattr(train_step, "reduced", identity)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_plain_decode_is_the_old_expressions(monkeypatch, arch):
    """On plain CPU tensors the decode step through the new helpers is
    bit for bit the step through the expressions they replaced (the slot
    assignment, ``torch.softmax``, ``table[ids]``, no reduction, the MoE's
    scatter into zeros and its gather back, the SSM skip term's product),
    logits and every cache, for every architecture over a prefill and 3
    tokens."""
    cfg = configs.get_smoke(arch)
    params = init_model(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    frames = (torch.randn(2, 16, cfg.frontend_dim or cfg.d_model,
                          generator=gen) if cfg.is_encdec else None)

    def run():
        logits, caches = transformer.prefill(params, cfg, tokens,
                                             encoder_frames=frames,
                                             cache_len=12, impl="einsum")
        outs = [logits]
        for i in range(3):
            logits, caches = decode_step(params, cfg, tokens[:, i:i + 1],
                                         caches, impl="einsum")
            outs.append(logits)
        return outs + [t for t in caches if isinstance(t, torch.Tensor)]

    new = run()
    monkeypatch.setattr(attention, "write_slot", _old_write)
    monkeypatch.setattr(attention, "softmax_last",
                        lambda s: torch.softmax(s, dim=-1))
    monkeypatch.setattr(attention, "reduced", lambda x: x)
    _old_expressions(monkeypatch)
    old = run()
    assert len(new) == len(old)
    assert all(torch.equal(a, b) for a, b in zip(new, old))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_plain_prefill_and_train_are_the_old_expressions(monkeypatch, arch):
    """On plain CPU tensors the sequence forms through the new helpers
    (every site ``_old_expressions`` names) are bit for bit the
    expressions they replaced: prefill_forward's logits and every cache,
    forward_train's loss and every gradient, and a train step's loss,
    metrics and new parameters and moments, for every architecture."""
    cfg = configs.get_smoke(arch)
    params = init_model(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.is_encdec:
        batch["encoder_frames"] = torch.randn(
            2, 16, cfg.frontend_dim or cfg.d_model, generator=gen)
    elif cfg.frontend_tokens > 0:
        batch["frontend"] = torch.randn(2, cfg.frontend_tokens,
                                        cfg.frontend_dim, generator=gen)

    def run():
        logits, caches = transformer.prefill_forward(
            params, cfg, tokens, frontend=batch.get("frontend"),
            encoder_frames=batch.get("encoder_frames"), impl="chunked")
        p = {k: v for k, v in params.items()}
        leaves = [t.detach().requires_grad_()
                  for t in transformer.tree.leaves(p)]
        p = transformer.tree.unflatten(p, leaves)
        loss, _ = transformer.forward_train(p, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        state, metrics = train_step.make_train_step(cfg, warmup_steps=1)(
            train_step.train_state_init(params), batch)
        return ([logits, loss] + list(grads)
                + [t for t in caches if isinstance(t, torch.Tensor)]
                + [torch.as_tensor(v) for _, v in sorted(metrics.items())]
                + [t for tr in (state.params, state.opt.mu, state.opt.nu)
                   for t in transformer.tree.leaves(tr)])

    new = run()
    _old_expressions(monkeypatch)
    old = run()
    assert len(new) == len(old)
    assert all(torch.equal(a, b) for a, b in zip(new, old))


def test_helpers_on_plain_tensors_are_the_old_expressions():
    gen = torch.Generator().manual_seed(0)
    s = torch.randn(2, 4, 3, 40, generator=gen)
    assert torch.equal(pspec.softmax_last(s), torch.softmax(s, dim=-1))
    table = torch.randn(50, 8, generator=gen)
    ids = torch.randint(0, 50, (4, 1), generator=gen)
    assert torch.equal(pspec.embed_lookup(table, ids), table[ids])
    cache, row = torch.zeros(2, 6, 3, 5), torch.randn(2, 3, 5, generator=gen)
    want = cache.clone()
    want[:, 4] = row
    pspec.write_slot(cache, 4, row)
    assert torch.equal(cache, want)
    assert pspec.reduced(s) is s
    assert torch.equal(pspec.logsumexp_last(s), torch.logsumexp(s, dim=-1))
    assert pspec.grad_reduced(s.requires_grad_()) is s
    assert pspec.on_head_shards(lambda *a: a, s, cache, row) == (
        s, cache, row)
    assert pspec.on_ssd_shards(lambda *a: a, s, cache, row, 1, 2, 3,
                               None) == (s, cache, row, 1, 2, 3, None)
    assert pspec.on_conv_shards(lambda *a: a, s, cache, row) == (
        s, cache, row)
    assert pspec.placed_like(s, cache) is s
    assert pspec.rows_like(ids, s) is ids
    # The sequence forms' lookup, and the MoE's scatter and gather back.
    ids = torch.randint(0, 50, (3, 7), generator=gen)
    assert torch.equal(pspec.embed_lookup(table, ids), table[ids])
    idx = torch.randint(0, 12, (10,), generator=gen)
    src, w = torch.randn(10, 8, generator=gen), torch.rand(10, generator=gen)
    want = torch.zeros_like(src[:1].expand(12, 8),
                            memory_format=torch.contiguous_format)
    assert torch.equal(pspec.scatter_rows(idx, src, "moe_buffer", (4, 3, 8)),
                       want.index_add_(0, idx, src))
    buf = torch.randn(12, 8, generator=gen)
    assert torch.equal(pspec.take_rows(buf, idx, w, 2),
                       (buf[idx] * w[:, None]).reshape(5, 2, 8).sum(1))


# ---- (f) the sharded decode's values on a real 2 x 2 world -----------------

_WORKER = r"""
import sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs
from repro_torch.launch import sharding
from repro_torch.models import decode_step, init_caches, init_model, pspec

rank, store, arch = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    pspec.set_mesh(mesh, sharding.activation_hint_specs(mesh))
    cfg = configs.get_smoke(arch)
    B, W, first, steps = 4, 16, 5, 14
    params = init_model(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(7)
    plain = init_caches(cfg, B, W, device="cpu")
    names = [n for n in plain._fields
             if isinstance(getattr(plain, n), torch.Tensor)]
    plain = plain._replace(pos=first, **{
        n: torch.randn(getattr(plain, n).shape, generator=gen)
        for n in names})
    tokens = torch.randint(0, cfg.vocab_size, (B, steps), generator=gen)
    psh = sharding.tree_param_shardings(mesh, params)
    tsh, csh = sharding.cache_shardings(mesh, cfg, tokens[:, :1], plain)
    dparams = sharding.shard_tree(params, psh)
    dcaches = sharding.shard_tree(plain._replace(**{
        n: getattr(plain, n).clone() for n in names}), csh)
    if plain.k is not None:
        assert Shard(2) in dcaches.k.placements, dcaches.k.placements
    if plain.ssm_h is not None:
        assert Shard(2) in dcaches.ssm_h.placements, dcaches.ssm_h.placements
    assert Shard(0) in dparams["embed"].placements
    worst, slots = 0.0, []
    for i in range(steps):
        slots.append(plain.pos % W)
        want, plain = decode_step(params, cfg, tokens[:, i:i + 1], plain,
                                  impl="einsum")
        tok = sharding.shard_tree(tokens[:, i:i + 1], tsh)
        with implicit_replication():
            got, dcaches = decode_step(dparams, cfg, tok, dcaches,
                                       impl="einsum")
        for a, b in [(got, want)] + [(getattr(dcaches, n), getattr(plain, n))
                                     for n in names]:
            worst = max(worst, float((a.full_tensor() - b).abs().max()))
        assert dcaches.pos == plain.pos
    print("RESULT", rank, worst, sorted(set(slots)), flush=True)
finally:
    pspec.set_mesh(None)
    dist.destroy_process_group()
"""


def _on_a_2x2_world(tmp_path, worker, *args):
    """The RESULT lines (split) that ``worker`` prints in each of four
    gloo processes, one per rank, every one of which must exit 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", worker, str(r), store,
                               *args],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        finally:
            p.kill()
        assert p.returncode == 0, out[-2000:] + err[-3000:]
        outs.append(out)
    results = [line.split() for o in outs for line in o.splitlines()
               if line.startswith("RESULT")]
    assert sorted(int(r[1]) for r in results) == [0, 1, 2, 3]
    return results


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m", "dbrx-132b"])
def test_sharded_decode_equals_the_plain_step(tmp_path, arch):
    """SMOKE decode_step on DTensors placed by the rules on a real (2, 2)
    ('data', 'model') gloo world of four processes (W, the SSM heads, the
    experts and the vocabulary sharded on 'model', the batch on 'data'):
    logits and every cache equal the plain step within 1e-5 at 14
    consecutive positions, whose slots 5..15, 0..2 fall on both W shards
    and wrap the ring; mamba2-370m's skip term on the head shards
    (``pspec.placed_like``), dbrx-132b's MoE dispatch on the copies'
    shards (``pspec.scatter_rows``, ``take_rows``)."""
    results = _on_a_2x2_world(tmp_path, _WORKER, arch)
    for r in results:
        assert float(r[2]) <= 1e-5, r
        assert "0," in " ".join(r[3:]) and "15]" in r[-1]


_SEQ_WORKER = r"""
import sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs, tree
from repro_torch.launch import sharding
from repro_torch.models import init_model, prefill_forward, pspec
from repro_torch.models.transformer import forward_train

rank, store, arch = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def err(got, want):
    return max(float((whole(a) - b).abs().max()) for a, b in zip(got, want))


try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    pspec.set_mesh(mesh, sharding.activation_hint_specs(mesh))
    cfg = configs.get_smoke(arch)
    params = init_model(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    dparams = sharding.shard_tree(
        params, sharding.tree_param_shardings(mesh, params))
    dbatch = sharding.shard_tree(
        batch, sharding.train_batch_shardings(mesh, batch))
    want_l, want_c = prefill_forward(params, cfg, tokens, impl="chunked")
    with implicit_replication():
        got_l, got_c = prefill_forward(dparams, cfg, dbatch["tokens"],
                                       impl="chunked")
    keep = [i for i, t in enumerate(want_c) if isinstance(t, torch.Tensor)]
    prefill = err([got_l] + [got_c[i] for i in keep],
                  [want_l] + [want_c[i] for i in keep])

    def loss_and_grads(p, b):
        p = tree.map_tree(lambda t: t.detach().requires_grad_(), p)
        loss, _ = forward_train(p, cfg, b, remat=True)
        return [loss] + list(torch.autograd.grad(
            loss, list(tree.leaves(p)), allow_unused=True,
            materialize_grads=True))

    want = loss_and_grads(params, batch)
    with implicit_replication():
        got = loss_and_grads(dparams, dbatch)
    # Each gradient leaf against its largest entry.
    train = max(float((whole(a) - b).abs().max())
                / max(float(b.abs().max()), 1e-30)
                for a, b in zip(got, want))
    print("RESULT", rank, prefill, train, flush=True)
finally:
    pspec.set_mesh(None)
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m", "zamba2-2.7b",
                                  "dbrx-132b"])
def test_sharded_prefill_and_train_equal_the_plain_ones(tmp_path, arch):
    """SMOKE prefill_forward (chunked) and a train step's loss and
    gradients (with remat) on DTensors placed by the rules on a real
    (2, 2) gloo world, with the blocked attention and the SSD scan on
    each device's shards (``pspec.on_shards``), the sub-blocks' partial
    sums completed (``reduced``, ``grad_reduced``) and the CE's
    logsumexp on vocabulary shards: the prefill's logits and caches
    within 1e-5 of the plain ones, the loss and each gradient leaf within
    1e-5 of its largest entry."""
    for r in _on_a_2x2_world(tmp_path, _SEQ_WORKER, arch):
        assert float(r[2]) <= 1e-5 and float(r[3]) <= 1e-5, r


def test_write_slot_writes_only_the_shard_that_holds_the_slot():
    """On a 16 x 16 mesh of the fake world (a ``"cpu"`` one, to hold
    values) rank 0 holds the first of W's 16 shards: a slot in it is
    written into rank 0's local tensor at its offset, a slot past it is
    not, and a row already replicated needs no collective."""
    with dryrun._world(256):
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        B, W, KV, hd = 32, 64, 4, 8
        cache = distribute_tensor(torch.zeros(B, W, KV, hd), mesh,
                                  [Shard(0), Shard(1)], src_data_rank=None)
        row = distribute_tensor(torch.ones(B, KV, hd), mesh,
                                [Replicate(), Replicate()],
                                src_data_rank=None)
        with rl.count_collectives() as got:
            pspec.write_slot(cache, 2, row)
            pspec.write_slot(cache, 9, row)
        local = cache.to_local()
    assert local.shape == (2, 4, KV, hd)
    assert bool((local[:, 2] == 1).all())
    assert float(local.sum()) == 2 * KV * hd
    assert got == rl.empty_collectives()
