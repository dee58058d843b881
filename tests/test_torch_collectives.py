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
import os
import subprocess
import sys
import traceback

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
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
    attention, decode_step, init_model, pspec, ssm, transformer,
)

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

def _sites(monkeypatch):
    """Records (kind, result shape, the pspec function it ran in) of each
    collective the counter counts."""
    seen = []
    real = rl._CollectiveCounter._count

    def spy(self, func, args, kwargs, result):
        before = {k: v["count"] for k, v in self.out.items()}
        real(self, func, args, kwargs, result)
        kind = next((k for k, v in self.out.items()
                     if v["count"] != before[k]), None)
        if kind is not None:
            where = [f.name for f in traceback.extract_stack()
                     if f.filename.endswith(os.path.join("models",
                                                         "pspec.py"))]
            seen.append((kind, tuple(result.shape),
                         where[0] if where else None))

    monkeypatch.setattr(rl._CollectiveCounter, "_count", spy)
    return seen


def test_the_sharded_decode_gathers_no_cache_score_or_table(monkeypatch):
    """SMOKE olmo-1b's decode step on the 16 x 16 fake mesh, its caches'
    W and its table's vocabulary sharded on 'model': no all-to-all; every
    all-gather is an explicit one of ``pspec`` (the token, the heads
    before a split, a K/V row), none in the softmax or the lookup, and
    each smaller than the gather of a layer's cache the slot write used
    to make; the lookup's one all-reduce is of (B, 1, D)."""
    cfg = configs.get_smoke("olmo-1b")
    shape = InputShape("d", 64, 32, "decode")
    seen = _sites(monkeypatch)
    with dryrun._world(256):
        mesh = make_production_mesh()
        pspec.set_mesh(mesh, sharding.activation_hint_specs(mesh))
        try:
            _, colls = dryrun._mesh_trace(cfg, shape, mesh, True, "", "tp",
                                          "model")
        finally:
            pspec.set_mesh(None)
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
    one where each sub-block ends."""
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
    per_layer = 2 if cfg.arch_type == "dense" else 1
    assert counts[0]["all-reduce"] == per_layer * cfg.num_layers


def _old_write(cache, slot, row):
    cache[:, slot] = row


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_plain_decode_is_the_old_expressions(monkeypatch, arch):
    """On plain CPU tensors the decode step through the new helpers is
    bit for bit the step through the expressions they replaced (the slot
    assignment, ``torch.softmax``, ``table[ids]``, no reduction), logits
    and every cache, for every architecture over a prefill and 3
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
    monkeypatch.setattr(transformer, "reduced", lambda x: x)
    monkeypatch.setattr(transformer, "embed_lookup", lambda t, i: t[i])
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

rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    pspec.set_mesh(mesh, sharding.activation_hint_specs(mesh))
    cfg = configs.get_smoke("olmo-1b")
    B, W, first, steps = 4, 16, 5, 14
    params = init_model(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(7)
    plain = init_caches(cfg, B, W, device="cpu")
    plain = plain._replace(k=torch.randn(plain.k.shape, generator=gen),
                           v=torch.randn(plain.v.shape, generator=gen),
                           pos=first)
    tokens = torch.randint(0, cfg.vocab_size, (B, steps), generator=gen)
    psh = sharding.tree_param_shardings(mesh, params)
    tsh, csh = sharding.cache_shardings(mesh, cfg, tokens[:, :1], plain)
    dparams = sharding.shard_tree(params, psh)
    dcaches = sharding.shard_tree(plain._replace(k=plain.k.clone(),
                                                 v=plain.v.clone()), csh)
    assert Shard(2) in dcaches.k.placements, dcaches.k.placements
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
        for a, b in ((got, want), (dcaches.k, plain.k),
                     (dcaches.v, plain.v)):
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


def test_sharded_decode_equals_the_plain_step(tmp_path):
    """SMOKE olmo-1b's decode_step on DTensors placed by the rules on a
    real (2, 2) ('data', 'model') gloo world of four processes (W and the
    vocabulary sharded on 'model', the batch on 'data'): logits and both
    caches equal the plain step within 1e-5 at 14 consecutive positions,
    whose slots 5..15, 0..2 fall on both W shards and wrap the ring."""
    results = _on_a_2x2_world(tmp_path, _WORKER)
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
