"""The port's dry run on the production mesh (``launch/dryrun.py``):
per-device memory from the DTensor trace, and the collective estimate.

Against XLA where the JAX reference compiles here (combos that reach no
activation hint): JAX's dry run runs in a subprocess, as
``tests/test_dryrun_e2e.py`` runs it, once per combo for the module, and
the port's per-device argument bytes equal XLA's
``argument_size_in_bytes``; for the two decode combos the JAX run counts
its collectives too, and the port's wire bytes per device are within 3x
of XLA's. Where the JAX reference raises on this JAX (every train and MoE
combo: its hints refer to the ``Explicit`` axes ``jax.make_mesh`` makes),
the port's argument bytes equal the sum of shard-shape bytes under JAX's
own shardings on an ``AbstractMesh``, at FULL without a trace and at
SMOKE through the DTensor trace. The model calls ``hint`` at JAX's sites
with JAX's names, and on a mesh each hinted activation takes the spec's
placements. The mesh options run with and without collectives.
``chip_smoke.py``'s phase 18 pins are what this torch counts. Each FULL
combo's mesh run with collectives is traced once for the module
(``full_run``).

Each mesh run starts a fake world of 512 ranks when none exists and
destroys it; the module leaves no process group behind.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim.adamw import AdamWState as JAdamWState  # noqa: E402
from repro.training import train_state_init as jtrain_state_init  # noqa: E402
from repro.training.train_step import TrainState as JTrainState  # noqa: E402
from repro_torch import configs, partition  # noqa: E402
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.configs.shapes import input_specs  # noqa: E402
from repro_torch.launch import dryrun, sharding  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import (  # noqa: E402
    init_model, moe, pspec, transformer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JMESH = {False: AbstractMesh((16, 16), ("data", "model")),
         True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
# The combos the JAX reference compiles here (no hint on their path) and
# two it cannot (a train step under fsdp, an MoE decode with the experts
# on 'data' on the multi-pod mesh): (arch, shape, multi_pod, profile,
# ep_axis). JAX's runs of the decode combos estimate the collectives
# (COLLECTIVE_COMBOS); the prefill ones skip them, as a 32k prefill's
# extra compiles would take minutes.
XLA_COMBOS = [("olmo-1b", "decode_32k", False, "tp", "model"),
              ("mamba2-370m", "decode_32k", False, "tp", "model"),
              ("zamba2-2.7b", "prefill_32k", True, "tp", "model"),
              ("olmo-1b", "prefill_32k", False, "dp", "model")]
COLLECTIVE_COMBOS = [c for c in XLA_COMBOS if c[1] == "decode_32k"]
# The port's wire bytes per device may differ from XLA's by this factor
# either way: GSPMD and DTensor place their collectives differently (XLA
# permutes the SSM's conv window, DTensor gathers it), but neither may
# move the whole caches, scores or table where the other does not.
WIRE_FACTOR = 3.0
HINTED_COMBOS = [("olmo-1b", "train_4k", False, "fsdp", "model"),
                 ("dbrx-132b", "decode_32k", True, "tp", "data")]
# A small (sequence, batch) of each kind for the SMOKE traces. Train
# keeps train_4k's batch of 256: a train batch the 256 devices do not
# divide gets uneven DTensor shards, which the backward cannot reshape
# back (ROADMAP.md, differences by design).
SMALL = {"train": (32, 256), "prefill": (64, 32), "decode": (64, 32)}


@pytest.fixture(scope="module", autouse=True)
def no_world_left():
    assert not dist.is_initialized()
    yield
    pspec.set_mesh(None)
    assert not dist.is_initialized(), "a mesh run left a process group"


def _small(monkeypatch, shape_name):
    """SMOKE configs and ``shape_name`` at a small size of its kind."""
    kind = INPUT_SHAPES[shape_name].kind
    small = InputShape(shape_name, *SMALL[kind], kind)
    monkeypatch.setattr(dryrun.configs, "get_config", configs.get_smoke)
    monkeypatch.setitem(dryrun.INPUT_SHAPES, shape_name, small)
    return small


def _jax_shard_bytes(cfg, shape, multi_pod, profile, ep_axis):
    """The bytes one device holds of the JAX dry run's step arguments under
    JAX's shardings (``dryrun._build_lowered``'s ``in_shardings``)."""
    jm = JMESH[multi_pod]
    params = jax.eval_shape(lambda: jinit_model(jax.random.PRNGKey(0), cfg))
    psh = jsharding.tree_param_shardings(jm, params, profile, ep_axis)
    if shape.kind == "train":
        specs = jshapes.input_specs(cfg, shape)
        rep = JNamedSharding(jm, JP())
        trees = (jax.eval_shape(jtrain_state_init, params), specs)
        shs = (JTrainState(params=psh,
                           opt=JAdamWState(step=rep, mu=psh, nu=psh)),
               jsharding.train_batch_shardings(jm, specs, profile))
    elif shape.kind == "prefill":
        specs = jshapes.input_specs(cfg, shape)
        specs.pop("labels", None)
        trees = (params, specs)
        shs = (psh, jsharding.train_batch_shardings(jm, specs, profile))
    else:
        token, caches = jshapes.input_specs(cfg, shape)
        trees = (params, token, caches)
        shs = (psh,) + tuple(jsharding.cache_shardings(jm, cfg, token,
                                                       caches))
    xs, ss = jax.tree.leaves(trees), jax.tree.leaves(shs)
    assert len(xs) == len(ss)
    return sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
               for x, s in zip(xs, ss))


def _port_argument_bytes(cfg, shape, multi_pod, profile, ep_axis):
    with dryrun._world(512):
        mesh = make_production_mesh(multi_pod=multi_pod)
        return dryrun.argument_bytes(cfg, shape, mesh, profile=profile,
                                     ep_axis=ep_axis)


# ---- (a) against XLA, where the JAX reference compiles -------------------

@pytest.fixture(scope="module")
def jax_dryrun(tmp_path_factory):
    """JAX's dry run of one combo in a subprocess, once for the module:
    (its file name, its result). The decode combos run with collectives,
    the others with --skip-collectives."""
    runs = {}

    def run(arch, shape, multi_pod, profile="tp"):
        key = (arch, shape, multi_pod, profile)
        if key not in runs:
            out = tmp_path_factory.mktemp("jax")
            env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
            env.pop("XLA_FLAGS", None)
            skip = [] if shape == "decode_32k" else ["--skip-collectives"]
            done = subprocess.run(
                [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--profile", profile, "--out", str(out)]
                + skip + (["--multi-pod"] if multi_pod else []),
                env=env, capture_output=True, text=True, timeout=600)
            assert done.returncode == 0, done.stdout[-2000:] + \
                done.stderr[-2000:]
            (name,) = os.listdir(out)
            runs[key] = name, json.loads((out / name).read_text())
        return runs[key]

    return run


@pytest.mark.parametrize("arch,shape,multi_pod,profile,ep_axis", XLA_COMBOS)
def test_argument_bytes_equal_xla(jax_dryrun, arch, shape, multi_pod,
                                  profile, ep_axis):
    jname, want = jax_dryrun(arch, shape, multi_pod, profile)
    cfg = configs.get_config(arch)
    got = _port_argument_bytes(cfg, INPUT_SHAPES[shape], multi_pod, profile,
                               ep_axis)
    assert got == want["memory"]["argument_bytes"]
    assert jname == f"{arch}_{shape}_{'2x16x16' if multi_pod else '16x16'}" \
        ".json"
    assert want["n_chips"] == (512 if multi_pod else 256)
    assert bool(want["collectives"]) == (shape == "decode_32k")


@pytest.fixture(scope="module")
def full_run():
    """The port's mesh run with collectives of one FULL combo, once for
    the module: (its result, the largest collective result a device
    gets, in bytes, over the traces the estimate fits)."""
    runs = {}

    def run(arch, shape, multi_pod=False, profile="tp", ep_axis="model",
            seq_len=0):
        key = (arch, shape, multi_pod, profile, ep_axis, seq_len)
        if key not in runs:
            with rl.record_sites() as seen:
                r = dryrun.lower_combo(arch, shape, multi_pod=multi_pod,
                                       profile=profile, ep_axis=ep_axis,
                                       seq_len=seq_len, verbose=False)
            runs[key] = r, max((s["result_bytes"] for s in seen), default=0)
        return runs[key]

    return run


@pytest.mark.parametrize("arch,shape,multi_pod,profile,ep_axis",
                         COLLECTIVE_COMBOS)
def test_wire_bytes_against_xla(jax_dryrun, full_run, arch, shape,
                                multi_pod, profile, ep_axis):
    """The port's collective estimate of the FULL decode step on 16 x 16
    against XLA's (the same JAX run as the argument bytes'): the total
    wire bytes per device within WIRE_FACTOR either way. Each kind's
    ratio is printed."""
    _, want = jax_dryrun(arch, shape, multi_pod, profile)
    r, _ = full_run(arch, shape, multi_pod, profile, ep_axis)
    assert tuple(r["collectives"]) == tuple(want["collectives"])
    for kind, c in r["collectives"].items():
        w = want["collectives"][kind]
        print(f"{arch} {kind}: port {c['wire_bytes']:.0f} / XLA "
              f"{w['wire_bytes']:.0f} = "
              f"{c['wire_bytes'] / max(w['wire_bytes'], 1.0):.3f}")
    ratio = r["wire_bytes_per_device"] / want["wire_bytes_per_device"]
    print(f"{arch} total: {ratio:.3f}")
    assert 1 / WIRE_FACTOR <= ratio <= WIRE_FACTOR
    assert r["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"]


def test_olmo_decode_on_the_mesh_against_xla(jax_dryrun, full_run,
                                             monkeypatch, tmp_path):
    """The mesh run of olmo-1b x decode_32k at FULL, through the CLI's
    default (the 16 x 16 mesh with collectives, the module's run of the
    combo), beside JAX's: file name, mesh, chips, the five kinds, XLA's
    argument bytes, wire bytes within WIRE_FACTOR, and the one-device
    FLOPs / 256."""
    jname, want = jax_dryrun("olmo-1b", "decode_32k", False)
    calls = []

    def combo(arch, shape, **kw):
        calls.append((arch, shape, kw["multi_pod"], kw["collectives"],
                      kw["profile"], kw["ep_axis"]))
        return full_run(arch, shape)[0]

    monkeypatch.setattr(dryrun, "lower_combo", combo)
    dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                 "--out", str(tmp_path / "port")])
    assert calls == [("olmo-1b", "decode_32k", False, True, "tp", "model")]
    assert os.listdir(tmp_path / "port") == [jname]
    r = json.loads((tmp_path / "port" / jname).read_text())
    for k in ("arch", "shape", "mesh", "kind", "n_chips"):
        assert r[k] == want[k], k
    assert tuple(r["collectives"]) == tuple(want["collectives"])
    assert r["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"] == 2_441_674_788
    ratio = r["wire_bytes_per_device"] / want["wire_bytes_per_device"]
    assert 1 / WIRE_FACTOR <= ratio <= WIRE_FACTOR
    cfg = configs.get_config("olmo-1b")
    one = dryrun.step_cost(cfg, INPUT_SHAPES["decode_32k"])
    assert r["flops_per_device"] == one.flops / 256
    assert r["hbm_bytes_per_device"] == one.hbm_bytes / 256
    assert r["collective_s"] > 0.0
    assert not dist.is_initialized()


def test_no_collective_result_over_2_mib_in_olmo_decode(full_run):
    """FULL olmo-1b x decode_32k on 16 x 16, at the two depths the
    estimate traces: no single collective's result on a device exceeds 2
    MiB (the slot write used to gather a 1 GiB layer cache)."""
    _, biggest = full_run("olmo-1b", "decode_32k")
    assert 0 < biggest <= 2 * 2 ** 20


def _chip_smoke():
    """``chip_smoke.py`` at the repository root, as a module."""
    import importlib.util

    path = os.path.join(REPO, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("combo", range(10))
def test_phase_18_pins_the_cpu_estimate(full_run, combo):
    """chip_smoke.py's phase 18 holds the card's estimate of each of its
    ten combos (decode at FULL; prefill and train at FULL widths and
    1,024 tokens) to a pin: the pins are what this CPU's torch counts
    (the module's run of each combo), and the argument bytes are the
    placement rules' shard sum, which a skip-collectives run's are by
    construction, and XLA's where JAX compiles the combo. The MoE decode's
    pins are at most the parent's on this torch (359,227,346 on 2 x 16 x
    16 with the experts on 'data')."""
    cs = _chip_smoke()
    assert len(cs.MESH_DRYRUN) == 10
    c = cs.MESH_DRYRUN[combo]
    arch, shape, multi_pod, profile, ep_axis, seq_len = c
    r, _ = full_run(arch, shape, multi_pod, profile, ep_axis, seq_len)
    assert r["wire_bytes_per_device"] == cs.MESH_WIRE_BYTES[c]
    xla = None if multi_pod else cs.XLA_WIRE_BYTES.get((arch, shape))
    if xla:
        ratio = r["wire_bytes_per_device"] / xla
        assert 1 / cs.WIRE_FACTOR <= ratio <= cs.WIRE_FACTOR
    if (arch, shape) == ("dbrx-132b", "decode_32k"):
        assert r["wire_bytes_per_device"] <= (
            359_227_346 if multi_pod else 107_833_380)
    cfg = configs.get_config(arch)
    full = INPUT_SHAPES[shape]
    cut = dataclasses.replace(full, seq_len=seq_len or full.seq_len)
    with dryrun._world(512):
        mesh = make_production_mesh(multi_pod=multi_pod)
        shards = dryrun.argument_bytes(cfg, cut, mesh, profile=profile,
                                       ep_axis=ep_axis)
    assert r["memory"]["argument_bytes"] == shards
    if not multi_pod and (arch, shape) in cs.XLA_ARGUMENT_BYTES:
        assert shards == cs.XLA_ARGUMENT_BYTES[arch, shape]


# ---- (b) the hinted combos, against JAX's shardings ----------------------

@pytest.mark.parametrize("arch,shape,multi_pod,profile,ep_axis",
                         HINTED_COMBOS)
def test_argument_bytes_equal_jax_shard_shapes(arch, shape, multi_pod,
                                               profile, ep_axis):
    """FULL, no trace: the port's placed arguments hold what JAX's
    shardings give each device."""
    jshape = jshapes.INPUT_SHAPES[shape]
    want = _jax_shard_bytes(
        jshapes.variant_for_shape(jconfigs.get_config(arch), jshape), jshape,
        multi_pod, profile, ep_axis)
    got = _port_argument_bytes(configs.get_config(arch), INPUT_SHAPES[shape],
                               multi_pod, profile, ep_axis)
    assert got == want


@pytest.mark.parametrize("arch,shape,multi_pod,profile,ep_axis",
                         HINTED_COMBOS)
def test_mesh_trace_at_smoke_holds_the_shards(monkeypatch, arch, shape,
                                              multi_pod, profile, ep_axis):
    """The DTensor trace itself, at SMOKE widths and a small size: the
    local bytes of the placed arguments are the JAX shard sum, and the
    result has the mesh run's keys."""
    small = _small(monkeypatch, shape)
    r = dryrun.lower_combo(arch, shape, multi_pod=multi_pod,
                           collectives=False, profile=profile,
                           ep_axis=ep_axis, verbose=False)
    jshape = jshapes.InputShape(shape, small.seq_len, small.global_batch,
                                small.kind)
    want = _jax_shard_bytes(jconfigs.get_smoke(arch), jshape, multi_pod,
                            profile, ep_axis)
    assert r["memory"]["argument_bytes"] == want
    assert r["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert r["n_chips"] == (512 if multi_pod else 256)
    assert r["collectives"] == {} and r["wire_bytes_per_device"] == 0.0
    m = r["memory"]
    assert m["temp_bytes"] > 0 and m["peak_bytes"] == (
        m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"])
    one = dryrun.step_cost(configs.get_smoke(arch), small)
    assert r["flops_per_device"] == one.flops / r["n_chips"]
    assert not dist.is_initialized()


def test_state_shardings_match_jax():
    jm = JMESH[False]
    with dryrun._world(256):
        mesh = make_production_mesh()
        params = init_model(configs.get_config("olmo-1b"), device="meta")
        sh = dryrun._state_shardings(
            mesh, sharding.tree_param_shardings(mesh, params, "fsdp"))
    jparams = jax.eval_shape(lambda: jinit_model(
        jax.random.PRNGKey(0), jconfigs.get_config("olmo-1b")))
    jpsh = jsharding.tree_param_shardings(jm, jparams, "fsdp")
    assert sh.opt.step.spec == tuple(JP()) == ()
    assert sh.opt.mu is sh.params and sh.opt.nu is sh.params
    assert [tuple(s.spec) for s in jax.tree.leaves(jpsh)] == [
        s.spec for s in jax.tree.leaves(
            sh.params, is_leaf=lambda x: isinstance(
                x, partition.NamedSharding))]


# ---- (c) hint ------------------------------------------------------------

def test_hint_without_a_mesh_is_the_identity():
    pspec.set_mesh(None)
    x = torch.ones(4, 8)
    for name in ("activations", "logits", "moe_buffer", "moe_group_local"):
        assert pspec.hint(x, name) is x
    assert pspec.gathered(x, 0) is x and pspec.grad_gathered(x, 0) is x
    r = pspec.reshaped(x, (4, 2, 4), 1, 2)
    assert r.data_ptr() == x.data_ptr() and r.shape == (4, 2, 4)
    idx = torch.tensor([1, 7, 0, 3])
    assert torch.equal(pspec.take_last(x * torch.arange(8.0), idx),
                       (x * torch.arange(8.0)).gather(-1, idx[:, None])[:, 0])


def _spy(monkeypatch, modules, calls):
    for mod in modules:
        real = mod.hint

        def spy(x, name, _mod=mod.__name__.rsplit(".", 1)[-1], _real=real):
            calls.add((_mod, name, tuple(x.shape)))
            return _real(x, name)

        monkeypatch.setattr(mod, "hint", spy)


@pytest.mark.parametrize("groups", [0, 2])
def test_the_model_hints_at_jaxs_sites(monkeypatch, groups):
    """forward_train of a SMOKE MoE config calls hint at the sites and with
    the names JAX's does, on tensors of the same shapes: activations,
    logits, and the flat (groups 0) or grouped dispatch's buffers."""
    B, S = 2, 32
    jcfg = dataclasses.replace(jconfigs.get_smoke("dbrx-132b"),
                               moe_dispatch_groups=groups)
    cfg = dataclasses.replace(configs.get_smoke("dbrx-132b"),
                              moe_dispatch_groups=groups)
    jcalls, calls = set(), set()
    _spy(monkeypatch, (jtransformer, jmoe), jcalls)
    _spy(monkeypatch, (transformer, moe), calls)
    jparams = jax.eval_shape(lambda: jinit_model(jax.random.PRNGKey(0), jcfg))
    jbatch = jshapes.input_specs(jcfg, jshapes.InputShape("t", S, B,
                                                          "train"))
    jax.eval_shape(lambda p, b: jtransformer.forward_train(p, jcfg, b),
                   jparams, jbatch)
    transformer.forward_train(
        init_model(cfg, device="meta"), cfg,
        input_specs(cfg, InputShape("t", S, B, "train")))
    names = {n for _, n, _ in calls}
    want = {"activations", "logits", "moe_buffer"} | (
        {"moe_group_local"} if groups else set())
    assert names == want
    assert calls == jcalls


@pytest.mark.parametrize("arch,groups,profile,ep_axis", [
    ("dbrx-132b", 2, "tp", "model"), ("olmo-1b", 0, "dp", "model")])
def test_hinted_activations_take_the_specs_placements(
        monkeypatch, arch, groups, profile, ep_axis):
    """In a SMOKE mesh trace every hinted activation comes out with
    NamedSharding(mesh, drop_indivisible(spec)).placements."""
    seen = []
    real = pspec.hint

    def spy(x, name):
        y = real(x, name)
        seen.append((name, tuple(x.shape), y))
        return y

    for mod in (transformer, moe):
        monkeypatch.setattr(mod, "hint", spy)
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              moe_dispatch_groups=groups)
    shape = InputShape("t", *SMALL["train"], "train")
    with dryrun._world(256):
        mesh = make_production_mesh()
        specs = sharding.activation_hint_specs(mesh, profile, ep_axis)
        pspec.set_mesh(mesh, specs)
        try:
            dryrun._mesh_trace(cfg, shape, mesh, True, "", profile, ep_axis)
            for name, shp, y in seen:
                want = partition.NamedSharding(
                    mesh, partition.drop_indivisible(mesh, specs[name], shp))
                assert y.placements == want.placements, (name, shp)
        finally:
            pspec.set_mesh(None)
    assert {n for n, _, _ in seen} >= {"activations", "logits"}


def test_gqa_backward_with_the_heads_sharded():
    """GQA's repeat_interleave folds its gradient's heads back into (KV,
    G): with 48 query heads sharded 16 ways on 'model' and 8 KV heads,
    DTensor cannot unflatten that gradient unless it is gathered first
    (pspec.grad_gathered in attention._expand_kv). dbrx-132b's shapes at
    one block of 512 and a batch of 16."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import attention

    B, S, H, KV, hd = 16, 512, 48, 8, 128
    with dryrun._world(256):
        mesh = make_production_mesh()

        def placed(shape, heads):
            t = torch.empty(shape, device="meta", dtype=torch.bfloat16)
            return distribute_tensor(t, mesh, [Shard(0), heads],
                                     src_data_rank=None).requires_grad_()

        q = placed((B, S, H, hd), Shard(2))
        k, v = (placed((B, S, KV, hd), Replicate()) for _ in range(2))
        pos = torch.arange(S, device="meta")
        with implicit_replication():
            out = attention.chunked_attention(q, k, v, pos, pos)
            grads = torch.autograd.grad(out.float().sum(), [q, k, v])
        assert [tuple(g.shape) for g in grads] == [
            (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)]


def test_attention_backward_with_heads_the_mesh_does_not_divide():
    """llama4's 40 query heads on the multi-pod mesh's 16-way 'model' axis:
    the gradients of the head split and of the merge before w_o arrive
    sharded unevenly over the heads, which DTensor cannot reshape, unless
    pspec.reshaped gathers them first. The attention block at llama4's
    widths, a batch of 32 and one block of 256 positions."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import attention

    cfg = configs.get_config("llama4-maverick-400b-a17b")
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    B, S = 32, 256
    with dryrun._world(512):
        mesh = make_production_mesh(multi_pod=True)
        rep, model = [Replicate()] * 2, Shard(1)

        def placed(shape, placements):
            t = torch.empty(shape, device="meta", dtype=torch.bfloat16)
            return distribute_tensor(t, mesh, placements,
                                     src_data_rank=None).requires_grad_()

        p = {"w_q": placed((D, H * hd), rep + [model]),
             "w_k": placed((D, KV * hd), rep + [model]),
             "w_v": placed((D, KV * hd), rep + [model]),
             "w_o": placed((H * hd, D), rep + [Shard(0)])}
        x = placed((B, S, D), [Shard(0), Shard(0), Replicate()])
        pos = torch.arange(S, device="meta")
        with implicit_replication():
            out = attention.attention(p, cfg, x, pos, impl="chunked")
            grads = torch.autograd.grad(out.float().sum(),
                                        [x] + list(p.values()))
        assert [tuple(g.shape) for g in grads] == [
            (B, S, D), (D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D)]


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_moe_backward_on_the_multi_pod_mesh(arch):
    """The MoE layer's backward on 2 x 16 x 16: the tokens' gradient comes
    back with its rows sharded over all 512 devices, which a batch of 32
    cannot be split back out of unless the reshape's gradient keeps only
    the axes the batch divides (pspec.reshaped in moe.apply_moe). One
    layer of the FULL config under the rules (tp), a batch of 32 rows of
    64 positions on ('pod', 'data')."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import tree

    cfg = dryrun._depth_variant(configs.get_config(arch), 1)
    B, S = 32, 64
    with dryrun._world(512):
        mesh = make_production_mesh(multi_pod=True)
        pspec.set_mesh(mesh, sharding.activation_hint_specs(mesh, "tp",
                                                            "model"))
        try:
            params = init_model(cfg, device="meta")
            placed = sharding.shard_tree(
                params, sharding.tree_param_shardings(mesh, params))
            p = transformer._layer(placed["blocks"], 0)["moe"]
            leaves = [t.requires_grad_() for t in tree.leaves(p)]
            x = distribute_tensor(
                torch.empty(B, S, cfg.d_model, device="meta",
                            dtype=torch.bfloat16), mesh,
                [Shard(0), Shard(0), Replicate()],
                src_data_rank=None).requires_grad_()
            with implicit_replication():
                y, aux = moe.apply_moe(p, cfg, x)
                grads = torch.autograd.grad(y.float().sum() + aux,
                                            [x] + leaves)
        finally:
            pspec.set_mesh(None)
    assert [tuple(g.shape) for g in grads] == [tuple(x.shape)] + [
        tuple(t.shape) for t in leaves]


# ---- (d) the mesh options run with collectives and without -------------

@pytest.mark.parametrize("extra,suffix", [
    (["--multi-pod"], "2x16x16"), (["--profile", "fsdp"], "16x16"),
    (["--ep-axis", "data"], "16x16"), ([], "16x16")])
def test_mesh_options_need_skip_collectives(monkeypatch, tmp_path, extra,
                                            suffix):
    """Each mesh option, which needed --skip-collectives until the
    estimate was ported, runs with it (the default, JAX's) and without
    it, at SMOKE: the same file name and memory, the five kinds or {}."""
    _small(monkeypatch, "decode_32k")
    base = ["--arch", "olmo-1b", "--shape", "decode_32k"]
    runs = {}
    for skip in ([], ["--skip-collectives"]):
        out = tmp_path / ("skip" if skip else "with")
        dryrun.main(base + extra + skip + ["--out", str(out)])
        runs[bool(skip)] = json.loads(
            (out / f"olmo-1b_decode_32k_{suffix}.json").read_text())
    with_c, without = runs[False], runs[True]
    assert with_c["mesh"] == without["mesh"] == suffix
    assert with_c["memory"] == without["memory"]
    assert tuple(with_c["collectives"]) == tuple(rl.empty_collectives())
    assert with_c["wire_bytes_per_device"] > 0
    assert without["collectives"] == {}
    assert without["wire_bytes_per_device"] == 0.0
    assert not dist.is_initialized()


def test_a_smaller_world_of_the_callers_raises(monkeypatch):
    """A world the caller made is used as it is: 256 ranks cannot hold the
    multi-pod mesh, and the caller's world stays."""
    _small(monkeypatch, "decode_32k")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        with pytest.raises(ValueError, match="512 ranks"):
            dryrun.lower_combo("olmo-1b", "decode_32k", multi_pod=True,
                               collectives=False, verbose=False)
        assert dist.is_initialized() and dist.get_world_size() == 256
        r = dryrun.lower_combo("olmo-1b", "decode_32k", collectives=False,
                               verbose=False)
        assert r["n_chips"] == 256
        assert dist.get_world_size() == 256
    finally:
        dist.destroy_process_group()
