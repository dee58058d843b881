"""The port's placement rules (``launch/sharding.py``, ``models/pspec.py``
and ``launch/mesh.py``'s production mesh) against the JAX package's.

JAX checks its rules on meshes of placeholder devices; here they are held
spec for spec and shard shape for shard shape against JAX's on
``jax.sharding.AbstractMesh``. The port's production meshes are real
``DeviceMesh``es over ``torch.distributed``'s fake backend, a world of 512
ranks in one process that holds both the 256-rank and the 512-rank mesh
(the counterpart of JAX's placeholder devices). DTensors themselves are
placed on a one-rank gloo world with a (1, 1) mesh. The module keeps one
default process group at a time and destroys it at its end.
"""
import functools
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import (  # noqa: E402
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor._utils import (  # noqa: E402
    _compute_local_shape_and_global_offset,
)
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.launch import mesh as jmesh_lib  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro_torch import configs, partition, tree  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.sharding import P  # noqa: E402
from repro_torch.models import init_caches, init_model, pspec  # noqa: E402
from repro_torch.training.train_step import train_state_init  # noqa: E402

JMESH = {False: AbstractMesh((16, 16), ("data", "model")),
         True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
MESH_IDS = {False: "pod", True: "multi_pod"}
MOE = [a for a in configs.ARCH_IDS
       if configs.get_config(a).arch_type == "moe"]
# (profile, ep_axis): the three profiles, and the expert axis on 'data'
# for the MoE architectures.
PARAM_CASES = [(a, p, "model") for a in configs.ARCH_IDS
               for p in ("tp", "fsdp", "dp")] + [
    (a, p, "data") for a in MOE for p in ("tp", "fsdp")]
SHAPE_CASES = [(a, s) for a in configs.ARCH_IDS for s in shapes.INPUT_SHAPES
               if shapes.variant_for_shape(configs.get_config(a),
                                           shapes.INPUT_SHAPES[s])]


class _World:
    """The module's default process group, one at a time: a fake world
    (``use("fake", n)``) or the one-rank gloo world (``use("gloo", 1)``)."""

    def __init__(self):
        self.key = None
        self.cache = {}

    def use(self, backend: str, size: int):
        if self.key == (backend, size):
            return
        self.close()
        store = FakeStore() if backend == "fake" else dist.HashStore()
        dist.init_process_group(backend, store=store, rank=0,
                                world_size=size)
        self.key = (backend, size)

    def meshes(self):
        """{multi_pod: the production mesh}, on the fake world of 512."""
        self.use("fake", 512)
        if "prod" not in self.cache:
            self.cache["prod"] = {
                mp: mesh_lib.make_production_mesh(multi_pod=mp)
                for mp in (False, True)}
        return self.cache["prod"]

    def gloo_mesh(self):
        self.use("gloo", 1)
        if "gloo" not in self.cache:
            self.cache["gloo"] = init_device_mesh(
                "cpu", (1, 1), mesh_dim_names=("data", "model"))
        return self.cache["gloo"]

    def close(self):
        self.cache.clear()
        self.key = None
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def world():
    w = _World()
    yield w
    w.close()
    pspec.set_mesh(None)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jconfigs.get_config(arch)
    return jax.eval_shape(lambda: jinit_model(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return init_model(configs.get_config(arch), device="meta")


def _jax_leaves(shardings, shapes_tree):
    """{path names: (spec, shard shape)} of a JAX sharding tree."""
    sh = jax.tree_util.tree_flatten_with_path(shardings)[0]
    sds = jax.tree_util.tree_leaves(shapes_tree)
    assert len(sh) == len(sds)
    return {jsharding._path_names(p): (tuple(s.spec), s.shard_shape(x.shape))
            for (p, s), x in zip(sh, sds)}


def _port_leaves(shardings, tensors):
    sh = list(tree.leaves_with_path(shardings))
    ts = list(tree.leaves(tensors))
    assert len(sh) == len(ts)
    return {p: (tuple(s.spec), s.shard_shape(t.shape))
            for (p, s), t in zip(sh, ts)}


# ---- mesh ----------------------------------------------------------------

def test_production_mesh_needs_a_world(world):
    """Runs first: no world yet. Without one, or with too few ranks, the
    mesh raises ValueError naming the world size it needs."""
    assert not dist.is_initialized()
    for mod in (partition, mesh_lib, sharding, pspec):
        importlib.reload(mod)  # no device or process-group state touched
    assert not dist.is_initialized() and not torch.cuda.is_initialized()
    with pytest.raises(ValueError, match="256 ranks"):
        mesh_lib.make_production_mesh()
    world.use("fake", 255)
    with pytest.raises(ValueError, match="256 ranks"):
        mesh_lib.make_production_mesh()
    world.use("fake", 256)
    with pytest.raises(ValueError, match="512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True)
    assert mesh_lib.make_production_mesh().shape == (16, 16)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=MESH_IDS.__getitem__)
def test_production_mesh_and_data_axes_match_jax(world, multi_pod):
    mesh = world.meshes()[multi_pod]
    jm = JMESH[multi_pod]
    assert tuple(mesh.shape) == tuple(jm.shape.values())
    assert tuple(mesh.mesh_dim_names) == tuple(jm.axis_names)
    assert mesh.device_type == "cuda"
    assert mesh_lib.data_axis_names(mesh) == jmesh_lib.data_axis_names(jm)
    assert (mesh_lib.data_parallel_size(mesh)
            == jmesh_lib.data_parallel_size(jm) == (32 if multi_pod else 16))


# ---- param_spec: the twins of tests/test_launch.py's TestParamSpecs ---------

@pytest.mark.parametrize("path,ndim,want", [
    (("embed",), 2, P("model", None)),
    (("lm_head",), 2, P(None, "model")),
    (("blocks", "attn", "w_q"), 3, P(None, None, "model")),
    (("blocks", "attn", "w_o"), 3, P(None, "model", None)),
    (("blocks", "moe", "w_gate"), 4, P(None, "model", None, None)),
    (("blocks", "moe", "router"), 3, P(None, None, None)),
    (("blocks", "mlp", "w_gate"), 3, P(None, None, "model")),
    (("blocks", "mixer", "wx"), 3, P(None, None, "model")),
    (("blocks", "mixer", "wB"), 3, P(None, None, None)),
    (("blocks", "mixer", "out_proj"), 3, P(None, "model", None)),
    (("blocks", "mixer", "A_log"), 2, P(None, "model")),
    (("shared_attn", "attn", "w_q"), 2, P(None, "model")),
])
def test_param_spec_twins(path, ndim, want):
    got = sharding.param_spec(path, ndim)
    assert got == want == tuple(jsharding.param_spec(path, ndim))


def test_partition_spec_canonical_as_jax():
    for entries in [(("data",), None), ((), "model"), (["data", "model"],),
                    (None,), ()]:
        assert P(*entries) == tuple(JP(*entries)), entries
    assert P("model", None) != P("model")
    assert sharding.COL == jsharding.COL and sharding.ROW == jsharding.ROW
    assert sharding.HEADED == jsharding.HEADED
    assert sharding.REPLICATED == jsharding.REPLICATED
    assert sharding.STACKS == jsharding.STACKS


# ---- every architecture at full width ------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=MESH_IDS.__getitem__)
@pytest.mark.parametrize("arch,profile,ep_axis", PARAM_CASES)
def test_param_shardings_match_jax(world, arch, profile, ep_axis, multi_pod):
    mesh = world.meshes()[multi_pod]
    jtree = _jax_params(arch)
    want = _jax_leaves(jsharding.tree_param_shardings(
        JMESH[multi_pod], jtree, profile, ep_axis), jtree)
    ptree = _port_params(arch)
    shard = sharding.tree_param_shardings(mesh, ptree, profile, ep_axis)
    assert _port_leaves(shard, ptree) == want
    for s in tree.leaves(shard):
        assert len(s.placements) == mesh.ndim


def _sharded(jshard, jspec, pshard, pspec_):
    """(spec, shard shape) of a JAX and a port sharding of one input."""
    return ((tuple(jshard.spec), jshard.shard_shape(jspec.shape)),
            (tuple(pshard.spec), pshard.shard_shape(pspec_.shape)))


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=MESH_IDS.__getitem__)
@pytest.mark.parametrize("arch,shape", SHAPE_CASES)
def test_batch_and_cache_shardings_match_jax(world, arch, shape, multi_pod):
    mesh, jm = world.meshes()[multi_pod], JMESH[multi_pod]
    ishape, jshape = shapes.INPUT_SHAPES[shape], jshapes.INPUT_SHAPES[shape]
    cfg = shapes.variant_for_shape(configs.get_config(arch), ishape)
    jcfg = jshapes.variant_for_shape(jconfigs.get_config(arch), jshape)
    got, want = shapes.input_specs(cfg, ishape), jshapes.input_specs(
        jcfg, jshape)
    if ishape.kind != "decode":
        for profile in ("tp", "fsdp", "dp"):
            psh = sharding.train_batch_shardings(mesh, got, profile)
            jsh = jsharding.train_batch_shardings(jm, want, profile)
            assert psh.keys() == jsh.keys() == got.keys()
            for k in got:
                j, p = _sharded(jsh[k], want[k], psh[k], got[k])
                assert p == j, (profile, k)
        return
    (token, caches), (jtoken, jcaches) = got, want
    tok_s, caches_s = sharding.cache_shardings(mesh, cfg, token, caches)
    jtok_s, jcaches_s = jsharding.cache_shardings(jm, jcfg, jtoken, jcaches)
    j, p = _sharded(jtok_s, jtoken, tok_s, token)
    assert p == j
    for k in jcaches._fields:
        js, ps = getattr(jcaches_s, k), getattr(caches_s, k)
        assert (js is None) == (ps is None), k
        if k == "pos":
            assert ps.spec == tuple(js.spec) == ()
            assert ps.placements == (Replicate(),) * mesh.ndim
        elif js is not None:
            j, p = _sharded(js, getattr(jcaches, k), ps, getattr(caches, k))
            assert p == j, k


@pytest.mark.parametrize("multi_pod,batch,profile,want", [
    (False, 256, "tp", ("data",)),        # divisible
    (False, 24, "tp", None),              # indivisible
    (False, 8, "tp", None),               # smaller than the data axes
    (False, 1, "fsdp", None),             # long_500k's batch of 1
    (False, 512, "dp", ("data", "model")),
    (False, 128, "dp", ("data",)),        # dp falls back to the data axes
    (False, 8, "dp", None),
    (True, 32, "tp", ("pod", "data")),
    (True, 16, "tp", None),
    (True, 256, "dp", ("pod", "data")),   # 256 < 512: back to pod x data
    (True, 1024, "dp", ("pod", "data", "model")),
], ids=str)
def test_batch_axes_edges(world, multi_pod, batch, profile, want):
    mesh = world.meshes()[multi_pod]
    got = sharding.batch_axes(mesh, batch, profile)
    assert got == want == jsharding.batch_axes(JMESH[multi_pod], batch,
                                               profile)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=MESH_IDS.__getitem__)
@pytest.mark.parametrize("profile,ep_axis", [
    ("tp", "model"), ("fsdp", "model"), ("dp", "model"), ("tp", "data"),
    ("fsdp", "data")])
def test_activation_hint_specs_match_jax(world, profile, ep_axis, multi_pod):
    mesh = world.meshes()[multi_pod]
    got = sharding.activation_hint_specs(mesh, profile, ep_axis)
    want = jsharding.activation_hint_specs(JMESH[multi_pod], profile, ep_axis)
    assert {k: tuple(v) for k, v in got.items()} == {
        k: tuple(v) for k, v in want.items()}
    for spec in got.values():
        sharding.NamedSharding(mesh, spec).placements  # all expressible


# ---- multi-axis placements -----------------------------------------------

def _jax_offsets(jm, spec, shape):
    """Each device's (flat mesh index) offset along dim 0 under a JAX
    spec, from XLA's tile assignment of the sharding: the devices in tile
    order, each tile's copies (the mesh axes the spec leaves out) last."""
    hlo = JNamedSharding(jm, spec)._to_xla_hlo_sharding(len(shape))
    tiles = hlo.tile_assignment_dimensions()
    assert tiles[1:len(shape)] == [1] * (len(shape) - 1)
    copies = int(np.prod(tiles[len(shape):]))
    chunk = shape[0] // tiles[0]
    return {dev: (i // copies) * chunk
            for i, dev in enumerate(hlo.tile_assignment_devices())}


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=MESH_IDS.__getitem__)
def test_multi_axis_placement_flattens_major_to_minor(world, multi_pod):
    """fsdp's embed, P(("data", "model"), None): each rank's local shape and
    offset under the port's placements equal JAX's, rank by rank."""
    mesh, jm = world.meshes()[multi_pod], JMESH[multi_pod]
    shape = (102_400, 4096)  # deepseek-7b's embed: 256 divides the vocab
    spec = sharding.param_spec(("embed",), 2, "fsdp")
    assert spec == P(("data", "model"), None)
    ns = sharding.NamedSharding(mesh, spec)
    assert ns.placements == ((Replicate(),) if multi_pod else ()) + (
        Shard(0), Shard(0))
    jns = JNamedSharding(jm, JP(*spec))
    assert ns.shard_shape(shape) == jns.shard_shape(shape) == (400, 4096)
    want = _jax_offsets(jm, JP(*spec), shape)
    for flat, coord in enumerate(np.ndindex(*mesh.shape)):
        local, offset = _compute_local_shape_and_global_offset(
            shape, mesh.shape, list(coord), ns.placements)
        assert local == (400, 4096) and offset == (want[flat], 0), coord


def test_out_of_order_multi_axis_raises(world):
    mesh = world.meshes()[False]
    with pytest.raises(ValueError, match="mesh order"):
        sharding.NamedSharding(mesh, P(("model", "data"), None)).placements
    with pytest.raises(ValueError, match="shards dimensions"):
        sharding.NamedSharding(mesh, P("model", "model")).placements
    # A transposed pair of single axes is expressible.
    assert sharding.NamedSharding(mesh, P("model", "data")).placements == (
        Shard(1), Shard(0))
    with pytest.raises(ValueError, match="do not divide"):
        sharding.NamedSharding(mesh, P("model")).shard_shape((50_280,))


# ---- pspec and shard_tree on DTensors ------------------------------------

def test_pspec_imports_no_launch_module():
    """The model layer's hints sit on ``repro_torch.partition``, not on
    the launch layer: importing ``pspec`` loads nothing of
    ``repro_torch.launch``."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import sys, repro_torch.models.pspec; print(sorted(m for m in "
            "sys.modules if m.startswith('repro_torch.launch')))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, cwd=root,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert out.stdout.strip() == "[]", out.stdout


def test_hint_without_a_mesh_is_the_identity():
    pspec.set_mesh(None)
    x = torch.ones(4, 8)
    assert pspec.hint(x, "activations") is x
    assert pspec.data_axes() is None


def test_hint_drops_indivisible_axes(world):
    """On a fake 256-rank (16, 16) mesh on the cpu, a logits hint keeps
    'data' on the batch and drops 'model' from a vocab of 50,280, as JAX's
    does."""
    world.use("fake", 256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    pspec.set_mesh(mesh, sharding.activation_hint_specs(mesh))
    try:
        x = DTensor.from_local(torch.zeros(32, 4, 50_280), mesh,
                               [Replicate(), Replicate()], run_check=False)
        y = pspec.hint(x, "logits")
        assert y.placements == (Shard(0), Replicate())
        assert y.to_local().shape == (2, 4, 50_280)
        z = DTensor.from_local(torch.zeros(32, 4, 4096), mesh,
                               [Replicate(), Replicate()], run_check=False)
        assert pspec.hint(z, "logits").placements == (Shard(0), Shard(2))
        assert pspec.data_axes() == ("data",)
    finally:
        pspec.set_mesh(None)


def test_hint_places_a_dtensor_on_a_one_rank_mesh(world):
    mesh = world.gloo_mesh()
    pspec.set_mesh(mesh, sharding.activation_hint_specs(mesh))
    try:
        t = torch.randn(8, 16, 32, generator=torch.Generator().manual_seed(0))
        x = distribute_tensor(t, mesh, [Replicate(), Replicate()])
        for name, want in [("activations", (Shard(0), Replicate())),
                           ("logits", (Shard(0), Shard(2)))]:
            y = pspec.hint(x, name)
            assert isinstance(y, DTensor) and y.placements == want
            assert torch.equal(y.to_local(), t)
        assert pspec.hint(t, "logits") is t          # a plain tensor
        assert pspec.hint(x, "no_such_hint") is x
        assert pspec.data_axes() == ("data",)
    finally:
        pspec.set_mesh(None)


def _bitwise(placed, source, shardings):
    """Every tensor leaf of ``placed`` a DTensor with its sharding's
    placements whose local tensor is ``source``'s, bit for bit."""
    n = 0
    for p, s, ns in zip(tree.leaves(placed), tree.leaves(source),
                        tree.leaves(shardings)):
        assert isinstance(p, DTensor) and p.placements == ns.placements
        assert p.to_local().dtype == s.dtype
        assert torch.equal(p.to_local().view(torch.uint8),
                           s.contiguous().view(torch.uint8))
        n += 1
    return n


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m", "dbrx-132b",
                                  "whisper-medium"])
def test_shard_tree_is_bit_for_bit(world, arch):
    mesh = world.gloo_mesh()
    cfg = configs.get_smoke(arch)
    params = init_model(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    for profile in ("tp", "fsdp", "dp"):
        sh = sharding.tree_param_shardings(mesh, params, profile)
        placed = sharding.shard_tree(params, sh)
        assert _bitwise(placed, params, sh) == len(list(tree.leaves(params)))

    # A TrainState: the moments under the parameter shardings, the step
    # replicated (the JAX dry run's _state_shardings).
    state = train_state_init(params)
    gen = torch.Generator().manual_seed(4)
    for m in (state.opt.mu, state.opt.nu):
        for leaf in tree.leaves(m):
            leaf.normal_(generator=gen)
    sh = sharding.tree_param_shardings(mesh, params)
    rep = sharding.NamedSharding(mesh, P())
    state_sh = type(state)(params=sh, opt=type(state.opt)(
        step=rep, mu=sh, nu=sh))
    placed = sharding.shard_tree(state, state_sh)
    assert placed.opt.step.placements == (Replicate(), Replicate())
    for got, src in [(placed.params, state.params),
                     (placed.opt.mu, state.opt.mu),
                     (placed.opt.nu, state.opt.nu)]:
        _bitwise(got, src, sh)

    # Decode caches: absent stacks stay None, pos stays an int.
    enc = cfg.encoder_seq if cfg.is_encdec else 0
    caches = init_caches(cfg, 2, 16, enc_seq=enc, device="cpu")
    for k, v in caches._asdict().items():
        if isinstance(v, torch.Tensor):
            v.copy_(torch.randn(v.shape, generator=gen).to(v.dtype))
    token = torch.zeros(2, 1, dtype=torch.int32)
    tok_s, caches_s = sharding.cache_shardings(mesh, cfg, token, caches)
    placed = sharding.shard_tree(caches._replace(pos=7),
                                 caches_s)
    assert placed.pos == 7
    for k, v in caches._asdict().items():
        got = getattr(placed, k)
        if v is None:
            assert got is None, k
        elif k != "pos":
            _bitwise({k: got}, {k: v}, {k: getattr(caches_s, k)})
    assert sharding.shard_tree(token, tok_s).placements == (
        Shard(0), Replicate())
