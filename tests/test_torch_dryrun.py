"""The port's dry run (``launch/dryrun.py``) on the production mesh.

``lower_combo`` on SMOKE configs gives the cost model's counts of the same
step per device, the collective estimate and the JAX dry run's result
keys; ``step_cost``'s depth extrapolation equals a trace of the whole
depth; ``init_model(device="meta")`` is the real tree's shapes and
dtypes; subprocess runs of the CLI at a FULL config, with collectives and
with ``--skip-collectives``, write their JSON without touching CUDA and
leave no process group; the mesh options run with collectives, and
whisper x long_500k writes the documented skip.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, tree  # noqa: E402
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.launch import costmodel, dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import init_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX dry run's result keys that mean the same here, and the port's
# own: the matmul FLOPs, FlopCounterMode's count, the two traces' times.
KEYS = {"arch", "shape", "mesh", "kind", "variant", "n_chips",
        "flops_per_device", "hbm_bytes_per_device", "collectives",
        "wire_bytes_per_device", "memory", "active_params", "total_params",
        "model_flops_global", "model_flops_per_device", "useful_flops_ratio",
        "compute_s", "memory_s", "collective_s", "dominant", "bound_s",
        "dot_flops_per_device", "flop_counter", "trace_s", "mesh_trace_s"}
# A small (sequence, batch) of each kind whose batch the mesh's data axis
# divides (a batch it does not divide is replicated, and the train step's
# hinted activations then cannot be unflattened).
SMALL = {"train": (32, 256), "prefill": (64, 32), "decode": (64, 32)}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_lower_combo_gives_the_cost_models_counts(monkeypatch, shape):
    """SMOKE olmo-1b (2 layers, traced whole) at the shape's kind and a
    small size on the 16 x 16 mesh: lower_combo's FLOPs and bytes are the
    cost model's on the step ``_build_step`` builds, per device; its
    collectives are the five kinds' counts of the placed trace, and their
    wire bytes the roofline's collective term."""
    kind = INPUT_SHAPES[shape].kind
    small = InputShape(shape, *SMALL[kind], kind)
    monkeypatch.setattr(dryrun.configs, "get_config", configs.get_smoke)
    monkeypatch.setitem(dryrun.INPUT_SHAPES, shape, small)
    r = dryrun.lower_combo("olmo-1b", shape, verbose=False,
                           kv_dtype="float8_e4m3fn")
    cfg = dataclasses.replace(configs.get_smoke("olmo-1b"),
                              kv_dtype="float8_e4m3fn")
    step, args = dryrun._build_step(cfg, small, True)
    _, c = costmodel.trace_cost(step, *args)
    assert set(r) == KEYS
    assert r["n_chips"] == 256 and r["mesh"] == "16x16"
    assert (r["flops_per_device"], r["hbm_bytes_per_device"]) == (
        c.flops / 256, c.hbm_bytes / 256)
    assert r["flop_counter"]["flops"] == c.flop_counter / 256 == \
        c.dot_flops / 256
    assert tuple(r["collectives"]) == KINDS
    wire = sum(k["wire_bytes"] for k in r["collectives"].values())
    assert r["wire_bytes_per_device"] == wire > 0
    assert r["collective_s"] == wire / rl.LINK_BW
    m = r["memory"]
    assert m["peak_bytes"] == (m["argument_bytes"] + m["output_bytes"]
                               + m["temp_bytes"])
    with dryrun._world(256):
        mesh = make_production_mesh()
        assert m["argument_bytes"] == dryrun.argument_bytes(cfg, small, mesh)
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"],
                               r["collective_s"])


@pytest.mark.parametrize("arch,kind", [
    ("olmo-1b", "train"), ("mamba2-370m", "decode"),
    ("llama4-maverick-400b-a17b", "prefill"), ("whisper-medium", "prefill")])
def test_depth_extrapolation_equals_the_whole_trace(arch, kind):
    cfg = dryrun._depth_variant(configs.get_smoke(arch), 5)
    shape = InputShape("s", 32, 2, kind)
    got = dryrun.step_cost(cfg, shape)
    want = dryrun._trace(cfg, shape, True, "")
    assert got == want


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-2.7b", "dbrx-132b",
                                  "llama4-maverick-400b-a17b",
                                  "whisper-medium", "phi-3-vision-4.2b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_init_model_has_the_real_trees_shapes(arch, dtype):
    cfg = configs.get_smoke(arch)
    real = init_model(cfg, device="cpu", dtype=dtype)
    meta = init_model(cfg, device="meta", dtype=dtype)
    assert tree.map_tree(lambda t: (tuple(t.shape), t.dtype), meta) == \
        tree.map_tree(lambda t: (tuple(t.shape), t.dtype), real)
    assert all(t.device.type == "meta" for t in tree.leaves(meta))
    # The real route's draws do not move (tests/test_torch_models.py pins
    # them): the same seed gives the same tree after a meta build.
    again = init_model(cfg, device="cpu", dtype=dtype)
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(real), tree.leaves(again)))


def _cli(tmp_path, *extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = ("import sys, torch, torch.distributed as dist; "
            "from repro_torch.launch import dryrun; "
            "dryrun.main(sys.argv[1:]); "
            "assert not torch.cuda.is_initialized(), 'CUDA was touched'; "
            "assert not dist.is_initialized(), 'a world was left'")
    out = subprocess.run(
        [sys.executable, "-c", code, "--arch", "mamba2-370m",
         "--shape", "decode_32k", "--out", str(tmp_path)] + list(extra),
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "all 1 combos traced OK" in out.stdout
    return json.loads((tmp_path / "mamba2-370m_decode_32k_16x16.json"
                       ).read_text())


def test_cli_writes_one_combo_without_cuda(tmp_path):
    """The default run, the 16 x 16 mesh with collectives: the run starts
    its own fake world, destroys it, and touches no CUDA."""
    r = _cli(tmp_path)
    assert r["n_chips"] == 256 and r["flops_per_device"] > 0
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert tuple(r["collectives"]) == KINDS
    assert r["wire_bytes_per_device"] > 0
    assert 0 < r["memory"]["argument_bytes"] < r["memory"]["peak_bytes"]


def test_cli_writes_a_mesh_combo_without_cuda(tmp_path):
    """The same with --skip-collectives: no estimate, the same memory."""
    r = _cli(tmp_path, "--skip-collectives")
    assert r["n_chips"] == 256 and r["mesh"] == "16x16"
    assert r["collectives"] == {} and r["wire_bytes_per_device"] == 0.0
    assert r["collective_s"] == 0.0
    assert r["memory"]["argument_bytes"] == 365_081_764


def test_documented_skip_and_refused_flags(monkeypatch, tmp_path):
    """whisper x long_500k writes the documented skip under the mesh's
    name; the mesh options that were refused while the estimate was not
    ported run with collectives and name their file by the mesh."""
    dryrun.main(["--arch", "whisper-medium", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    r = json.loads((tmp_path / "whisper-medium_long_500k_16x16.json"
                    ).read_text())
    assert r["skipped"] and r["reason"] == "documented skip (DESIGN.md §5)"
    small = InputShape("decode_32k", 64, 32, "decode")
    monkeypatch.setattr(dryrun.configs, "get_config", configs.get_smoke)
    monkeypatch.setitem(dryrun.INPUT_SHAPES, "decode_32k", small)
    for extra, suffix in ((["--multi-pod"], "2x16x16"),
                          (["--profile", "dp", "--multi-pod"], "2x16x16")):
        out = tmp_path / "_".join(extra)
        dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--out",
                     str(out)] + extra)
        r = json.loads((out / f"olmo-1b_decode_32k_{suffix}.json"
                        ).read_text())
        assert r["mesh"] == suffix and r["n_chips"] == 512
        assert tuple(r["collectives"]) == KINDS


def test_a_failed_combo_is_reported_and_the_sweep_goes_on(monkeypatch,
                                                          tmp_path, capsys):
    """``main``'s sweep reports a combo's error in its FAILURES list,
    writes no file for it, traces the others and exits 1; a collective the
    counter has no kind for fails its combo the same way, never counting
    as zero."""
    def boom(arch, shape, **kw):
        if arch == "olmo-1b":
            raise ValueError(f"no rule for {arch}")
        return {"arch": arch, "shape": shape}

    monkeypatch.setattr(dryrun, "lower_combo", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all", "--out", str(tmp_path)])
    assert e.value.code == 1
    names = sorted(os.listdir(tmp_path))
    assert len(names) == len(configs.ARCH_IDS) * len(INPUT_SHAPES) - len(
        INPUT_SHAPES)
    assert not any(n.startswith("olmo-1b_") for n in names)
    assert "('olmo-1b', 'decode_32k', 'no rule for olmo-1b')" in \
        capsys.readouterr().out

    def unknown(arch, shape, **kw):
        raise NotImplementedError("collective op _c10d_functional.broadcast"
                                  " has no kind in the wire-bytes model")

    monkeypatch.setattr(dryrun, "lower_combo", unknown)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--out",
                     str(tmp_path / "y")])
    assert e.value.code == 1 and not os.listdir(tmp_path / "y")
    assert "has no kind" in capsys.readouterr().out
