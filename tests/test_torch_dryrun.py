"""The port's one-device dry run (``launch/dryrun.py``).

``lower_combo`` on SMOKE configs gives the cost model's counts of the same
step and the JAX dry run's result keys; the depth extrapolation equals a
trace of the whole depth; ``init_model(device="meta")`` is the real tree's
shapes and dtypes; one subprocess run of the CLI at a FULL config writes
its JSON without touching CUDA, and one on the production mesh
(``--skip-collectives``) that leaves no process group; the mesh options
without ``--skip-collectives`` raise, and whisper x long_500k writes the
documented skip.
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
from repro_torch.models import init_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX dry run's result keys that mean the same on one device, and the
# port's own: the matmul FLOPs, FlopCounterMode's count, the trace time.
KEYS = {"arch", "shape", "mesh", "kind", "variant", "n_chips",
        "flops_per_device", "hbm_bytes_per_device", "collectives",
        "wire_bytes_per_device", "memory", "active_params", "total_params",
        "model_flops_global", "model_flops_per_device", "useful_flops_ratio",
        "compute_s", "memory_s", "collective_s", "dominant", "bound_s",
        "dot_flops_per_device", "flop_counter", "trace_s"}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_lower_combo_gives_the_cost_models_counts(monkeypatch, shape):
    """SMOKE olmo-1b (2 layers, traced whole) at the shape's kind and a
    small size: lower_combo's numbers are the cost model's on the step
    ``_build_step`` builds."""
    small = InputShape(shape, 32, 2, INPUT_SHAPES[shape].kind)
    monkeypatch.setattr(dryrun.configs, "get_config", configs.get_smoke)
    monkeypatch.setitem(dryrun.INPUT_SHAPES, shape, small)
    r = dryrun.lower_combo("olmo-1b", shape, verbose=False,
                           kv_dtype="float8_e4m3fn")
    cfg = configs.get_smoke("olmo-1b")
    step, args = dryrun._build_step(
        dataclasses.replace(cfg, kv_dtype="float8_e4m3fn"), small, True)
    _, c = costmodel.trace_cost(step, *args)
    assert set(r) == KEYS
    assert (r["flops_per_device"], r["hbm_bytes_per_device"]) == (
        c.flops, c.hbm_bytes)
    assert r["flop_counter"]["flops"] == c.flop_counter == c.dot_flops
    assert r["n_chips"] == 1 and r["collectives"] == {}
    assert r["wire_bytes_per_device"] == 0.0 and r["collective_s"] == 0.0
    m = r["memory"]
    assert m["peak_bytes"] == (m["argument_bytes"] + m["output_bytes"]
                               + m["temp_bytes"])
    assert m["argument_bytes"] == c.argument_bytes
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"])


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


def test_cli_writes_one_combo_without_cuda(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = ("import sys, torch; from repro_torch.launch import dryrun; "
            "dryrun.main(sys.argv[1:]); "
            "assert not torch.cuda.is_initialized(), 'CUDA was touched'")
    out = subprocess.run(
        [sys.executable, "-c", code, "--arch", "mamba2-370m",
         "--shape", "decode_32k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    r = json.loads((tmp_path / "mamba2-370m_decode_32k_1.json").read_text())
    assert r["n_chips"] == 1 and r["flops_per_device"] > 0
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["memory"]["peak_bytes"] > 0
    assert "all 1 combos traced OK" in out.stdout


def test_cli_writes_a_mesh_combo_without_cuda(tmp_path):
    """The same on the production mesh (--skip-collectives): the run
    starts its own fake world, destroys it, and touches no CUDA."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = ("import sys, torch, torch.distributed as dist; "
            "from repro_torch.launch import dryrun; "
            "dryrun.main(sys.argv[1:]); "
            "assert not torch.cuda.is_initialized(), 'CUDA was touched'; "
            "assert not dist.is_initialized(), 'a world was left'")
    out = subprocess.run(
        [sys.executable, "-c", code, "--arch", "mamba2-370m",
         "--shape", "decode_32k", "--skip-collectives", "--out",
         str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    r = json.loads((tmp_path / "mamba2-370m_decode_32k_16x16.json"
                    ).read_text())
    assert r["n_chips"] == 256 and r["mesh"] == "16x16"
    assert r["collectives"] == {} and r["wire_bytes_per_device"] == 0.0
    assert 0 < r["memory"]["argument_bytes"] < r["memory"]["peak_bytes"]
    assert "all 1 combos traced OK" in out.stdout


def test_documented_skip_and_refused_flags(tmp_path):
    """whisper x long_500k writes the documented skip; the mesh options
    without --skip-collectives need the collective estimate and raise
    before any combo runs (with it they run: test_torch_dryrun_mesh.py)."""
    dryrun.main(["--arch", "whisper-medium", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    r = json.loads((tmp_path / "whisper-medium_long_500k_1.json").read_text())
    assert r["skipped"] and r["reason"] == "documented skip (DESIGN.md §5)"
    base = ["--arch", "olmo-1b", "--shape", "decode_32k", "--out",
            str(tmp_path / "x")]
    for extra in (["--multi-pod"], ["--profile", "fsdp"],
                  ["--ep-axis", "data"], ["--profile", "dp", "--multi-pod"]):
        with pytest.raises(NotImplementedError, match="queue 1 item 2"):
            dryrun.main(base + extra)
    assert not (tmp_path / "x").exists() or not os.listdir(tmp_path / "x")


def test_a_failed_combo_is_reported_and_the_sweep_goes_on(monkeypatch,
                                                          tmp_path, capsys):
    """``main``'s sweep reports a combo's error in its FAILURES list,
    writes no file for it, traces the others and exits 1; the refusal of
    a mesh option is raised."""
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

    def refuse(arch, shape, **kw):
        dryrun._refuse("the multi-pod mesh")

    monkeypatch.setattr(dryrun, "lower_combo", refuse)
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        dryrun.main(["--all", "--out", str(tmp_path / "y")])
