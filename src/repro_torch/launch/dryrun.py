"""Dry run: what each (architecture x input shape) step costs on the
production mesh, traced on ``meta`` tensors, so nothing is computed or
allocated and no card is needed.

For every (architecture x input shape) it builds the step the JAX
package's dry run lowers (``make_train_step`` on a ``TrainState``,
``prefill_forward`` on the token batch, ``decode_step(impl="einsum")`` on
the decode specs) and runs it on the production mesh, 16 x 16 = 256
devices or 2 x 16 x 16 = 512 with ``--multi-pod``, under ``--profile
tp|fsdp|dp`` and ``--ep-axis model|data``, in a world of 512 ranks of
``torch.distributed``'s fake backend when no world exists (the
counterpart of JAX's 512 placeholder devices), destroyed at the end. It
writes the JAX dry run's result keys where they mean the same; its
``xla_cost_analysis`` becomes ``flop_counter``, what
``torch.utils.flop_counter.FlopCounterMode`` counts on the same trace.

  * FLOPs and HBM bytes per device are the global totals of a trace on
    one device under ``costmodel.trace_cost`` (``step_cost``) / ``n_chips``.
  * Memory is per device. The step runs once more with its arguments
    placed as DTensors on ``meta`` shards under the placement rules
    (``launch/sharding.py``; the state by ``_state_shardings``) and the
    model's activation hints installed (``pspec.set_mesh``).
    ``argument_bytes`` is the bytes of rank 0's shards, the sum of
    ``NamedSharding.shard_shape`` over the placed leaves, which is XLA's
    ``argument_size_in_bytes``. ``output_bytes`` counts the result's
    shards that are not arguments (a decode step's caches are updated in
    place, so they count once, as arguments). ``temp_bytes`` is NOT XLA's
    number, which fuses and reuses buffers: it is the high-water mark of
    the eager local storages alive at once, every shard an op of the step
    created until it is freed (what DTensor allocates inside one op to
    redistribute its inputs is not seen).
  * ``collectives`` (``collective_estimate``) is counted on the same
    placed trace: ``roofline.count_collectives`` sees each collective
    DTensor issues for rank 0, by kind, with its result bytes and the
    wire bytes per device of the JAX package's ring models;
    ``wire_bytes_per_device`` feeds the roofline's collective term.
    ``collectives=False`` (``--skip-collectives``, the JAX dry run's
    "lowering proof only" pass) writes {} and 0 wire bytes.

Both traces run at two and three layer units and are extrapolated to the
full depth (``_depth_fit``), or trace the whole model at three units or
fewer, so a run with collectives traces no more than one without.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k [--multi-pod] [--profile fsdp] [--ep-axis data] [--skip-collectives]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--kv-dtype float8_e4m3fn] [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs, tree
from repro_torch.configs.shapes import (
    INPUT_SHAPES, input_specs, variant_for_shape,
)
from repro_torch.launch import costmodel
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import decode_step, init_model, prefill_forward
from repro_torch.models.pspec import set_mesh
from repro_torch.optim.adamw import AdamWState
from repro_torch.partition import NamedSharding, P
from repro_torch.training import make_train_step, train_state_init
from repro_torch.training.train_step import TrainState

OUT = "benchmarks/results/dryrun_torch"
# The fake world a mesh run starts when none exists: JAX's 512
# placeholder devices, which hold both production meshes.
FAKE_WORLD = 512
def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _state_shardings(mesh, param_sh):
    """The ``TrainState``'s shardings: the AdamW moments like the
    parameters, the step replicated (the JAX dry run's)."""
    rep = NamedSharding(mesh, P())
    return TrainState(
        params=param_sh,
        opt=AdamWState(step=rep, mu=param_sh, nu=param_sh),
    )


def _build_step(cfg, shape, remat: bool, infer_dtype: str = ""):
    """(step, its arguments) of one (cfg, shape), on ``meta`` tensors: the
    train step on a ``TrainState`` of f32 parameters, or the prefill or
    serve step on parameters in ``infer_dtype`` when one is given (else
    f32, as the JAX dry run's ``eval_shape`` of ``init_model`` gives)."""
    params = init_model(cfg, device="meta")
    if infer_dtype and shape.kind != "train":
        dt = getattr(torch, infer_dtype)
        params = tree.map_tree(
            lambda t: t.to(dt) if t.is_floating_point() else t, params)
    if shape.kind == "train":
        step = make_train_step(cfg, remat=remat)
        return step, (train_state_init(params), input_specs(cfg, shape))
    if shape.kind == "prefill":
        specs = input_specs(cfg, shape)
        specs.pop("labels", None)

        def prefill_step(params, batch):
            return prefill_forward(
                params, cfg, batch["tokens"], frontend=batch.get("frontend"),
                encoder_frames=batch.get("encoder_frames"), impl="chunked")

        return prefill_step, (params, specs)
    token, caches = input_specs(cfg, shape)

    def serve_step(params, tok, cch):
        return decode_step(params, cfg, tok, cch, impl="einsum")

    return serve_step, (params, token, caches)


def _layer_unit(cfg) -> int:
    """The layers of one repeating group: the hybrid's SSM blocks per
    shared-attention application, the MoE family's ``moe_every``."""
    if cfg.arch_type == "hybrid":
        return cfg.shared_attn_every
    if cfg.arch_type == "moe":
        return cfg.moe_every
    return 1


def _depth_variant(cfg, k: int):
    """cfg with num_layers = k * unit (the encoder scaled alongside)."""
    u = _layer_unit(cfg)
    kw = {"num_layers": k * u}
    if cfg.is_encdec:
        kw["encoder_layers"] = k * u
    return dataclasses.replace(cfg, **kw)


def _trace(cfg, shape, remat: bool, infer_dtype: str) -> costmodel.Cost:
    step, args = _build_step(cfg, shape, remat, infer_dtype)
    return costmodel.trace_cost(step, *args)[1]


def _fit(lo, hi, k: int):
    """The line through ``lo`` (at two units) and ``hi`` (at three),
    at ``k`` units, of every count in a ``Cost``, a collectives dict or a
    tuple of them."""
    if isinstance(lo, costmodel.Cost):
        return costmodel.Cost(**{
            f.name: _fit(getattr(lo, f.name), getattr(hi, f.name), k)
            for f in dataclasses.fields(costmodel.Cost)})
    if isinstance(lo, dict):
        return {n: _fit(lo[n], hi[n], k) for n in lo}
    if isinstance(lo, tuple):
        return tuple(_fit(a, b, k) for a, b in zip(lo, hi))
    return lo + (hi - lo) * (k - 2)


def _depth_fit(trace, cfg):
    """``trace(cfg)`` at ``cfg``'s depth; beyond three layer units, the
    traces at two and three units extrapolated linearly (``step_cost``)."""
    k_full = cfg.num_layers // _layer_unit(cfg)
    if k_full <= 3:
        return trace(cfg)
    return _fit(*(trace(_depth_variant(cfg, k)) for k in (2, 3)), k_full)


def step_cost(cfg, shape, remat: bool = True,
              infer_dtype: str = "") -> costmodel.Cost:
    """The step's ``Cost`` at ``cfg``'s depth. Beyond three layer units it
    traces depths of two and three units (``_depth_variant``) and
    extrapolates each count linearly, as the JAX dry run extrapolates its
    collectives (from depths of one and two): every unit has the same
    shapes, so FLOPs, bytes and the argument and output bytes are a + b k
    exactly, and so is the live-memory high-water mark once the first
    unit is behind it. A trace of the full depth of a 95-layer model at
    32k tokens takes minutes on the host; the two small ones take
    seconds."""
    return _depth_fit(lambda c: _trace(c, shape, remat, infer_dtype), cfg)


def _arg_shardings(mesh, cfg, shape, args, profile: str, ep_axis: str):
    """The NamedShardings of ``_build_step``'s arguments under the
    placement rules, a tree of the arguments' structure."""
    if shape.kind == "train":
        state, batch = args
        param_sh = shard_lib.tree_param_shardings(mesh, state.params,
                                                  profile, ep_axis)
        return (_state_shardings(mesh, param_sh),
                shard_lib.train_batch_shardings(mesh, batch, profile))
    param_sh = shard_lib.tree_param_shardings(mesh, args[0], profile,
                                              ep_axis)
    if shape.kind == "prefill":
        return param_sh, shard_lib.train_batch_shardings(mesh, args[1],
                                                         profile)
    return (param_sh,) + shard_lib.cache_shardings(mesh, cfg, *args[1:])


def _pos_bytes(shape) -> int:
    """A decode step's int ``pos``, a traced int32 scalar in JAX: 4."""
    return 4 if shape.kind == "decode" else 0


def argument_bytes(cfg, shape, mesh, infer_dtype: str = "",
                   profile: str = "tp", ep_axis: str = "model") -> int:
    """The step's argument bytes per device on ``mesh`` (XLA's
    ``argument_size_in_bytes``), from the shardings alone: no trace."""
    _, args = _build_step(cfg, shape, True, infer_dtype)
    shards = shard_lib.map_shardings(
        lambda t, s: t.new_empty(s.shard_shape(t.shape)), args,
        _arg_shardings(mesh, cfg, shape, args, profile, ep_axis))
    return sum(map(costmodel.nbytes, costmodel.tensors(shards))) \
        + _pos_bytes(shape)


def _mesh_trace(cfg, shape, mesh, remat: bool, infer_dtype: str,
                profile: str, ep_axis: str):
    """The step traced with its arguments placed on ``mesh``: (a ``Cost``
    whose memory counts are rank 0's local bytes, the collectives the
    step issued). ``shard_tree`` places the arguments before the count
    starts, as XLA's ``in_shardings`` place them before the program.
    Tensors the step makes from scratch (positions, masks) join as
    replicated."""
    step, args = _build_step(cfg, shape, remat, infer_dtype)
    placed = shard_lib.shard_tree(
        args, _arg_shardings(mesh, cfg, shape, args, profile, ep_axis))
    with rl.count_collectives() as colls, implicit_replication():
        cost = costmodel.trace_cost(step, *placed)[1]
    # The placed tensors count the shards DTensor cut.
    cost.argument_bytes += _pos_bytes(shape)
    return cost, colls


def mesh_cost(cfg, shape, mesh, remat: bool = True, infer_dtype: str = "",
              profile: str = "tp", ep_axis: str = "model"):
    """(per-device memory of the step on ``mesh`` as a ``Cost``, its
    collectives), at ``cfg``'s depth by ``step_cost``'s two-depth fit of
    the same placed traces. The caller installs the activation hints
    (``pspec.set_mesh``)."""
    return _depth_fit(lambda c: _mesh_trace(c, shape, mesh, remat,
                                            infer_dtype, profile, ep_axis),
                      cfg)


def _estimate(colls, verbose: bool = False):
    """JAX's clamps on a fitted collectives dict: result and wire bytes
    at least 0. Returns (the dict, the total wire bytes), and prints the
    estimate when ``verbose``."""
    est = {kind: {"count": c["count"],
                  "result_bytes": max(c["result_bytes"], 0.0),
                  "wire_bytes": max(c["wire_bytes"], 0.0)}
           for kind, c in colls.items()}
    if verbose:
        print("collective estimate (depth-extrapolated):",
              {k: "%.3e" % v["wire_bytes"] for k, v in est.items()})
    return est, sum(c["wire_bytes"] for c in est.values())


def collective_estimate(cfg, shape, mesh, remat, verbose=False,
                        profile="tp", infer_dtype="", ep_axis="model"):
    """Per-device collective counts and bytes of the step on ``mesh``,
    extrapolated over depth: (the five kinds' ``count``, ``result_bytes``
    and ``wire_bytes``, the total wire bytes), JAX's ``collective_estimate``.

    The collectives are those DTensor issues in ``_mesh_trace``, counted by
    ``roofline.count_collectives``. Each count is fitted as a + b k, k the
    depth in layer units, from the traces at two and three units, and
    evaluated at the full depth (a model of three units or fewer is traced
    whole); the bytes are clamped at 0. JAX compiles depths of one and two
    units, with its layer scan unrolled, for this fit alone; the port's
    layer loops are unrolled already, and two and three units are the
    traces its memory fit runs (``mesh_cost``), so the same traces give
    both. The caller installs the activation hints (``pspec.set_mesh``)."""
    return _estimate(mesh_cost(cfg, shape, mesh, remat, infer_dtype,
                               profile, ep_axis)[1], verbose)


@contextlib.contextmanager
def _world(n: int):
    """A process group of at least ``n`` ranks: the caller's, or, when
    none exists, a fake world of ``FAKE_WORLD`` ranks in this process,
    destroyed on the way out. A smaller world of the caller's raises in
    ``make_production_mesh``."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=max(n, FAKE_WORLD))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_run(cfg, shape, multi_pod: bool, remat: bool, infer_dtype: str,
              profile: str, ep_axis: str):
    n = 512 if multi_pod else 256
    with _world(n):
        mesh = make_production_mesh(multi_pod=multi_pod)
        set_mesh(mesh, shard_lib.activation_hint_specs(mesh, profile,
                                                       ep_axis))
        try:
            return mesh_cost(cfg, shape, mesh, remat, infer_dtype, profile,
                             ep_axis)
        finally:
            set_mesh(None)


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                remat: bool = True, verbose: bool = True,
                collectives: bool = True, profile: str = "tp",
                kv_dtype: str = "", infer_dtype: str = "",
                moe_groups: int = 0, ep_axis: str = "model") -> dict:
    """The result dict of one (arch, shape) on the production mesh
    (``multi_pod``: 2 x 16 x 16, else 16 x 16), or the documented skip.
    Prints the analyses when ``verbose``.

    ``collectives=False`` writes no collective estimate (the JAX dry
    run's pass of that name); the mesh trace runs either way, for the
    memory."""
    shape = INPUT_SHAPES[shape_name]
    cfg = variant_for_shape(configs.get_config(arch), shape)
    if cfg is None:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "documented skip (DESIGN.md §5)"}
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    if moe_groups:
        cfg = dataclasses.replace(cfg, moe_dispatch_groups=moe_groups)

    n_chips = 512 if multi_pod else 256
    mesh_name = _mesh_name(multi_pod)
    t0 = time.perf_counter()
    cost = step_cost(cfg, shape, remat, infer_dtype)
    t_trace = time.perf_counter() - t0
    t0 = time.perf_counter()
    mem_cost, colls = _mesh_run(cfg, shape, multi_pod, remat, infer_dtype,
                                profile, ep_axis)
    t_mesh = time.perf_counter() - t0
    colls, wire = (_estimate(colls, verbose) if collectives
                   else ({}, 0.0))
    mem = {"argument_bytes": mem_cost.argument_bytes,
           "output_bytes": mem_cost.output_bytes,
           "temp_bytes": mem_cost.temp_bytes,
           "peak_bytes": (mem_cost.argument_bytes + mem_cost.output_bytes
                          + mem_cost.temp_bytes)}
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "kind": shape.kind,
        "variant": {"profile": profile, "kv_dtype": kv_dtype,
                    "infer_dtype": infer_dtype},
        "n_chips": n_chips,
        "flops_per_device": cost.flops / n_chips,
        "hbm_bytes_per_device": cost.hbm_bytes / n_chips,
        "dot_flops_per_device": cost.dot_flops / n_chips,
        "flop_counter": {"flops": cost.flop_counter / n_chips},
        "collectives": colls,
        "wire_bytes_per_device": wire,
        "memory": mem,
        "active_params": cfg.active_params(),
        "total_params": cfg.total_params(),
        "model_flops_global": rl.model_flops(cfg, shape),
        "trace_s": t_trace,
        "mesh_trace_s": t_mesh,
    }
    result["model_flops_per_device"] = result["model_flops_global"] / n_chips
    result["useful_flops_ratio"] = (
        result["model_flops_global"] / max(cost.flops, 1.0))
    result.update(rl.roofline_terms(result["flops_per_device"],
                                    result["hbm_bytes_per_device"], wire))
    if verbose:
        print(f"== {arch} x {shape_name} ({mesh_name}) ==")
        print("memory:", mem)
        print("FlopCounterMode: flops=%.3e; cost model: flops=%.3e "
              "(matmul %.3e) bytes=%.3e (global)" % (
                  cost.flop_counter, cost.flops, cost.dot_flops,
                  cost.hbm_bytes))
        print("collective wire bytes/device: %.3e" % wire)
        print("roofline: compute %.4fs memory %.4fs collective %.4fs -> %s"
              % (result["compute_s"], result["memory_s"],
                 result["collective_s"], result["dominant"]))
        print("trace %.1fs; mesh trace %.1fs" % (t_trace, t_mesh),
              flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--skip-collectives", action="store_true",
                    help="no collective estimate (the lowering-proof "
                         "pass)")
    ap.add_argument("--profile", default="tp", choices=("tp", "fsdp", "dp"),
                    help="sharding profile")
    ap.add_argument("--kv-dtype", default="",
                    help="decode cache dtype override (e.g. float8_e4m3fn)")
    ap.add_argument("--infer-dtype", default="",
                    help="inference param dtype override (e.g. bfloat16)")
    ap.add_argument("--moe-groups", type=int, default=0,
                    help="grouped MoE dispatch (see models/moe.py)")
    ap.add_argument("--ep-axis", default="model", choices=("model", "data"),
                    help="mesh axis carrying the MoE expert dimension")
    ap.add_argument("--tag", default="",
                    help="suffix for result files (perf iterations)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in configs.ARCH_IDS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    suffix = _mesh_name(args.multi_pod)
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in combos:
        tag = f"{arch}_{shape}_{suffix}"
        if args.tag:
            tag += f"_{args.tag}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"skip (exists): {tag}", flush=True)
            continue
        try:
            res = lower_combo(
                arch, shape, multi_pod=args.multi_pod,
                remat=not args.no_remat,
                collectives=not args.skip_collectives,
                profile=args.profile, kv_dtype=args.kv_dtype,
                infer_dtype=args.infer_dtype, moe_groups=args.moe_groups,
                ep_axis=args.ep_axis)
        except Exception as e:  # noqa: BLE001 - report and go on
            traceback.print_exc()
            failures.append((arch, shape, str(e)[:200]))
            continue
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"all {len(combos)} combos traced OK")


if __name__ == "__main__":
    sys.exit(main())
