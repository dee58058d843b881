"""One-device dry run: what each (architecture x input shape) step costs on
one H100, traced on ``meta`` tensors, so nothing is computed or allocated
and no card is needed.

For every (architecture x input shape) it builds the step the JAX
package's dry run lowers (``make_train_step`` on a ``TrainState``,
``prefill_forward`` on the token batch, ``decode_step(impl="einsum")`` on
the decode specs), traces it under ``costmodel.trace_cost`` (at one and
two layer units, extrapolated to the full depth: ``step_cost``) and
writes its FLOPs, HBM bytes, live memory and roofline terms, with the JAX
dry run's result keys where they mean the same. One device has no
collective: ``collectives`` is {} and the wire bytes 0, as the JAX dry run
gives with ``collectives=False``; its ``xla_cost_analysis`` becomes
``flop_counter``, what ``torch.utils.flop_counter.FlopCounterMode`` counts
on the same trace. The mesh, the sharding profiles, the multi-pod pass and
the expert axis need sharding (ROADMAP.md, queue 1 item 3) and raise
``NotImplementedError``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--kv-dtype float8_e4m3fn] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import configs, tree
from repro_torch.configs.shapes import (
    INPUT_SHAPES, input_specs, variant_for_shape,
)
from repro_torch.launch import costmodel
from repro_torch.launch import roofline as rl
from repro_torch.models import decode_step, init_model, prefill_forward
from repro_torch.training import make_train_step, train_state_init

N_CHIPS = 1
OUT = "benchmarks/results/dryrun_torch"
SHARDING = ("needs sharding and the production mesh (ROADMAP.md, queue 1 "
            "item 3)")


def _refuse(what: str) -> None:
    raise NotImplementedError(f"{what} {SHARDING}")


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
    k_full = cfg.num_layers // _layer_unit(cfg)
    if k_full <= 3:
        return _trace(cfg, shape, remat, infer_dtype)
    lo, hi = (_trace(_depth_variant(cfg, k), shape, remat, infer_dtype)
              for k in (2, 3))
    return costmodel.Cost(**{
        f.name: getattr(lo, f.name) + (getattr(hi, f.name)
                                       - getattr(lo, f.name)) * (k_full - 2)
        for f in dataclasses.fields(costmodel.Cost)})


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                remat: bool = True, verbose: bool = True,
                profile: str = "tp", kv_dtype: str = "",
                infer_dtype: str = "", moe_groups: int = 0,
                ep_axis: str = "model") -> dict:
    """The result dict of one (arch, shape) on one device (or the
    documented skip). Prints the analyses when ``verbose``."""
    if multi_pod:
        _refuse("the multi-pod mesh")
    if profile != "tp":
        _refuse(f"the {profile!r} sharding profile")
    if ep_axis != "model":
        _refuse(f"the expert axis on {ep_axis!r}")
    shape = INPUT_SHAPES[shape_name]
    cfg = variant_for_shape(configs.get_config(arch), shape)
    if cfg is None:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "documented skip (DESIGN.md §5)"}
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    if moe_groups:
        cfg = dataclasses.replace(cfg, moe_dispatch_groups=moe_groups)

    t0 = time.perf_counter()
    cost = step_cost(cfg, shape, remat, infer_dtype)
    t_trace = time.perf_counter() - t0
    mem = {"argument_bytes": cost.argument_bytes,
           "output_bytes": cost.output_bytes,
           "temp_bytes": cost.temp_bytes,
           "peak_bytes": (cost.argument_bytes + cost.output_bytes
                          + cost.temp_bytes)}
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": str(N_CHIPS),
        "kind": shape.kind,
        "variant": {"profile": profile, "kv_dtype": kv_dtype,
                    "infer_dtype": infer_dtype},
        "n_chips": N_CHIPS,
        "flops_per_device": cost.flops / N_CHIPS,
        "hbm_bytes_per_device": cost.hbm_bytes / N_CHIPS,
        "dot_flops_per_device": cost.dot_flops / N_CHIPS,
        "flop_counter": {"flops": cost.flop_counter},
        "collectives": {},
        "wire_bytes_per_device": 0.0,
        "memory": mem,
        "active_params": cfg.active_params(),
        "total_params": cfg.total_params(),
        "model_flops_global": rl.model_flops(cfg, shape),
        "trace_s": t_trace,
    }
    result["model_flops_per_device"] = result["model_flops_global"] / N_CHIPS
    result["useful_flops_ratio"] = (
        result["model_flops_global"] / max(cost.flops, 1.0))
    result.update(rl.roofline_terms(result["flops_per_device"],
                                    result["hbm_bytes_per_device"], 0.0))
    if verbose:
        print(f"== {arch} x {shape_name} (1 device) ==")
        print("memory:", mem)
        print("FlopCounterMode: flops=%.3e; cost model: flops=%.3e "
              "(matmul %.3e) bytes=%.3e" % (
                  cost.flop_counter, cost.flops, cost.dot_flops,
                  cost.hbm_bytes))
        print("roofline: compute %.4fs memory %.4fs collective %.4fs -> %s"
              % (result["compute_s"], result["memory_s"],
                 result["collective_s"], result["dominant"]))
        print("trace %.1fs" % t_trace, flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not on one device: raises NotImplementedError")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--skip-collectives", action="store_true",
                    help="not on one device: raises NotImplementedError")
    ap.add_argument("--profile", default="tp", choices=("tp", "fsdp", "dp"),
                    help="sharding profile; one device runs tp only")
    ap.add_argument("--kv-dtype", default="",
                    help="decode cache dtype override (e.g. float8_e4m3fn)")
    ap.add_argument("--infer-dtype", default="",
                    help="inference param dtype override (e.g. bfloat16)")
    ap.add_argument("--moe-groups", type=int, default=0,
                    help="grouped MoE dispatch (see models/moe.py)")
    ap.add_argument("--ep-axis", default="model", choices=("model", "data"),
                    help="mesh axis of the MoE experts; one device: model")
    ap.add_argument("--tag", default="",
                    help="suffix for result files (perf iterations)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if args.skip_collectives:
        _refuse("--skip-collectives (the multi-pod pass)")

    if args.all:
        combos = [(a, s) for a in configs.ARCH_IDS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in combos:
        tag = f"{arch}_{shape}_{N_CHIPS}"
        if args.tag:
            tag += f"_{args.tag}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"skip (exists): {tag}", flush=True)
            continue
        try:
            res = lower_combo(arch, shape, multi_pod=args.multi_pod,
                              remat=not args.no_remat, profile=args.profile,
                              kv_dtype=args.kv_dtype,
                              infer_dtype=args.infer_dtype,
                              moe_groups=args.moe_groups,
                              ep_axis=args.ep_axis)
        except NotImplementedError:
            raise
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
