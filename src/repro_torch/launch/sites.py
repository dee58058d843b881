"""Per-site probe of the mesh dry run: one combo's placed trace on the
production mesh, its collectives by kind and by the site that issued
them (``roofline.record_sites``: the model frame, the ``pspec`` helper
and the last aten op DTensor was handed), or the place where the trace
failed. Two torches that place a collective differently show it here
site by site.

A probe traces the step at ``--units`` layer units (``dryrun._mesh_trace``,
one depth) or, with ``--fit``, gives the depth-fitted estimate the dry
run reports (``dryrun.collective_estimate``: the traces at two and three
units). ``--seq-len`` cuts the shape's sequence.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.sites --arch olmo-1b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.sites --arch dbrx-132b --shape decode_32k --multi-pod --ep-axis data --fit

The file also runs as a script against another tree's package (one whose
``roofline`` has ``record_sites``), whose ``src`` is on ``PYTHONPATH``:
  PYTHONPATH=<tree>/src python src/repro_torch/launch/sites.py --arch olmo-1b --shape prefill_32k

It prints one JSON line (``ok``, ``error``, ``wire_bytes`` by kind and in
all, ``sites``: kind, site, op, count and wire bytes, largest first) and,
with ``--out``, appends it there. Several combos run as one process each
(``xargs -P``) into one ``--out``.
"""
from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    # Run as a file, the directory of this file comes first on sys.path;
    # the package comes from PYTHONPATH.
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.getcwd()) != _here]

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

_PACKAGE = "repro_torch" + os.sep


def _failure(e: BaseException) -> dict:
    """An exception's type, message and innermost frame of the package."""
    tb = [f for f in traceback.extract_tb(e.__traceback__)
          if _PACKAGE in f.filename]
    where = (f"{tb[-1].filename.split(_PACKAGE)[-1]}:{tb[-1].lineno} "
             f"{tb[-1].name}" if tb else None)
    return {"type": type(e).__name__, "message": str(e)[:400],
            "where": where}


def probe(arch: str, shape_name: str, *, multi_pod: bool = False,
          profile: str = "tp", ep_axis: str = "model", units: int = 2,
          fit: bool = False, seq_len: int = 0, batch: int = 0,
          smoke: bool = False) -> dict:
    """One combo's probe: the result dict printed as a JSON line.
    ``seq_len`` / ``batch`` cut the shape (0: its own), ``smoke`` takes
    the SMOKE widths."""
    import torch

    from repro_torch import configs
    from repro_torch.configs.shapes import (INPUT_SHAPES, InputShape,
                                            variant_for_shape)
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import pspec

    shape = INPUT_SHAPES[shape_name]
    shape = InputShape(shape.name, seq_len or shape.seq_len,
                       batch or shape.global_batch, shape.kind)
    cfg = (configs.get_smoke if smoke else configs.get_config)(arch)
    cfg = variant_for_shape(cfg, shape)
    out = {"arch": arch, "shape": shape_name, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch,
           "mesh": "2x16x16" if multi_pod else "16x16", "profile": profile,
           "ep_axis": ep_axis, "smoke": smoke,
           "units": "fit" if fit else units, "torch": torch.__version__}
    if cfg is None:
        return dict(out, ok=True, skipped=True)
    if not fit:
        cfg = dryrun._depth_variant(cfg, units)

    t0 = time.perf_counter()
    with rl.record_sites() as seen:
        try:
            with dryrun._world(dryrun.FAKE_WORLD):
                mesh = make_production_mesh(multi_pod=multi_pod)
                pspec.set_mesh(mesh, sharding.activation_hint_specs(
                    mesh, profile, ep_axis))
                try:
                    if fit:
                        colls, _ = dryrun.collective_estimate(
                            cfg, shape, mesh, True, profile=profile,
                            ep_axis=ep_axis)
                    else:
                        _, colls = dryrun._mesh_trace(
                            cfg, shape, mesh, True, "", profile, ep_axis)
                finally:
                    pspec.set_mesh(None)
            out.update(ok=True, wire_bytes={k: c["wire_bytes"]
                                            for k, c in colls.items()},
                       counts={k: c["count"] for k, c in colls.items()},
                       total_wire_bytes=sum(c["wire_bytes"]
                                            for c in colls.values()))
        except Exception as e:  # noqa: BLE001 - a failed trace is a result
            out.update(ok=False, error=_failure(e))
    out["seconds"] = time.perf_counter() - t0
    sites: dict = {}
    for r in seen:
        where = r["site"] + (f" [{r['helper']}]" if r["helper"] else "")
        s = sites.setdefault((r["kind"], where, r["op"]), [0, 0.0])
        s[0] += 1
        s[1] += r["wire_bytes"]
    out["sites"] = [{"kind": k, "site": s, "op": op, "count": n,
                     "wire_bytes": w}
                    for (k, s, op), (n, w) in sorted(
                        sites.items(), key=lambda kv: -kv[1][1])]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--profile", default="tp", choices=("tp", "fsdp", "dp"))
    ap.add_argument("--ep-axis", default="model", choices=("model", "data"))
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--fit", action="store_true",
                    help="the depth-fitted estimate (2 and 3 units)")
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    r = probe(args.arch, args.shape, multi_pod=args.multi_pod,
              profile=args.profile, ep_axis=args.ep_axis, units=args.units,
              fit=args.fit, seq_len=args.seq_len)
    line = json.dumps(r)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
