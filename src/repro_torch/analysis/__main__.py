"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exit status is 1 iff any finding is NOT covered by the committed
baseline. ``--write-baseline`` regenerates the
baseline (preserving existing justifications); every new entry must
then have its ``why`` filled in by hand before ``load_baseline``
accepts the file again.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.findings import (
    dedupe_keys, load_baseline, report_json, save_baseline, split_new,
)
from repro_torch.analysis.core import build_index
from repro_torch.analysis.runner import run_analysis

DEFAULT_BASELINE = "analysis_baseline_torch.json"
DEFAULT_PATHS = ["src/repro_torch", "chip_smoke.py"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="host-sync, concurrency and kernel-wrapper lints for "
                    "the PyTorch port")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to scan (default: src/repro_torch "
                         "chip_smoke.py)")
    ap.add_argument("--root", default=".", help="repo root")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file of grandfathered findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignore the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "(keeps existing justifications)")
    ap.add_argument("--report", metavar="FILE",
                    help="also write a JSON findings report")
    ap.add_argument("--rules", nargs="*",
                    help="restrict to rule ids ('JB02'), prefixes "
                         "('LK') or pass names ('locks')")
    args = ap.parse_args(argv)

    paths = args.paths or DEFAULT_PATHS
    index = build_index(paths, args.root)
    findings = run_analysis(paths, repo_root=args.root, rules=args.rules,
                            index=index)
    modules = {index.by_global[q].module.modname for q in index.hot}
    print(f"hot path: {len(index.hot)} functions in {len(modules)} "
          f"modules from {len(index.hot_roots)} roots")

    baseline = {} if args.no_baseline else load_baseline(args.baseline)

    if args.write_baseline:
        save_baseline(args.baseline, findings, whys=baseline)
        missing = [k for f, k in zip(findings, dedupe_keys(findings))
                   if k not in baseline]
        print(f"wrote {args.baseline}: {len(findings)} entries "
              f"({len(missing)} need a 'why' filled in)")
        return 0

    new, old = split_new(findings, baseline)

    if args.report:
        with open(args.report, "w") as fh:
            json.dump(report_json(findings, baseline), fh, indent=2)
            fh.write("\n")

    for f in new:
        print(f.render())
    if old:
        print(f"[{len(old)} baselined finding(s) suppressed; "
              f"see {args.baseline}]")
    if new:
        print(f"\n{len(new)} new finding(s). Fix them, or — for a "
              "deliberate exception — add a baseline entry with a "
              "'why'.")
        return 1
    print(f"analysis clean: {len(findings)} finding(s), all baselined."
          if findings else "analysis clean: no findings.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
