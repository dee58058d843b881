"""`repro_torch.analysis` — the port's lint suite: host syncs on the hot
path, capture and compile hazards, writer planes, lock discipline and
kernel-wrapper hygiene.

The port's main-path guarantees are invariants no type checker sees:

  * no host sync on the per-block or per-token path — one ``.item()``
    in the router's block step stalls the host until the device has
    caught up, once per block, and the closed loop is host-bound;
  * disjoint LEARN/SELECT/CONTROL writer planes and lock-guarded
    gateway state (DESIGN.md §13) — an unlocked write to gateway state
    is a lost hot-swap;
  * every kernel wrapper checks its operands before the launch, checks
    the launch's error code, and never hides a failed kernel behind the
    plain version.

This package enforces them statically: ``python -m repro_torch.analysis``
parses every module of ``src/repro_torch`` and ``chip_smoke.py``, builds
an approximate call graph rooted at the hot path's entry points
(``core.HOT_PATH_ROOTS``), runs five passes over it, and fails on any
finding not grandfathered in the committed baseline
(``analysis_baseline_torch.json``). It is the port's twin of the JAX
package's ``repro.analysis``, with the rule ids kept where the meaning
carries over; it imports neither JAX nor that package.

Passes and rule families (one module per pass under ``passes/``):

  ====  =====================================================
  JB*   host syncs on the hot path
  RT*   CUDA-graph / torch.compile rebuilds, tensor-keyed caches
  PT*   LEARN/SELECT/CONTROL writer-plane partition
  LK*   lock discipline on shared mutable serving state
  KW*   kernel-wrapper hygiene (checks, fallbacks, error codes)
  ====  =====================================================

The suite is importable (``run_analysis``) for tests; the runtime twin
of the PT rules is ``repro_torch.core.types.validate_leaf_partition``.
"""
from repro_torch.analysis.findings import Finding, Severity, load_baseline
from repro_torch.analysis.runner import run_analysis

__all__ = ["Finding", "Severity", "load_baseline", "run_analysis"]
