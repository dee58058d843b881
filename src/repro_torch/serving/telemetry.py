"""Operator telemetry for the serving gateway (DESIGN.md §13).

One ``Telemetry`` object per gateway, fed from three places:

  * the **selection plane** records every routed block (per-arm pulls,
    forced-exploration dispatches, per-decision route latency, the pacer
    dual lambda_t it scored under, and the snapshot version);
  * the **admission layer** records queue depth and window occupancy at
    every flush;
  * the **learner plane** records publishes (feedback applied, blocks
    folded, version) plus the drop/expiry counters that used to live as
    ad-hoc ``PortfolioServer`` attributes.

Export is two-shaped: ``metrics()`` — a flat ``Dict[str, float]`` (the
typed contract ``PortfolioServer.metrics`` always claimed; missing
values are ``-1.0``, never ``None``) — and ``prometheus_text()``, a
Prometheus exposition-format text endpoint (counters/gauges/summary
quantiles) for scrape-based operators.

Windows are bounded deques: latency and lambda trajectories keep the
last ``window`` samples, so a long-lived gateway's telemetry memory is
O(window), not O(traffic).
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

# Counter names owned by the telemetry module. ``inc()`` accepts only
# these (typos fail loudly instead of minting a new series).
COUNTERS = (
    "decisions_total",        # routed requests
    "blocks_total",           # routed micro-batch windows
    "forced_total",           # forced-exploration dispatches (§4.5)
    "publishes_total",        # learner snapshot publishes
    "feedback_applied_total",  # feedback rows folded into update_batch
    "feedback_late_total",    # rows applied >=1 publish after routing
    "dropped_feedback",       # unknown/duplicate/retired-arm rows dropped
    "expired_feedback",       # rows lost to store TTL aging
    "learn_retries_total",    # learner ticks retried after a control op
)


def _percentile(xs: Sequence[float], q: float) -> float:
    if not xs:
        return -1.0
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _escape_label(value) -> str:
    """Escape a Prometheus label *value* per the exposition format:
    backslash, double-quote, and newline must be backslash-escaped or
    one hostile tenant name corrupts the whole scrape page."""
    return (str(value)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


class Telemetry:
    """Thread-safe gateway telemetry: counters, per-arm pulls, bounded
    latency/lambda windows, admission gauges."""

    def __init__(self, max_arms: int, *, window: int = 4096,
                 tenant_names: Optional[Sequence[str]] = None):
        self.max_arms = int(max_arms)
        self.window = int(window)
        self.tenant_names = (None if tenant_names is None
                             else tuple(str(n) for n in tenant_names))
        self._lock = threading.Lock()
        self._counters = {name: 0 for name in COUNTERS}
        self._pulls = np.zeros(self.max_arms, np.int64)
        self._route_us: collections.deque = collections.deque(maxlen=window)
        self._lam: collections.deque = collections.deque(maxlen=window)
        self._queue_depth = 0
        self._window_fill = 0
        self._window_cap = 0
        self._snapshot_version = 0
        self._version_lag_max = 0
        # latest tenant-plane readings (DESIGN.md §15); None until the
        # learner records a table snapshot
        self._tenant: Optional[Dict[str, np.ndarray]] = None

    # ------------------------------------------------------------------
    # recording
    def inc(self, name: str, n: int = 1) -> None:
        if name not in self._counters:
            raise KeyError(f"unknown telemetry counter: {name!r} "
                           f"(have {sorted(self._counters)})")
        with self._lock:
            self._counters[name] += int(n)

    def record_route(self, arms: Iterable[int], route_us: float,
                     lam: float, *, forced: int = 0,
                     version: int = 0) -> None:
        """One routed block: per-arm pull counts, the per-decision route
        latency (µs), the pacer dual it was scored under."""
        arms = np.asarray(list(arms), np.int64)
        with self._lock:
            np.add.at(self._pulls, arms, 1)
            self._counters["decisions_total"] += int(arms.size)
            self._counters["blocks_total"] += 1
            self._counters["forced_total"] += int(forced)
            self._route_us.append(float(route_us))
            self._lam.append(float(lam))
            self._snapshot_version = max(self._snapshot_version,
                                         int(version))

    def record_admission(self, queue_depth: int, window_fill: int,
                         window_cap: int) -> None:
        with self._lock:
            self._queue_depth = int(queue_depth)
            self._window_fill = int(window_fill)
            self._window_cap = int(window_cap)

    def record_publish(self, version: int, *, n_feedback: int = 0,
                       n_blocks: int = 0) -> None:
        with self._lock:
            self._counters["publishes_total"] += 1
            self._counters["feedback_applied_total"] += int(n_feedback)
            self._snapshot_version = max(self._snapshot_version,
                                         int(version))

    def record_feedback_version(self, routed_version: int,
                                current_version: int) -> None:
        """Version lag of one feedback row: how many publishes elapsed
        between routing and its application (the late-feedback satellite:
        lag >= 1 means it decayed against newer stats — by design)."""
        lag = max(0, int(current_version) - int(routed_version))
        with self._lock:
            if lag >= 1:
                self._counters["feedback_late_total"] += 1
            self._version_lag_max = max(self._version_lag_max, lag)

    def record_tenants(self, spend, pulls, lam, budget) -> None:
        """Latest tenant-table reading (learner plane, after a publish):
        cumulative spend and pull counts, current dual lambda, and the
        budget ceiling, one entry per tenant (DESIGN.md §15)."""
        snap = {
            "spend": np.asarray(spend, np.float64).ravel(),
            "pulls": np.asarray(pulls, np.int64).ravel(),
            "lam": np.asarray(lam, np.float64).ravel(),
            "budget": np.asarray(budget, np.float64).ravel(),
        }
        n = {v.shape for v in snap.values()}
        if len(n) != 1:
            raise ValueError(f"tenant arrays disagree on shape: {n}")
        with self._lock:
            self._tenant = snap

    def _tenant_label(self, i: int) -> str:
        if self.tenant_names is not None and i < len(self.tenant_names):
            return self.tenant_names[i]
        return str(i)

    # ------------------------------------------------------------------
    # reading
    def counter(self, name: str) -> int:
        return int(self._counters[name])

    def pull_counts(self) -> np.ndarray:
        with self._lock:
            return self._pulls.copy()

    def pull_rates(self) -> np.ndarray:
        """Per-arm share of all routed decisions (zeros before traffic)."""
        pulls = self.pull_counts()
        total = pulls.sum()
        return pulls / total if total else pulls.astype(np.float64)

    def route_latency_us(self, q: float) -> float:
        with self._lock:
            return _percentile(list(self._route_us), q)

    def lam_trajectory(self) -> np.ndarray:
        with self._lock:
            return np.asarray(list(self._lam), np.float64)

    def metrics(self) -> Dict[str, float]:
        """Flat all-float metrics (``-1.0`` = no data, never ``None``)."""
        with self._lock:
            route = list(self._route_us)
            lam = list(self._lam)
            pulls = self._pulls.copy()
            tenant = self._tenant
            out: Dict[str, float] = {
                name: float(v) for name, v in self._counters.items()
            }
            out.update(
                queue_depth=float(self._queue_depth),
                window_occupancy=(self._window_fill / self._window_cap
                                  if self._window_cap else -1.0),
                snapshot_version=float(self._snapshot_version),
                feedback_version_lag_max=float(self._version_lag_max),
            )
        out["route_p50_us"] = _percentile(route, 50)
        out["route_p95_us"] = _percentile(route, 95)
        out["lam"] = float(lam[-1]) if lam else -1.0
        out["lam_mean"] = float(np.mean(lam)) if lam else -1.0
        total = pulls.sum()
        for k in range(self.max_arms):
            out[f"pull_rate_{k}"] = float(pulls[k] / total) if total else 0.0
        if tenant is not None:
            for i in range(tenant["lam"].size):
                n_i = int(tenant["pulls"][i])
                mean_cost = (tenant["spend"][i] / n_i) if n_i else -1.0
                out[f"tenant_spend_{i}"] = float(tenant["spend"][i])
                out[f"tenant_pulls_{i}"] = float(n_i)
                out[f"tenant_lam_{i}"] = float(tenant["lam"][i])
                out[f"tenant_budget_{i}"] = float(tenant["budget"][i])
                # mean realized cost over the budget ceiling: 1.0 = exactly
                # paced, > 1 = overspend; -1.0 before any traffic
                out[f"tenant_compliance_{i}"] = (
                    float(mean_cost / tenant["budget"][i])
                    if n_i and tenant["budget"][i] > 0 else -1.0)
        return out

    def prometheus_text(self,
                        extra: Optional[Dict[str, float]] = None) -> str:
        """Prometheus exposition format, ``paretobandit_`` prefix."""
        lines = []

        def emit(name, kind, value, help_, labels=""):
            lines.append(f"# HELP paretobandit_{name} {help_}")
            lines.append(f"# TYPE paretobandit_{name} {kind}")
            lines.append(f"paretobandit_{name}{labels} {value:.10g}")

        with self._lock:
            counters = dict(self._counters)
            pulls = self._pulls.copy()
            route = list(self._route_us)
            lam = list(self._lam)
            queue_depth = self._queue_depth
            occ = (self._window_fill / self._window_cap
                   if self._window_cap else 0.0)
            version = self._snapshot_version
            tenant = self._tenant
        for name, v in sorted(counters.items()):
            emit(name, "counter", float(v), f"{name} counter")
        lines.append("# HELP paretobandit_arm_pulls_total "
                     "routed decisions per arm slot")
        lines.append("# TYPE paretobandit_arm_pulls_total counter")
        for k in range(self.max_arms):
            lines.append(
                f'paretobandit_arm_pulls_total'
                f'{{arm="{_escape_label(k)}"}} {int(pulls[k])}')
        lines.append("# HELP paretobandit_route_latency_us "
                     "per-decision route latency (microseconds)")
        lines.append("# TYPE paretobandit_route_latency_us summary")
        for q in (0.5, 0.95, 0.99):
            v = _percentile(route, 100 * q)
            lines.append(
                f'paretobandit_route_latency_us'
                f'{{quantile="{_escape_label(f"{q:g}")}"}} '
                f"{v:.10g}")
        if tenant is not None:
            series = (
                ("tenant_spend_total", "counter", "spend",
                 "cumulative realized cost per tenant"),
                ("tenant_pulls_total", "counter", "pulls",
                 "routed decisions per tenant"),
                ("tenant_lambda", "gauge", "lam",
                 "per-tenant pacer dual lambda_t (DESIGN.md section 15)"),
                ("tenant_budget", "gauge", "budget",
                 "per-tenant budget ceiling B_j"),
            )
            for name, kind, key, help_ in series:
                lines.append(f"# HELP paretobandit_{name} {help_}")
                lines.append(f"# TYPE paretobandit_{name} {kind}")
                for i, v in enumerate(tenant[key]):
                    lines.append(
                        f'paretobandit_{name}'
                        f'{{tenant="{_escape_label(self._tenant_label(i))}"}}'
                        f" {float(v):.10g}")
        emit("pacer_lambda", "gauge", float(lam[-1]) if lam else 0.0,
             "pacer dual variable lambda_t (Eq. 4)")
        emit("queue_depth", "gauge", float(queue_depth),
             "admission queue depth at last flush")
        emit("window_occupancy", "gauge", float(occ),
             "micro-batch window fill fraction at last flush")
        emit("snapshot_version", "gauge", float(version),
             "latest published router-state version")
        for name, v in sorted((extra or {}).items()):
            emit(name, "gauge", float(v), f"{name} gauge")
        return "\n".join(lines) + "\n"
