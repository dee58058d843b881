"""Pareto knee-point hyper-parameter selection (Appendix A).

Given per-configuration scores on two objectives — stationary budget-paced
Pareto AUC and non-stationary Phase-2 reward — select the knee of the
non-dominated frontier: the point with maximal perpendicular distance to
the line through the two (min-max normalised) extreme endpoints.
"""
from __future__ import annotations

import numpy as np


def pareto_frontier(points: np.ndarray) -> np.ndarray:
    """Indices of non-dominated points (both objectives maximised)."""
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    keep = []
    for i in range(n):
        dominated = False
        for j in range(n):
            if j == i:
                continue
            if (pts[j] >= pts[i]).all() and (pts[j] > pts[i]).any():
                dominated = True
                break
        if not dominated:
            keep.append(i)
    return np.asarray(keep, dtype=np.int64)


def knee_point(points: np.ndarray) -> int:
    """Knee of the Pareto frontier: max perpendicular distance to the
    endpoint chord after min-max normalisation of both objectives.

    Returns the index *into the original points array*.
    """
    pts = np.asarray(points, dtype=np.float64)
    idx = pareto_frontier(pts)
    front = pts[idx]
    lo = front.min(axis=0)
    hi = front.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    norm = (front - lo) / span
    # Order along objective 0 so endpoints are the chord extremes.
    order = np.argsort(norm[:, 0])
    norm = norm[order]
    idx = idx[order]
    if len(idx) == 1:
        return int(idx[0])
    p0, p1 = norm[0], norm[-1]
    chord = p1 - p0
    chord_len = np.linalg.norm(chord)
    if chord_len == 0:
        return int(idx[0])
    # Perpendicular distance of each frontier point to the chord.
    rel = norm - p0
    cross = np.abs(rel[:, 0] * chord[1] - rel[:, 1] * chord[0])
    dist = cross / chord_len
    return int(idx[int(np.argmax(dist))])


def auc_of_frontier(costs: np.ndarray, qualities: np.ndarray) -> float:
    """Area under a quality-vs-log-cost frontier, normalised to the swept
    cost range (the paper's budget-paced Pareto AUC objective)."""
    c = np.log(np.asarray(costs, dtype=np.float64))
    q = np.asarray(qualities, dtype=np.float64)
    order = np.argsort(c)
    c, q = c[order], q[order]
    if c[-1] == c[0]:
        return float(q.mean())
    return float(np.trapezoid(q, c) / (c[-1] - c[0]))
