"""JB* fixtures: host syncs on the hot path, one per rule (the functions
of tests/analysis_fixtures/jb_bad.py, as tensor code)."""
import numpy as np
import torch


def jb01_item(x):
    return x.item()          # JB01: host sync


def jb02_cast(x):
    return float(x)          # JB02: cast of a tensor


def jb03_materialize(x):
    return np.asarray(x)     # JB03: host copy of a tensor


def jb04_iterate(x):
    total = torch.zeros(())
    for v in x:              # JB04: python iteration over a tensor
        total = total + v
    return total


def shapes_are_host_values(x, n: int):
    # none of these syncs: shapes, lengths and host-typed parameters
    rows = int(x.shape[0]) + len(x) + int(n)
    for d in x.shape:
        rows += d
    return rows
