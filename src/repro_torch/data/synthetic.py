"""Request streams for serving experiments: text prompts tagged with a
task family, from a seed. The JAX package's LM dataset and tenant-mix
streams belong to slices not ported yet (training, tenancy).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

_TEMPLATES = {
    "math": "solve the equation {a} x plus {b} equals {c} step by step",
    "code": "write a python function that returns the {a} th fibonacci number",
    "knowledge": "which element has atomic number {a} and why is it notable",
    "commonsense": "if it rains and {a} forgets an umbrella what happens next",
    "reasoning": "alice has {a} boxes each with {b} items how many in total",
}


def make_request_stream(
    n: int, seed: int = 0, families: Sequence[str] = tuple(_TEMPLATES),
) -> List[Dict]:
    """Text prompts tagged with a task family, for the live serving demo."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fam = families[int(rng.integers(len(families)))]
        vals = {k: int(rng.integers(2, 99)) for k in ("a", "b", "c")}
        out.append({
            "id": i,
            "family": fam,
            "prompt": _TEMPLATES[fam].format(**vals),
        })
    return out
