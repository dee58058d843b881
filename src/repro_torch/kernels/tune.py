"""Timing-based autotune of the scoring kernel's rows per block.

    PYTHONPATH=src python -m repro_torch.kernels.tune

``linucb_score`` takes ``block_r`` rows of requests a block (the JAX
op's knob of that name); the best tile depends on the shape and the
card, not something a static default can pin. ``autotune_block_r`` times
each candidate on synthetic operands of the real shape and returns the
fastest; ``best_block_r`` memoises the winner per (S, R, d, K, device)
so a serving path pays the sweep once.

The winner is not part of the numerical contract: every ``block_r`` gives
the same scores bit for bit (a (row, arm)'s sums run in an order set by
the padded width alone, ``csrc/linucb_common.cuh``). The main path keeps
the default, 128.

On the card each candidate is timed as ``ssd_scan.tune.graph_ms`` times a
plan: 20 calls captured in a CUDA graph and replayed between CUDA events.
On the CPU the plain version is timed on the host clock; it ignores
``block_r``, so the table there says nothing of the kernel, but it has
every key. The CLI prints the card's name and power limit, then one JSON
line per shape: the two ``linucb_score`` shapes of PERF.md's kernel table.
"""
from __future__ import annotations

import functools
import json
import subprocess
import time

import torch

from repro_torch.kernels.linucb_score.kernel import BLOCK_ROWS
from repro_torch.kernels.linucb_score.ops import linucb_score
from repro_torch.kernels.ssd_scan.tune import graph_ms

BLOCK_R_CANDIDATES = BLOCK_ROWS
# (S, R, K, d): the main path's served block and the largest supported shape.
SHAPES = ((20, 256, 8, 26), (1, 4096, 8, 128))


def operands(S: int, R: int, K: int, d: int, device, seed: int = 0):
    """Synthetic scoring operands in the JAX autotune's shapes with the
    state axis in front: x (S, R, d), theta (S, K, d), symmetric positive
    definite ainv (S, K, d, d) = M M^T / d + I, pen (S, K) in [0, 1),
    infl (S, K) ones, alpha (S,) 0.01. Drawn on the CPU from a seeded
    generator, then moved, so every device gets the same values."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((S, R, d), generator=gen)
    theta = torch.randn((S, K, d), generator=gen)
    m = torch.randn((S, K, d, d), generator=gen, dtype=torch.float64)
    ainv = (m @ m.transpose(-1, -2) / d + torch.eye(d, dtype=torch.float64))
    pen = torch.rand((S, K), generator=gen)
    args = (x, theta, ainv.float(), pen, torch.ones((S, K)),
            torch.full((S,), 0.01))
    return tuple(t.to(device).contiguous() for t in args)


def _host_seconds(fn, repeats: int) -> float:
    fn()                                   # warm, outside the timed region
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def autotune_block_r(R: int, d: int, K: int, *, S: int = 1, device=None,
                     repeats: int = 3, candidates=BLOCK_R_CANDIDATES):
    """Time the scoring kernel at each rows-per-block candidate on
    synthetic (S, R, K, d) operands. Returns (best_block_r, {block_r:
    seconds}), each the least of ``repeats`` timings after one warm call.
    Runs on the card unless ``device`` is "cpu". A candidate that fails to
    launch raises."""
    device = torch.device(device if device is not None else "cuda")
    args = operands(S, R, K, d, device)
    timings = {}
    for br in candidates:
        run = functools.partial(linucb_score, *args, block_r=int(br))
        if device.type == "cuda":
            timings[int(br)] = min(graph_ms(run) for _ in range(repeats)) / 1e3
        else:
            timings[int(br)] = _host_seconds(run, repeats)
    best = min(timings, key=timings.get)
    return best, timings


@functools.lru_cache(maxsize=32)
def best_block_r(R: int, d: int, K: int, *, S: int = 1,
                 device: str | None = None) -> int:
    """The memoised autotune winner for one problem shape and device."""
    best, _ = autotune_block_r(R, d, K, S=S, device=device)
    return best


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for S, R, K, d in SHAPES:
        best, table = autotune_block_r(R, d, K, S=S)
        print(json.dumps(dict(
            shape=dict(S=S, R=R, K=K, d=d),
            graph_ms={br: secs * 1e3 for br, secs in table.items()},
            best=best)), flush=True)


if __name__ == "__main__":
    main()
