"""Times the tensor-core SSD routes under several plans on one card.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_scan.tune

For mamba2-370m's widths (H 32, P 64, N 128, bf16) at L = 32 (the
served prompts), 128 and 2048, it runs ``ssd_scan_bhp`` under the plan
``ssd_plan`` picks and under other (heads per block, P tile) pairs,
checks each against the plain version (0.08, the bf16 SSD bar), and
prints one JSON line per plan with its time: 20 calls captured in a CUDA
graph, replayed 5 times, the least of 3 such readings, per call. The
card's name and power limit come first.
"""
from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.kernels.ssd_scan.kernel import (
    ssd_plan, ssd_scan_bhp, workspace,
)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

SHAPES = {  # (B, L, H, P, N): (heads per block, P tile) pairs tried
    (1, 32, 32, 64, 128): ((1, 64), (1, 32), (1, 16), (2, 32), (2, 16)),
    (1, 128, 32, 64, 128): ((1, 64), (1, 32), (1, 16), (2, 16)),
    (1, 2048, 32, 64, 128): ((1, 64), (1, 32), (2, 64), (2, 32), (4, 32)),
}


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (B, L, H, P, N), pairs in SHAPES.items():
        xBC = torch.randn((B, L, H * P + 2 * N), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        xs, Bi, Ci = torch.split(xBC, [H * P, N, N], dim=-1)
        dt = torch.rand((B, L, H), generator=gen, device="cuda") * 0.099 + 1e-3
        A = -(torch.rand((H,), generator=gen, device="cuda") * 3.5 + 0.5)
        D = torch.randn((H,), generator=gen, device="cuda")
        args = (xs.reshape(B, L, H, P), dt, A, Bi, Ci, D)
        chunk = min(128, L)
        want = ssd_scan_ref(*args, chunk=chunk)
        base = ssd_plan(B, L, H, P, N, chunk, torch.bfloat16, True)
        picked = (base["heads_per_block"], base["p_tile"])
        for G, TP in dict.fromkeys((picked,) + pairs):
            plan = dict(base, heads_per_block=G, p_tile=TP)
            y = torch.empty_like(args[0])
            h = torch.empty((B, H, N, P), device="cuda")
            ws = workspace(plan, B, H, N, P, "cuda")
            run = lambda: ssd_scan_bhp(*args, y, h, *ws, plan=plan)  # noqa: E731
            run()
            torch.cuda.synchronize()
            for got, ref in ((y, want[0]), (h, want[1])):
                torch.testing.assert_close(got.float(), ref.float(),
                                           rtol=0.08, atol=0.08)
            print(json.dumps(dict(
                shape=[B, L, H, P, N], route=plan["route"],
                heads_per_block=G, p_tile=TP, picked=(G, TP) == picked,
                graph_ms=min(graph_ms(run) for _ in range(3)))), flush=True)


if __name__ == "__main__":
    main()
