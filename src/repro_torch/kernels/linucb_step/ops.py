"""Wrapper of the fused step kernel.

On CPU tensors it runs the plain version (``ref.py``); on CUDA tensors it
checks the operands and launches the CUDA kernel, or raises. The
per-state hyper and pacer leaves and the bool masks go to the kernel as
they are, one pointer each.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import checks
from repro_torch.kernels.linucb_step.kernel import (
    ROUTES, linucb_step_blocked, route, scores_workspace,
)
from repro_torch.kernels.linucb_step.ref import linucb_step_ref

# Kernel launches since import (or since a caller reset it to 0), and the
# same by route (kernel.route: one launch for B <= 1, two chained above).
LAUNCHES = [0]
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
# The sweep fabric launches from one thread per device.
_COUNT_LOCK = threading.Lock()

# Operand names in call order, and the dtypes that are not f32.
OPERANDS = ("A", "A_inv", "b", "theta", "last_upd", "X", "rewards", "costs",
            "noise", "cand", "pen", "infl", "alpha", "gamma", "eta",
            "alpha_ema", "lambda_bar", "lam", "c_ema", "budget", "t_sel",
            "force_arm", "forced")
_DTYPES = {"last_upd": torch.int32, "t_sel": torch.int32,
           "force_arm": torch.int32, "cand": torch.bool,
           "forced": torch.bool}


def linucb_step(*operands, dt_max: int = 4096):
    """One fused block step per state. ``operands`` are those of
    ``ref.linucb_step_ref``, in the order of ``OPERANDS``. Returns
    (A', A_inv', b', theta', last_upd' (S,K) i32, arms (S,B) i32,
    r (S,B), c (S,B), lam' (S,), c_ema' (S,)). The pacer outputs are the
    ungated Eq. 3-4 fold; the router applies ``pacer.enabled``."""
    if checks.on_cpu(*operands):
        return linucb_step_ref(*operands, num_valid=operands[5].shape[1],
                               dt_max=dt_max)
    return _launch(operands, dt_max)


def _launch(ins, dt_max: int):
    """The CUDA path: check the 23 operands, allocate the 10 outputs,
    launch the kernel on the current stream, once per slice of at most
    ``checks.MAX_STATES`` states, and count each launch and its route.
    Every request row is real (num_valid = B) and the kernel takes any B
    and d <= 128, so nothing is padded."""
    A, _, b, _, last_upd, X = ins[:6]
    S, B, d = X.shape
    K = b.shape[1]
    f32 = torch.float32
    shapes = dict(A=(S, K, d, d), A_inv=(S, K, d, d), b=(S, K, d),
                  theta=(S, K, d), last_upd=(S, K), X=(S, B, d),
                  rewards=(S, B, K), costs=(S, B, K), noise=(S, B, K),
                  cand=(S, K), pen=(S, K), infl=(S, K), forced=(S, B))
    checks.cuda_operands("linucb_step", (S, K, d), **{
        n: (t, shapes.get(n, (S,)), _DTYPES.get(n, f32))
        for n, t in zip(OPERANDS, ins)})
    vec = lambda dtype=f32: torch.empty((S,), dtype=dtype,  # noqa: E731
                                        device=X.device)
    outs = (torch.empty_like(A), torch.empty_like(ins[1]),
            torch.empty_like(b), torch.empty_like(ins[3]),
            torch.empty_like(last_upd),
            torch.empty((S, B), dtype=torch.int32, device=X.device),
            torch.empty((S, B), dtype=f32, device=X.device),
            torch.empty((S, B), dtype=f32, device=X.device),
            vec(), vec())
    scores = scores_workspace(S, B, K, X.device)
    for states in checks.state_slices(S):
        linucb_step_blocked(ins, outs, scores, num_valid=B, dt_max=dt_max,
                            states=states)
        with _COUNT_LOCK:
            LAUNCHES[0] += 1
            ROUTE_LAUNCHES[route(B)] += 1
    return outs
