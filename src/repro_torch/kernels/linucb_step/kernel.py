"""Launch of the CUDA step kernel (``csrc/linucb_step.cu``), and its
route.

An update kernel with one block per (arm, state) and one pacer block per
state. A block of B > 1 requests takes two launches, chained by
programmatic dependent launch: the scoring kernel writes the (S, B, K)
scores to a workspace, then the update kernel selects and applies them.
A single request (B <= 1) takes one launch: the update kernel's blocks
score the row themselves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.linucb_score.kernel import score_plan, state_ptr

ROUTES = ("single", "pdl")


def route(B: int) -> str:
    """``single`` (one launch) for B <= 1, ``pdl`` (score, then update by
    programmatic dependent launch) above."""
    return "single" if B <= 1 else "pdl"


def scores_workspace(S: int, B: int, K: int, device):
    """The (S, B, K) f32 scores the ``pdl`` route needs, else None."""
    if route(B) == "single":
        return None
    return torch.empty((S, B, K), dtype=torch.float32, device=device)


def linucb_step_blocked(ins, outs, scores, *, num_valid: int,
                        dt_max: int, states=None) -> None:
    """Run one block step. ``ins`` are the 23 operands of
    ``ref.linucb_step_ref`` in order; ``outs`` the 10 preallocated
    outputs (A', A_inv', b', theta', last_upd', arms, r, c, lam', c_ema');
    ``scores`` is ``scores_workspace(S, B, K)``. All are checked,
    contiguous CUDA tensors (``ops.linucb_step``). ``states`` = (start,
    stop) runs only those states of the stack (at most
    ``checks.MAX_STATES``; default all)."""
    S, B, d = ins[5].shape
    K = ins[2].shape[1]
    a, z = states or (0, S)
    err = build.library().linucb_step_launch(
        *(state_ptr(t, a) for t in ins), *(state_ptr(t, a) for t in outs),
        None if scores is None else state_ptr(scores, a),
        z - a, B, K, d, score_plan(S, B, K, d)["dp"], num_valid, dt_max,
        torch.cuda.current_stream(ins[0].device).cuda_stream)
    if err:
        raise RuntimeError(f"linucb_step launch failed: CUDA error {err}")
