"""AdamW as functions of trees of tensors, in the JAX package's f32 order.

Moments are f32 whatever the parameters' dtype; global-norm gradient
clipping is fused into the update. A bf16 parameter is updated in f32
and rounded back to bf16, with no f32 master copy, as in the JAX
package. ``torch.optim.AdamW`` is another optimiser: it keeps moments in
the parameter's dtype and clips elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import tree

Tensor = torch.Tensor


@dataclasses.dataclass
class AdamWState:
    step: Tensor   # 0-d int32
    mu: Any        # first moments, f32, a tree like the params
    nu: Any        # second moments


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    device = next(tree.leaves(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree.map_tree(zeros, params),
                      nu=tree.map_tree(zeros, params))


def global_norm(grads) -> Tensor:
    """sqrt of the sum of every leaf's squares, each summed in f32."""
    sums = [torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: AdamWState,
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
):
    """Returns (new_params, new_state, {"grad_norm": the norm before
    clipping}). New tensors throughout: nothing given is modified."""
    gnorm = global_norm(grads)
    # The clipped gradient is f32 for any gradient dtype, as JAX's bf16 *
    # f32 product promotes.
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
        grads = tree.map_tree(lambda g: g.float() * scale, grads)

    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        mhat = m / c1
        vhat = v / c2
        p32 = p.float()
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), m, v

    out = tree.map_tree(upd, params, grads, state.mu, state.nu)
    pick = lambda i: tree.map_tree(lambda o: o[i], out)  # noqa: E731
    return (pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2)),
            {"grad_norm": gnorm})
