"""Training step: loss + gradients + AdamW, with optional per-layer
activation checkpointing (remat).

``make_train_step`` returns step(state, batch) -> (state, metrics). The
gradients come from torch autograd over detached copies of the parameter
leaves, so a ``TrainState`` stays a plain tree of tensors, and the step is
functional, as the JAX package's is. Metrics stay tensors on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch import tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec import reduced
from repro_torch.models.transformer import forward_train
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedule import warmup_cosine

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: AdamWState


def train_state_init(params) -> TrainState:
    return TrainState(params=params, opt=adamw_init(params))


def make_train_step(
    cfg: ModelConfig,
    *,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    remat: bool = True,
    impl: str = "chunked",
) -> Callable[[TrainState, Dict[str, Tensor]], tuple]:
    """Returns step(state, batch) -> (state, metrics): metrics "loss",
    "nll", "aux", "tokens" (forward_train's), "lr" and "grad_norm" (before
    clipping). ``impl`` is forward_train's route: a kernel route raises
    NotImplementedError (the kernels have no backward)."""

    def step(state: TrainState, batch: Dict[str, Tensor]):
        params = tree.map_tree(lambda p: p.detach().requires_grad_(),
                               state.params)
        loss, metrics = forward_train(params, cfg, batch, impl=impl,
                                      remat=remat)
        # A leaf the loss does not reach gets a zero gradient, as in JAX.
        # On a mesh a gradient that is a partial sum (a parameter
        # replicated on an axis that shards the batch) is completed once,
        # XLA's data-parallel all-reduce; DTensor would complete it again
        # in each AdamW op that reads it.
        grads = [reduced(g) for g in torch.autograd.grad(
            loss, list(tree.leaves(params)), allow_unused=True,
            materialize_grads=True)]
        lr = warmup_cosine(state.opt.step + 1, peak_lr=peak_lr,
                           warmup_steps=warmup_steps,
                           total_steps=total_steps)
        new_params, new_opt, opt_metrics = adamw_update(
            state.params, tree.unflatten(state.params, grads), state.opt, lr,
            weight_decay=weight_decay, clip_norm=clip_norm)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), lr=lr, **opt_metrics)
        return TrainState(params=new_params, opt=new_opt), metrics

    return step
