"""Logical sharding rules: parameter paths -> PartitionSpecs, and their
DTensor placements on a ``DeviceMesh``.

The JAX package's rules, name for name:

Megatron-style tensor parallelism on the ``model`` axis:
  * column-parallel in-projections (attention q/k/v, MLP up/gate, SSM
    wz/wx/wdt), row-parallel out-projections (attention o, MLP down, SSM
    out) — activations stay model-replicated between blocks with the two
    canonical all-reduces per block;
  * vocab-parallel embedding and LM head;
  * expert-parallel MoE (expert dim on ``model``);
  * decode KV caches sequence-sharded on ``model`` (W axis) and
    batch-sharded on the data axes — the right layout when
    num_kv_heads < model-parallel degree.

Optimizer moments inherit parameter specs (same tree structure).

The port's own ``PartitionSpec`` and ``NamedSharding`` (in
``repro_torch.partition``) stand in for JAX's. The rules drop every axis
that does not divide its dimension before a sharding is made, so a
tensor placed under them is never sharded unevenly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch import tree as tree_lib
from repro_torch.models.config import ModelConfig
from repro_torch.partition import NamedSharding, P, axis_sizes, data_axis_names
from repro_torch.partition import drop_indivisible as _drop_indivisible

COL = {"w_q", "w_k", "w_v", "w_gate", "w_up", "w_in", "wz", "wx", "wdt"}
ROW = {"w_o", "w_down", "w_out", "out_proj"}
HEADED = {"A_log", "dt_bias", "D", "b_q", "b_k", "b_v", "norm_w"}
REPLICATED = {"router", "conv_w", "conv_b", "w", "wB", "wC",
              "frontend_proj"}
STACKS = {"blocks", "encoder_blocks", "dense_blocks"}


def param_spec(path_names: tuple, ndim: int, profile: str = "tp",
               ep_axis: str = "model") -> P:
    """Profiles:
      tp    — Megatron tensor parallelism on 'model', replicated on data
              (the baseline).
      fsdp  — tp + a large weight dim additionally sharded on 'data'
              (ZeRO-3-style: 16x less parameter/optimizer memory).
      dp    — pure data parallelism: params replicated, BOTH mesh axes
              carry batch (for small models where TP is all overhead).

    ``ep_axis`` places the MoE expert dimension: 'model' (baseline) or
    'data' — with grouped dispatch, the G<->E exchange then stays on ONE
    mesh axis.
    """
    name = path_names[-1]
    stacked = any(s in path_names for s in STACKS)
    moe = "moe" in path_names
    if profile == "dp":
        return P(*([None] * ndim))
    fs = "data" if profile == "fsdp" else None

    def wrap(*spec):
        if stacked:
            spec = (None,) + spec
        spec = spec + (None,) * (ndim - len(spec))
        assert len(spec) == ndim, (path_names, ndim, spec)
        return P(*spec)

    if name == "embed":
        return P(("data", "model") if profile == "fsdp" else "model", None)
    if name == "lm_head":
        return P(fs, "model")
    if name == "frontend_proj":
        return P(None, None)
    if moe and name in ("w_gate", "w_up", "w_down"):
        if ep_axis == "data":
            # EP on the data axis: one expert shard per data rank, FFN
            # fully local (no model-axis collectives inside experts)
            return wrap("data", None, None)
        return wrap("model", fs, None)          # expert parallel (+ fsdp D)
    if name in COL:
        return wrap(fs, "model")
    if name in ROW:
        return wrap("model", fs)
    if name in HEADED:
        return wrap("model")
    # REPLICATED, scalars and the rest (norm scales etc.): replicate
    return wrap()


def tree_param_shardings(mesh, tree_shape: Any, profile: str = "tp",
                         ep_axis: str = "model"):
    """A tree of tensors (``meta`` ones will do) -> a NamedSharding tree
    via the param_spec rules."""
    def one(path, leaf):
        spec = param_spec(path, leaf.dim(), profile, ep_axis)
        return NamedSharding(mesh, _drop_indivisible(mesh, spec, leaf.shape))
    return tree_lib.map_with_path(one, tree_shape)


def _div(n: int, size: int) -> bool:
    return n % size == 0 and n >= size


def batch_axes(mesh, batch: int, profile: str = "tp"):
    """Data-parallel axes if the batch divides them, else replicate.
    In the 'dp' profile every mesh axis carries batch."""
    sizes = axis_sizes(mesh)
    dd = (tuple(mesh.mesh_dim_names) if profile == "dp"
          else data_axis_names(mesh))
    if _div(batch, math.prod(sizes[n] for n in dd)):
        return dd
    dd2 = data_axis_names(mesh)
    return dd2 if _div(batch, math.prod(sizes[n] for n in dd2)) else None


def train_batch_shardings(mesh, specs: Dict[str, torch.Tensor],
                          profile: str = "tp"):
    out = {}
    for k, s in specs.items():
        bspec = batch_axes(mesh, s.shape[0], profile)
        out[k] = NamedSharding(mesh, P(bspec, *([None] * (s.dim() - 1))))
    return out


def cache_shardings(mesh, cfg: ModelConfig, token, caches):
    """NamedShardings for (token, DecodeCaches): an absent stack gets
    None, and ``pos``, an int here, the replicated sharding."""
    dd = batch_axes(mesh, token.shape[0])
    model = "model"
    n_model = axis_sizes(mesh)[model]

    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    def kv_spec(t):
        # (L, B, W, KV, hd): W sequence-sharded on model
        if t is None:
            return None
        wspec = model if _div(t.shape[2], n_model) else None
        return ns(None, dd, wspec, None, None)

    f = {k: kv_spec(getattr(caches, k))
         for k in ("k", "v", "shared_k", "shared_v")}
    if caches.ssm_conv is not None:
        f["ssm_conv"] = ns(None, dd, None, None)
        # (L, B, H, N, P): SSD heads on model
        hspec = model if _div(caches.ssm_h.shape[2], n_model) else None
        f["ssm_h"] = ns(None, dd, hspec, None, None)
    else:
        f["ssm_conv"] = f["ssm_h"] = None
    if caches.cross_k is not None:
        f["cross_k"] = f["cross_v"] = ns(None, dd, None, None, None)
    else:
        f["cross_k"] = f["cross_v"] = None
    f["pos"] = ns()
    return ns(dd, None), type(caches)(**f)


def activation_hint_specs(mesh, profile: str = "tp",
                          ep_axis: str = "model") -> Dict[str, P]:
    if profile == "dp":
        all_ax = tuple(mesh.mesh_dim_names)
        return {
            "logits": P(all_ax, None, None),
            "activations": P(all_ax, None, None),
        }
    dd = data_axis_names(mesh)
    return {
        "moe_buffer": P(ep_axis, None, None),
        "moe_group_local": P(dd, None, None, None),
        "logits": P(dd, None, "model"),
        "activations": P(dd, None, None),
    }


def map_shardings(fn, tree, shardings):
    """``fn(leaf, sharding)`` over every tensor leaf of ``tree`` and the
    NamedSharding at the same place in ``shardings`` (a tree of the same
    structure: nested mappings, tuples, named tuples and dataclasses, as
    ``tree_param_shardings`` and ``cache_shardings`` give), as a tree of
    ``tree``'s structure. Leaves that are not tensors (``pos``, absent
    stacks) stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, shardings)
    if isinstance(tree, dict):
        return {k: map_shardings(fn, v, shardings[k])
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        kids = (map_shardings(fn, v, s) for v, s in zip(tree, shardings))
        return type(tree)(*kids) if hasattr(tree, "_fields") \
            else tuple(kids)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: map_shardings(fn, getattr(tree, f.name),
                                  getattr(shardings, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def shard_tree(tree, shardings):
    """Place every tensor leaf of ``tree`` as a DTensor under the
    NamedSharding at the same place in ``shardings`` (``map_shardings``).
    Each rank cuts its shard from its own copy of the whole tensor, with
    no communication: every rank holds the same tensor (a seeded init, or
    ``meta`` tensors, whose shards allocate nothing)."""
    return map_shardings(
        lambda t, s: distribute_tensor(t, s.mesh, s.placements,
                                       src_data_rank=None),
        tree, shardings)

