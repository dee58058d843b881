"""Roofline terms of a dry-run on one H100, as the JAX package's
``launch/roofline.py`` computes them for its TPU mesh.

Three terms per (arch x shape), in seconds:

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = HBM_bytes_per_device / HBM_BW
  collective = wire_bytes_per_device / LINK_BW

The peaks are NVIDIA's H100 SXM5 data sheet's: dense bf16 on the tensor
cores 989 TFLOP/s, HBM3 3.35 TB/s, and NVLink's 900 GB/s per card, 450
GB/s each way, in the place of the TPU's per-link ICI rate. One device
has no collective, so its wire bytes are 0; the parse of XLA's HLO for
collectives comes with sharding.
"""
from __future__ import annotations

from typing import Dict

PEAK_FLOPS = 989e12     # bf16 dense, tensor cores
HBM_BW = 3.35e12        # bytes/s
LINK_BW = 450e9         # bytes/s, NVLink each way


def roofline_terms(flops: float, hbm_bytes: float,
                   wire_bytes: float) -> Dict[str, float]:
    """The three terms, the dominant one's name and ``bound_s``, its
    time: the least time the card could take."""
    terms = {"compute_s": flops / PEAK_FLOPS,
             "memory_s": hbm_bytes / HBM_BW,
             "collective_s": wire_bytes / LINK_BW}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs (global): 6·N·D to train, 2·N·D to infer, N the
    active parameters and D the tokens (one a sequence to decode)."""
    n_act = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n_act * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.seq_len * shape.global_batch
    return 2.0 * n_act * shape.global_batch
