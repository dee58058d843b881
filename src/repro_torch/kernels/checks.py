"""Operand checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

# Compile-time limits of csrc/linucb_common.cuh (kMaxD, kMaxK).
MAX_D = 128
MAX_K = 64


def on_cpu(*tensors) -> bool:
    """True when every operand lies on the CPU, False when every one lies
    on a CUDA device; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"operands must all be on the CPU or all on CUDA; got "
                     f"{sorted(kinds)}")


def cuda_operands(name: str, skd: tuple, **operands) -> None:
    """Raise unless every operand is a contiguous CUDA tensor on one
    device with the given shape and dtype (default f32), and (K, d) are
    within the kernels' limits. ``operands`` maps a name to
    (tensor, shape) or (tensor, shape, dtype)."""
    _, K, d = skd
    if not (1 <= d <= MAX_D and 1 <= K <= MAX_K):
        raise ValueError(f"{name}: kernel takes 1 <= d <= {MAX_D} and "
                         f"1 <= K <= {MAX_K}; got d={d}, K={K}")
    device = None
    for key, spec in operands.items():
        t, shape = spec[0], tuple(spec[1])
        dtype = spec[2] if len(spec) > 2 else torch.float32
        if device is None:
            device = t.device
        if t.device != device:
            raise ValueError(f"{name}: {key} on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
