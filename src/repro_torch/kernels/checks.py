"""Operand checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

# Compile-time limits of csrc/linucb_common.cuh (kMaxD, kMaxK).
MAX_D = 128
MAX_K = 64
# Compile-time limits of csrc/attention_common.cuh (kMaxHd) and
# csrc/decode_attention.cu (kMaxG, kMaxOut), and the attention kernels'
# input types.
MAX_HD = 128
MAX_G = 64
MAX_G_HD = 2048
ATTN_DTYPES = (torch.float32, torch.bfloat16)


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
    _check(name, torch.float32, operands)


def attention_operands(name: str, hd: int, H: int, KV: int,
                       **operands) -> None:
    """Raise unless the attention operands are contiguous CUDA tensors on
    one device with the given shapes and one dtype the kernels take (that
    of the first operand; an operand may name another dtype as the third
    entry of its spec), and (hd, H, KV) are within the kernels' limits."""
    if not (1 <= hd <= MAX_HD and KV >= 1 and H % KV == 0):
        raise ValueError(f"{name}: kernel takes 1 <= hd <= {MAX_HD} and H a "
                         f"multiple of KV; got hd={hd}, H={H}, KV={KV}")
    dtype = next(iter(operands.values()))[0].dtype
    if dtype not in ATTN_DTYPES:
        raise TypeError(f"{name}: kernel takes {ATTN_DTYPES}; got {dtype}")
    _check(name, dtype, operands)


def _check(name: str, default_dtype, operands) -> None:
    device = None
    for key, spec in operands.items():
        t, shape = spec[0], tuple(spec[1])
        dtype = spec[2] if len(spec) > 2 else default_dtype
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
