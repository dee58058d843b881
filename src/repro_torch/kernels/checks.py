"""Operand checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

# Compile-time limits of csrc/linucb_common.cuh (kMaxD, kMaxK).
MAX_D = 128
MAX_K = 64
# The LinUCB kernels put the state axis on gridDim.y (linucb_step.cu) or
# gridDim.z (linucb_common.cuh), which CUDA caps at 65,535 blocks: their
# wrappers launch a larger stack in slices of at most this many states.
MAX_STATES = 65535
# Compile-time limits of csrc/attention_common.cuh (kMaxHd) and
# csrc/decode_attention.cu (kMaxG, kMaxOut), and the attention kernels'
# input types.
MAX_HD = 128
MAX_G = 64
MAX_G_HD = 2048
ATTN_DTYPES = (torch.float32, torch.bfloat16)
# Compile-time limits of csrc/ssd_scan.cu (kMaxQ, kMaxN) and the types its
# x / B / C operands take (dt, A and D are f32).
MAX_SSD_CHUNK = 128
MAX_SSD_N = 128
SSD_DTYPES = (torch.float32, torch.bfloat16)


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
    (tensor, shape) or (tensor, shape, dtype). Any number of states S
    passes (``state_slices``)."""
    _, K, d = skd
    if not (1 <= d <= MAX_D and 1 <= K <= MAX_K):
        raise ValueError(f"{name}: kernel takes 1 <= d <= {MAX_D} and "
                         f"1 <= K <= {MAX_K}; got d={d}, K={K}")
    _check(name, torch.float32, operands)


def state_slices(S: int) -> list:
    """The (start, stop) ranges of a LinUCB launch over S states: one
    launch per slice of at most ``MAX_STATES`` states, in order. Each
    (arm, state) has its own block, so the slices compute what one
    launch over the whole stack would."""
    return [(a, min(a + MAX_STATES, S)) for a in range(0, S, MAX_STATES)]


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


def aligned16(name: str, **tensors) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary, as a
    TMA tensor map's base address must."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key}'s data is not 16-byte aligned "
                             f"(storage offset {t.storage_offset()})")


def ssd_operands(name: str, chunk: int, *, x, dt, A, B_in, C_in,
                 D_skip) -> None:
    """Raise unless the SSD scan's operands are CUDA tensors on one device
    that the kernel takes: x (B, L, H, P) and B_in / C_in (B, L, N) of one
    dtype in ``SSD_DTYPES`` whose rows are unit-stride (x's (H, P) rows
    contiguous; batch and row strides are free, so views of one
    projection pass), dt (B, L, H), A and D_skip (H,) contiguous f32, and
    1 <= chunk <= MAX_SSD_CHUNK, 1 <= N <= MAX_SSD_N."""
    Bb, L, H, P = x.shape
    N = B_in.shape[-1]
    if not (1 <= chunk <= MAX_SSD_CHUNK and 1 <= N <= MAX_SSD_N):
        raise ValueError(f"{name}: kernel takes 1 <= chunk <= "
                         f"{MAX_SSD_CHUNK} and 1 <= N <= {MAX_SSD_N}; got "
                         f"chunk={chunk}, N={N}")
    if x.dtype not in SSD_DTYPES:
        raise TypeError(f"{name}: kernel takes x in {SSD_DTYPES}; got "
                        f"{x.dtype}")
    _check(name, torch.float32, dict(
        dt=(dt, (Bb, L, H)), A=(A, (H,)), D_skip=(D_skip, (H,))))
    for key, t, shape in (("x", x, (Bb, L, H, P)), ("B_in", B_in, (Bb, L, N)),
                          ("C_in", C_in, (Bb, L, N))):
        if t.device != dt.device:
            raise ValueError(f"{name}: {key} on {t.device}, expected "
                             f"{dt.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected "
                            f"{x.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        inner = (P, 1) if t is x else (1,)
        if tuple(t.stride())[2:] != inner:
            raise ValueError(f"{name}: {key}'s rows are not unit-stride "
                             f"(strides {tuple(t.stride())})")


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
