"""Assigned input shapes and per-(arch, shape) input specs, as in the JAX
package's ``configs/shapes.py``.

A spec is a ``meta`` tensor, the torch form of ``jax.ShapeDtypeStruct``:
it has a shape and a dtype and no storage, so a dry run traces a step on
specs and allocates nothing. Decode shapes describe one serve step (ONE
new token against a KV cache of ``seq_len``); train describes the train
step; prefill the batched prefill.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_caches

LONG_CONTEXT_WINDOW = 8192  # sliding window of the dense archs at long_500k

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def variant_for_shape(cfg: ModelConfig,
                      shape: InputShape) -> Optional[ModelConfig]:
    """The architecture variant run at ``shape``, or None = skip.

    long_500k needs sub-quadratic attention: the SSM runs as it is (O(1)
    state); the hybrid's shared attention block and the dense / MoE / VLM
    families take the sliding window of ``LONG_CONTEXT_WINDOW``, so their
    KV caches stay bounded; whisper skips (an encoder-decoder audio model,
    whose 500k-token decode has no meaning: the JAX package's DESIGN.md
    §5)."""
    if shape.name == "long_500k":
        if cfg.is_encdec:
            return None
        if cfg.arch_type == "ssm":
            return cfg
        return dataclasses.replace(cfg, window=LONG_CONTEXT_WINDOW)
    return cfg


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def token_batch_specs(cfg: ModelConfig, batch: int,
                      seq: int) -> Dict[str, torch.Tensor]:
    """The train step's (and the prefill's) inputs: tokens and labels
    (B, seq) int32, or seq less the frontend's tokens for the VLM, whose
    frontend embeddings (bf16) come first; the encoder-decoder's frames
    (bf16)."""
    text_seq = seq
    specs: Dict[str, torch.Tensor] = {}
    if cfg.frontend_tokens > 0 and not cfg.is_encdec:
        text_seq = seq - cfg.frontend_tokens
        specs["frontend"] = _spec((batch, cfg.frontend_tokens,
                                   cfg.frontend_dim), torch.bfloat16)
    if cfg.is_encdec:
        specs["encoder_frames"] = _spec((batch, cfg.encoder_seq,
                                         cfg.frontend_dim), torch.bfloat16)
    specs["tokens"] = _spec((batch, text_seq), torch.int32)
    specs["labels"] = _spec((batch, text_seq), torch.int32)
    return specs


def decode_specs(cfg: ModelConfig, batch: int, seq_len: int):
    """The serve step's inputs: (token (B, 1) int32, ``DecodeCaches``),
    the caches' stacks in ``cfg.kv_torch_dtype`` (fp8 included) and the
    SSM state in f32, with the JAX package's leaves and shapes. ``pos``,
    a traced scalar in JAX and an int here, is ``seq_len - 1``: the new
    token is the cache's last position."""
    enc = cfg.encoder_seq if cfg.is_encdec else 0
    caches = init_caches(cfg, batch, seq_len, enc_seq=enc, device=META)
    return (_spec((batch, 1), torch.int32),
            caches._replace(pos=seq_len - 1))


def input_specs(cfg: ModelConfig, shape: InputShape):
    """Every model input for (arch, shape) as specs."""
    if shape.kind in ("train", "prefill"):
        return token_batch_specs(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "decode":
        return decode_specs(cfg, shape.global_batch, shape.seq_len)
    raise ValueError(shape.kind)
