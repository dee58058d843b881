"""Model configuration for every architecture family the JAX package
serves.

One frozen dataclass covers dense / MoE / SSM / hybrid / VLM / audio, as in
the JAX package, so configs and parameter counts (which price the arms)
are the same. ``torch_dtype`` and ``kv_torch_dtype`` take the place of
JAX's ``dtype_jnp``/``kv_dtype_jnp``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str           # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention
    rope_theta: float = 10_000.0
    window: int = 0                 # 0 = full causal; >0 = sliding window
    attn_bias: bool = False
    norm: str = "rmsnorm"           # rmsnorm | nonparametric (OLMo)
    mlp: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_every: int = 1
    moe_dispatch_groups: int = 1

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4

    # hybrid (Zamba2-style): shared attention block every N SSM layers
    shared_attn_every: int = 0

    # encoder-decoder (Whisper): num_layers counts decoder layers
    encoder_layers: int = 0
    encoder_seq: int = 0

    # multimodal frontends (stubbed): embeddings prepended to the text
    frontend_tokens: int = 0
    frontend_dim: int = 0

    dtype: str = "bfloat16"
    kv_dtype: str = ""   # decode-cache dtype; "" = same as dtype

    # ----- derived ---------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def kv_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.kv_dtype or self.dtype)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def __post_init__(self):
        if self.arch_type in ("dense", "moe", "vlm", "audio", "hybrid"):
            assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if self.is_moe:
            assert 0 < self.experts_per_token <= self.num_experts
        if self.arch_type in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.ssm_d_inner % self.ssm_head_dim == 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind for the decoder stack: dense/vlm/audio ->
        'attn'; moe -> 'moe' (with 'attn' interleaved when moe_every > 1);
        ssm and hybrid -> 'ssm' (the hybrid's shared attention block is
        scheduled by the decoder, not by layer kinds)."""
        if self.arch_type == "moe":
            if self.moe_every > 1:
                assert self.num_layers % self.moe_every == 0
                pattern = ("attn",) * (self.moe_every - 1) + ("moe",)
                return pattern * (self.num_layers // self.moe_every)
            return ("moe",) * self.num_layers
        if self.arch_type in ("ssm", "hybrid"):
            return ("ssm",) * self.num_layers
        return ("attn",) * self.num_layers

    def active_params(self) -> float:
        """Approximate *active* parameter count (MoE counts only routed
        experts): 6*N*D model FLOPs and FLOPs-derived pricing."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.num_heads, self.num_kv_heads, self.hd
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        mlp_dense = 3 * D * F if self.mlp == "swiglu" else 2 * D * F
        per_layer = 0.0
        for kind in self.layer_kinds():
            if kind == "attn":
                per_layer += attn + mlp_dense
            elif kind == "moe":
                router = D * self.num_experts
                per_layer += attn + router + self.experts_per_token * mlp_dense
            elif kind == "ssm":
                d_in, N, Hs = self.ssm_d_inner, self.ssm_state, self.ssm_heads
                in_proj = D * (2 * d_in + 2 * N + Hs)
                conv = self.conv_width * (d_in + 2 * N)
                out = d_in * D
                per_layer += in_proj + conv + out + 2 * Hs + d_in
        if self.arch_type == "hybrid" and self.shared_attn_every:
            per_layer += (attn + mlp_dense) / self.num_layers
        total = per_layer + V * D  # embed (lm head tied or counted once)
        if not self.tie_embeddings:
            total += V * D
        if self.is_encdec:
            enc = self.encoder_layers * (attn + mlp_dense)
            cross = self.num_layers * attn
            total += enc + cross
        return float(total)

    def total_params(self) -> float:
        """Full parameter count (all experts)."""
        if not self.is_moe:
            return self.active_params()
        D, F = self.d_model, self.d_ff
        mlp_dense = 3 * D * F if self.mlp == "swiglu" else 2 * D * F
        extra = (self.num_experts - self.experts_per_token) * mlp_dense
        n_moe = sum(1 for k in self.layer_kinds() if k == "moe")
        return self.active_params() + n_moe * extra
