"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]. We use one parameter-shared attention block applied
every 6 Mamba2 layers (the reference alternates two shared blocks;
recorded in DESIGN.md §4)."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,          # shared attention block's MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,     # d_inner = 5120 -> 80 SSD heads
    ssm_chunk=128,
    shared_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke",
    arch_type="hybrid",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=16,
    shared_attn_every=2,
    dtype="float32",
)
