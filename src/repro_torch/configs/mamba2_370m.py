"""mamba2-370m [ssm]: 48L d_model=1024, attn-free (d_ff=0), vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=16,        # unused by SSM blocks (no attention)
    num_kv_heads=16,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,     # d_inner = 2048 -> 32 SSD heads
    ssm_chunk=128,
    conv_width=4,
    tie_embeddings=True,  # mamba2 reference ties embeddings
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke",
    arch_type="ssm",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=16,
    tie_embeddings=True,
    dtype="float32",
)
