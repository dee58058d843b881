"""olmo-1b [dense]: 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304
— non-parametric LN [arXiv:2402.00838], tied embeddings."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="olmo-1b",
    arch_type="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="olmo-1b-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=256,
    norm="nonparametric",
    tie_embeddings=True,
    dtype="float32",
)
