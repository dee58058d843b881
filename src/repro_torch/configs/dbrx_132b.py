"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, 16 experts top-4 (fine-grained) [hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_token=4,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke",
    arch_type="moe",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=256,
    num_experts=4,
    experts_per_token=2,
    dtype="float32",
)
