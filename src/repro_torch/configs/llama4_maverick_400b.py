"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 — early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

Text backbone config (the early-fusion image pathway reuses the same
frontend mechanism as the VLM config — set frontend_tokens > 0 to enable;
the assigned input shapes exercise the token path). MoE FFNs sit on every
*other* layer (moe_every=2, the Maverick interleave), which is what puts
total parameters at ~400B with ~17B active."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    moe_every=2,
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    arch_type="moe",
    num_layers=4,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    num_experts=4,
    experts_per_token=1,
    moe_every=2,
    dtype="float32",
)
