"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — phi3-mini + CLIP [hf:microsoft/Phi-3-vision-128k-instruct].

The vision frontend (CLIP ViT-L/14-336: 576 patches, width 1024) is a
STUB per the assignment carve-out: input_specs provides precomputed patch
embeddings; frontend_proj maps them into the decoder width."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    frontend_tokens=576,
    frontend_dim=1024,
)

SMOKE = ModelConfig(
    name="phi-3-vision-4.2b-smoke",
    arch_type="vlm",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=256,
    frontend_tokens=16,
    frontend_dim=64,
    dtype="float32",
)
