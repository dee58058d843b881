"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    attn_bias=False,
)

SMOKE = ModelConfig(
    name="command-r-35b-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    dtype="float32",
)
