"""whisper-medium [audio]: 24L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=51865 — enc-dec with conv frontend STUB [arXiv:2212.04356].

num_layers counts decoder layers; the encoder is another 24 layers over
1500 (stubbed) mel-frame embeddings (30 s at 50 Hz post-conv). The
mel-spectrogram + conv feature extractor is replaced by input_specs
providing (B, 1500, 80) frame features projected by frontend_proj
(assignment carve-out). RoPE replaces Whisper's learned positional
embeddings (DESIGN.md §4). GELU MLPs as in the reference."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    mlp="gelu",
    encoder_layers=24,
    encoder_seq=1500,
    frontend_dim=80,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke",
    arch_type="audio",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=256,
    mlp="gelu",
    encoder_layers=2,
    encoder_seq=16,
    frontend_dim=16,
    tie_embeddings=True,
    dtype="float32",
)
