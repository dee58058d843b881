"""Model substrate of the port in PyTorch: every family of the JAX
package's model zoo (dense, SSM, hybrid, MoE, VLM and encoder-decoder
audio), served and trained."""
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    DecodeCaches,
    chunked_cross_entropy,
    decode_step,
    forward_train,
    init_caches,
    init_model,
    prefill,
    prefill_forward,
)
