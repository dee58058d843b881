"""Model substrate of the port: the dense decoder and SSM (Mamba2)
families in PyTorch."""
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    DecodeCaches,
    decode_step,
    init_caches,
    init_model,
    prefill,
    prefill_forward,
)
