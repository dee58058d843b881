"""Token sampling for the decode loop."""
from __future__ import annotations

import torch

from repro_torch.core import prng


def sample_token(logits: torch.Tensor, key: torch.Tensor,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (B, V), one threefry key (2,) -> (B,) i32 next token ids.

    Greedy is the argmax (ties to the first index, as ``jnp.argmax``).
    With ``temperature > 0`` it is ``jax.random.categorical``: the argmax
    of the logits plus Gumbel noise from the port's bitwise threefry, so
    the tokens equal the JAX package's for the same key."""
    if temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    logits = logits / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff, -1e30, logits)
    noise = prng.gumbel(key.to(logits.device), tuple(logits.shape))
    return (noise + logits).argmax(-1).to(torch.int32)
