"""Context featurisation (§2.2).

The paper encodes prompts with all-MiniLM-L6-v2 (384-d), projects to 25 PCA
components whitened to unit variance, and appends a bias term (d = 26).

The encoder is pluggable: a deterministic hashing n-gram encoder (384-d,
the same width as MiniLM) routes real text prompts end-to-end; the PCA +
whitening + bias pipeline is torch and identical regardless of the
upstream encoder. Simulation benchmarks bypass the text encoder and draw
contexts from the task-family generative model in simulator.py.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.types import resolve_device

Tensor = torch.Tensor

RAW_DIM = 384   # MiniLM-L6-v2 width; hashing encoder matches it
PCA_DIM = 25    # components kept, + 1 bias -> d = 26


def _hash_token(tok: str, seed: int) -> int:
    h = hashlib.blake2b(f"{seed}:{tok}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


def hash_encode(text: str, dim: int = RAW_DIM) -> np.ndarray:
    """Deterministic bag-of-ngrams hashing embedding (signed feature
    hashing over unigrams + bigrams), L2-normalised."""
    toks = text.lower().split()
    grams = toks + [f"{a}_{b}" for a, b in zip(toks, toks[1:])]
    v = np.zeros((dim,), np.float32)
    for g in grams:
        h = _hash_token(g, 0)
        idx = h % dim
        sign = 1.0 if (h >> 32) & 1 else -1.0
        v[idx] += sign
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def hash_encode_batch(texts: Sequence[str], dim: int = RAW_DIM) -> np.ndarray:
    return np.stack([hash_encode(t, dim) for t in texts])


@dataclasses.dataclass(frozen=True)
class PCAWhitener:
    """PCA projection + whitening + bias append, fitted offline."""

    mean: Tensor        # (raw_dim,)
    components: Tensor  # (pca_dim, raw_dim)
    scale: Tensor       # (pca_dim,) 1/sqrt(explained variance)

    @property
    def d(self) -> int:
        return self.components.shape[0] + 1

    def __call__(self, raw) -> Tensor:
        """(..., raw_dim) -> (..., pca_dim + 1) whitened + bias, on the
        whitener's device."""
        raw = torch.as_tensor(raw, dtype=torch.float32,
                              device=self.mean.device)
        z = (raw - self.mean) @ self.components.T * self.scale
        bias = torch.ones(z.shape[:-1] + (1,), dtype=z.dtype, device=z.device)
        return torch.cat([z, bias], dim=-1)


def fit_pca_whitener(raw, pca_dim: int = PCA_DIM, eps: float = 1e-6,
                     device=None) -> PCAWhitener:
    """Fit PCA + whitening via SVD of the centred design matrix. The right
    singular vectors' signs are the solver's: they may differ from another
    library's, which negates that context column."""
    raw = torch.as_tensor(np.asarray(raw), dtype=torch.float32,
                          device=resolve_device(device))
    n = raw.shape[0]
    mean = raw.mean(0)
    _, s, vt = torch.linalg.svd(raw - mean, full_matrices=False)
    var = s[:pca_dim] ** 2 / max(n - 1, 1)
    return PCAWhitener(mean=mean, components=vt[:pca_dim].contiguous(),
                       scale=1.0 / torch.sqrt(var + eps))


def featurize_texts(texts: Sequence[str], whitener: PCAWhitener) -> Tensor:
    """End-to-end prompt -> context vector x_t (the synchronous path's
    feature extractor, §3.1)."""
    return whitener(hash_encode_batch(texts))
