"""Deterministic hashing word tokenizer for the live serving demo (no
external tokenizer artifacts offline)."""
from __future__ import annotations

import hashlib
from typing import List

import numpy as np


class HashTokenizer:
    def __init__(self, vocab_size: int, bos: int = 1):
        self.vocab_size = vocab_size
        self.bos = bos

    def encode(self, text: str) -> np.ndarray:
        ids = [self.bos]
        for w in text.lower().split():
            h = hashlib.blake2b(w.encode(), digest_size=4).digest()
            ids.append(2 + int.from_bytes(h, "little") % (self.vocab_size - 2))
        return np.asarray(ids, np.int32)

    def decode(self, ids: List[int]) -> str:
        return " ".join(f"<{i}>" for i in ids)
