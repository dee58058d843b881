"""PT01 fixture: a writer-plane partition that misses a field."""
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ToyState:
    A: torch.Tensor
    b: torch.Tensor
    t: torch.Tensor
    price: torch.Tensor


LEARN_LEAVES = ("A", "b")
SELECT_LEAVES = ("t",)          # PT01: "price" belongs to no plane
