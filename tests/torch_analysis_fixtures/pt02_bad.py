"""PT02 fixture: two writer planes claim one leaf."""
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ToyState:
    A: torch.Tensor
    t: torch.Tensor
    key: torch.Tensor


LEARN_LEAVES = ("A", "key")
SELECT_LEAVES = ("t", "key")    # PT02: "key" is in both planes
