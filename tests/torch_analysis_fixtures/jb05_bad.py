"""JB05 fixture: a tensor where Python wants a bool, on the hot path.
torch reads it with bool(), a device->host sync; JAX raises there at
trace time, so its pass has no twin of this rule."""
import torch


def jb05_truthiness(x):
    total = torch.zeros(())
    if x.any():              # JB05: bool() of a tensor
        total = total + x.sum()
    return total
