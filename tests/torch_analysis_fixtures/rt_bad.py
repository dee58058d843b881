"""RT* fixtures: a graph captured per call and a tensor-keyed cache."""
import functools

import torch
from torch import Tensor


def replay_twice(fn):
    graph = torch.cuda.CUDAGraph()   # RT01: captured on every call
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    graph.replay()


@functools.lru_cache(maxsize=8)
def compiled(fn):
    return torch.compile(fn)         # fine: a cached factory


def run_compiled(fn, x):
    return compiled(fn)(x)


@functools.lru_cache(maxsize=8)
def scaled(x: Tensor, k: int):      # RT03: cache keyed by tensor identity
    return x * k
