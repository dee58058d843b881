"""JB05's negative fixture: conditions on host values only (shapes,
lengths, identity tests, config, host-typed parameters and returns, a
mapping's string keys). None is flagged."""
from typing import Optional

import torch


def _route(impl: Optional[str], x) -> str:
    return impl or ("cuda" if x.is_cuda else "chunked")


def host_conditions(x, cfg, n: int, mask=None, impl: Optional[str] = None,
                    params=None):
    y = torch.zeros(x.shape[1:])
    if _route(impl, x) == "cuda" and "b_q" in params:
        y = y + params["b_q"]
    if x.shape[0] > 1 and len(x) > n:
        y = y + x[0]
    if mask is not None and not cfg.causal:
        y = y * 2
    while n > 0:
        n -= 1
    assert x.dim() == 3 and x.dtype == torch.float32, x.shape
    route = "cuda" if impl == "cuda" else (impl or "chunked")
    return y, [d for d in x.shape if d > 1], route
