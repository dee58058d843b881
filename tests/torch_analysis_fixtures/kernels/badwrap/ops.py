"""KW01 / KW02 fixtures: kernel wrappers that break the contract."""
import torch

from repro_torch.kernels import checks
from tests.torch_analysis_fixtures.kernels.badwrap.kernel import (
    badwrap_blocked, checked_blocked, plan,
)
from tests.torch_analysis_fixtures.kernels.badwrap.ref import badwrap_ref


def badwrap(x):
    if checks.on_cpu(x):
        return badwrap_ref(x)
    out = torch.empty_like(x)
    badwrap_blocked(x, out)      # KW01: no checks.*_operands on the path
    return out


def badwrap_fallback(x):
    if checks.on_cpu(x):
        return badwrap_ref(x)
    return _launch(x)


def _launch(x):
    checks.cuda_operands("badwrap", (1, 1, 1), x=(x, tuple(x.shape)))
    out = torch.empty_like(x)
    try:                         # KW02: a failed launch falls back to ref
        checked_blocked(x, out)
    except RuntimeError:
        return badwrap_ref(x)
    return out


def planned(x):
    return plan(x.shape[0])      # fine: a plan, not a launch
