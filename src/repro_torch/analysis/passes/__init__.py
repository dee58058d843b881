"""Pass registry: each pass is ``run(index) -> list[Finding]``."""
from repro_torch.analysis.passes import (
    host_sync, kernel_hygiene, locks, pytree, retrace,
)

PASSES = {
    "host_sync": host_sync.run,        # JB* rules
    "retrace": retrace.run,            # RT* rules
    "pytree": pytree.run,              # PT* rules
    "locks": locks.run,                # LK* rules
    "kernel_hygiene": kernel_hygiene.run,   # KW* rules
}

__all__ = ["PASSES"]
