"""KW03 fixture: a launch whose error code is dropped."""
from repro_torch.kernels import build


def badwrap_blocked(x, out) -> None:
    build.library().badwrap_launch(x.data_ptr(), out.data_ptr())  # KW03


def checked_blocked(x, out) -> None:
    err = build.library().badwrap_launch(x.data_ptr(), out.data_ptr())
    if err:
        raise RuntimeError(f"badwrap launch failed: CUDA error {err}")


def plan(n: int) -> int:
    return n
