"""Builds the port's CUDA kernels at first use and loads them.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface (and ``libdl``, through which the attention
kernel finds libcuda's ``cuTensorMapEncodeTiled``), loaded with
``ctypes``. The library lives in
``build/kernels/<hash>/`` at the root of the checkout, keyed by a hash of
the sources and flags, so a fresh checkout builds it on its first kernel
call and later calls reuse it.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libport_kernels.so"

_LIB = None
# The sweep fabric's parts run from one thread per device, and the first
# of them to launch a kernel loads the library.
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (PATH or CUDA_HOME)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join((ARCH,) + FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the library unless this source hash is built.
    Returns its path. The build log (with ``-Xptxas -v``'s registers,
    shared memory and spills per kernel) is kept beside it."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix=".tmp-"))
    cu, _ = _sources()
    procs = []
    for src in cu:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, ARCH, *FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc={proc.returncode})\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(tmp / LIB_NAME), *objs,
             "-ldl"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc={link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"kernel build failed ({', '.join(failed)}):\n"
                           + "\n".join(log))
    try:
        os.replace(tmp, out_dir)     # atomic: concurrent builds race safely
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_log() -> str:
    """The compiler output of the current build ('' before the build)."""
    p = BUILD_ROOT / source_hash() / "build.log"
    return p.read_text() if p.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with the argument
    types of every entry point declared: pointers and the stream as
    ``c_void_p``, sizes, modes and dtype codes as ``c_int``, the attention
    scale as ``c_float``, tensor strides as ``c_longlong``."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _load()
    return _LIB


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.linucb_score_launch.argtypes = [P] * 7 + [I] * 6 + [P]
    lib.linucb_score_launch.restype = I
    lib.linucb_step_launch.argtypes = [P] * 34 + [I] * 7 + [P]
    lib.linucb_step_launch.restype = I
    F = ctypes.c_float
    lib.flash_attention_launch.argtypes = [P] * 4 + [I] * 8 + [F, I, P]
    lib.flash_attention_launch.restype = I
    lib.flash_attention_tc_launch.argtypes = [P] * 4 + [I] * 8 + [F, P]
    lib.flash_attention_tc_launch.restype = I
    lib.decode_attention_launch.argtypes = [P] * 7 + [I] * 7 + [F, I, I, P]
    lib.decode_attention_launch.restype = I
    LL = ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = ([P] * 10 + [I] * 6 + [LL] * 6
                                    + [I] * 4 + [P])
    lib.ssd_scan_launch.restype = I
    return lib
