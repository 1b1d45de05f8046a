"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, under ``ddqst_tpu_torch/_build/`` (listed
in ``.gitignore``). Sources include the shared headers ``csrc/*.cuh`` (the
Philox generator). The file name carries a hash of the source, of every
header and of the flags, so an edited source or header rebuilds and an
unchanged one is reused. The compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``<lib>.log``.

Nothing is built at import time; the wrappers in ``cuda_kernels.py`` call
:func:`load` on their first launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels are built on a machine with the CUDA toolkit"
    )


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` (may not exist yet)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu"),
                 *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build(name: str) -> tuple[str, float]:
    """Compile ``csrc/<name>.cu`` unless already built.

    Returns ``(library path, seconds spent compiling)`` (0.0 when reused).
    Raises ``RuntimeError`` with the compiler's output if nvcc fails.
    """
    out = library_path(name)
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    with open(f"{out}.log", "w") as f:
        f.write(log)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, seconds


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = _loaded[name] = ctypes.CDLL(path)
        return lib
