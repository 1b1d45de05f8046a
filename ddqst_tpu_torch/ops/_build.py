"""Build the port's native sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a``, and each
``csrc/<name>.cc`` (host code: the statevector engine) with ``g++``, into a
shared library with a plain C interface under ``ddqst_tpu_torch/_build/``
(listed in ``.gitignore``). CUDA sources include the shared headers
``csrc/*.cuh`` (the Philox generator). The file name carries a hash of the
flags, of the source and, for CUDA, of every header, so an edited source or
header rebuilds, an unchanged one is reused, and a ``.cu`` and a ``.cc``
never share a file. The compiler's output (for CUDA ``-Xptxas -v``:
registers, shared memory, spills) is kept beside the library as
``<lib>.log``. A missing or failing compiler raises ``RuntimeError``.

Nothing is built at import time; the wrappers in ``cuda_kernels.py`` and
``qsim/native_engine.py`` call :func:`load` on first use.
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
CXX = "g++"
HOST_FLAGS = ("-O3", "-shared", "-fPIC")

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


def _cxx() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(
            f"{CXX} not found on PATH; the statevector engine "
            "(csrc/statevec.cc) is built with a C++ compiler"
        )
    return found


def _source(name: str) -> tuple[str, tuple[str, ...], list[str]]:
    """``(source, flags, files hashed)`` of ``csrc/<name>.cc`` if it exists,
    else of ``csrc/<name>.cu``."""
    host = os.path.join(CSRC, f"{name}.cc")
    if os.path.exists(host):
        return host, HOST_FLAGS, [host]
    cuda = os.path.join(CSRC, f"{name}.cu")
    return cuda, NVCC_FLAGS, [cuda, *sorted(
        glob.glob(os.path.join(CSRC, "*.cuh")))]


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cc`` or ``.cu`` (may not
    exist yet)."""
    _, flags, hashed = _source(name)
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in hashed:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build(name: str) -> tuple[str, float]:
    """Compile ``csrc/<name>.cc`` (g++) or ``csrc/<name>.cu`` (nvcc) unless
    already built.

    Returns ``(library path, seconds spent compiling)`` (0.0 when reused).
    Raises ``RuntimeError`` with the compiler's output if the compiler is
    missing or fails.
    """
    out = library_path(name)
    if os.path.exists(out):
        return out, 0.0
    src, flags, _ = _source(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    if src.endswith(".cc"):
        cmd = [_cxx(), *flags, "-o", tmp, src]
    else:
        cmd = [_nvcc(), *flags, "-I", CSRC, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed ({proc.returncode}):\n{log}")
    with open(f"{out}.log", "w") as f:
        f.write(log)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, seconds


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cc`` or ``.cu``; cached per
    process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = _loaded[name] = ctypes.CDLL(path)
        return lib
