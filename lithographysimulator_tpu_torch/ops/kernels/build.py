"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

``csrc/intensity_int8.cu`` is compiled for ``sm_90a`` into a shared library
with a plain C interface, on first use, into ``_build/`` inside this package
(listed in ``.gitignore``). The library's file name carries a hash of the
source and the flags, so an edited source rebuilds and a stale library is
never loaded. Nothing here runs at import: the CPU tests import every
module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE = PACKAGE_DIR / "csrc" / "intensity_int8.cu"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    "row_limb_gemm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "row_requantize": (_P, _P, _P, _P, _I, _I, _I, _P),
    "column_intensity": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}

def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the int8 kernels build from csrc/ on the GPU host")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libintensity_int8-{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library unless an up-to-date one exists; returns its path
    and nvcc's output (``-Xptxas -v``: registers, shared memory, spills per
    kernel; empty when the library was already built)."""
    lib = library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a half-written file
    return lib, proc.stdout + proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with every C function's argument types declared."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
