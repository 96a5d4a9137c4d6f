"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

``csrc/intensity_int8.cu`` is compiled for ``sm_90a`` into a shared library
with a plain C interface, on first use, into ``_build/`` inside this package
(listed in ``.gitignore``). The library's file name carries a hash of the
source and the flags, so an edited source rebuilds and a stale library is
never loaded. Nothing here runs at import: the CPU tests import every
module and have no ``nvcc``.

Threads of one process (a server's batch worker and job runner) may make
their first kernel call together: builds and loads run under
:data:`BUILD_LOCK`, which the host rasterizer's build (``io/native.py``)
shares, and each compiler writes a temporary file of its own process and
thread before the finished library is moved into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
    "window_product_limbs": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P),
    "window_product_limbs_plan": (_P, _P, _I, _I, _I, _I, _P),
    "column_intensity": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "int8_chunk_loop": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                        _I, _I, _I, _I, _I, _I, _P, _P),
    "set_dynamic_smem": (_I,),
}


#: serializes every build and load of the package's native libraries
BUILD_LOCK = threading.RLock()
_LIBRARY = None


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


def compile_library(argv: list, source: Path, lib: Path) -> str:
    """Run the compiler ``argv`` (its path and flags) on ``source`` into
    ``lib``; returns its output. It writes a temporary file of this process
    and thread, moved into place in one step, so a concurrent build never
    loads a half-written library. Raises with the compiler's stderr."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([*argv, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"{argv[0]} could not run: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{argv[0]} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return proc.stdout + proc.stderr


def build() -> tuple[Path, str]:
    """Compile the library unless an up-to-date one exists; returns its path
    and nvcc's output (``-Xptxas -v``: registers, shared memory, spills per
    kernel), kept beside the library for later calls."""
    with BUILD_LOCK:
        lib = library_path()
        log = lib.with_suffix(".log")
        if lib.exists() and log.exists():
            return lib, log.read_text()
        log_text = compile_library([_nvcc(), *NVCC_FLAGS], SOURCE, lib)
        log.write_text(log_text)
        return lib, log_text


def sass(lib: Path) -> str:
    """``cuobjdump -sass`` of the built library: the machine code per kernel."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def load_library() -> ctypes.CDLL:
    """The built library with every C function's argument types declared,
    built and loaded once a process."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    with BUILD_LOCK:
        if _LIBRARY is None:
            lib = ctypes.CDLL(str(build()[0]))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBRARY = lib
        return _LIBRARY
