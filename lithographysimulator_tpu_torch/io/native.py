"""ctypes bridge to the port's C++ polygon rasterizer and loop tracer.

Port of ``lithographysimulator_tpu/io/native.py``, with the same functions
and semantics: pixel-centre even-odd fill, ``antialias`` coverage, boundary
loops of a binary raster. The library is built from the port's own
``csrc/rasterizer.cpp`` at first use, with ``g++ -O3 -shared -fPIC``, into
the package's ``_build/`` directory under a file name that carries a hash
of the source and the flags, under the kernels' build lock
(:data:`..ops.kernels.build.BUILD_LOCK`).

There is no silent fallback (ROADMAP.md D11): where the library does not
build, :func:`rasterize` and :func:`trace_loops_native` raise with g++'s
stderr. :func:`_rasterize_numpy` stays as the plain version of the same
rule, which the tests hold the library against bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
from pathlib import Path

import numpy as np

from ..ops.kernels import build as _build

SOURCE = _build.PACKAGE_DIR / "csrc" / "rasterizer.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIBRARY = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return _build.BUILD_DIR / f"librasterizer-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless an up-to-date one exists; its path."""
    with _build.BUILD_LOCK:
        lib = library_path()
        if not lib.exists():
            _build.compile_library(["g++", *GXX_FLAGS], SOURCE, lib)
        return lib


def _get_lib() -> ctypes.CDLL:
    """The loaded library with its argument types declared (built once a
    process); raises where it does not build or load."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    with _build.BUILD_LOCK:
        if _LIBRARY is None:
            lib = ctypes.CDLL(str(build()))
            for name in ("rasterize_polygons", "rasterize_polygons_aa",
                         "trace_loops"):
                getattr(lib, name).restype = ctypes.c_int
            lib.trace_loops.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
            ]
            lib.rasterize_polygons.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
            ]
            lib.rasterize_polygons_aa.argtypes = (
                lib.rasterize_polygons.argtypes[:7]
                + [ctypes.c_int32, ctypes.POINTER(ctypes.c_float)])
            _LIBRARY = lib
        return _LIBRARY


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def trace_loops_native(binary: np.ndarray) -> list:
    """Boundary loops of a {0, 1} raster through the library: a list of
    (v, 2) int32 pixel-corner loops (``csrc/rasterizer.cpp`` trace_loops;
    :func:`..io.contours._trace_loops_python` is the plain version)."""
    lib = _get_lib()
    arr = np.ascontiguousarray(binary.astype(np.uint8))
    h, w = arr.shape
    inner = arr.astype(bool)
    pad = np.zeros((h + 2, w + 2), bool)
    pad[1:-1, 1:-1] = inner
    n_edges = int((inner & ~pad[:-2, 1:-1]).sum()
                  + (inner & ~pad[2:, 1:-1]).sum()
                  + (inner & ~pad[1:-1, :-2]).sum()
                  + (inner & ~pad[1:-1, 2:]).sum())
    if n_edges == 0:
        return []
    out_xy = np.empty((n_edges, 2), np.int32)
    loop_sizes = np.empty(n_edges // 4 + 1, np.int32)
    rc = lib.trace_loops(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int32(h), np.int32(w),
        out_xy.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        np.longlong(n_edges),
        loop_sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        np.longlong(loop_sizes.size))
    if rc < 0:
        # the capacities are exact counts of the raster's edges and loops
        raise RuntimeError(f"native trace_loops overflowed its buffers (rc={rc})")
    loops, off = [], 0
    for k in range(rc):
        m = int(loop_sizes[k])
        loops.append(out_xy[off:off + m].copy())
        off += m
    return loops


def _pack(polygons):
    sizes = np.asarray([len(p) for p in polygons], np.int32)
    if len(polygons):
        xy = np.concatenate([np.asarray(p, np.float64).reshape(-1, 2)
                             for p in polygons]).ravel()
    else:
        xy = np.zeros(0, np.float64)
    return np.ascontiguousarray(xy), sizes


def rasterize(polygons, *, origin=(0.0, 0.0), pixel_size: float, n: int,
              antialias: int = 0) -> np.ndarray:
    """Rasterize polygons (lists of (x, y) vertices, layout units) onto an
    (n, n) float32 host grid. ``origin`` is the (x, y) of the grid's low
    corner; row iy samples y = origin[1] + (iy + 0.5) * pixel_size.
    ``antialias`` > 1 enables ss x ss coverage sampling (gray levels)."""
    grid = np.zeros((n, n), np.float32)
    xy, sizes = _pack(polygons)
    if len(sizes) == 0:
        return grid
    lib = _get_lib()
    c_xy = xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    c_sizes = sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    c_grid = grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if antialias > 1:
        rc = lib.rasterize_polygons_aa(
            c_xy, c_sizes, len(sizes), float(origin[0]), float(origin[1]),
            float(pixel_size), n, int(antialias), c_grid)
    else:
        rc = lib.rasterize_polygons(
            c_xy, c_sizes, len(sizes), float(origin[0]), float(origin[1]),
            float(pixel_size), n, c_grid)
    if rc != 0:
        raise RuntimeError(f"native rasterizer failed (rc={rc})")
    return grid


def _rasterize_numpy(polygons, origin, pixel_size, n, antialias) -> np.ndarray:
    """The plain version of :func:`rasterize`: the same pixel-centre
    even-odd rule (a vectorized crossing-number test per polygon bounding
    box)."""
    ss = max(1, int(antialias))
    nn = n * ss
    px = pixel_size / ss
    grid = np.zeros((nn, nn), np.float32)
    cx = origin[0] + (np.arange(nn) + 0.5) * px
    cy = origin[1] + (np.arange(nn) + 0.5) * px
    for poly in polygons:
        v = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(v) < 3:
            continue
        x1, y1 = v[:, 0], v[:, 1]
        x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
        iy_lo = max(0, int(np.floor((y1.min() - origin[1]) / px - 0.5)))
        iy_hi = min(nn, int(np.ceil((y1.max() - origin[1]) / px)))
        for iy in range(iy_lo, iy_hi):
            y = cy[iy]
            crosses = (y1 <= y) != (y2 <= y)
            if not crosses.any():
                continue
            xs = x1[crosses] + (y - y1[crosses]) / (y2[crosses] - y1[crosses]) \
                * (x2[crosses] - x1[crosses])
            inside = (np.sum(cx[None, :] >= np.sort(xs)[:, None], axis=0) % 2) == 1
            grid[iy, inside] = 1.0
    if ss == 1:
        return grid
    coarse = grid.reshape(n, ss, n, ss).mean(axis=(1, 3))
    return np.minimum(coarse, 1.0).astype(np.float32)
