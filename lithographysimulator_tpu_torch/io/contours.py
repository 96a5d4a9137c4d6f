"""Printed-contour extraction and GDSII export: the fab-handoff round trip.

Port of ``lithographysimulator_tpu/io/contours.py``. Simulation ends in
rasters (aerial images, resist profiles, OPC masks); mask shops and
inspection flows consume polygons. :func:`trace_contours` traces the
boundary of a thresholded raster into closed rectilinear polygons along
pixel edges and :func:`contours_to_gds` writes them through the GDSII
writer (:mod:`.gdsii`). A device tensor is read back once; the tracing
runs on the host.

The stitching walk runs in the port's C++ library (``csrc/rasterizer.cpp``
``trace_loops``: full-chip boundary sets run to millions of edges, where a
Python dict walk costs tens of seconds), with no fallback (ROADMAP.md D11);
:func:`_trace_loops_python` is its plain version, which the tests hold it
against. The tracing is exact with respect to the raster: every loop runs
on pixel-cell boundaries, so re-rasterizing the polygons with the
centre-sampling rasterizer (:func:`.native.rasterize`) reproduces the
binary raster bit for bit. Each filled/empty pixel adjacency contributes
one directed boundary edge (interior on the left, so outer boundaries come
out counter-clockwise and holes clockwise, emitted as separate polygons
per the usual GDS XOR convention); the ambiguous checkerboard corner takes
the sharpest left turn (keeps loops simple); collinear runs collapse, so a
w x h rectangle is 4 vertices, not 2(w+h).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import OpticsConfig
from .gdsii import write_gds
from .native import rasterize, trace_loops_native


def _binary(profile, threshold: float) -> np.ndarray:
    if isinstance(profile, torch.Tensor):
        profile = profile.detach().cpu().numpy()
    arr = np.asarray(profile) > threshold
    if arr.ndim != 2:
        raise ValueError(f"expected 2-D raster, got {arr.shape}")
    return arr


def _trace_loops_python(arr: np.ndarray) -> list:
    """The plain version of :func:`.native.trace_loops_native`: (v, 2)
    int64 pixel-corner loops of a boolean raster, collinear runs collapsed."""
    h, w = arr.shape
    pad = np.zeros((h + 2, w + 2), bool)
    pad[1:-1, 1:-1] = arr
    filled = pad[1:-1, 1:-1]

    # Directed boundary edges, interior on the LEFT (CCW outer loops):
    #   bottom (empty below):  (j, i)     -> (j+1, i)
    #   right  (empty right):  (j+1, i)   -> (j+1, i+1)
    #   top    (empty above):  (j+1, i+1) -> (j, i+1)
    #   left   (empty left):   (j, i+1)   -> (j, i)
    ii, jj = np.nonzero(filled)
    segs = []
    for mask_dir, (ax0, ay0, ax1, ay1) in (
        (~pad[:-2, 1:-1][filled], (0, 0, 1, 0)),
        (~pad[1:-1, 2:][filled], (1, 0, 1, 1)),
        (~pad[2:, 1:-1][filled], (1, 1, 0, 1)),
        (~pad[1:-1, :-2][filled], (0, 1, 0, 0)),
    ):
        i, j = ii[mask_dir], jj[mask_dir]
        segs.append(np.stack([j + ax0, i + ay0, j + ax1, i + ay1], axis=1))
    edges = np.concatenate(segs)
    if edges.shape[0] == 0:
        return []

    # start-point -> outgoing edges (at most 2: the checkerboard corner)
    out_edges: dict = {}
    for x0, y0, x1, y1 in map(tuple, edges.tolist()):
        out_edges.setdefault((x0, y0), []).append((x1, y1))

    loops = []
    while out_edges:
        # never START at a checkerboard (degree-2) vertex: with no incoming
        # direction the left-turn rule is ambiguous there and can stitch a
        # figure-eight across components; a degree-1 vertex always exists
        start = next((v for v, o in out_edges.items() if len(o) == 1),
                     next(iter(out_edges)))
        cur = start
        prev = (0, 0)
        loop = [start]
        while True:
            options = out_edges[cur]
            # checkerboard vertex: the sharpest LEFT turn (largest z of the
            # cross product) hugs its own component
            nxt = max(options, key=lambda o: prev[0] * (o[1] - cur[1])
                      - prev[1] * (o[0] - cur[0]))
            options.remove(nxt)
            if not options:
                del out_edges[cur]
            prev = (nxt[0] - cur[0], nxt[1] - cur[1])
            cur = nxt
            if cur == start:
                break
            loop.append(cur)
        pts = np.asarray(loop, np.int64)
        # collapse collinear runs (all edges are axis-aligned unit steps)
        d = np.diff(np.vstack([pts, pts[:1]]), axis=0)
        keep = np.any(np.diff(np.vstack([d[-1:], d]), axis=0) != 0, axis=1)
        loops.append(pts[keep])
    return loops


def trace_contours(profile, *, threshold: float = 0.5,
                   pixel_size: float = 1.0,
                   origin=(0.0, 0.0)) -> list[np.ndarray]:
    """Closed rectilinear boundary loops of ``profile > threshold`` (a
    host array or a tensor, read back once).

    Returns a list of (v, 2) float64 arrays of (x, y) vertices in layout
    units (``origin`` + pixel-edge coordinates * ``pixel_size``); column j
    spans x in [j, j+1] pixels, row i spans y in [i, i+1], matching
    :func:`.native.rasterize`'s centre-sampling convention. Outer loops are
    CCW, hole loops CW."""
    ox, oy = origin
    return [np.stack([ox + xy[:, 0].astype(np.float64) * pixel_size,
                      oy + xy[:, 1].astype(np.float64) * pixel_size], axis=1)
            for xy in trace_loops_native(_binary(profile, threshold))]


def rasterize_loops(loops, *, pixel_size: float, n: int,
                    origin=(0.0, 0.0)) -> np.ndarray:
    """XOR-reconstruct a binary raster from traced loops: each loop's
    even-odd fill toggles membership, so hole loops carve their interior
    back out (the GDS XOR convention). The exact inverse of
    :func:`trace_contours` under centre sampling. (:func:`.native.rasterize`
    OR-combines polygons, which is right for layout input but loses
    holes.)

    Each loop is rasterized over the pixels of its bounding box only, so a
    full chip's ten thousand contours cost their own area, not ten
    thousand whole grids. A window's pixel centres are the whole grid's,
    up to the rounding of its origin, which cannot move a centre across
    a loop on the pixel lattice (what :func:`trace_contours` gives)."""
    grid = np.zeros((n, n), bool)
    ox, oy = origin
    for loop in loops:
        v = np.asarray(loop, np.float64).reshape(-1, 2)
        if len(v) < 3:
            continue
        j0, i0 = (max(0, int(np.floor((v[:, k].min() - o) / pixel_size)))
                  for k, o in ((0, ox), (1, oy)))
        j1, i1 = (min(n, int(np.ceil((v[:, k].max() - o) / pixel_size)))
                  for k, o in ((0, ox), (1, oy)))
        if j1 <= j0 or i1 <= i0:
            continue
        part = rasterize([v], origin=(ox + j0 * pixel_size,
                                      oy + i0 * pixel_size),
                         pixel_size=pixel_size, n=max(j1 - j0, i1 - i0))
        grid[i0:i1, j0:j1] ^= part[:i1 - i0, :j1 - j0] > 0.5
    return grid.astype(np.float32)


def contours_to_gds(path, profile, config: OpticsConfig | float, *,
                    threshold: float = 0.5, layer: int = 1,
                    cell: str = "CONTOUR", origin=(0.0, 0.0)):
    """Trace ``profile > threshold`` and write the loops as one GDS cell
    (coordinates in nm; outer loops and holes as separate BOUNDARYs: XOR
    semantics downstream). ``config`` supplies the pixel size (or pass it
    directly). Returns the written path."""
    px = (config.pixel_size if isinstance(config, OpticsConfig)
          else float(config))
    loops = trace_contours(profile, threshold=threshold, pixel_size=px,
                           origin=origin)
    return write_gds(path, {cell: [(layer, xy) for xy in loops]},
                     unit_nm=1.0)
