"""Layout -> Mask: GDSII or OASIS (or raw polygon lists) rasterized onto
the grid.

Port of ``lithographysimulator_tpu/io/layout.py``. The polygons are read
and rasterized on the host (:func:`.native.rasterize`, the port's C++
library); a mask is then uploaded to ``device`` as
:func:`..models.mask.from_array` does, binary or anti-aliased (gray-level
masks feed the imaging path unchanged: intermediate transmission values
are physically meaningful for sub-pixel edges). The streaming front end
(:func:`window_provider`) hands host float32 windows to
:func:`..ops.tiled.tiled_socs_image_stream`, which uploads them a group at
a time.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import OpticsConfig
from ..models.mask import Mask, from_array
from .gdsii import GDSLibrary, read_gds
from .native import rasterize
from .oasis import MAGIC, read_oasis


def _centered_origin(polys: list, field_nm: float):
    """The (x, y) that centres the polygons' bounding box in a square
    field of ``field_nm``."""
    if polys:
        allv = np.concatenate([np.asarray(p, np.float64).reshape(-1, 2)
                               for p in polys])
        center = 0.5 * (allv.min(axis=0) + allv.max(axis=0))
    else:
        center = np.zeros(2)
    return (center[0] - field_nm / 2.0, center[1] - field_nm / 2.0)


def mask_from_polygons(
    polygons,
    config: OpticsConfig,
    *,
    origin=None,
    antialias: int = 0,
    device,
) -> Mask:
    """Rasterize (v, 2) nm-coordinate polygons onto ``config``'s grid, as
    a mask on ``device``.

    ``origin``: layout (x, y) mapped to the grid's low corner; default
    centers the polygons' bounding box in the field.
    """
    if origin is None:
        origin = _centered_origin(list(polygons), config.field_nm)
    grid = rasterize(polygons, origin=origin, pixel_size=config.pixel_size,
                     n=config.n, antialias=antialias)
    return from_array(grid, config, device=device)


def _read_layout(path) -> GDSLibrary:
    """A GDSII or OASIS file (told apart by the OASIS magic bytes)."""
    with Path(path).open("rb") as f:
        head = f.read(len(MAGIC))
    return read_oasis(path) if head == MAGIC else read_gds(path)


def _layer_polygons(path, cell, layer) -> list:
    polys = _read_layout(path).flatten(cell)
    return [p.xy_nm for p in polys if layer is None or p.layer == layer]


def mask_from_layout(
    path,
    config: OpticsConfig,
    *,
    cell: str | None = None,
    layer: int | None = None,
    origin=None,
    antialias: int = 0,
    device,
) -> Mask:
    """Load a GDSII or OASIS file, flatten ``cell`` (default: the top
    cell), keep ``layer`` (default: all layers), and rasterize onto the
    config grid, as a mask on ``device``."""
    return mask_from_polygons(_layer_polygons(path, cell, layer), config,
                              origin=origin, antialias=antialias,
                              device=device)


def window_provider(
    polygons,
    config: OpticsConfig,
    big_n: int,
    *,
    origin=None,
    antialias: int = 0,
):
    """``window_fn(row0, col0) -> (n, n)`` host float32 window, rasterizing
    only the polygons that intersect each tile window: the streaming front
    end for :func:`..ops.tiled.tiled_socs_image_stream`. No full-chip
    raster is ever built: memory is O(tile^2) + the polygon list.

    ``origin``: layout (x, y) of chip pixel (0, 0)'s low corner; default
    centers the polygons' bounding box in the ``big_n``-pixel chip. Window
    pixel (r, c) samples layout point
    ``origin + ((col0+c+0.5) px, (row0+r+0.5) px)``: the arithmetic of one
    big :func:`.native.rasterize` call, so streamed windows are
    bit-identical to slices of the full-chip raster."""
    px = config.pixel_size
    n = config.n
    polys = [np.asarray(p, np.float64).reshape(-1, 2) for p in polygons]
    polys = [p for p in polys if len(p) >= 3]
    if origin is None:
        origin = _centered_origin(polys, big_n * px)
    if polys:
        boxes = np.array([[p[:, 0].min(), p[:, 1].min(),
                           p[:, 0].max(), p[:, 1].max()] for p in polys])
    else:
        boxes = np.zeros((0, 4))

    def window_fn(row0: int, col0: int) -> np.ndarray:
        x_lo = origin[0] + col0 * px
        y_lo = origin[1] + row0 * px
        x_hi = x_lo + n * px
        y_hi = y_lo + n * px
        hit = ((boxes[:, 0] < x_hi) & (boxes[:, 2] > x_lo)
               & (boxes[:, 1] < y_hi) & (boxes[:, 3] > y_lo))
        selected = [p for p, h in zip(polys, hit) if h]
        return rasterize(selected, origin=(x_lo, y_lo), pixel_size=px,
                         n=n, antialias=antialias)

    return window_fn


def layout_window_provider(path, config: OpticsConfig, big_n: int, *,
                           cell: str | None = None, layer: int | None = None,
                           origin=None, antialias: int = 0):
    """:func:`window_provider` straight from a GDSII/OASIS file."""
    return window_provider(_layer_polygons(path, cell, layer), config, big_n,
                           origin=origin, antialias=antialias)


# the JAX package's names for the same function
mask_from_gds = mask_from_layout
mask_from_oasis = mask_from_layout
