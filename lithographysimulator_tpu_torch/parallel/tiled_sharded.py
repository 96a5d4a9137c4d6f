"""Tile-parallel full-chip imaging: tiles split over a mesh.

Port of ``lithographysimulator_tpu/parallel/tiled_sharded.py``. Tiles are
optically independent (halo-isolated), so the tile-coordinate list is
split over the mesh's 'source' axis, each entry images its tiles with the
single-device tile pipeline of :mod:`..ops.tiled` (the slice,
``mask3d.apply``, the spectrum, :func:`..ops.hopkins.socs_image`, the
crop), and the cores are gathered into the stitched image on the mesh's
first device (the all-gather). On a mesh that repeats one device every
tile runs the same code as :func:`..ops.tiled.tiled_socs_image`, so the
two images are equal bit for bit.
"""

from __future__ import annotations

import torch

from ..config import OpticsConfig
from ..ops.hopkins import SOCSKernels
from ..ops.tiled import _core, _layout, _padded_chip
from .abbe_sharded import shard_bounds
from .mesh import SOURCE_AXIS, Mesh


def tiled_socs_image_sharded(
    mask_big,
    socs: SOCSKernels,
    tile_config: OpticsConfig,
    mesh: Mesh,
    *,
    halo: int | None = None,
    solver: str = "gau23",
    chunk: int = 4,
    engine: str = "auto",
    mask3d=None,
) -> torch.Tensor:
    """(M, M) aerial image on the mesh's first device, tiles distributed
    in contiguous blocks of the row-major tile list over ``mesh``'s
    'source' axis. The padded mask and the kernels are replicated to each
    entry. ``mask3d`` (BoundaryLayer / EdgeKernelM3D) applies a window, as
    on the single-device tiled path. Dummy tiles that pad the list to a
    multiple of the device count re-image the (0, 0) window and are
    dropped."""
    first = mesh.first
    devices = mesh.axis_devices(SOURCE_AXIS)
    big_n = mask_big.shape[-1]
    n = tile_config.n
    halo, tiles, step = _layout(big_n, tile_config, halo, mask3d)
    padded = _padded_chip(mask_big, n, halo, tiles, step, first)
    coords = [(i, j) for i in range(tiles) for j in range(tiles)]
    total = len(coords)
    coords += [(0, 0)] * ((-total) % len(devices))
    out = torch.empty((tiles * step, tiles * step), dtype=torch.float32,
                      device=first)
    for dev, (lo, hi) in zip(devices, shard_bounds(len(coords), len(devices))):
        chip = padded.to(dev)
        shard = SOCSKernels(kernels=socs.kernels.to(dev),
                            eigenvalues=socs.eigenvalues.to(dev),
                            total_rank=socs.total_rank)
        for t in range(lo, hi):
            core = _core(chip[coords[t][0] * step:coords[t][0] * step + n,
                              coords[t][1] * step:coords[t][1] * step + n],
                         shard, tile_config, halo, step, solver=solver,
                         chunk=chunk, engine=engine, spectrum_solver="gau23",
                         mask3d=mask3d)
            if t < total:
                i, j = coords[t]
                out[i * step:(i + 1) * step, j * step:(j + 1) * step] = core.to(first)
    return out[:big_n, :big_n].contiguous()
