"""Device meshes: a named grid of ``torch.device`` entries.

Port of ``lithographysimulator_tpu/parallel/mesh.py``. The physics has two
natural parallel axes: the illumination source grid (each device images
its shard of source points, and the incoherent sums meet in one sum) and
the through-focus axis (independent defocus settings). The JAX package's
mesh is one process over the devices it sees; so is this one. A sharded
function runs each shard on its mesh entry from the calling process and
returns the whole result: the sum of the partials on the mesh's first
device is the psum, and a copy of the partials there the all-gather.

An entry may repeat: ``devices=["cuda:0"] * 4`` is a 4-way mesh on one
card (its shards run one after another on that card's stream), and
``devices=["cpu"] * 8`` is the counterpart of the JAX tests' 8 virtual
host devices. With ``devices=None`` a mesh spans every visible CUDA device
and raises where there is none: it never falls back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

SOURCE_AXIS = "source"
FOCUS_AXIS = "focus"


class Mesh:
    """An ndarray of ``torch.device`` entries with one name an axis;
    ``mesh.shape[axis]`` is that axis's size, as in JAX."""

    def __init__(self, devices, axis_names):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(given[idx])
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or grid.size == 0:
            raise ValueError(f"mesh of shape {grid.shape} needs one name an "
                             f"axis and an entry, got {axis_names}")
        self.devices = grid
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def first(self) -> torch.device:
        """Where the partials meet (the psum's and all-gather's device)."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str, index: int = 0) -> list:
        """The entries along ``axis`` at ``index`` of every other axis (a
        sharded function that splits one axis runs on these)."""
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh axes {self.axis_names}")
        k = self.axis_names.index(axis)
        sel = [index] * self.devices.ndim
        sel[k] = slice(None)
        return list(self.devices[tuple(sel)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _devices(devices) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is visible: pass devices= "
                           "(e.g. ['cpu'] * 4) for a mesh on the host")
    return [torch.device("cuda", i) for i in range(count)]


def source_mesh(n_devices: int | None = None, *, devices=None) -> Mesh:
    """1-D mesh over the source-point axis: the first ``n_devices`` of
    ``devices`` (default every visible CUDA device)."""
    devices = _devices(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"mesh of {n_devices} needs {n_devices} devices, "
                             f"have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices, (SOURCE_AXIS,))


def focus_source_mesh(focus: int, source: int | None = None, *,
                      devices=None) -> Mesh:
    """2-D (focus, source) mesh: defocus settings across the first axis,
    source-point shards across the second."""
    devices = _devices(devices)
    if source is None:
        source = len(devices) // focus
    n = focus * source
    if n > len(devices):
        raise ValueError(
            f"mesh {focus}x{source} needs {n} devices, have {len(devices)}")
    grid = np.empty((focus, source), dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i // source, i % source] = d
    return Mesh(grid, (FOCUS_AXIS, SOURCE_AXIS))
