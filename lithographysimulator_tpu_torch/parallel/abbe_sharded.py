"""Source-sharded Abbe imaging: source-point data parallelism over a mesh.

Port of ``lithographysimulator_tpu/parallel/abbe_sharded.py``. The padded
source-point list is split over the mesh's 'source' axis; every shard runs
the single-device engine (:func:`..ops.abbe.accumulate_intensity`, on CUDA
the four int8 kernels) on its mesh entry, and the (n, n) float32 partial
images meet in one sum on the mesh's first device (the psum). The sum is
an autograd graph across devices (``Tensor.to`` is differentiable), so a
loss of the result has every shard's gradient.

Through-focus stacks also split their defocus settings over a 'focus'
axis: focus row r images its block of planes from its source shards.

Shifts live on the host, as everywhere in the port; ``max_abs_shift=None``
is worked out from them (as :func:`..ops.abbe.abbe_image_points` does), so
the windowed int8 path runs wherever it is exact; a bound above
``n // 4 - 2`` asks for the dense transform.
"""

from __future__ import annotations

import numpy as np
import torch

from .._tensors import to_tensor
from ..config import OpticsConfig
from ..models.pupil import pupil_function
from ..ops.abbe import (Solver, _pad_points, accumulate_intensity,
                        postprocess_gau23, source_points)
from .mesh import FOCUS_AXIS, SOURCE_AXIS, Mesh


def padded_source_arrays(source_map, multiple: int):
    """Host side: the live source points of ``source_map`` and their
    weights, zero-weight padded so their length divides ``multiple``
    (devices * chunk). Returns (shifts (p, 2) int32, weights (p,) float32,
    live count), numpy arrays."""
    pts = source_points(source_map)
    shifts, weights = _pad_points(pts.shifts, pts.weights, multiple)
    return shifts, weights, pts.live_count


def host_shifts(shifts) -> np.ndarray:
    if isinstance(shifts, torch.Tensor):
        shifts = shifts.detach().cpu().numpy()
    return np.asarray(shifts).reshape(-1, 2)


def shard_bounds(total: int, parts: int) -> list:
    """``parts`` contiguous equal (start, stop) blocks of ``range(total)``
    (``total`` divisible by ``parts``)."""
    size = total // parts
    return [(k * size, (k + 1) * size) for k in range(parts)]


def meet(partials, first: torch.device) -> torch.Tensor:
    """The psum: the partials, each on its shard's device, summed on
    ``first`` in shard order (differentiable across devices)."""
    total = partials[0].to(first)
    for part in partials[1:]:
        total = total + part.to(first)
    return total


def normalized(image: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``image`` over the total source weight, zero for a dark source; the
    sum stays in the graph (the weights' gradient has a term through it)."""
    total = weights.sum().to(image.device)
    return torch.where(total > 0, image / torch.clamp(total, min=1e-30), 0.0)


def _check_points(p: int, n_dev: int, chunk: int) -> None:
    if p % (n_dev * chunk):
        raise ValueError(
            f"point count {p} must divide devices*chunk = {n_dev * chunk}")


def _max_shift(shifts: np.ndarray, max_abs_shift):
    if max_abs_shift is None and shifts.size:
        return int(np.abs(shifts).max())
    return max_abs_shift


def _source_partials(pupil_on, spectrum, shifts, weights, config, devices, *,
                     solver, chunk, max_abs_shift, engine) -> list:
    """Each source shard's raw (n, n) intensity on its device;
    ``pupil_on(device)`` gives the pupil there."""
    partials = []
    for dev, (lo, hi) in zip(devices, shard_bounds(len(shifts), len(devices))):
        partials.append(accumulate_intensity(
            pupil_on(dev), spectrum.to(dev), shifts[lo:hi],
            weights[lo:hi].to(dev), config, solver=solver, chunk=chunk,
            engine=engine, max_abs_shift=max_abs_shift))
    return partials


def _weights_tensor(weights, spectrum: torch.Tensor) -> torch.Tensor:
    return to_tensor(weights, device=None if isinstance(weights, torch.Tensor)
                     else spectrum.device, dtype=torch.float32)


def abbe_image_sharded(
    spectrum: torch.Tensor,
    pupil: torch.Tensor,
    shifts,
    weights,
    config: OpticsConfig,
    mesh: Mesh,
    *,
    solver: Solver = "gau23",
    chunk: int = 4,
    normalize: bool = False,
    max_abs_shift: int | None = None,
    engine: str = "auto",
) -> torch.Tensor:
    """(n, n) aerial image on the mesh's first device, the source-point
    list sharded over ``mesh``'s 'source' axis (on a 2-D mesh, that axis
    of its first focus row). ``shifts``/``weights`` length must divide
    ``mesh.shape['source'] * chunk`` (see :func:`padded_source_arrays`)."""
    devices = mesh.axis_devices(SOURCE_AXIS)
    shifts = host_shifts(shifts)
    _check_points(len(shifts), len(devices), chunk)
    weights = _weights_tensor(weights, spectrum)
    image = meet(_source_partials(
        lambda dev: pupil.to(dev), spectrum, shifts, weights, config, devices,
        solver=solver, chunk=chunk, max_abs_shift=_max_shift(shifts, max_abs_shift),
        engine=engine), mesh.first)
    if solver == "gau23":
        image = postprocess_gau23(image, config)
    return normalized(image, weights) if normalize else image


def through_focus_sharded(
    spectrum: torch.Tensor,
    aberrations_stack,
    shifts,
    weights,
    config: OpticsConfig,
    mesh: Mesh,
    *,
    solver: Solver = "gau23",
    chunk: int = 4,
    normalize: bool = False,
    max_abs_shift: int | None = None,
    engine: str = "auto",
) -> torch.Tensor:
    """(F, n, n) focal stack on the mesh's first device over a 2-D
    ('focus', 'source') mesh: the F defocus settings of
    ``aberrations_stack`` (host (F, A), or a tensor, which keeps its
    gradient) split over 'focus', source points over 'source'."""
    n_focus = mesh.shape[FOCUS_AXIS]
    n_src = mesh.shape[SOURCE_AXIS]
    f = len(aberrations_stack)
    if f % n_focus:
        raise ValueError(f"focus count {f} must divide mesh focus axis {n_focus}")
    shifts = host_shifts(shifts)
    _check_points(len(shifts), n_src, chunk)
    weights = _weights_tensor(weights, spectrum)
    max_abs_shift = _max_shift(shifts, max_abs_shift)
    if not isinstance(aberrations_stack, torch.Tensor):
        aberrations_stack = np.asarray(aberrations_stack, np.float32)
    planes = []
    for row, (lo, hi) in enumerate(shard_bounds(f, n_focus)):
        devices = mesh.axis_devices(SOURCE_AXIS, row)
        for ab in aberrations_stack[lo:hi]:
            image = meet(_source_partials(
                lambda dev: pupil_function(ab, config, device=dev), spectrum,
                shifts, weights, config, devices, solver=solver, chunk=chunk,
                max_abs_shift=max_abs_shift, engine=engine), mesh.first)
            if solver == "gau23":
                image = postprocess_gau23(image, config)
            planes.append(image)
    stack = torch.stack(planes)
    return normalized(stack, weights) if normalize else stack
