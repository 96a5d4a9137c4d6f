"""High-level one-call simulation pipeline.

Port of ``lithographysimulator_tpu/simulate.py`` for scalar, monochromatic,
thin-mask imaging with the exact Abbe solvers (``gau23`` and ``direct``):
mask spectrum, Zernike pupil and source point list, then the Abbe engine,
returning the aerial image and the same run report. Options outside this
slice raise ``NotImplementedError`` naming their ``ROADMAP.md`` item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Literal

import numpy as np
import torch

from .models.mask import Mask
from .models.pupil import pupil_function
from .ops.abbe import _pad_points, abbe_image_points, source_points
from .ops.fraunhofer import mask_spectrum


@dataclasses.dataclass(frozen=True)
class SimulationResult:
    image: torch.Tensor
    spectrum: torch.Tensor
    pupil: torch.Tensor
    source_map: np.ndarray
    report: dict


_NOT_PORTED = {
    "polarization": "Queue 1 item 9 (vector imaging)",
    "chromatic": "Queue 1 item 9 (chromatic imaging)",
    "perturb": "Queue 1 item 9 (perturbations)",
    "mask3d": "Queue 1 item 10 (mask-3D)",
}


def simulate(
    mask: Mask,
    source_map,
    aberrations=None,
    *,
    device,
    solver: Literal["gau23", "direct"] = "gau23",
    chunk: int = 4,
    normalize: bool = False,
    polarization=None,
    chromatic=None,
    perturb=None,
    mask3d=None,
) -> SimulationResult:
    """Run the pipeline on ``device`` ('cuda' on the card, 'cpu' in tests).
    ``source_map`` is a host (n, n) weight map (e.g. from
    :class:`..models.source.LightSource`). The image is complete when this
    returns: the device is synchronized before the wall clock is read."""
    if solver == "socs":
        raise NotImplementedError(
            "solver='socs' is not ported yet: ROADMAP.md Queue 1 items 6-7")
    if solver not in ("gau23", "direct"):
        raise ValueError(f"unknown solver {solver!r}")
    for name, value in (("polarization", polarization), ("chromatic", chromatic),
                        ("perturb", perturb), ("mask3d", mask3d)):
        if value is not None:
            raise NotImplementedError(
                f"{name} is not ported yet: ROADMAP.md {_NOT_PORTED[name]}")
    config = mask.config
    device = torch.device(device)
    t0 = time.perf_counter()

    if isinstance(source_map, torch.Tensor):
        source_map = source_map.detach().cpu().numpy()
    src_np = np.asarray(source_map)
    pts = source_points(src_np)
    shifts, weights = _pad_points(pts.shifts, pts.weights, chunk)
    if aberrations is None:
        aberrations = np.zeros((1,), np.float32)

    geometry = mask.geometry.to(device)
    spectrum = mask_spectrum(geometry, config, solver=solver)
    pupil = pupil_function(aberrations, config, device=device)
    max_abs_shift = int(np.abs(shifts).max()) if shifts.size else 0
    image = abbe_image_points(
        spectrum, pupil, shifts, weights, config, device=device,
        solver=solver, chunk=chunk, normalize=normalize,
        total_weight=pts.total_weight, max_abs_shift=max_abs_shift)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0

    ws = config.wavelength_scaling()
    report = {
        "solver": solver,
        "pixel_number": config.n,
        "pixel_size_nm": config.pixel_size,
        "wavelength_nm": config.wavelength,
        "na": config.na,
        "beta": ws.beta,
        "fft_size": ws.fft_size,
        "epsilon": ws.epsilon,
        "source_points": pts.live_count,
        "polarization": "scalar",
        "chromatic": "monochromatic",
        "mask3d": "thin",
        "wall_clock_s": elapsed,
    }
    return SimulationResult(image=image, spectrum=spectrum, pupil=pupil,
                            source_map=src_np, report=report)
