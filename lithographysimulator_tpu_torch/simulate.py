"""High-level one-call simulation pipeline.

Port of ``lithographysimulator_tpu/simulate.py`` for scalar, monochromatic,
thin-mask imaging: the exact Abbe solvers (``gau23`` and ``direct``) and the
SOCS (Hopkins) fast path (``socs``), for one mask (:func:`simulate`) or a
batch under one optical setup (:func:`simulate_batch`), returning the aerial
image and the same run report. Options outside this slice raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Literal

import numpy as np
import torch

from ._tensors import to_tensor
from .config import OpticsConfig
from .models.mask import Mask
from .models.pupil import pupil_function
from .ops.abbe import _pad_points, abbe_image_points, source_points
from .ops.fraunhofer import mask_spectrum
from .ops.hopkins import (SOCSKernels, lean_auto, randomized_socs,
                          socs_image, socs_image_nrms_bound, tcc_total_trace)


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


def _check_options(solver, **options) -> None:
    if solver not in ("gau23", "direct", "socs"):
        raise ValueError(f"unknown solver {solver!r}")
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(
                f"{name} is not ported yet: ROADMAP.md {_NOT_PORTED[name]}")


def _host_inputs(source_map, aberrations):
    """(source map, aberrations) as host float32 arrays."""
    if isinstance(source_map, torch.Tensor):
        source_map = source_map.detach().cpu().numpy()
    if aberrations is None:
        aberrations = np.zeros((1,), np.float32)
    if isinstance(aberrations, torch.Tensor):
        aberrations = aberrations.detach().cpu().numpy()
    return np.asarray(source_map), np.asarray(aberrations, np.float32)


# Host-side cache of SOCS builds keyed on the concrete optics inputs: the
# rank-doubling auto loop runs on the host, and a kernel build must never
# be paid twice for the same (config, source, aberrations, rank, device).
# The kernels stay on their device, so the cache is bounded in bytes as well
# as in entries (the oldest go first): 16 kernel sets of rank 256 at 2048^2
# would hold 137 GB.
_SOCS_BUILD_CACHE: dict = {}
_SOCS_BUILD_CACHE_MAX = 16
_SOCS_BUILD_CACHE_BYTES = 16e9

_AUTO_RANK_START = 32
_AUTO_RANK_MAX = 512
_AUTO_ENERGY_TARGET = 0.999


def _socs_kernels_cached(config: OpticsConfig, src_np: np.ndarray,
                         aberrations: np.ndarray, rank: int | str, *, device,
                         tolerance: float | None = None, geometry=None,
                         chunk: int = 4):
    """Returns ``(socs, pupil, energy, bound)`` for a scalar build on
    ``device``. ``rank='auto'`` grows the rank from 32 by doubling until
    the kept eigenvalues capture 99.9% of the trace or, with
    ``tolerance``, until :func:`..ops.hopkins.socs_image_nrms_bound` of
    the mask ``geometry`` is <= tolerance (its apply uses the caller's
    ``chunk``; the bound does not depend on normalization). ``bound`` is
    None unless tolerance mode ran."""
    device = torch.device(device)
    if tolerance is not None and geometry is None:
        raise ValueError("socs tolerance mode needs the mask geometry "
                         "(the image-error bound is mask-dependent)")
    if tolerance is not None and rank != "auto":
        raise ValueError("socs_tolerance composes with socs_rank='auto' "
                         "only (a pinned rank cannot honor a tolerance)")
    geo = (None if tolerance is None
           else geometry.detach().cpu().numpy() if isinstance(geometry, torch.Tensor)
           else np.asarray(geometry))
    key = (config, src_np.tobytes(), aberrations.tobytes(), rank, tolerance,
           None if geo is None else geo.tobytes(),
           chunk if tolerance is not None else None, str(device))
    hit = _SOCS_BUILD_CACHE.get(key)
    if hit is not None:
        return hit
    pupil = pupil_function(aberrations, config, device=device)
    src = to_tensor(src_np, device=device, dtype=torch.float32)
    trace = tcc_total_trace(pupil, src_np)

    def energy_of(socs):
        kept = float(socs.eigenvalues.sum(dtype=torch.float64))
        return kept / trace if trace > 0 else 1.0

    bound = None
    if tolerance is not None:
        spectrum = mask_spectrum(torch.as_tensor(geo, device=device), config,
                                 solver="gau23")

        def bound_of(socs):
            image = socs_image(spectrum, socs, config, chunk=chunk)
            return socs_image_nrms_bound(
                socs, spectrum, image, trace=trace, pupil=pupil,
                source_map=src, config=config)

    if rank == "auto":
        # Grow the rank until the energy target (or tolerance) is met.
        # rank(TCC) <= #live source points, so never past that. Each
        # doubling warm-starts from the previous rank's Ritz basis with
        # power_iters=1; the basis is kept only where the standard-memory
        # build fits the device (the lean build has no basis).
        max_rank = max(1, min(_AUTO_RANK_MAX, int((src_np > 0).sum())))
        r = min(_AUTO_RANK_START, max_rank)
        basis = None
        while True:
            keep_basis = (r < max_rank
                          and not lean_auto(2 * r + 16, config.n, device=device))
            if basis is not None:
                socs, basis = randomized_socs(
                    pupil, src, config, rank=r, power_iters=1,
                    init_basis=basis, return_basis=True, lean=False)
            elif keep_basis:
                socs, basis = randomized_socs(pupil, src, config, rank=r,
                                              return_basis=True, lean=False)
            else:
                socs = randomized_socs(pupil, src, config, rank=r)
            energy = energy_of(socs)
            if tolerance is not None:
                bound = bound_of(socs)
                done = bound <= tolerance
            else:
                done = energy >= _AUTO_ENERGY_TARGET
            if done or r >= max_rank:
                break
            r = min(r * 2, max_rank)
            if not keep_basis:
                basis = None
    else:
        socs = randomized_socs(pupil, src, config, rank=int(rank))
        energy = energy_of(socs)
    hit = (socs, pupil, energy, bound)
    _SOCS_BUILD_CACHE[key] = hit
    while len(_SOCS_BUILD_CACHE) > 1 and (
            len(_SOCS_BUILD_CACHE) > _SOCS_BUILD_CACHE_MAX
            or sum(h[0].kernels.nbytes for h in _SOCS_BUILD_CACHE.values())
            > _SOCS_BUILD_CACHE_BYTES):
        _SOCS_BUILD_CACHE.pop(next(iter(_SOCS_BUILD_CACHE)))
    return hit


def _normalized(image: torch.Tensor, total: float) -> torch.Tensor:
    # all-dark source: a zero image, normalized or not
    return image / total if total > 0 else torch.zeros_like(image)


def _socs_apply(geometry, socs: SOCSKernels, config, *, chunk, normalize,
                w_sum):
    spectrum = mask_spectrum(geometry, config, solver="gau23")
    image = socs_image(spectrum, socs, config, chunk=chunk)
    return (_normalized(image, w_sum) if normalize else image), spectrum


def simulate(
    mask: Mask,
    source_map,
    aberrations=None,
    *,
    device,
    solver: Literal["gau23", "direct", "socs"] = "gau23",
    chunk: int = 4,
    normalize: bool = False,
    socs_rank: int | str = "auto",
    socs_tolerance: float | None = None,
    polarization=None,
    chromatic=None,
    perturb=None,
    mask3d=None,
) -> SimulationResult:
    """Run the pipeline on ``device`` ('cuda' on the card, 'cpu' in tests).
    ``source_map`` is a host (n, n) weight map (e.g. from
    :class:`..models.source.LightSource`). The image is complete when this
    returns: the device is synchronized before the wall clock is read.

    ``solver='socs'`` runs the Hopkins eigenkernel fast path: the kernel
    set is built once per (config, source, aberrations, rank, device) and
    cached, then applied with :func:`..ops.hopkins.socs_image` (the int8
    kernels on CUDA). ``socs_rank='auto'`` (default) grows the rank to 99.9%
    captured TCC energy; an int pins it. ``socs_tolerance`` (with
    ``socs_rank='auto'``) grows it instead until the image-error bound
    :func:`..ops.hopkins.socs_image_nrms_bound` meets the tolerance. Every
    SOCS run reports ``socs_rank``, ``socs_energy_captured`` and that bound
    as ``socs_image_nrms_bound``."""
    _check_options(solver, polarization=polarization, chromatic=chromatic,
                   perturb=perturb, mask3d=mask3d)
    if socs_tolerance is not None and (solver != "socs" or socs_rank != "auto"):
        raise ValueError("socs_tolerance needs solver='socs' with "
                         "socs_rank='auto' (a pinned rank cannot honor a "
                         "tolerance)")
    config = mask.config
    device = torch.device(device)
    t0 = time.perf_counter()

    src_np, aberrations = _host_inputs(source_map, aberrations)
    pts = source_points(src_np)
    geometry = mask.geometry.to(device)
    socs_report = {}
    if solver == "socs":
        w_sum = float(src_np.sum(dtype=np.float64))
        socs, pupil, energy, bound = _socs_kernels_cached(
            config, src_np, aberrations, socs_rank, device=device,
            tolerance=socs_tolerance, geometry=mask.geometry, chunk=chunk)
        image, spectrum = _socs_apply(geometry, socs, config, chunk=chunk,
                                      normalize=normalize, w_sum=w_sum)
        if bound is None:
            # the accuracy class of the run, from pieces already in hand
            bound = socs_image_nrms_bound(
                socs, spectrum, image, pupil=pupil, source_map=src_np,
                config=config, total_weight=w_sum if normalize else None)
        socs_report = {"socs_rank": socs.rank,
                       "socs_energy_captured": round(float(energy), 6),
                       "socs_image_nrms_bound": float(bound)}
        if socs_tolerance is not None:
            socs_report["socs_tolerance"] = float(socs_tolerance)
    else:
        shifts, weights = _pad_points(pts.shifts, pts.weights, chunk)
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
        **socs_report,
    }
    return SimulationResult(image=image, spectrum=spectrum, pupil=pupil,
                            source_map=src_np, report=report)


def simulate_batch(
    geometries,
    config: OpticsConfig,
    source_map,
    aberrations=None,
    *,
    device,
    solver: Literal["gau23", "direct", "socs"] = "gau23",
    chunk: int = 4,
    normalize: bool = False,
    socs_rank: int | str = "auto",
    polarization=None,
    chromatic=None,
    perturb=None,
    mask3d=None,
) -> torch.Tensor:
    """(B, n, n) aerial images on ``device`` for a batch of (B, n, n) mask
    geometries under one optical setup: the pupil, source points and SOCS
    kernels are made once per batch, not once per mask (the JAX package's
    vmap over masks is a loop here). Synchronized before it returns."""
    _check_options(solver, polarization=polarization, chromatic=chromatic,
                   perturb=perturb, mask3d=mask3d)
    device = torch.device(device)
    geometries = to_tensor(geometries, device=device, dtype=torch.float32)
    if geometries.ndim != 3:
        raise ValueError(f"expected (B, n, n) geometries, got {tuple(geometries.shape)}")
    src_np, aberrations = _host_inputs(source_map, aberrations)
    images = torch.empty_like(geometries)
    if solver == "socs":
        socs = _socs_kernels_cached(config, src_np, aberrations, socs_rank,
                                    device=device)[0]
        w_sum = float(src_np.sum(dtype=np.float64))
        for b, geometry in enumerate(geometries):
            images[b] = _socs_apply(geometry, socs, config, chunk=chunk,
                                    normalize=normalize, w_sum=w_sum)[0]
    else:
        pts = source_points(src_np)
        shifts, weights = _pad_points(pts.shifts, pts.weights, chunk)
        max_abs_shift = int(np.abs(shifts).max()) if shifts.size else 0
        pupil = pupil_function(aberrations, config, device=device)
        for b, geometry in enumerate(geometries):
            images[b] = abbe_image_points(
                mask_spectrum(geometry, config, solver=solver), pupil, shifts,
                weights, config, device=device, solver=solver, chunk=chunk,
                normalize=normalize, total_weight=pts.total_weight,
                max_abs_shift=max_abs_shift)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return images
