"""High-level one-call simulation pipeline.

Port of ``lithographysimulator_tpu/simulate.py``: the exact Abbe solvers
(``gau23`` and ``direct``) and the SOCS (Hopkins) fast path (``socs``),
scalar or vector (Jones pupil), monochromatic or polychromatic (finite
laser bandwidth), thin or thick mask (``mask3d``, applied to the geometry
before the spectrum on every path), with scanner perturbations applied to
the image, for one mask (:func:`simulate`) or a batch under one optical
setup (:func:`simulate_batch`), returning the aerial image and the same run
report; and the rigorous image in the resist film, exact
(:func:`film_stack_images`) or through per-slab SOCS kernels
(:func:`film_socs_kernels`, :func:`film_socs_stack`).

While a profiler trace records (:mod:`.utils.profiling`), :func:`simulate`
marks its call (``litho.simulate``) and, within it, the host inputs
(``.inputs``: the source map, its points on the exact paths, the
geometry's upload), the kernel set's cache key, look-up and any build
(``.kernels``), the spectrum (``.spectrum``), the apply (``.apply``), the
image-error bound (``.bound``) and the final synchronize (``.sync``); :func:`simulate_batch` marks its
call (``litho.simulate_batch``) and kernel set (``.kernels``). The kernel
set cache counts its hits, misses and evictions, the look-ups that reused
the last source map's key and the bounds computed from an entry's terms
(:func:`socs_cache_counts`).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Literal, NamedTuple

import numpy as np
import torch

from ._spans import Counters, span
from ._tensors import to_tensor
from .config import OpticsConfig
from .models.mask import Mask
from .models.pupil import pupil_function
from .ops.abbe import _pad_points, abbe_image_points, source_points
from .ops.focus import chromatic_aberrations
from .ops.fraunhofer import mask_spectrum
from .ops.hopkins import (SOCSBoundTerms, SOCSKernels, _field_power,
                          channel_gram, chromatic_component_stack, lean_auto,
                          randomized_socs, randomized_socs_chromatic,
                          randomized_socs_vector, rotation_from_gram,
                          socs_bound_from_terms, socs_bound_terms, socs_image,
                          vector_component_stack, vector_pupil_power)
from .ops.perturb import apply_perturbation
from .ops.vector import vector_abbe_image


@dataclasses.dataclass(frozen=True)
class SimulationResult:
    image: torch.Tensor
    spectrum: torch.Tensor
    pupil: torch.Tensor
    source_map: np.ndarray
    report: dict


def _check_solver(solver) -> None:
    if solver not in ("gau23", "direct", "socs"):
        raise ValueError(f"unknown solver {solver!r}")


def _thick(geometry: torch.Tensor, config: OpticsConfig, mask3d):
    """The geometry the spectrum is taken of: ``mask3d.apply`` of it for a
    thick-mask model (:mod:`.ops.mask3d`), itself for the thin mask."""
    return geometry if mask3d is None else mask3d.apply(geometry, config)


def _mask3d_report(mask3d) -> str:
    """The report's ``mask3d`` string, as the JAX package writes it."""
    if mask3d is None:
        return "thin"
    if hasattr(mask3d, "beta_h"):
        return (f"BL(w={mask3d.width_nm}nm, bh={mask3d.beta_h}, "
                f"bv={mask3d.beta_v})")
    return f"EdgeKernel(w={mask3d.width_nm}nm, K={mask3d.k})"


def _polarization_key(polarization):
    """A list or array Jones vector as a tuple of complex: hashable, so it
    keys the build caches, and printed as the JAX package prints it."""
    if isinstance(polarization, (list, np.ndarray)):
        return tuple(complex(v) for v in polarization)
    return polarization


def _host_inputs(source_map, aberrations):
    """(source map, aberrations) as host float32 arrays."""
    if isinstance(source_map, torch.Tensor):
        source_map = source_map.detach().cpu().numpy()
    if aberrations is None:
        aberrations = np.zeros((1,), np.float32)
    if isinstance(aberrations, torch.Tensor):
        aberrations = aberrations.detach().cpu().numpy()
    return np.asarray(source_map), np.asarray(aberrations, np.float32)


def _exact_image(spectrum, aberrations, shifts, weights, config, *, device,
                 solver, chunk, normalize, max_abs_shift, polarization=None,
                 apodize=True, chromatic=None) -> torch.Tensor:
    """One exact-Abbe aerial image (scalar or vector); with ``chromatic``
    the spectrum-weighted sum over the focus planes of the
    :class:`..config.LaserSpectrum`, one plane's imaging state live at a
    time. Shared by the single and batch pipelines."""

    def one(ab):
        pupil = pupil_function(ab, config, device=device)
        kw = dict(device=device, solver=solver, chunk=chunk,
                  normalize=normalize, max_abs_shift=max_abs_shift)
        if polarization is None:
            return abbe_image_points(spectrum, pupil, shifts, weights, config,
                                     **kw)
        return vector_abbe_image(spectrum, pupil, shifts, weights, config,
                                 polarization=polarization, apodize=apodize,
                                 **kw)

    if chromatic is None:
        return one(aberrations)
    stack_ab, q_f = chromatic_aberrations(aberrations, chromatic)
    image = None
    for ab, q in zip(stack_ab, q_f):
        part = float(q) * one(ab)
        image = part if image is None else image + part
    return image


@functools.lru_cache(maxsize=32)
def _channel_rotation_cached(config: OpticsConfig, polarization,
                             apodize: bool, chromatic, device: str):
    """Principal-channel rotation of the (config, polarization, spectrum)
    component stack, or None when compression would not shrink it. The
    channel Gram does not see phase-only aberrations, so the rotation at
    zero aberrations serves every build of that setup: computed once per
    (config, polarization, apodize, chromatic, device), the Gram on the
    device in complex128 and its ``eigh`` on the host in float64."""
    if polarization is None and chromatic is None:
        return None
    zeros = np.zeros((5,), np.float32)
    if chromatic is not None:
        comps, q = chromatic_component_stack(
            zeros, config, spectrum=chromatic, polarization=polarization,
            apodize=apodize, device=device)
    else:
        comps, q = vector_component_stack(
            pupil_function(zeros, config, device=device), config,
            polarization=polarization, apodize=apodize)
    s_pair = channel_gram(comps, q)
    rot, _captured = rotation_from_gram(s_pair, tol=config.channel_tol)
    if rot.shape[2] >= s_pair.shape[1]:
        return None
    return rot


def _socs_build(config, rank: int, aberrations, src, pupil, *, polarization,
                apodize, chromatic, rot, power_iters: int = 2,
                init_basis=None, return_basis: bool = False, lean="auto"):
    """One kernel build of the setup: the scalar source-side build (``lean``
    as :func:`..ops.hopkins.randomized_socs`; a basis needs the standard
    build), or the vector / polychromatic summed-TCC build with the channel
    rotation."""
    kw = dict(rank=rank, power_iters=power_iters, init_basis=init_basis,
              return_basis=return_basis)
    if chromatic is not None:
        return randomized_socs_chromatic(
            aberrations, src, config, spectrum=chromatic,
            polarization=polarization, apodize=apodize, channel_rotation=rot,
            device=pupil.device, **kw)
    if polarization is None:
        return randomized_socs(pupil, src, config,
                               lean=False if return_basis else lean, **kw)
    return randomized_socs_vector(pupil, src, config,
                                  polarization=polarization, apodize=apodize,
                                  channel_rotation=rot, **kw)


def _pupil_power(pupil, config, polarization, apodize) -> float:
    """r0 of trace(T) = w_sum * r0: sum |P|^2, or the vector component
    power. A polychromatic r0 is the base pupil's: the spectral weights sum
    to 1 and the defocus phases have unit modulus."""
    if polarization is None:
        return _field_power(pupil)
    return vector_pupil_power(pupil, config, polarization=polarization,
                              apodize=apodize)


# Host-side cache of SOCS builds keyed on the concrete optics inputs: the
# rank-doubling auto loop runs on the host, and a kernel build must never
# be paid twice for the same (config, source, aberrations, rank,
# polarization, apodize, spectrum, device). The kernels stay on their
# device, so the cache is bounded in bytes as well as in entries (the
# oldest go first): 16 kernel sets of rank 256 at 2048^2 would hold 137 GB.
# A server's batch worker and job runner share it, so every look-up,
# insertion and eviction holds the lock; builds run outside it (two threads
# that miss on one key both build, and the second insertion wins). An entry
# holds what a warm call needs besides its mask: the kernels, the bound's
# kernel-set terms and the source's live count and weight sum.
_SOCS_BUILD_CACHE: dict = {}
_SOCS_BUILD_CACHE_LOCK = threading.Lock()
_SOCS_CACHE_COUNTS = Counters("socs_cache", ("hits", "misses", "evictions",
                                             "key_reuses", "bound_from_entry"))
_SOCS_BUILD_CACHE_MAX = 16
_SOCS_BUILD_CACHE_BYTES = 16e9
# the last source map's key bytes, under the cache's lock (_source_key)
_SOURCE_KEY_MEMO = None

_AUTO_RANK_START = 32
_AUTO_RANK_MAX = 512
_AUTO_ENERGY_TARGET = 0.999


class _SOCSEntry(NamedTuple):
    """One kernel set of the cache, with what a warm call reads of it."""

    socs: SOCSKernels
    pupil: torch.Tensor
    energy: float
    bound: float | None  # tolerance mode's bound of its mask, else None
    terms: SOCSBoundTerms  # the bound's mask-independent terms
    live_count: int  # the source's live points
    w_sum: float  # the source's weight sum, in float64


def _holds_bytes(a: np.ndarray, key: bytes) -> bool:
    """Whether ``a.tobytes() == key``, compared in place, word by word."""
    if a.nbytes != len(key) or a.dtype.hasobject:
        return False
    a = np.ascontiguousarray(a)
    words = np.uint64 if a.nbytes % 8 == 0 else np.uint8
    return bool(np.array_equal(a.reshape(-1).view(words),
                               np.frombuffer(key, words)))


def _source_key(src_np: np.ndarray) -> bytes:
    """``src_np.tobytes()`` for the cache key. While the map holds the
    bytes of the last map keyed, it is that very bytes object, whose hash
    Python keeps: a warm look-up neither serializes nor hashes the map
    again. The memo is the bytes themselves, a copy of the map, so an
    in-place change to the caller's array misses it."""
    global _SOURCE_KEY_MEMO
    with _SOCS_BUILD_CACHE_LOCK:
        memo = _SOURCE_KEY_MEMO
    if memo is not None and _holds_bytes(src_np, memo):
        _SOCS_CACHE_COUNTS.add("key_reuses")
        return memo
    key = src_np.tobytes()
    with _SOCS_BUILD_CACHE_LOCK:
        _SOURCE_KEY_MEMO = key
    return key


def _socs_kernels_cached(config: OpticsConfig, src_np: np.ndarray,
                         aberrations: np.ndarray, rank: int | str, *, device,
                         polarization=None, apodize: bool = True,
                         chromatic=None, tolerance: float | None = None,
                         geometry=None, chunk: int = 4, mask3d=None) -> _SOCSEntry:
    """The cache's :class:`_SOCSEntry` for a build on ``device`` (scalar,
    vector with ``polarization``, polychromatic with ``chromatic``).
    ``rank='auto'`` grows the rank from 32 by doubling until the kept
    eigenvalues capture 99.9% of the trace or, with
    ``tolerance``, until :func:`..ops.hopkins.socs_image_nrms_bound` of
    the mask ``geometry`` is <= tolerance (its apply uses the caller's
    ``chunk`` and ``mask3d``; the bound does not depend on normalization).
    ``bound`` is None unless tolerance mode ran. ``terms`` are the bound's
    mask-independent terms (:func:`..ops.hopkins.socs_bound_terms`):
    refined for scalar kernels; for vector and chromatic kernels the sup
    bound's, as the JAX package reports it (R5, reproduced on purpose: its
    simulate.py:889-894 passes pupil=None)."""
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
    key = (config, _source_key(src_np), aberrations.tobytes(), rank, polarization,
           apodize, chromatic, tolerance,
           None if geo is None else geo.tobytes(),
           chunk if tolerance is not None else None,
           mask3d if tolerance is not None else None, str(device))
    with _SOCS_BUILD_CACHE_LOCK:
        hit = _SOCS_BUILD_CACHE.get(key)
    _SOCS_CACHE_COUNTS.add("misses" if hit is None else "hits")
    if hit is not None:
        return hit
    pupil = pupil_function(aberrations, config, device=device)
    src = to_tensor(src_np, device=device, dtype=torch.float32)
    scalar = polarization is None and chromatic is None
    w_sum = float(src_np.sum(dtype=np.float64))
    live_count = int(np.count_nonzero(src_np > 0))
    trace = w_sum * _pupil_power(pupil, config, polarization, apodize)
    # aberration-independent channel rotation, shared by every doubling
    rot = _channel_rotation_cached(config, polarization, apodize, chromatic,
                                   str(device))
    channel_k = None if rot is None else int(rot.shape[2])

    def build(r, **kw):
        return _socs_build(config, r, aberrations, src, pupil,
                           polarization=polarization, apodize=apodize,
                           chromatic=chromatic, rot=rot, **kw)

    def energy_of(socs):
        kept = float(socs.eigenvalues.sum(dtype=torch.float64))
        return kept / trace if trace > 0 else 1.0

    def terms_of(socs):
        if not scalar:
            return socs_bound_terms(socs, trace=trace)
        return socs_bound_terms(socs, trace=trace, pupil=pupil,
                                source_map=src, config=config)

    bound = terms = None
    if tolerance is not None:
        spectrum = mask_spectrum(
            _thick(torch.as_tensor(geo, device=device), config, mask3d),
            config, solver="gau23")

    if rank == "auto":
        # Grow the rank until the energy target (or tolerance) is met.
        # rank(T) <= #components x #live source points (#channels when the
        # stack compresses), so never past that. Each doubling warm-starts
        # from the previous rank's Ritz basis with power_iters=1; the basis
        # is kept only where the standard-memory build fits the device (the
        # lean scalar build has no basis).
        n_comp = 1 if polarization is None else 3
        if chromatic is not None:
            n_comp *= chromatic.samples
        if channel_k is not None:
            n_comp = channel_k
        max_rank = max(1, min(_AUTO_RANK_MAX, n_comp * live_count))
        r = min(_AUTO_RANK_START, max_rank)
        basis = None
        while True:
            keep_basis = (r < max_rank
                          and not lean_auto(2 * r + 16, config.n, device=device))
            if basis is not None:
                socs, basis = build(r, power_iters=1, init_basis=basis,
                                    return_basis=True)
            elif keep_basis:
                socs, basis = build(r, return_basis=True)
            else:
                socs = build(r)
            energy = energy_of(socs)
            if tolerance is not None:
                terms = terms_of(socs)
                bound = socs_bound_from_terms(
                    terms, spectrum, socs_image(spectrum, socs, config, chunk=chunk))
                done = bound <= tolerance
            else:
                done = energy >= _AUTO_ENERGY_TARGET
            if done or r >= max_rank:
                break
            r = min(r * 2, max_rank)
            if not keep_basis:
                basis = None
    else:
        socs = build(int(rank))
        energy = energy_of(socs)
    hit = _SOCSEntry(socs, pupil, energy, bound,
                     terms_of(socs) if terms is None else terms,
                     live_count, w_sum)
    with _SOCS_BUILD_CACHE_LOCK:
        _SOCS_BUILD_CACHE[key] = hit
        while len(_SOCS_BUILD_CACHE) > 1 and (
                len(_SOCS_BUILD_CACHE) > _SOCS_BUILD_CACHE_MAX
                or sum(h[0].kernels.nbytes for h in _SOCS_BUILD_CACHE.values())
                > _SOCS_BUILD_CACHE_BYTES):
            _SOCS_BUILD_CACHE.pop(next(iter(_SOCS_BUILD_CACHE)))
            _SOCS_CACHE_COUNTS.add("evictions")
    return hit


def socs_cache_stats() -> tuple[int, int]:
    """(entries, bytes of kernels) held by the SOCS kernel-set cache."""
    with _SOCS_BUILD_CACHE_LOCK:
        return (len(_SOCS_BUILD_CACHE),
                int(sum(h[0].kernels.nbytes for h in _SOCS_BUILD_CACHE.values())))


def socs_cache_counts() -> dict:
    """The SOCS kernel-set cache's look-ups that hit, those that missed
    (and built), the entries evicted, the look-ups that reused the last
    source map's key (``key_reuses``) and the SOCS calls whose bound came
    from their entry's terms (``bound_from_entry``), since the process
    started."""
    return _SOCS_CACHE_COUNTS.snapshot()


def _normalized(image: torch.Tensor, total: float) -> torch.Tensor:
    # all-dark source: a zero image, normalized or not
    return image / total if total > 0 else torch.zeros_like(image)


def _socs_apply(geometry, socs: SOCSKernels, config, *, chunk, normalize,
                w_sum, mask3d=None):
    spectrum = mask_spectrum(_thick(geometry, config, mask3d), config,
                             solver="gau23")
    image = socs_image(spectrum, socs, config, chunk=chunk)
    return _normalized(image, w_sum) if normalize else image


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
    apodize: bool = True,
    chromatic=None,
    perturb=None,
    mask3d=None,
    block: bool = True,
) -> SimulationResult:
    """Run the pipeline on ``device`` ('cuda' on the card, 'cpu' in tests).
    ``source_map`` is a host (n, n) weight map (e.g. from
    :class:`..models.source.LightSource`). The image is complete when this
    returns: the device is synchronized before the wall clock is read.

    ``solver='socs'`` runs the Hopkins eigenkernel fast path: the kernel
    set is built once per (config, source, aberrations, rank, polarization,
    apodize, spectrum, device) and cached, then applied with
    :func:`..ops.hopkins.socs_image` (the int8 kernels on CUDA).
    ``socs_rank='auto'`` (default) grows the rank to 99.9% captured TCC
    energy; an int pins it. ``socs_tolerance`` (with ``socs_rank='auto'``)
    grows it instead until the image-error bound
    :func:`..ops.hopkins.socs_image_nrms_bound` meets the tolerance. Every
    SOCS run reports ``socs_rank``, ``socs_energy_captured`` and that bound
    as ``socs_image_nrms_bound``.

    ``polarization`` (None = scalar): 'unpolarized', 'x', 'y' or a Jones
    2-vector switches to the vector Jones-pupil engine
    (:mod:`.ops.vector`), or with ``solver='socs'`` to the vector kernel
    build; ``apodize`` adds the 1/sqrt(cos theta) obliquity factor.
    ``chromatic`` (a :class:`..config.LaserSpectrum`) makes the image the
    spectrum-weighted sum over the chromatic focus planes: a loop over
    planes on the exact solvers, one polychromatic kernel set on
    ``solver='socs'``; it composes with ``polarization``. ``perturb`` (an
    :class:`..ops.perturb.ImagePerturbation`) applies stage blur and flare
    to the image last, on every solver. ``mask3d`` (a
    :class:`..ops.mask3d.BoundaryLayer` or
    :class:`..ops.mask3d.EdgeKernelM3D`; None is the thin mask) turns the
    geometry into its effective thick-mask transmission before the
    spectrum, on every solver. ``block`` is accepted for the JAX package's
    signature and does nothing: the port always synchronizes."""
    _check_solver(solver)
    if socs_tolerance is not None and (solver != "socs" or socs_rank != "auto"):
        raise ValueError("socs_tolerance needs solver='socs' with "
                         "socs_rank='auto' (a pinned rank cannot honor a "
                         "tolerance)")
    config = mask.config
    device = torch.device(device)
    t0 = time.perf_counter()
    with span("litho.simulate"):
        with span("litho.simulate.inputs"):
            src_np, aberrations = _host_inputs(source_map, aberrations)
            polarization = _polarization_key(polarization)
            # the SOCS path reads the live count from its cache entry
            pts = None if solver == "socs" else source_points(src_np)
            geometry = mask.geometry.to(device)
        socs_report = {}
        if solver == "socs":
            with span("litho.simulate.kernels"):
                entry = _socs_kernels_cached(
                    config, src_np, aberrations, socs_rank, device=device,
                    polarization=polarization, apodize=apodize,
                    chromatic=chromatic, tolerance=socs_tolerance,
                    geometry=mask.geometry, chunk=chunk, mask3d=mask3d)
            socs, pupil, live_count = entry.socs, entry.pupil, entry.live_count
            with span("litho.simulate.spectrum"):
                spectrum = mask_spectrum(_thick(geometry, config, mask3d),
                                         config, solver="gau23")
            with span("litho.simulate.apply"):
                image = socs_image(spectrum, socs, config, chunk=chunk)
                if normalize:
                    image = _normalized(image, entry.w_sum)
            bound = entry.bound
            if bound is None:
                # the accuracy class of the run: the mask's share of the
                # bound, from the entry's kernel-set terms
                with span("litho.simulate.bound"):
                    bound = socs_bound_from_terms(
                        entry.terms, spectrum, image,
                        total_weight=entry.w_sum if normalize else None)
                _SOCS_CACHE_COUNTS.add("bound_from_entry")
            socs_report = {"socs_rank": socs.rank,
                           "socs_energy_captured": round(float(entry.energy), 6),
                           "socs_image_nrms_bound": float(bound)}
            if socs_tolerance is not None:
                socs_report["socs_tolerance"] = float(socs_tolerance)
        else:
            live_count = pts.live_count
            shifts, weights = _pad_points(pts.shifts, pts.weights, chunk)
            with span("litho.simulate.spectrum"):
                spectrum = mask_spectrum(_thick(geometry, config, mask3d),
                                         config, solver=solver)
            with span("litho.simulate.apply"):
                pupil = pupil_function(aberrations, config, device=device)
                max_abs_shift = int(np.abs(shifts).max()) if shifts.size else 0
                image = _exact_image(
                    spectrum, aberrations, shifts, weights, config,
                    device=device, solver=solver, chunk=chunk,
                    normalize=normalize, max_abs_shift=max_abs_shift,
                    polarization=polarization, apodize=apodize,
                    chromatic=chromatic)
        if perturb is not None and perturb.active:
            image = apply_perturbation(image, perturb, config.pixel_size)
        if device.type == "cuda":
            with span("litho.simulate.sync"):
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
        "source_points": live_count,
        "polarization": (str(polarization) if polarization is not None
                         else "scalar"),
        "chromatic": (f"{chromatic.shape} E95={chromatic.bandwidth_pm}pm "
                      f"x{chromatic.samples} @ {chromatic.focus_nm_per_pm}"
                      "nm/pm" if chromatic is not None else "monochromatic"),
        "mask3d": _mask3d_report(mask3d),
        "wall_clock_s": elapsed,
    }
    if config.pupil_at_na:
        # the default convention (the edge at 1/wavelength) keeps the JAX
        # package's report, key for key
        report["pupil_edge"] = "NA/wavelength"
    if perturb is not None and perturb.active:
        report["perturbation"] = (
            f"MSD=({perturb.msd_x_nm},{perturb.msd_y_nm})nm "
            f"TIS={perturb.flare_tis}")
    report.update(socs_report)
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
    apodize: bool = True,
    chromatic=None,
    perturb=None,
    mask3d=None,
    block: bool = True,
) -> torch.Tensor:
    """(B, n, n) aerial images on ``device`` for a batch of (B, n, n) mask
    geometries under one optical setup: the source points and SOCS kernels
    are made once per batch, not once per mask (the JAX package's vmap over
    masks is a loop here). ``polarization``, ``apodize``, ``chromatic`` and
    ``perturb`` act as in :func:`simulate`; the flare background is each
    image's own mean (ROADMAP.md Queue 3, R7); ``mask3d`` applies to each
    geometry. Synchronized before it returns (``block`` does nothing, as
    in :func:`simulate`)."""
    _check_solver(solver)
    device = torch.device(device)
    with span("litho.simulate_batch"):
        geometries = to_tensor(geometries, device=device, dtype=torch.float32)
        if geometries.ndim != 3:
            raise ValueError(f"expected (B, n, n) geometries, got "
                             f"{tuple(geometries.shape)}")
        src_np, aberrations = _host_inputs(source_map, aberrations)
        polarization = _polarization_key(polarization)
        images = torch.empty_like(geometries)
        if solver == "socs":
            with span("litho.simulate_batch.kernels"):
                entry = _socs_kernels_cached(
                    config, src_np, aberrations, socs_rank, device=device,
                    polarization=polarization, apodize=apodize,
                    chromatic=chromatic)
            for b, geometry in enumerate(geometries):
                images[b] = _socs_apply(geometry, entry.socs, config,
                                        chunk=chunk, normalize=normalize,
                                        w_sum=entry.w_sum, mask3d=mask3d)
        else:
            pts = source_points(src_np)
            shifts, weights = _pad_points(pts.shifts, pts.weights, chunk)
            max_abs_shift = int(np.abs(shifts).max()) if shifts.size else 0
            for b, geometry in enumerate(geometries):
                images[b] = _exact_image(
                    mask_spectrum(_thick(geometry, config, mask3d), config,
                                  solver=solver), aberrations,
                    shifts, weights, config, device=device, solver=solver,
                    chunk=chunk, normalize=normalize,
                    max_abs_shift=max_abs_shift, polarization=polarization,
                    apodize=apodize, chromatic=chromatic)
        if perturb is not None and perturb.active:
            images = apply_perturbation(images, perturb, config.pixel_size)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return images


def _film_depths(depths_nm, resist) -> tuple:
    """The slab depths of a film call; ``resist`` is read only for its
    ``depths_nm``."""
    if depths_nm is None:
        if resist is None:
            raise ValueError("pass depths_nm or a DepthResist via resist=")
        depths_nm = resist.depths_nm
    return tuple(float(z) for z in np.atleast_1d(depths_nm))


def _mask_geometry(mask, device) -> torch.Tensor:
    geometry = mask.geometry if hasattr(mask, "geometry") else mask
    return to_tensor(geometry, device=device)


def film_stack_images(
    mask,
    source_map,
    aberrations=None,
    *,
    device,
    config: OpticsConfig | None = None,
    wafer_stack,
    depths_nm=None,
    resist=None,
    polarization=None,
    apodize: bool = True,
    solver: Literal["gau23", "direct"] = "gau23",
    chunk: int = 4,
    normalize: bool = True,
    engine: str = "auto",
    mask3d=None,
    block: bool = True,
) -> torch.Tensor:
    """(nz, n, n) rigorous in-film exposure stack on ``device``: the image
    inside the resist of ``wafer_stack`` (:mod:`.ops.filmstack`), slab by
    slab. Every plane wave of the Abbe sum refracts into the resist and
    interferes with its reflection off the underlayers and the substrate;
    slab z is ``sum_c AbbeIntensity(pupil * mult[z, c])`` over the
    component multipliers of
    :func:`.ops.filmstack.film_component_multipliers` (one for
    ``polarization=None``, the scalar TE-Airy image; three a state for a
    Jones spec). ``depths_nm`` defaults to ``resist.depths_nm``.
    ``mask3d`` composes: thick-mask physics at the object side, thick-film
    physics at the image side. ``block`` does nothing (the device is
    synchronized before this returns)."""
    from .ops.filmstack import film_component_multipliers

    if config is None:
        config = mask.config
    device = torch.device(device)
    depths = _film_depths(depths_nm, resist)
    src_np, aberrations = _host_inputs(source_map, aberrations)
    polarization = _polarization_key(polarization)
    pts = source_points(src_np)
    shifts, weights = _pad_points(pts.shifts, pts.weights, chunk)
    max_abs_shift = int(np.abs(shifts).max()) if shifts.size else 0
    mult = film_component_multipliers(config, wafer_stack, depths,
                                      polarization=polarization,
                                      apodize=apodize)  # (nz, C, n, n)
    geometry = _thick(_mask_geometry(mask, device), config, mask3d)
    spectrum = mask_spectrum(geometry, config, solver=solver)
    pupil = pupil_function(aberrations, config, device=device)
    stack = torch.empty((len(depths), config.n, config.n), dtype=torch.float32,
                        device=device)
    for z in range(len(depths)):
        mult_z = torch.as_tensor(mult[z], dtype=torch.complex64, device=device)
        total = torch.zeros((config.n, config.n), dtype=torch.float32,
                            device=device)
        for mult_c in mult_z:
            total = total + abbe_image_points(
                spectrum, pupil * mult_c, shifts, weights, config,
                device=device, solver=solver, chunk=chunk,
                normalize=normalize, engine=engine,
                max_abs_shift=max_abs_shift)
        stack[z] = total
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return stack


def film_socs_kernels(
    source_map,
    aberrations=None,
    *,
    device,
    config: OpticsConfig,
    wafer_stack,
    depths_nm=None,
    resist=None,
    polarization=None,
    apodize: bool = True,
    rank: int = 64,
    power_iters: int = 2,
    warm_iters: int = 1,
) -> list:
    """Per-slab SOCS kernel sets on ``device`` for the rigorous image in
    the resist: build once, then every mask and dose reuses them at
    :func:`.ops.hopkins.socs_image` cost a slab. Each slab's summed TCC
    stacks the film-modified component pupils (the multipliers times the
    aberrated pupil) through
    :func:`.ops.hopkins.randomized_socs_components`. Slab 0 is built cold
    at ``power_iters``; each deeper slab restarts from the previous slab's
    Ritz basis at ``warm_iters``, since adjacent slabs differ only by the
    in-film propagation phase. Returns a list of
    :class:`.ops.hopkins.SOCSKernels`, top slab first; apply with
    :func:`film_socs_stack`."""
    from .ops.filmstack import film_component_multipliers
    from .ops.hopkins import randomized_socs_components

    device = torch.device(device)
    depths = _film_depths(depths_nm, resist)
    src_np, aberrations = _host_inputs(source_map, aberrations)
    mult = film_component_multipliers(config, wafer_stack, depths,
                                      polarization=_polarization_key(
                                          polarization),
                                      apodize=apodize)  # (nz, C, n, n)
    pupil = pupil_function(aberrations, config, device=device)
    src = to_tensor(src_np, device=device, dtype=torch.float32)
    kernels = []
    basis = None
    for z in range(len(depths)):
        comps = torch.as_tensor(mult[z], dtype=torch.complex64,
                                device=device) * pupil[None]
        weights = torch.ones((comps.shape[0],), dtype=torch.float32,
                             device=device)
        socs, basis = randomized_socs_components(
            comps, weights, src, config, rank=rank,
            power_iters=power_iters if basis is None else warm_iters,
            init_basis=basis, return_basis=True)
        kernels.append(socs)
    return kernels


def film_socs_stack(
    mask,
    kernels: list,
    *,
    config: OpticsConfig | None = None,
    source_total=None,
    chunk: int = 4,
    normalize: bool = True,
    mask3d=None,
    block: bool = True,
) -> torch.Tensor:
    """Apply per-slab film-SOCS kernel sets (:func:`film_socs_kernels`):
    the (nz, n, n) in-film exposure on the kernels' device at SOCS cost.
    ``source_total`` (the sum of source weights) normalizes like the exact
    path and is required when ``normalize=True``. ``block`` does nothing
    (the device is synchronized before this returns)."""
    if config is None:
        config = mask.config
    if normalize and source_total is None:
        raise ValueError("normalize=True needs source_total (sum of source "
                         "weights) to match the exact path's scaling")
    device = kernels[0].kernels.device
    geometry = _mask_geometry(mask, device)
    total = float(source_total) if source_total is not None else 1.0
    planes = [_socs_apply(geometry, socs, config, chunk=chunk,
                          normalize=normalize, w_sum=total, mask3d=mask3d)
              for socs in kernels]
    stack = torch.stack(planes)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return stack
