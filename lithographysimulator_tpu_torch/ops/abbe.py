"""Abbe partial-coherence imaging engine.

Port of ``lithographysimulator_tpu/ops/abbe.py``: for every illuminated
source point, shift the pupil by the point's integer sigma-grid offset,
multiply by the mask spectrum, transform to the image plane and accumulate
``I = sum_s w_s |E_s|^2``. The JAX ``lax.scan`` over fixed-size chunks of
points is a Python loop over the same chunks here; the (n, n) float32
accumulator is the only state carried between chunks.

Engines (:func:`resolve_engine`):

* ``fft``: batched padded inverse FFT (cuFFT on the card);
* ``matmul``: the zoom-DFT ``E = T X T^T`` as complex matmuls; on the
  windowed path the phase-free 3M form with one static ``T0``, in float32
  with TF32 off;
* ``int8`` / ``int8_fast``: the same windowed contraction on the
  hand-written int8 limb kernels (:mod:`.kernels.intensity_int8`),
  forward only.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import numpy as np
import torch

from .._tensors import to_tensor
from ..config import OpticsConfig
from .fourier import centered_ifft2, crop_center, pad_center
from .fraunhofer import separable_dft
from .kernels.intensity_int8 import (column_intensity_int8, prepare_t0_limbs,
                                     row_transform_int8)
from .resize import bilinear_resize

Solver = Literal["gau23", "direct"]
ENGINES = ("fft", "matmul", "int8", "int8_fast")


def resolve_engine(engine: str, *, device) -> str:
    """``'auto'`` -> ``'int8'`` for a CUDA device (the hand-written
    kernels) and ``'fft'`` for the CPU, mirroring the JAX package's TPU/CPU
    split; explicit names are validated. ``int8_fast`` (2-limb, ~1.5e-5
    normalized RMS) is never chosen automatically."""
    if engine != "auto" and engine not in ENGINES:
        raise ValueError(
            f"unknown field-transform engine {engine!r} (allowed: {ENGINES})")
    if engine != "auto":
        return engine
    return "int8" if torch.device(device).type == "cuda" else "fft"


# ---------------------------------------------------------------------------
# Source points
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SourcePoints:
    """Static source-point list: integer sigma-grid offsets (dy, dx) of each
    illuminated point relative to the array center, plus per-point weights
    (possibly padded with zero-weight entries)."""

    shifts: np.ndarray  # (p, 2) int32, (dy, dx)
    weights: np.ndarray  # (p,) float32
    live_count: int

    @property
    def total_weight(self) -> float:
        return float(self.weights.sum())


def source_points(source_map, *, threshold: float = 0.0) -> SourcePoints:
    """Live source points of a host source map, in the row-major order of
    the reference's ``argwhere`` loop."""
    if isinstance(source_map, torch.Tensor):
        source_map = source_map.detach().cpu().numpy()
    m = np.asarray(source_map)
    n = m.shape[0]
    idx = np.argwhere(m > threshold)
    shifts = (idx - n // 2).astype(np.int32)
    weights = m[idx[:, 0], idx[:, 1]].astype(np.float32)
    return SourcePoints(shifts=shifts, weights=weights, live_count=len(idx))


def _pad_points(shifts: np.ndarray, weights: np.ndarray, chunk: int):
    p = len(weights)
    pad = (-p) % chunk
    if pad:
        shifts = np.concatenate([shifts, np.zeros((pad, 2), np.int32)])
        weights = np.concatenate([weights, np.zeros((pad,), np.float32)])
    return shifts, weights


# ---------------------------------------------------------------------------
# Per-chunk products
# ---------------------------------------------------------------------------

def _tiled(pupil: torch.Tensor) -> torch.Tensor:
    """2n x 2n periodic tiling of the pupil: every circular shift of the
    pupil is one contiguous (n, n) window of it."""
    return pupil.repeat(2, 2)


def _window_starts(shifts: np.ndarray, n: int, w: int, lo: int) -> np.ndarray:
    """(p, 4) int64 window origins (pupil row, pupil col, spectrum row,
    spectrum col) of ``roll(P, s) * M`` restricted to the (w, w) window at
    ``lo + s`` clipped into the grid (``abbe.py:224-229`` of the JAX
    package); ``w = n, lo = 0`` gives the whole rolled product."""
    s = np.asarray(shifts, np.int64)
    r0 = np.clip(lo + s[:, 0], 0, n - w)
    c0 = np.clip(lo + s[:, 1], 0, n - w)
    return np.stack([(-s[:, 0]) % n + r0, (-s[:, 1]) % n + c0, r0, c0], axis=1)


def _gather_products(pupil_tiled, spectrum, starts: torch.Tensor, w: int):
    """(B, w, w) products of pupil and spectrum windows at ``starts``
    (B, 4): two batched gathers and one multiply per chunk."""
    ar = torch.arange(w, device=starts.device)
    rows = starts[:, :, None] + ar  # (B, 4, w)
    pup = pupil_tiled[rows[:, 0, :, None], rows[:, 1, None, :]]
    spec = spectrum[rows[:, 2, :, None], rows[:, 3, None, :]]
    return pup * spec


def _rolled_products(pupil_tiled, spectrum, shifts):
    """(B, n, n) stack of roll(pupil, s_b) * spectrum (torch.roll's sign)."""
    n = spectrum.shape[-1]
    starts = torch.as_tensor(_window_starts(shifts, n, n, 0),
                             device=spectrum.device)
    return _gather_products(pupil_tiled, spectrum, starts, n)


def _windowed_products(pupil_tiled, spectrum, shifts, w: int, lo: int):
    """(B, w, w) windows of roll(P, s_b) * M. For |shift| <= n/4 - 2 the
    rolled unit disk stays interior and the window holds every nonzero
    entry of the product (guard in :func:`accumulate_intensity`)."""
    n = spectrum.shape[-1]
    starts = torch.as_tensor(_window_starts(shifts, n, w, lo),
                             device=spectrum.device)
    return _gather_products(pupil_tiled, spectrum, starts, w)


@functools.lru_cache(maxsize=16)
def _zoom_dft_kernel(n: int, fft_size: int) -> np.ndarray:
    """``crop_n . centered_ifft2_N . pad_center_N`` as an (n, n) matrix:
    ``T[a, b] = exp(+2i pi (a - n/2)(b - n/2) / N)`` per axis, so the padded
    transform is ``E = T X T^T``. For N < n, T's rows and columns are masked
    to the central N indices. Built in float64 on the host."""
    a = np.arange(n, dtype=np.float64) - n / 2
    t = np.exp(2j * np.pi * np.outer(a, a) / fft_size)
    if fft_size < n:
        lo = (n - fft_size) // 2
        mask = np.zeros(n)
        mask[lo : lo + fft_size] = 1.0
        t = t * np.outer(mask, mask)
    return t


def _window_size(n: int) -> int:
    """Support window of a rolled pupil product: the unit disk spans
    n/2 + 1 samples; +2 guard, rounded to a multiple of 8."""
    return min(n, ((n // 2 + 3 + 7) // 8) * 8)


@functools.lru_cache(maxsize=16)
def _zoom_dft_window(n: int, fft_size: int) -> np.ndarray:
    """Static (n, w) slice ``T0 = T[:, lo:lo+w]`` shared by every source
    point in the phase-free windowed contraction (needs fft_size >= n)."""
    assert fft_size >= n
    w = _window_size(n)
    lo = n // 4 - 1
    return _zoom_dft_kernel(n, fft_size)[:, lo:lo + w]


def _cmatmul_3m(ar, ai, br, bi):
    """Complex matmul ``(ar + i ai) @ (br + i bi)`` as 3 real matmuls."""
    m1 = ar @ br
    m2 = ai @ bi
    m3 = (ar + ai) @ (br + bi)
    return m1 - m2, m3 - m1 - m2


def _intensity_windowed_3m(x, t0r, t0i, weights):
    """``sum_b w_b |T0 @ X_b @ T0^T|^2`` in float32 (TF32 off): the
    per-point column slices of T differ from T0 only by unit-magnitude
    phases, which vanish under |.|^2, so one static T0 serves every point."""
    yr, yi = _cmatmul_3m(t0r, t0i, x.real, x.imag)
    er, ei = _cmatmul_3m(yr, yi, t0r.T, t0i.T)
    return torch.sum(weights[:, None, None] * (er * er + ei * ei), dim=0)


def _intensity_windowed_int8(x, t_limbs, t_scales, weights, *, fast: bool,
                             out: torch.Tensor):
    """Same contraction as :func:`_intensity_windowed_3m` on the int8 limb
    kernels, added into ``out`` in place. Forward only."""
    if x.requires_grad or weights.requires_grad:
        raise NotImplementedError(
            "the int8 engine is forward-only; its f32-recompute backward "
            "arrives with optimize.py (ROADMAP.md, Queue 2: int8 VJP) - use "
            "engine='matmul' for gradients")
    y_limbs, y_scales = row_transform_int8(x, t_limbs, t_scales, fast=fast)
    return column_intensity_int8(y_limbs, y_scales, t_limbs, t_scales,
                                 weights, fast=fast, out=out)


def _fields_gau23(pupil_tiled, spectrum, shifts, fft_size, engine="fft"):
    """(B, n, n) coherent fields for one chunk, Gau'23 solver: batched
    padded inverse FFT, or the same transform as two complex matmuls."""
    n = spectrum.shape[-1]
    prods = _rolled_products(pupil_tiled, spectrum, shifts)
    if engine == "matmul":
        t = torch.as_tensor(_zoom_dft_kernel(n, fft_size), dtype=spectrum.dtype,
                            device=spectrum.device)
        return t @ prods @ t.T
    fields = centered_ifft2(pad_center(prods, fft_size))
    return crop_center(fields, n)


def _fields_direct(pupil_tiled, spectrum, shifts, config):
    """(B, n, n) coherent fields via the separable direct transform
    (constant -2i*pi/lambda)."""
    prods = _rolled_products(pupil_tiled, spectrum, shifts)
    return separable_dft(prods, config, sign=-1, dtype=spectrum.dtype)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def accumulate_intensity(
    pupil: torch.Tensor,
    spectrum: torch.Tensor,
    shifts,
    weights: torch.Tensor,
    config: OpticsConfig,
    *,
    solver: Solver = "gau23",
    chunk: int = 4,
    engine: str = "auto",
    max_abs_shift: int | None = None,
) -> torch.Tensor:
    """Loop over source-point chunks accumulating ``sum_s w_s |E_s|^2``.

    ``shifts`` (p, 2) integer offsets live on the host; ``weights`` (p,) on
    the spectrum's device; p must be divisible by ``chunk``. Returns the raw
    (n, n) float32 intensity (before postprocessing)."""
    n = config.n
    device = spectrum.device
    shifts = np.asarray(shifts).reshape(-1, 2)
    p = shifts.shape[0]
    real_dtype = spectrum.real.dtype
    acc = torch.zeros((n, n), dtype=real_dtype, device=device)
    if p == 0:
        return acc
    if p % chunk:
        raise ValueError(f"point count {p} not divisible by chunk {chunk}")
    engine = resolve_engine(engine, device=device)
    fft_size = config.wavelength_scaling().fft_size
    # The windowed contraction is exact only when every rolled pupil stays
    # interior (static bound on |shift|) and T is the unmasked chirp.
    windowed = (engine in ("matmul", "int8", "int8_fast")
                and max_abs_shift is not None
                and max_abs_shift <= n // 4 - 2 and _window_size(n) < n
                and fft_size >= n)
    if engine in ("int8", "int8_fast") and (not windowed or solver != "gau23"):
        engine = "matmul"  # the int8 kernels serve the windowed path only
    weights = weights.to(device=device, dtype=real_dtype)
    pupil_tiled = _tiled(pupil)

    if windowed and solver == "gau23":
        w_win = _window_size(n)
        lo = n // 4 - 1
        t0 = _zoom_dft_window(n, fft_size)
        t0r = torch.as_tensor(t0.real, dtype=torch.float32, device=device)
        t0i = torch.as_tensor(t0.imag, dtype=torch.float32, device=device)
        if engine in ("int8", "int8_fast"):
            t_limbs, t_scales = prepare_t0_limbs(t0r, t0i)
        starts = torch.as_tensor(_window_starts(shifts, n, w_win, lo),
                                 device=device)

    for c in range(0, p, chunk):
        s = shifts[c : c + chunk]
        w = weights[c : c + chunk]
        if solver == "gau23" and windowed:
            x = _gather_products(pupil_tiled, spectrum, starts[c : c + chunk],
                                 w_win)
            if engine in ("int8", "int8_fast"):
                _intensity_windowed_int8(x, t_limbs, t_scales, w,
                                         fast=engine == "int8_fast", out=acc)
            else:
                acc = acc + _intensity_windowed_3m(x, t0r, t0i, w)
            continue
        if solver == "gau23":
            fields = _fields_gau23(pupil_tiled, spectrum, s, fft_size, engine)
        else:
            fields = _fields_direct(pupil_tiled, spectrum, s, config)
        acc = acc + torch.sum(w[:, None, None] * fields.abs() ** 2, dim=0)
    return acc


def _postprocess_gau23(image: torch.Tensor, config: OpticsConfig) -> torch.Tensor:
    """Gau'23-path post-processing: bilinear downscale by 1/epsilon, then
    center zero-pad back to n x n."""
    eps = config.wavelength_scaling().epsilon
    down = bilinear_resize(image, 1.0 / eps, dtype=image.dtype)
    return pad_center(down, config.n)


def abbe_image_points(
    spectrum,
    pupil,
    shifts,
    weights,
    config: OpticsConfig,
    *,
    device,
    solver: Solver = "gau23",
    chunk: int = 4,
    normalize: bool = False,
    total_weight=None,
    engine: str = "auto",
    max_abs_shift: int | None = None,
) -> torch.Tensor:
    """Aerial image on ``device`` from an explicit padded point list:
    ``shifts`` (p, 2) host integers and ``weights`` (p,), p divisible by
    ``chunk``; zero-weight entries act as padding."""
    spectrum = to_tensor(spectrum, device=device, dtype=torch.complex64)
    pupil = to_tensor(pupil, device=device, dtype=torch.complex64)
    weights = to_tensor(weights, device=device, dtype=torch.float32)
    if isinstance(shifts, torch.Tensor):
        shifts = shifts.cpu().numpy()
    shifts = np.asarray(shifts)
    if max_abs_shift is None and shifts.size:
        max_abs_shift = int(np.abs(shifts).max())
    image = accumulate_intensity(
        pupil, spectrum, shifts, weights, config, solver=solver, chunk=chunk,
        engine=engine, max_abs_shift=max_abs_shift)
    if solver == "gau23":
        image = _postprocess_gau23(image, config)
    if normalize:
        total = float(weights.sum()) if total_weight is None else float(total_weight)
        # all-dark source: a zero image, normalized or not
        image = image / total if total > 0 else torch.zeros_like(image)
    return image


def abbe_image(
    spectrum,
    pupil,
    source,
    config: OpticsConfig,
    *,
    device,
    solver: Solver = "gau23",
    chunk: int = 4,
    normalize: bool = False,
    engine: str = "auto",
) -> torch.Tensor:
    """Aerial image from a mask spectrum, pupil function and source: a
    :class:`SourcePoints` list or an (n, n) source map (turned into points
    on the host). Returns the (n, n) float32 image with the reference's
    scaling; ``normalize=True`` divides by the total source weight."""
    if solver not in ("gau23", "direct"):
        raise ValueError(f"unknown abbe solver {solver!r}")
    if not isinstance(source, SourcePoints):
        source = source_points(source)
    shifts, weights = _pad_points(source.shifts, source.weights, chunk)
    return abbe_image_points(
        spectrum, pupil, shifts, weights, config, device=device,
        solver=solver, chunk=chunk, normalize=normalize,
        total_weight=source.total_weight, engine=engine)
