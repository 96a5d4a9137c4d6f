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
  hand-written int8 limb kernels (:mod:`.kernels.intensity_int8`), behind
  one entry, :func:`int8_intensity`, which this engine's windowed pass and
  the SOCS apply both call: on the card one host call issues every chunk,
  on the CPU the chunks run one at a time through the plain versions; the
  gradient recomputes each chunk through the float32 3M path, as the JAX
  package's ``custom_vjp`` does (:class:`_Int8Intensity`). T0's planes and
  limbs are cached per configuration and device (:func:`t0_operands`).
  ``pallas`` is accepted as an alias of ``int8``.

Only ``matmul_precision='highest'`` exists: TF32 stays off.

While a profiler trace records (:mod:`..utils.profiling`),
:func:`accumulate_intensity` marks the per-call set-up of its windowed path
(``litho.abbe.setup``: T0's cache look-up and the window starts' check
and upload), and
it counts the fields it computes (``abbe.fields``, padding included).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import numpy as np
import torch

from .._spans import Counters, span
from .._tensors import per_device_cache, to_tensor
from ..config import OpticsConfig
from .fourier import centered_ifft2, crop_center, pad_center
from .fraunhofer import separable_dft
from .kernels.intensity_int8 import (check_window_starts, column_intensity_int8,
                                     int8_chunk_loop, prepare_t0_limbs,
                                     row_limb_gemm, row_requantize,
                                     window_product_limbs, window_products)
from .resize import bilinear_resize

Solver = Literal["gau23", "direct"]
ENGINES = ("fft", "matmul", "int8", "int8_fast")

_FIELD_COUNTS = Counters("abbe", ("fields",))


def resolve_engine(engine: str, *, device, allowed=ENGINES) -> str:
    """``'auto'`` -> ``'int8'`` for a CUDA device (the hand-written
    kernels; ``'matmul'`` where ``allowed`` has no ``int8``) and ``'fft'``
    for the CPU, mirroring the JAX package's TPU/CPU split; explicit names
    are validated against ``allowed``, and ``pallas`` is an alias of
    ``int8``. ``int8_fast`` (2-limb, ~1.5e-5 normalized RMS) is never chosen
    automatically."""
    if engine == "pallas":
        engine = "int8"
    if engine != "auto" and engine not in allowed:
        raise ValueError(
            f"unknown field-transform engine {engine!r} (allowed: {allowed})")
    if engine != "auto":
        return engine
    if torch.device(device).type != "cuda":
        return "fft"
    return "int8" if "int8" in allowed else "matmul"


def check_matmul_precision(matmul_precision: str) -> None:
    """The JAX package's ``matmul_precision`` argument: only
    ``'highest'`` (full float32) exists here, since TF32 stays off; its
    reduced settings are refused."""
    if matmul_precision != "highest":
        raise ValueError(
            f"matmul_precision={matmul_precision!r}: only 'highest' is "
            "supported (TF32 stays off for every engine contraction)")


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


def dense_source_points(n: int) -> np.ndarray:
    """All (n*n, 2) integer grid offsets, row-major, for the dense path."""
    iy, ix = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return (np.stack([iy.ravel(), ix.ravel()], axis=-1) - n // 2).astype(np.int32)


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


def _rolled_products(pupil_tiled, spectrum, shifts):
    """(B, n, n) stack of roll(pupil, s_b) * spectrum (torch.roll's sign)."""
    n = spectrum.shape[-1]
    starts = torch.as_tensor(_window_starts(shifts, n, n, 0),
                             device=spectrum.device)
    return window_products(pupil_tiled[None], spectrum, starts, n)


def _windowed_products(pupil_tiled, spectrum, shifts, w: int, lo: int):
    """(B, w, w) windows of roll(P, s_b) * M. For |shift| <= n/4 - 2 the
    rolled unit disk stays interior and the window holds every nonzero
    entry of the product (guard in :func:`accumulate_intensity`)."""
    n = spectrum.shape[-1]
    starts = torch.as_tensor(_window_starts(shifts, n, w, lo),
                             device=spectrum.device)
    return window_products(pupil_tiled[None], spectrum, starts, w)


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


@per_device_cache(maxsize=4)
def t0_operands(n: int, fft_size: int, w: int, device: torch.device):
    """T0's float32 planes (n, w) on ``device`` and their int8 row limbs
    and scales (:func:`prepare_t0_limbs`), a function of the config alone:
    ``w = n`` the whole chirp (the SOCS apply), ``w = _window_size(n)`` the
    exact engine's window (:func:`_zoom_dft_window`); the matmul and int8
    engines read the same entry. Cached, so a tiled chip or a vector image
    forms, uploads and quantizes it once instead of once an apply or a
    pass; the values are the same either way."""
    t0 = (_zoom_dft_kernel(n, fft_size) if w == n
          else _zoom_dft_window(n, fft_size))
    t0r = torch.as_tensor(t0.real, dtype=torch.float32, device=device)
    t0i = torch.as_tensor(t0.imag, dtype=torch.float32, device=device)
    return (t0r, t0i, *prepare_t0_limbs(t0r, t0i))


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


def _int8_pass(a, b, starts, w: int, t_limbs, t_scales, weights, *,
               chunk: int, fast: bool, out: torch.Tensor) -> torch.Tensor:
    """The int8 contraction added into ``out`` in place, on the device's
    one path: on the card one host call issues every chunk
    (:func:`int8_chunk_loop`, four launches a chunk); on the CPU the chunks
    run one at a time through the four wrappers' plain versions."""
    if out.device.type == "cuda":
        return int8_chunk_loop(a, b, starts, w, t_limbs, t_scales, weights,
                               chunk=chunk, fast=fast, out=out)
    for c in range(0, starts.shape[0], chunk):
        a_c = a[c:c + chunk] if a.shape[0] > 1 else a
        x_limbs, x_scales = window_product_limbs(a_c, b, starts[c:c + chunk], w)
        yr, yi = row_limb_gemm(x_limbs, x_scales, t_limbs, t_scales, fast=fast)
        y_limbs, y_scales = row_requantize(yr, yi, t_limbs.shape[-1])
        column_intensity_int8(y_limbs, y_scales, t_limbs, t_scales,
                              weights[c:c + chunk], fast=fast, out=out)
    return out


class _Int8Intensity(torch.autograd.Function):
    """The int8 pass as a differentiable function of ``a``, ``b`` and
    ``weights``. The forward runs :func:`_int8_pass` into a fresh (n, n)
    buffer; the backward loops the chunks, re-forms each chunk's X with
    :func:`window_products` and differentiates
    :func:`_intensity_windowed_3m` in float32, as the JAX package's
    ``custom_vjp`` does (its ``abbe.py`` bwd): limb rounding has no useful
    gradient. T0 gets none."""

    @staticmethod
    def forward(ctx, a, b, weights, starts, w, t0, chunk, fast):
        t0r, t0i, t_limbs, t_scales = t0
        n = t_limbs.shape[2]
        out = torch.zeros((n, n), dtype=torch.float32, device=b.device)
        _int8_pass(a, b, starts, w, t_limbs, t_scales, weights, chunk=chunk,
                   fast=fast, out=out)
        ctx.save_for_backward(a, b, weights, starts, t0r, t0i)
        ctx.w, ctx.chunk = w, chunk
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, weights, starts, t0r, t0i = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        grads = [torch.zeros_like(t) if r else None
                 for t, r in zip((a, b, weights), need)]
        batched = a.shape[0] > 1
        for c in range(0, starts.shape[0], ctx.chunk):
            rows = slice(c, c + ctx.chunk)
            with torch.enable_grad():
                a_, b_, w_ = (t.detach().requires_grad_(r) for t, r in zip(
                    (a[rows] if batched else a, b, weights[rows]), need))
                x = window_products(a_, b_, starts[rows], ctx.w)
                part = _intensity_windowed_3m(x, t0r, t0i, w_)
                live = [t for t, r in zip((a_, b_, w_), need) if r]
                # the VJP as the gradient of <part, g>: the same values, and
                # torch.autograd.grad with no grad_outputs skips the shape
                # check that imports sympy (seconds) on its first call in a
                # process
                got = iter(torch.autograd.grad((part * g).sum(), live))
            # a batch of arrays and the weights take one slice a chunk; a
            # one-array a and b gather every chunk's part
            for grad, sl in zip(grads, (rows if batched else slice(None),
                                        slice(None), rows)):
                if grad is not None:
                    grad[sl] += next(got)
        return (*grads, None, None, None, None, None)


def int8_intensity(a, b, starts, w: int, t0, weights, *, chunk: int,
                   fast: bool, out: torch.Tensor) -> torch.Tensor:
    """The one entry of the int8 contraction: ``out`` plus the
    :func:`_intensity_windowed_3m` image of the window products X_b of
    ``a`` and ``b`` at ``starts`` (P, 4) (see :func:`window_product_limbs`)
    on the int8 limb kernels, ``chunk`` windows a chunk. ``t0`` is
    :func:`t0_operands`' (planes, limbs, scales); ``a`` (1 or P, ...) holds
    the one array every window reads, or one array a window. Without
    gradients the sum is added into ``out`` in place
    (:func:`_int8_pass`); when grad mode is on and an input requires grad,
    the pass runs as :class:`_Int8Intensity` and is added out of place: the
    caller keeps the returned sum."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad
                                    or weights.requires_grad):
        return out + _Int8Intensity.apply(a, b, weights, starts, w, t0, chunk,
                                          fast)
    return _int8_pass(a, b, starts, w, *t0[2:], weights, chunk=chunk,
                      fast=fast, out=out)


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
    (constant -2i*pi*pupil_na/lambda)."""
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
    matmul_precision: str = "highest",
    max_abs_shift: int | None = None,
) -> torch.Tensor:
    """Loop over source-point chunks accumulating ``sum_s w_s |E_s|^2``.

    ``shifts`` (p, 2) integer offsets live on the host; ``weights`` (p,) on
    the spectrum's device; p must be divisible by ``chunk``. Returns the raw
    (n, n) float32 intensity (before postprocessing). Differentiable on
    every engine (the int8 engines through :class:`_Int8Intensity`)."""
    check_matmul_precision(matmul_precision)
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
        with span("litho.abbe.setup"):
            w_win = _window_size(n)
            lo = n // 4 - 1
            t0 = t0_operands(n, fft_size, w_win, device)
            if engine in ("int8", "int8_fast"):
                spectrum = spectrum.contiguous()
            one_pupil = pupil_tiled[None]  # (1, 2n, 2n): the array all windows read
            # validated once on the host: no chunk checks them on the device
            starts = torch.as_tensor(
                check_window_starts(_window_starts(shifts, n, w_win, lo), w_win,
                                    pupil_tiled.shape, spectrum.shape),
                device=device)

    if solver == "gau23" and windowed and engine in ("int8", "int8_fast"):
        acc = int8_intensity(one_pupil, spectrum, starts, w_win, t0, weights,
                             chunk=chunk, fast=engine == "int8_fast", out=acc)
        _FIELD_COUNTS.add("fields", p)
        return acc
    for c in range(0, p, chunk):
        s = shifts[c : c + chunk]
        w = weights[c : c + chunk]
        if solver == "gau23" and windowed:
            x = window_products(one_pupil, spectrum, starts[c : c + chunk], w_win)
            acc = acc + _intensity_windowed_3m(x, *t0[:2], w)
            continue
        if solver == "gau23":
            fields = _fields_gau23(pupil_tiled, spectrum, s, fft_size, engine)
        else:
            fields = _fields_direct(pupil_tiled, spectrum, s, config)
        acc = acc + torch.sum(w[:, None, None] * fields.abs() ** 2, dim=0)
    _FIELD_COUNTS.add("fields", p)
    return acc


def postprocess_gau23(image: torch.Tensor, config: OpticsConfig) -> torch.Tensor:
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
    matmul_precision: str = "highest",
    max_abs_shift: int | None = None,
) -> torch.Tensor:
    """Aerial image on ``device`` from an explicit padded point list:
    ``shifts`` (p, 2) host integers and ``weights`` (p,), p divisible by
    ``chunk``; zero-weight entries act as padding."""
    check_matmul_precision(matmul_precision)
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
        image = postprocess_gau23(image, config)
    if normalize:
        if total_weight is None:
            # the sum stays on the device and in the graph: the weights'
            # gradient has a term through it, as in the JAX package
            total = weights.sum()
            # all-dark source: a zero image, normalized or not
            return torch.where(total > 0,
                               image / torch.clamp(total, min=1e-30), 0.0)
        total = float(total_weight)
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
    :class:`SourcePoints` list, an (n, n) source map (turned into points
    on the host), or an (n, n) map tensor that requires grad (the dense
    path over every grid point, differentiable in each pixel of the map,
    as the JAX package's traced map). Returns the (n, n) float32 image
    with the reference's scaling; ``normalize=True`` divides by the total
    source weight."""
    if solver not in ("gau23", "direct"):
        raise ValueError(f"unknown abbe solver {solver!r}")
    if isinstance(source, torch.Tensor) and source.requires_grad:
        shifts = dense_source_points(config.n)
        shifts, _ = _pad_points(shifts, np.zeros(len(shifts), np.float32),
                                chunk)
        flat = source.reshape(-1).to(torch.float32)
        # zero padding on the map's device; the weights' sum (the
        # normalization) stays in the graph, as F5's does
        weights = torch.nn.functional.pad(flat, (0, len(shifts) - flat.numel()))
        return abbe_image_points(
            spectrum, pupil, shifts, weights, config, device=device,
            solver=solver, chunk=chunk, normalize=normalize, engine=engine)
    if not isinstance(source, SourcePoints):
        source = source_points(source)
    shifts, weights = _pad_points(source.shifts, source.weights, chunk)
    return abbe_image_points(
        spectrum, pupil, shifts, weights, config, device=device,
        solver=solver, chunk=chunk, normalize=normalize,
        total_weight=source.total_weight, engine=engine)
