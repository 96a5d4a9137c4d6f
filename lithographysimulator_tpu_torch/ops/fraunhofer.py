"""Mask-spectrum solvers: Gau'23 wavelength-scaling FFT and direct Fraunhofer.

Port of ``lithographysimulator_tpu/ops/fraunhofer.py``:

* :func:`spectrum_fft` — bilinear-upsample the mask by epsilon, zero-pad to
  the power-of-two FFT size N, centered unnormalized ``fft2`` (cuFFT on the
  card), crop back to n.
* :func:`spectrum_direct` — the discrete Fraunhofer integral as the
  separable product ``Kw @ G @ Kw^T`` with trapezoid weights folded into
  ``Kw`` (built on the host in float64, cached per config).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import OpticsConfig
from ..grid import Grid
from .fourier import centered_fft2, crop_center, pad_center
from .resize import bilinear_resize


def trapezoid_weights(n: int) -> np.ndarray:
    """Uniform-spacing trapezoid quadrature weights [0.5, 1, ..., 1, 0.5]."""
    w = np.ones(n, dtype=np.float64)
    w[0] = w[-1] = 0.5
    return w


@functools.lru_cache(maxsize=16)
def _dft_kernel_cached(config: OpticsConfig, sign: int) -> np.ndarray:
    """``Kw[a, b] = exp(sign*2i*pi/lambda * k[a] * x[b]) * w[b]``, complex128."""
    grid = Grid(config)
    c = sign * 2j * np.pi / config.wavelength
    kernel = np.exp(c * grid.k[:, None] * grid.x[None, :])
    return kernel * trapezoid_weights(config.n)[None, :]


def separable_dft(field: torch.Tensor, config: OpticsConfig, sign: int,
                  dtype=torch.complex64) -> torch.Tensor:
    """``Kw @ field @ Kw^T`` over the trailing two dims."""
    kw = torch.as_tensor(_dft_kernel_cached(config, sign), dtype=dtype,
                         device=field.device)
    return kw @ field.to(dtype) @ kw.T


def spectrum_direct(geometry: torch.Tensor, config: OpticsConfig,
                    dtype=torch.complex64) -> torch.Tensor:
    """Direct Fraunhofer mask spectrum (constant +2i*pi/lambda)."""
    return separable_dft(geometry, config, sign=+1, dtype=dtype)


def spectrum_fft(geometry: torch.Tensor, config: OpticsConfig,
                 dtype=torch.complex64) -> torch.Tensor:
    """Gau'23 wavelength-scaling FFT mask spectrum."""
    ws = config.wavelength_scaling()
    real_dtype = torch.float64 if dtype == torch.complex128 else torch.float32
    scaled = bilinear_resize(geometry, ws.epsilon, dtype=real_dtype)
    padded = pad_center(scaled, ws.fft_size)
    return crop_center(centered_fft2(padded.to(dtype)), config.n)


def mask_spectrum(geometry: torch.Tensor, config: OpticsConfig, *,
                  solver: str = "gau23", dtype=torch.complex64) -> torch.Tensor:
    """Dispatch on solver kind: ``'gau23'`` (fast FFT) or ``'direct'``."""
    if solver == "gau23":
        return spectrum_fft(geometry, config, dtype=dtype)
    if solver == "direct":
        return spectrum_direct(geometry, config, dtype=dtype)
    raise ValueError(f"unknown spectrum solver {solver!r}")
