"""Separable bilinear resize as two matmuls.

Port of ``lithographysimulator_tpu/ops/resize.py``: torch's own
``interpolate(mode='bilinear')`` convention (output size ``floor(n *
scale)``, source coordinate ``(dst + 0.5) / scale - 0.5`` clamped to
``[0, n - 1]``, identity when the size is unchanged), written as
``W @ img @ W.T`` with the 1-D interpolation matrix ``W`` built once per
``(n, scale)`` on the host in float64.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .._tensors import per_device_cache


@functools.lru_cache(maxsize=128)
def _interp_matrix_cached(n: int, scale: float, out_size: int) -> np.ndarray:
    src = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    src = np.clip(src, 0.0, n - 1.0)
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    hi = np.minimum(lo + 1, n - 1)
    w = np.zeros((out_size, n), dtype=np.float64)
    np.add.at(w, (np.arange(out_size), lo), 1.0 - frac)
    np.add.at(w, (np.arange(out_size), hi), frac)
    return w


def output_size(n: int, scale: float) -> int:
    return int(math.floor(n * scale))


def interp_matrix(n: int, scale: float, out_size: int | None = None) -> np.ndarray:
    """1-D bilinear interpolation matrix of shape ``(out_size, n)``, f64."""
    if out_size is None:
        out_size = output_size(n, scale)
    return _interp_matrix_cached(n, float(scale), int(out_size))


def bilinear_resize(img: torch.Tensor, scale: float,
                    dtype=torch.float32) -> torch.Tensor:
    """Resize the trailing two dims of ``img`` by ``scale`` (torch parity).
    Complex input resizes its real and imaginary planes."""
    if img.is_complex():
        re = bilinear_resize(img.real, scale, dtype=dtype)
        im = bilinear_resize(img.imag, scale, dtype=dtype)
        return torch.complex(re, im)
    n_rows, n_cols = img.shape[-2], img.shape[-1]
    out_r, out_c = output_size(n_rows, scale), output_size(n_cols, scale)
    if out_r == n_rows and out_c == n_cols:
        return img.to(dtype)
    w_r = _interp_matrix_on(n_rows, float(scale), out_r, dtype, img.device)
    w_c = _interp_matrix_on(n_cols, float(scale), out_c, dtype, img.device)
    return w_r @ img.to(dtype) @ w_c.T


@per_device_cache(maxsize=8)
def _interp_matrix_on(n: int, scale: float, out_size: int, dtype,
                      device: torch.device) -> torch.Tensor:
    """:func:`interp_matrix` as a ``dtype`` tensor on ``device``, uploaded
    once: a tiled chip resizes every tile's mask and image with the same
    two matrices."""
    return torch.as_tensor(interp_matrix(n, scale, out_size), dtype=dtype,
                           device=device)
