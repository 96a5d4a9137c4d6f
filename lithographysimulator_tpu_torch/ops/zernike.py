"""Zernike polynomials (OSA/ANSI indexing) and wavefront-error assembly.

Port of ``lithographysimulator_tpu/ops/zernike.py``: Born & Wolf radial
polynomial R_mn, normalization N_mn = sqrt((2n+1)/(1+delta_m0)),
cos(m*theta) for m >= 0 and sin(|m|*theta) for m < 0, zeroed outside the
unit disk. The (count, n, n) basis depends only on the config, so it is
built on the host in float64 and cached, and its float32 (or float64)
copy on each device is cached too: an optimizer forms the pupil every
step. The wavefront error is one tensordot of the coefficient vector
against it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .._tensors import per_device_cache, to_tensor
from ..config import OpticsConfig
from ..grid import Grid

DEFOCUS_OSA_INDEX = 4  # Z_2^0, stored in nm and converted to waves internally.


def osa_index_to_mn(j: int) -> tuple[int, int]:
    """OSA/ANSI single index -> (m, n) (Lin eqs. 4.39/4.40)."""
    n = math.ceil(0.5 * (-3.0 + math.sqrt(9.0 + 8.0 * j)))
    m = 2 * j - n * (n + 2)
    return m, n


def mn_to_osa_index(m: int, n: int) -> int:
    return (n * (n + 2) + m) // 2


def noll_index_to_mn(j: int) -> tuple[int, int]:
    """Noll single index (1-based) -> (m, n): radial order ascending; within
    an order |m| ascending, even j <-> cosine (m >= 0), odd j <-> sine."""
    if j < 1:
        raise ValueError(f"Noll index is 1-based, got {j}")
    n = 0
    k = j - 1
    while k > n:
        n += 1
        k -= n
    m = (-1) ** j * ((n % 2) + 2 * ((k + ((n + 1) % 2)) // 2))
    return m, n


def fringe_index_to_mn(j: int) -> tuple[int, int]:
    """Fringe / University-of-Arizona single index (1-based) -> (m, n):
    j = (1 + (n + |m|)/2)^2 - 2|m| + (1 - sgn m)/2."""
    if j < 1:
        raise ValueError(f"Fringe index is 1-based, got {j}")
    order = 1
    while order**2 < j:
        order += 1
    for n in range(2 * order + 1):
        for m in sorted(range(-n, n + 1), key=lambda v: (-abs(v), -v)):
            if (n - abs(m)) % 2:
                continue
            jf = (1 + (n + abs(m)) // 2) ** 2 - 2 * abs(m) + (0 if m >= 0 else 1)
            if jf == j:
                return m, n
    raise ValueError(f"no Fringe term with index {j}")


_INDEXINGS = {"osa": osa_index_to_mn,
              "noll": noll_index_to_mn,
              "fringe": fringe_index_to_mn}


def to_osa_coefficients(coefficients, scheme: str = "noll") -> np.ndarray:
    """Re-order a Noll- or Fringe-indexed coefficient vector (1-based,
    ``coefficients[0]`` is term 1) into the OSA-ordered vector."""
    scheme = scheme.lower()
    if scheme == "osa":
        return np.asarray(coefficients, np.float64)
    try:
        index_to_mn = _INDEXINGS[scheme]
    except KeyError:
        raise ValueError(
            f"unknown Zernike indexing {scheme!r} (osa, noll, fringe)") from None
    coefficients = np.asarray(coefficients, np.float64)
    pairs = [index_to_mn(j) for j in range(1, len(coefficients) + 1)]
    out = np.zeros(max(mn_to_osa_index(m, n) for m, n in pairs) + 1)
    for c, (m, n) in zip(coefficients, pairs):
        out[mn_to_osa_index(m, n)] += c
    return out


def radial_polynomial(m: int, n: int, r: np.ndarray) -> np.ndarray:
    """R_mn(r): sum over k of the factorial-coefficient terms."""
    am = abs(m)
    l_lim = (n - am) // 2
    il_lim = (n + am) // 2
    out = np.zeros_like(r)
    for k in range(l_lim + 1):
        coeff = ((-1) ** k * math.factorial(n - k)) / (
            math.factorial(k) * math.factorial(il_lim - k) * math.factorial(l_lim - k)
        )
        out += coeff * r ** (n - 2 * k)
    return out


def zernike_term(m: int, n: int, grid: Grid) -> np.ndarray:
    """One unit-coefficient Zernike polynomial on the sigma grid, float64,
    zeroed outside the unit disk."""
    r = grid.radius()
    theta = grid.theta()
    radial = radial_polynomial(m, n, r)
    norm = math.sqrt((2 * n + 1) / (1 + (1 if m == 0 else 0)))
    if m >= 0:
        z = norm * radial * np.cos(m * theta)
    else:
        z = norm * radial * np.sin(abs(m) * theta)
    return np.where(r <= 1.0, z, 0.0)


@functools.lru_cache(maxsize=16)
def _basis_cached(config: OpticsConfig, count: int) -> np.ndarray:
    grid = Grid(config)
    stack = np.empty((count, config.n, config.n), dtype=np.float64)
    for j in range(count):
        m, n = osa_index_to_mn(j)
        stack[j] = zernike_term(m, n, grid)
    return stack


def zernike_basis(config: OpticsConfig, count: int) -> np.ndarray:
    """Host-side cached (count, n, n) float64 stack of unit Zernike terms in
    OSA order 0..count-1."""
    return _basis_cached(config, int(count)).copy()


def convert_defocus(aberrations: torch.Tensor,
                    config: OpticsConfig) -> torch.Tensor:
    """Coefficients with entry 4 converted from nm of defocus to waves
    (Mack eq. 3.24); returns a new tensor, the input is not mutated."""
    if aberrations.shape[0] >= DEFOCUS_OSA_INDEX + 1:
        aberrations = aberrations.clone()
        aberrations[DEFOCUS_OSA_INDEX] *= config.na**2 / (4.0 * config.wavelength)
    return aberrations


def wavefront_error(aberrations, config: OpticsConfig, *, device=None,
                    defocus_in_nm: bool = True,
                    dtype=torch.float32) -> torch.Tensor:
    """Coefficient-weighted sum of Zernike terms -> (n, n) wavefront error in
    waves. Host coefficients need ``device``; a tensor keeps its own."""
    aberrations = to_tensor(aberrations, device=device, dtype=dtype)
    if defocus_in_nm:
        aberrations = convert_defocus(aberrations, config)
    basis = _basis_on(config, int(aberrations.shape[0]), dtype,
                      aberrations.device)
    return torch.tensordot(aberrations, basis, dims=1)


@per_device_cache(maxsize=4)
def _basis_on(config: OpticsConfig, count: int, dtype,
              device: torch.device) -> torch.Tensor:
    """:func:`zernike_basis` as a ``dtype`` tensor on ``device``, uploaded
    once per (config, count, dtype, device); callers must not write to it."""
    return torch.tensor(_basis_cached(config, count), dtype=dtype,
                        device=device)
