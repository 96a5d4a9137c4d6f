"""Vector (high-NA) imaging: the Jones-pupil Abbe engine.

Port of ``lithographysimulator_tpu/ops/vector.py``. Above NA ~ 0.85 the
scalar approximation breaks down: the focused plane waves tilt, the
tangential (TE) and radial (TM) components focus differently, and a
longitudinal (z) component appears. The pupil becomes a 3x2 Jones/vector
pupil V(sigma): input polarization (Jx, Jy) at the mask -> wafer-plane field
components (Ex, Ey, Ez). At pupil position sigma with rho = |sigma| <= 1,

    sin(theta) = NA * rho / n_medium,   gamma = cos(theta)
    e_t = (-sy, sx)/rho  (TE, unchanged by focusing)
    e_r = ( sx, sy)/rho  (TM: in-plane part scales by gamma, z part
                          is -sin(theta))

    V[:, p] = e_t e_t[p] + gamma * e_r e_r[p]    (x, y rows)
    V[2, p] = -sin(theta) * e_r[p]               (z row)

with an optional 1/sqrt(gamma) radiometric apodization. Each component
pupil V_cp * P is a scalar pupil, so every source point runs through the
scalar Abbe engine unchanged (the int8 limb kernels on CUDA), and the vector
image is the incoherent sum over components and polarization states:

    I = sum_p q_p sum_c AbbeIntensity(V_cp * P, M)

While a profiler trace records, each pass is marked
``litho.vector.component`` (attributes ``state``, the index of the Jones
state, and ``component``, 0-2 for x, y, z).

The factors are built on the host in float64, as in the JAX package (the
JAX module imports jax, so the port keeps its own copy of this numpy half):
the component-dedup of :mod:`.hopkins` compares them by exact equality.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._spans import span
from .._tensors import to_tensor
from ..config import OpticsConfig
from ..grid import Grid
from .abbe import abbe_image_points

#: polarization states: name -> list of (weight, jones (jx, jy))
_UNPOL = [(0.5, (1.0, 0.0)), (0.5, (0.0, 1.0))]


def polarization_states(polarization) -> list:
    """Normalize a polarization spec to [(weight, (jx, jy)), ...].

    'x' / 'y': linear; 'unpolarized': incoherent equal mix of x and y;
    a 2-tuple/list: an explicit Jones vector (normalized to unit power).
    """
    if polarization in (None, "unpolarized"):
        return _UNPOL
    if polarization == "x":
        return [(1.0, (1.0, 0.0))]
    if polarization == "y":
        return [(1.0, (0.0, 1.0))]
    if isinstance(polarization, (tuple, list)) and len(polarization) == 2:
        jx, jy = complex(polarization[0]), complex(polarization[1])
        norm = np.sqrt(abs(jx) ** 2 + abs(jy) ** 2)
        if norm == 0:
            raise ValueError("zero Jones vector")
        return [(1.0, (jx / norm, jy / norm))]
    raise ValueError(f"unknown polarization {polarization!r}")


@functools.lru_cache(maxsize=16)
def _vector_basis(config: OpticsConfig):
    """Host float64 pupil-angle basis ``(tx, ty, rx, ry, gamma, sin_t,
    inside)``: the tangential (TE) and radial (TM) unit vectors on the sigma
    plane, the focus-cone cosine and sine in the image-side medium, and the
    propagating unit-disk mask. Positions with NA rho >= n_medium are
    evanescent (beyond total internal reflection) and are cut, not clipped."""
    grid = Grid(config)
    sx = grid.sigma[None, :]
    sy = grid.sigma[:, None]
    rho = np.hypot(sx + 0 * sy, sy + 0 * sx)
    inside = rho <= 1.0
    n_med = config.immersion_index
    sin_t = config.na * rho / n_med
    propagating = sin_t < 1.0 - 1e-12
    sin_t = np.where(propagating, sin_t, 0.0)
    inside = inside & propagating
    gamma = np.sqrt(1.0 - sin_t**2)

    safe_rho = np.where(rho > 0, rho, 1.0)
    tx = np.where(rho > 0, -sy / safe_rho, 0.0)
    ty = np.where(rho > 0, sx / safe_rho, 1.0)
    rx = np.where(rho > 0, sx / safe_rho, 1.0)
    ry = np.where(rho > 0, sy / safe_rho, 0.0)
    return tx, ty, rx, ry, gamma, sin_t, inside


@functools.lru_cache(maxsize=16)
def _vector_factors(config: OpticsConfig, apodize: bool):
    """Host (3, 2, n, n) float64 V(sigma) plus the unit-disk mask."""
    tx, ty, rx, ry, gamma, sin_t, inside = _vector_basis(config)
    rho = Grid(config).radius()
    # on-axis point: direction degenerate; V must be identity (x,y), 0 (z)
    v = np.zeros((3, 2, config.n, config.n))
    for p, (tp, rp) in enumerate(((tx, rx), (ty, ry))):
        v[0, p] = tx * tp + gamma * rx * rp
        v[1, p] = ty * tp + gamma * ry * rp
        v[2, p] = -sin_t * rp
    center = rho == 0
    if center.any():
        v[0, 0][center] = 1.0
        v[1, 1][center] = 1.0
        v[0, 1][center] = v[1, 0][center] = v[2, 0][center] = v[2, 1][center] = 0.0
    if apodize:
        v = v / np.sqrt(np.maximum(gamma, 1e-6))[None, None]
    return v * inside[None, None], inside


def component_factors(config: OpticsConfig, jones, *,
                      apodize: bool = True) -> np.ndarray:
    """Host (3, n, n) V . J: the three wafer-plane component factors for
    one Jones input state (multiply by the scalar pupil to get the
    component pupils)."""
    v, _ = _vector_factors(config, apodize)
    jx, jy = jones
    return v[:, 0] * jx + v[:, 1] * jy  # (3, n, n), possibly complex


def vector_pupils(pupil, config: OpticsConfig, jones, *,
                  apodize: bool = True, device=None) -> torch.Tensor:
    """(3, n, n) complex64 component pupils (Vx.J, Vy.J, Vz.J) * scalar
    pupil, on the pupil's device (``device`` places a host pupil)."""
    pupil = to_tensor(pupil, device=device, dtype=torch.complex64)
    comp = component_factors(config, jones, apodize=apodize)
    return torch.as_tensor(comp, dtype=torch.complex64,
                           device=pupil.device) * pupil[None]


def vector_abbe_image(
    spectrum,
    pupil,
    shifts,
    weights,
    config: OpticsConfig,
    *,
    device,
    polarization="unpolarized",
    apodize: bool = True,
    solver: str = "gau23",
    chunk: int = 4,
    normalize: bool = False,
    engine: str = "auto",
    max_abs_shift: int | None = None,
) -> torch.Tensor:
    """Vector aerial image from an explicit padded source-point list: the
    contract of :func:`..ops.abbe.abbe_image_points` plus the polarization
    spec. One Abbe pass per (state, component): six for 'unpolarized', three
    for one Jones state, each on the int8 kernels on CUDA."""
    image = None
    for state, (weight, jones) in enumerate(polarization_states(polarization)):
        comps = vector_pupils(pupil, config, jones, apodize=apodize,
                              device=device)
        for c in range(3):
            with span("litho.vector.component", state=state, component=c):
                part = weight * abbe_image_points(
                    spectrum, comps[c], shifts, weights, config, device=device,
                    solver=solver, chunk=chunk, normalize=normalize,
                    engine=engine, max_abs_shift=max_abs_shift)
                image = part if image is None else image + part
    return image
