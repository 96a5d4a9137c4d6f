"""Shared coordinate grids (sigma ≡ k plane, spatial plane).

The reference rebuilds these meshgrids in four different modules, in float16
(``mask.py:44-52``, ``pupil.py:50-57``, ``lightsource.py:36-45``,
``imageformation.py:10-18``). Here they are built once, in float64 on the host
and cast down to the requested dtype, so a 2048-point axis does not suffer
fp16 rounding of the step 4/2048.

Axis convention matches ``torch.meshgrid(indexing='xy')`` as used throughout
the reference: for a 2-D field ``F[i, j]``, row index ``i`` varies along the
*y* axis and column index ``j`` along the *x* axis.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .config import SIGMA_SPAN, OpticsConfig


def axis(bound: float, step: float, n: int, shift: float = 0.0) -> np.ndarray:
    """``[-bound - shift, bound - shift)`` with ``n`` uniform samples, f64."""
    return (-bound - shift) + step * np.arange(n, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class Grid:
    """All coordinate axes for one :class:`OpticsConfig`, host-side numpy.

    Fields are float64 numpy; cast at the torch boundary. ``sigma`` and ``k``
    axes are numerically identical (the load-bearing invariant that lets a
    source point shift the pupil by an integer roll).
    """

    config: OpticsConfig

    @functools.cached_property
    def sigma(self) -> np.ndarray:
        c = self.config
        return axis(SIGMA_SPAN, c.delta_sigma, c.n)

    @functools.cached_property
    def k(self) -> np.ndarray:
        c = self.config
        return axis(c.k_bound, c.delta_k, c.n)

    @functools.cached_property
    def x(self) -> np.ndarray:
        c = self.config
        return axis(c.pixel_bound, c.pixel_size, c.n)

    def sigma_shifted(self, shift_x: float = 0.0, shift_y: float = 0.0):
        """Sigma axes offset by a source shift in wavelength/NA units
        (reference ``lightsource.py:39-40``). Returns ``(sigma_x, sigma_y)``."""
        c = self.config
        return (
            axis(SIGMA_SPAN, c.delta_sigma, c.n, shift_x),
            axis(SIGMA_SPAN, c.delta_sigma, c.n, shift_y),
        )

    def radius(self, shift_x: float = 0.0, shift_y: float = 0.0) -> np.ndarray:
        """``r[i, j] = hypot(sigma_x[j], sigma_y[i])`` on the sigma plane."""
        sx, sy = self.sigma_shifted(shift_x, shift_y)
        return np.hypot(sx[None, :], sy[:, None])

    def theta(self, shift_x: float = 0.0, shift_y: float = 0.0) -> np.ndarray:
        """``theta[i, j] = atan2(sigma_y[i], sigma_x[j])``."""
        sx, sy = self.sigma_shifted(shift_x, shift_y)
        return np.arctan2(sy[:, None], np.broadcast_to(sx[None, :], (len(sy), len(sx))))


def unit_disk_mask(grid: Grid) -> np.ndarray:
    """Boolean mask of the unit pupil r <= 1 on the sigma plane."""
    return grid.radius() <= 1.0
