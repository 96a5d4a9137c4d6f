"""Illumination sources: classical / annular / quasar (quadrupole) / dipole.

Port of ``lithographysimulator_tpu/models/source.py``. A source map is
static configuration that the imaging engine turns into a host-side point
list, so the maps are built and returned as float32 numpy arrays on the
sigma plane (the JAX package returns the same values as jnp arrays).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import OpticsConfig
from ..grid import Grid


@dataclasses.dataclass(frozen=True)
class LightSource:
    """Partial-coherence source spec: sigma_in/sigma_out in partial-coherence
    units, optional off-axis shift in wavelength/NA units."""

    config: OpticsConfig
    sigma_in: float = 0.0
    sigma_out: float = 0.6
    shift_x: float = 0.0
    shift_y: float = 0.0

    def _polar(self):
        grid = Grid(self.config)
        r = grid.radius(self.shift_x, self.shift_y)
        theta = grid.theta(self.shift_x, self.shift_y)
        return r, theta

    def annular(self) -> np.ndarray:
        """Binary ring sigma_in <= ||sigma|| <= sigma_out."""
        r, _ = self._polar()
        ring = (r >= self.sigma_in) & (r <= self.sigma_out)
        return ring.astype(np.float32)

    def classical(self) -> np.ndarray:
        """Top-hat circular source: the sigma_in = 0 annulus."""
        r, _ = self._polar()
        disk = (r >= 0.0) & (r <= self.sigma_out)
        return disk.astype(np.float32)

    def quasar(self, count: int, rotation: float) -> np.ndarray:
        """Annulus with ``count`` poles carved out by zeroing alternating
        angular sectors of width pi/count, rotated by ``rotation``."""
        r, theta = self._polar()
        theta = np.mod(theta + rotation, 2.0 * np.pi)
        ring = (r >= self.sigma_in) & (r <= self.sigma_out)
        spacing = np.pi / count
        keep = np.ones_like(theta, dtype=bool)
        for gap in range(count):
            lo = 2 * gap * spacing
            hi = (2 * gap + 1) * spacing
            keep &= ~((lo < theta) & (theta < hi))
        return (ring & keep).astype(np.float32)

    def quadrupole(self, rotation: float = -np.pi / 8) -> np.ndarray:
        """Four-pole quasar; default rotation matches the reference demo."""
        return self.quasar(4, rotation)

    def dipole(self, rotation: float = 0.0) -> np.ndarray:
        """Two-pole quasar."""
        return self.quasar(2, rotation)

    def monopole(self) -> np.ndarray:
        """Single on-axis point: the coherent-illumination limit."""
        n = self.config.n
        m = np.zeros((n, n), dtype=np.float32)
        m[n // 2, n // 2] = 1.0
        return m
