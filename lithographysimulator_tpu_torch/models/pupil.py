"""Projection-pupil model: Zernike-aberrated complex pupil function.

Port of ``lithographysimulator_tpu/models/pupil.py``: wavefront error as an
OSA-ordered Zernike sum (entry 4 in nm of defocus), pupil function
P = exp(i * 2pi * WE) hard-clipped to the unit disk (minus any central
obscuration) on the sigma plane.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import OpticsConfig
from ..grid import Grid, unit_disk_mask
from ..ops.zernike import wavefront_error


@dataclasses.dataclass(frozen=True)
class Pupil:
    """Aberration description for one imaging configuration: OSA-ordered
    Zernike coefficients in waves (entry 4 in nm when ``defocus_in_nm``);
    ``None`` is a perfect lens."""

    config: OpticsConfig
    aberrations: tuple[float, ...] | None = None
    defocus_in_nm: bool = True

    def coefficients(self) -> np.ndarray:
        if self.aberrations is None:
            return np.zeros((1,), dtype=np.float32)
        return np.asarray(self.aberrations, dtype=np.float32)

    def wavefront(self, *, device, dtype=torch.float32) -> torch.Tensor:
        return wavefront_error(self.coefficients(), self.config, device=device,
                               defocus_in_nm=self.defocus_in_nm, dtype=dtype)

    def function(self, *, device, dtype=torch.complex64) -> torch.Tensor:
        return pupil_function(self.coefficients(), self.config, device=device,
                              defocus_in_nm=self.defocus_in_nm, dtype=dtype)


def pupil_function(aberrations, config: OpticsConfig, *, device=None,
                   defocus_in_nm: bool = True,
                   dtype=torch.complex64) -> torch.Tensor:
    """(n, n) complex pupil P = exp(i*2pi*WE) on r <= 1, zero outside.
    Host coefficients need ``device``; a tensor keeps its own."""
    real_dtype = torch.float64 if dtype == torch.complex128 else torch.float32
    we = wavefront_error(aberrations, config, device=device,
                         defocus_in_nm=defocus_in_nm, dtype=real_dtype)
    phase = (2.0 * np.pi) * we
    phi = torch.complex(torch.cos(phase), torch.sin(phase)).to(dtype)
    grid = Grid(config)
    disk = unit_disk_mask(grid)
    if config.obscuration > 0.0:
        disk = disk & (grid.radius() >= config.obscuration)
    return phi * torch.as_tensor(disk, dtype=dtype, device=phi.device)
