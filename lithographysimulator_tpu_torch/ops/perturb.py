"""Aerial-image perturbation models: scanner stage blur (MSD) and flare.

Port of ``lithographysimulator_tpu/ops/perturb.py``. Both act on the
intensity (they are incoherent effects), so they compose with every solver
(scalar, SOCS, vector, chromatic) as a post-step on the aerial image:

* **Stage blur**: stage vibration and synchronization error smear the
  image during the scan; a separable Gaussian with independent x / y
  moving standard deviations (MSD, nm).
* **Flare**: long-range scattered light adds a background,
  I' = (1 - TIS) I + TIS * <I>, with TIS the total integrated scatter;
  ``flare_kernel_nm`` > 0 makes the background a wide Gaussian blur of the
  image instead of its mean (mid-range flare).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import OpticsConfig


@dataclasses.dataclass(frozen=True)
class ImagePerturbation:
    """Scanner non-idealities applied to the aerial intensity.

    msd_x_nm / msd_y_nm: Gaussian stage-blur sigmas (0 = off).
    flare_tis: total integrated scatter in [0, 1) (0 = off).
    flare_kernel_nm: 0 = uniform (field-mean) flare background; > 0
        spreads the background with a Gaussian of this sigma instead.
    """

    msd_x_nm: float = 0.0
    msd_y_nm: float = 0.0
    flare_tis: float = 0.0
    flare_kernel_nm: float = 0.0

    def __post_init__(self):
        if min(self.msd_x_nm, self.msd_y_nm, self.flare_kernel_nm) < 0:
            raise ValueError("blur sigmas must be >= 0")
        if not (0.0 <= self.flare_tis < 1.0):
            raise ValueError(f"flare_tis must be in [0, 1), got {self.flare_tis}")

    @property
    def active(self) -> bool:
        return (self.msd_x_nm > 0 or self.msd_y_nm > 0
                or self.flare_tis > 0)


def _gauss_transfer(n: int, pixel_size: float, sigma_x: float,
                    sigma_y: float) -> np.ndarray:
    """Host float64 (n, n) Gaussian transfer function on the FFT grid (unit
    DC, so a blur conserves energy)."""
    freqs = np.fft.fftfreq(n, d=pixel_size)
    return np.exp(-2.0 * np.pi ** 2 * (sigma_x ** 2 * freqs[None, :] ** 2
                                       + sigma_y ** 2 * freqs[:, None] ** 2))


def _blur(image: torch.Tensor, transfer: np.ndarray) -> torch.Tensor:
    t = torch.as_tensor(transfer, dtype=torch.complex64, device=image.device)
    return torch.fft.ifft2(torch.fft.fft2(image) * t).real


def apply_perturbation(image, perturb: ImagePerturbation,
                       config_or_pixel) -> torch.Tensor:
    """Stage blur, then flare, on an (n, n) or (B, n, n) float32 intensity
    on its device. Energy is conserved by both steps (unit-DC transfer;
    flare redistributes).

    The uniform-flare background of a (B, n, n) stack is each image's own
    mean. Divergence from the JAX package, on purpose (ROADMAP.md Queue 3,
    R7): there ``jnp.mean`` of the stack averages over the whole batch, so
    one mask's flare level depends on the other masks it was batched with.
    On a single (n, n) image both agree."""
    px = (config_or_pixel.pixel_size
          if isinstance(config_or_pixel, OpticsConfig)
          else float(config_or_pixel))
    if not isinstance(image, torch.Tensor):
        raise TypeError("apply_perturbation takes a tensor (it fixes the device)")
    n = image.shape[-1]
    if perturb.msd_x_nm > 0 or perturb.msd_y_nm > 0:
        image = _blur(image, _gauss_transfer(n, px, perturb.msd_x_nm,
                                             perturb.msd_y_nm))
    if perturb.flare_tis > 0:
        if perturb.flare_kernel_nm > 0:
            background = _blur(image, _gauss_transfer(
                n, px, perturb.flare_kernel_nm, perturb.flare_kernel_nm))
        else:
            background = image.mean(dim=(-2, -1), keepdim=True)
        image = (1.0 - perturb.flare_tis) * image + perturb.flare_tis * background
    return image
