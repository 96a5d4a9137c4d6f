"""Plain PyTorch reference of the scalar SOCS image of an EUV scanner, in
float64: the pupil's edge at NA / lambda, a pixelated dipole, and the
scanner's stage blur and flare on the image.

* The grid: with ``pupil_at_na`` the sigma plane is in NA units, so the
  Gau'23 scaling of :mod:`.optics` runs on the configuration with
  ``lambda' = lambda / NA`` (:func:`.vector.grid_config`).
* The kernel set: :func:`.socs.kernel_set` of the pupil (:func:`.optics.pupil`)
  and the dipole (:func:`.vector.dipole_source`), converged far past a
  production build.
* A field: the centered ``N``-point inverse transform of the kernel times
  the spectrum, evaluated at the ``n`` image points, is ``T X T^T`` with
  ``T[a, q] = exp(2 pi i (a - n/2)(q - n/2) / N)`` (:func:`.vector._transform_rows`),
  which equals :func:`.optics.fields` without an ``N x N`` array (``N`` is
  8,192 for a 1024^2 clip at 1 nm); the image is downsampled and padded
  back as :func:`.optics.finish` does.
* Stage blur (moving standard deviations ``msd_x_nm``, ``msd_y_nm``): the
  periodic Gaussian of transfer ``exp(-2 pi^2 (s_x^2 f_x^2 + s_y^2 f_y^2))``
  on the image's grid; then uniform flare, ``(1 - TIS) I + TIS mean(I)``.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

from . import optics as ro
from . import socs as rs
from . import vector as rv

F64, C128 = ro.F64, ro.C128


def kernel_set(cfg: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(kernels, eigenvalues) of the configuration's rank-``socs_rank``
    TCC, in float64."""
    ref = cfg["reference"]
    return rs.kernel_set(ro.pupil(cfg, device=device), rv.dipole_source(cfg),
                         cfg["socs_rank"], oversample=ref["oversample"],
                         iterations=ref["iterations"])


def socs_image(geometry: torch.Tensor, kernels: torch.Tensor,
               eigenvalues: torch.Tensor, cfg: dict, *, block: int = 8,
               dtype=C128) -> torch.Tensor:
    """``sum_j lambda_j |T (phi_j M) T^T|^2``, downsampled to the wafer
    grid: the image before the scanner's blur and flare."""
    grid = rv.grid_config(cfg)
    spec = ro.spectrum(geometry, grid, dtype)
    t = rv._transform_rows(cfg, geometry.device, dtype)
    real = spec.real.dtype
    lam = eigenvalues.to(device=spec.device, dtype=real)
    acc = torch.zeros(spec.shape, dtype=real, device=spec.device)
    for c in range(0, kernels.shape[0], block):
        e = t @ (kernels[c:c + block].to(dtype) * spec) @ t.T
        acc += torch.einsum("b,bij->ij", lam[c:c + block],
                            e.real ** 2 + e.imag ** 2)
    return ro.finish(acc, grid)


def perturbed(image: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The configuration's stage blur, then its uniform flare."""
    p = cfg["perturbation"]
    if p.get("flare_kernel_nm", 0.0) > 0:
        raise ValueError("the reference's flare is uniform (flare_kernel_nm 0)")
    h, w = image.shape[-2:]
    px = cfg["pixel_nm"]
    if p["msd_x_nm"] > 0 or p["msd_y_nm"] > 0:
        fy = torch.fft.fftfreq(h, d=px, dtype=F64, device=image.device)
        fx = torch.fft.fftfreq(w, d=px, dtype=F64, device=image.device)
        transfer = torch.exp(-2.0 * math.pi ** 2
                             * (p["msd_x_nm"] ** 2 * fx[None, :] ** 2
                                + p["msd_y_nm"] ** 2 * fy[:, None] ** 2))
        image = torch.fft.ifft2(torch.fft.fft2(image) * transfer).real
    tis = p["flare_tis"]
    if tis > 0:
        image = (1.0 - tis) * image + tis * image.mean()
    return image


def image(geometry: torch.Tensor, kernels: torch.Tensor,
          eigenvalues: torch.Tensor, cfg: dict, **kw) -> torch.Tensor:
    """The scanner's image of ``geometry``: the SOCS image, blurred and
    flared."""
    return perturbed(socs_image(geometry, kernels, eigenvalues, cfg, **kw), cfg)
