"""The comparison that decides ``correct`` for the SOCS imaging cells.

``image_nrms``: the worst, over a sample of the window's images, of the
normalized RMS between the program's image and the plain image of the same
mask: the float64 spectrum (:mod:`.reference.optics`) through the float64
rank-``r`` kernel set of the configuration's TCC (:mod:`.reference.socs`),
formed again from the configuration's pupil and source and converged far
past a production build. Crops of a tiled chip are compared with the crop
of their tile window's image. Nothing the program made enters the
reference: the kernel set, the spectrum and the apply are each worked out
again, so the number covers the program's build, spectrum and apply
together.

``broadband_nrms``: the worst, over the same images, of the RMS of the
same difference at spatial frequencies that no image of the optics holds
(Hann-windowed, above 1.05 times the band edge ``2 (1 + sigma_out) NA /
lambda``, the reach of two fields of kernels that span the shifted
pupils), over the reference's peak. A sound image has nothing there
whatever its kernel set, so a build's error (which ``image_nrms`` bounds)
stays out of it, and the noise of the apply's arithmetic reads there on
its own.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import optics as ro
from .reference import socs as rs


def reference_kernels(cfg: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain rank-``socs_rank`` kernel set of the configuration."""
    return rs.kernel_set(ro.pupil(cfg, device=device), ro.quasar_source(cfg),
                         cfg["socs_rank"],
                         oversample=cfg["reference"]["oversample"],
                         iterations=cfg["reference"]["iterations"])


def band_edge(cfg: dict) -> float:
    """The highest spatial frequency (1/nm) in any image of the optics."""
    ill = cfg["illumination"]
    return 2.0 * (1.0 + ill["sigma_out"]) * cfg["na"] / cfg["wavelength_nm"]


def broadband(cfg: dict, image: torch.Tensor, ref: torch.Tensor) -> float:
    """RMS of ``image - ref`` above 1.05 band edges, over ``ref``'s peak."""
    d = image.to(ro.F64) - ref.to(ro.F64)
    h, w = d.shape
    win = (torch.hann_window(h, periodic=False, dtype=ro.F64, device=d.device)[:, None]
           * torch.hann_window(w, periodic=False, dtype=ro.F64, device=d.device)[None, :])
    power = torch.fft.fft2(d * win).abs() ** 2
    fy = torch.fft.fftfreq(h, d=cfg["pixel_nm"], dtype=ro.F64, device=d.device)
    fx = torch.fft.fftfreq(w, d=cfg["pixel_nm"], dtype=ro.F64, device=d.device)
    outside = torch.hypot(fy[:, None], fx[None, :]) > 1.05 * band_edge(cfg)
    rms = torch.sqrt(power[outside].sum() / (h * w) / (win * win).sum())
    return float(rms / ref.to(ro.F64).abs().max())


def worst_errors(cfg: dict, pairs, kernels: torch.Tensor,
                 eigenvalues: torch.Tensor) -> tuple[float, float]:
    """(worst ``image_nrms``, worst ``broadband_nrms``) over ``pairs`` of
    (window geometry (n, n), the program's image of it or of its crop,
    crop box (y0, y1, x0, x1) or None) against the float64 apply of
    ``kernels`` to the window's float64 spectrum."""
    worst, worst_band = 0.0, 0.0
    for geometry, image, box in pairs:
        ref = ro.socs_image(ro.spectrum(geometry, cfg), kernels,
                            eigenvalues, cfg)
        if box is not None:
            y0, y1, x0, x1 = box
            ref = ref[y0:y1, x0:x1]
        image = image.to(ref.device)
        worst = max(worst, ro.nrms(image, ref))
        worst_band = max(worst_band, broadband(cfg, image, ref))
    return worst, worst_band


def socs_checks(cfg: dict, pairs) -> list:
    """The numbers of a SOCS cell, each beside its limit (a window that
    produced nothing to compare fails)."""
    if not pairs:
        return [("images_compared", 0.0, -1.0)]
    kernels, values = reference_kernels(cfg, pairs[0][0].device)
    worst, worst_band = worst_errors(cfg, pairs, kernels, values)
    limits = cfg["limits"]
    return [("image_nrms", worst, limits["image_nrms"]),
            ("broadband_nrms", worst_band, limits["broadband_nrms"])]


def sample(rng: np.random.Generator, population: int, k: int) -> list[int]:
    """``k`` distinct indices of ``range(population)``, in order."""
    return sorted(rng.choice(population, size=min(k, population),
                             replace=False).tolist())
