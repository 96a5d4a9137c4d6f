"""Through-focus (focal stack) and chromatic focus-plane imaging.

Port of ``lithographysimulator_tpu/ops/focus.py``. The defocus axis is the
Zernike defocus entry (OSA 4, nm) of the aberration vector; the JAX
package's ``vmap`` over planes (and ``lax.map`` on the SOCS path) is a loop
over planes here, one plane's imaging state live at a time. Aberration
stacks are host float32 arrays, like every aberration vector the port's
entry points take.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import OpticsConfig
from ..models.pupil import pupil_function
from .abbe import Solver, abbe_image_points
from .zernike import DEFOCUS_OSA_INDEX


def _host_vector(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    base = np.asarray(x, np.float32).reshape(-1)
    if base.shape[0] < DEFOCUS_OSA_INDEX + 1:
        base = np.pad(base, (0, DEFOCUS_OSA_INDEX + 1 - base.shape[0]))
    return base


def focus_stack_aberrations(base_aberrations, defocus_nm_values) -> np.ndarray:
    """(F, A) float32 coefficient stack: ``base_aberrations`` with entry 4
    (defocus, nm) replaced by each value of ``defocus_nm_values``."""
    base = _host_vector(base_aberrations)
    defocus = np.asarray(defocus_nm_values, np.float32).reshape(-1)
    stack = np.repeat(base[None], defocus.shape[0], axis=0)
    stack[:, DEFOCUS_OSA_INDEX] = defocus
    return stack


def chromatic_aberrations(base_aberrations, spectrum) -> tuple:
    """((C, A) float32 aberration stack, (C,) float32 weights) for a finite
    laser bandwidth: each spectral sample of a
    :class:`..config.LaserSpectrum` lands at its chromatic defocus offset
    ADDED to the base entry-4 defocus (both nm; the nm -> waves map is
    linear). The polychromatic image is the weighted sum of the planes'."""
    base = _host_vector(base_aberrations)
    offsets = np.asarray(spectrum.defocus_offsets_nm(), np.float32)
    stack = np.repeat(base[None], offsets.shape[0], axis=0)
    stack[:, DEFOCUS_OSA_INDEX] += offsets
    return stack, np.asarray(spectrum.weights(), np.float32)


def through_focus_images(
    spectrum,
    aberrations_stack,
    shifts,
    weights,
    config: OpticsConfig,
    *,
    device,
    solver: Solver = "gau23",
    chunk: int = 4,
    normalize: bool = False,
    max_abs_shift: int | None = None,
    engine: str = "auto",
) -> torch.Tensor:
    """(F, n, n) focal stack on ``device`` for an (F, A) aberration stack
    over one shared mask spectrum and padded source-point list."""
    stack = np.asarray(aberrations_stack, np.float32)
    out = torch.empty((stack.shape[0], config.n, config.n), dtype=torch.float32,
                      device=device)
    for f, ab in enumerate(stack):
        pupil = pupil_function(ab, config, device=device)
        out[f] = abbe_image_points(
            spectrum, pupil, shifts, weights, config, device=device,
            solver=solver, chunk=chunk, normalize=normalize, engine=engine,
            max_abs_shift=max_abs_shift)
    return out


@functools.lru_cache(maxsize=8)
def compiled_focus_stack(config: OpticsConfig, chunk: int = 4,
                         normalize: bool = False, solver: Solver = "gau23",
                         max_abs_shift: int | None = None, mask3d=None):
    """Cached (geometry, aberration stack, shifts, weights) -> (F, n, n)
    focal-stack callable, spectrum included, on the geometry's device: the
    JAX package's jitted pipeline as a plain function with the same
    arguments (the ``focus`` CLI's entry, ROADMAP.md Queue 1 item 3);
    ``mask3d`` turns the geometry into its thick-mask transmission first."""
    from .fraunhofer import mask_spectrum

    def run(geometry, aberrations_stack, shifts, weights):
        if mask3d is not None:
            geometry = mask3d.apply(geometry, config)
        spectrum = mask_spectrum(geometry, config, solver=solver)
        return through_focus_images(
            spectrum, aberrations_stack, shifts, weights, config,
            device=spectrum.device, solver=solver, chunk=chunk,
            normalize=normalize, max_abs_shift=max_abs_shift)

    return run


def through_focus_socs(
    spectrum: torch.Tensor,
    base_aberrations,
    defocus_nm_values,
    source_map,
    config: OpticsConfig,
    *,
    rank: int = 96,
    chunk: int = 4,
    engine: str = "auto",
) -> torch.Tensor:
    """(F, n, n) focal stack on the Hopkins fast path, on the spectrum's
    device: one SOCS build per defocus plane (the TCC depends on the
    pupil), one plane's kernel set live at a time."""
    from .hopkins import randomized_socs, socs_image

    device = spectrum.device
    stack = focus_stack_aberrations(base_aberrations, defocus_nm_values)
    out = torch.empty((stack.shape[0], config.n, config.n), dtype=torch.float32,
                      device=device)
    for f, ab in enumerate(stack):
        pupil = pupil_function(ab, config, device=device)
        socs = randomized_socs(pupil, source_map, config, rank=rank)
        out[f] = socs_image(spectrum, socs, config, chunk=chunk, engine=engine)
        del socs
    return out
