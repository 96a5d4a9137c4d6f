"""Source-sharded image in the resist: the film stack over a mesh.

Port of ``lithographysimulator_tpu/parallel/film_sharded.py``. The exact
in-film exposure (:func:`..simulate.film_stack_images`) is an Abbe sum a
resist slab and field component, so the source-point split of
:mod:`.abbe_sharded` applies unchanged: every mesh entry runs its shard of
the padded point list through each (slab, component) of the
film-modified pupils, and the (nz, n, n) partial stacks meet in one sum on
the mesh's first device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._tensors import to_tensor
from ..config import OpticsConfig
from ..models.pupil import pupil_function
from ..ops.abbe import postprocess_gau23
from ..ops.fraunhofer import mask_spectrum
from .abbe_sharded import (_check_points, _max_shift, _source_partials,
                           host_shifts, meet, normalized,
                           padded_source_arrays)
from .mesh import SOURCE_AXIS, Mesh


def film_images_sharded(
    geometry,
    aberrations,
    shifts,
    weights,
    mult_re,
    mult_im,
    config: OpticsConfig,
    mesh: Mesh,
    *,
    solver: str = "gau23",
    chunk: int = 4,
    normalize: bool = True,
    max_abs_shift: int | None = None,
    engine: str = "auto",
    mask3d=None,
) -> torch.Tensor:
    """(nz, n, n) in-film exposure on the mesh's first device, source
    points sharded over ``mesh``'s 'source' axis. ``mult_re``/``mult_im``
    are the (nz, C, n, n) real and imaginary planes of
    :func:`..ops.filmstack.film_component_multipliers`;
    ``shifts``/``weights`` length must divide ``mesh.shape['source'] *
    chunk`` (:func:`.abbe_sharded.padded_source_arrays`). Host geometry
    and aberrations go to the first device."""
    first = mesh.first
    devices = mesh.axis_devices(SOURCE_AXIS)
    shifts = host_shifts(shifts)
    _check_points(len(shifts), len(devices), chunk)
    max_abs_shift = _max_shift(shifts, max_abs_shift)
    geometry = to_tensor(geometry, device=first)
    if mask3d is not None:
        geometry = mask3d.apply(geometry, config)
    spectrum = mask_spectrum(geometry, config, solver=solver)
    pupil = pupil_function(aberrations, config, device=first)
    weights = to_tensor(weights, device=first, dtype=torch.float32)
    mult = torch.complex(to_tensor(mult_re, device=first, dtype=torch.float32),
                         to_tensor(mult_im, device=first, dtype=torch.float32))
    slabs = []
    for mult_z in mult:
        total = None
        for mult_c in mult_z:
            part = meet(_source_partials(
                lambda dev: (pupil * mult_c).to(dev), spectrum, shifts,
                weights, config, devices, solver=solver, chunk=chunk,
                max_abs_shift=max_abs_shift, engine=engine), first)
            total = part if total is None else total + part
        if solver == "gau23":
            total = postprocess_gau23(total, config)
        slabs.append(total)
    stack = torch.stack(slabs)
    return normalized(stack, weights) if normalize else stack


def film_stack_sharded(
    mask,
    source_map,
    aberrations=None,
    *,
    config: OpticsConfig | None = None,
    wafer_stack,
    mesh: Mesh,
    depths_nm=None,
    resist=None,
    polarization=None,
    apodize: bool = True,
    solver: str = "gau23",
    chunk: int = 4,
    normalize: bool = True,
    engine: str = "auto",
    mask3d=None,
    block: bool = True,
) -> torch.Tensor:
    """Sharded :func:`..simulate.film_stack_images`: the same arguments
    with ``mesh`` in place of ``device``, the same (nz, n, n) result on the
    mesh's first device; the two agree to float32 summation order.
    ``block`` does nothing (the first device is synchronized before this
    returns)."""
    from ..ops.filmstack import film_component_multipliers
    from ..simulate import _film_depths, _host_inputs, _mask_geometry, \
        _polarization_key

    if config is None:
        config = mask.config
    depths = _film_depths(depths_nm, resist)
    src_np, aberrations = _host_inputs(source_map, aberrations)
    polarization = _polarization_key(polarization)
    shifts, weights, _ = padded_source_arrays(
        src_np, mesh.shape[SOURCE_AXIS] * chunk)
    mult = film_component_multipliers(config, wafer_stack, depths,
                                      polarization=polarization,
                                      apodize=apodize)
    stack = film_images_sharded(
        _mask_geometry(mask, mesh.first), aberrations, shifts, weights,
        mult.real.astype(np.float32), mult.imag.astype(np.float32), config,
        mesh, solver=solver, chunk=chunk, normalize=normalize, engine=engine,
        mask3d=mask3d)
    if mesh.first.type == "cuda":
        torch.cuda.synchronize(mesh.first)
    return stack
