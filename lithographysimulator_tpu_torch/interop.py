"""Carry the JAX package's imaging state over to the port.

This system has no weights: an optics config, a mask, a source map and an
aberration vector are its parameters (with, for vector, chromatic and
perturbed imaging, a laser spectrum and an image perturbation; for thick
masks an M3D model, for in-film imaging a wafer stack, and for the resist
a resist or stochastic model, for mask rule checks a rule set, for
optimization an SMO problem), and a SOCS kernel set is the state a build
leaves. Source maps and aberration vectors
cross as numpy arrays (``np.asarray(x)`` of either package's value), which
every port entry point takes; the config, the mask, the spectrum, the
perturbation, an M3D model, a wafer stack, the models, the mask rules, an
SMO problem and a kernel set need the helpers here. Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from .config import LaserSpectrum, OpticsConfig
from .models.mask import Mask, from_array
from .models.mrc import MaskRules
from .models.resist import DepthResist, MackResist, ResistModel
from .models.stochastic import StochasticResist
from .ops.filmstack import WaferStack
from .ops.hopkins import SOCSKernels
from .ops.mask3d import BoundaryLayer, EdgeKernelM3D
from .ops.perturb import ImagePerturbation
from .optimize import SMOProblem


def _same_fields(cls, obj):
    """``cls`` with each field ``obj`` has; a field of the port's that
    ``obj`` lacks (``OpticsConfig.pupil_at_na``) keeps its default."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
                  if hasattr(obj, f.name)})


def config_from_jax(cfg) -> OpticsConfig:
    """Port :class:`OpticsConfig` with the same field values as ``cfg`` (a
    ``lithographysimulator_tpu.OpticsConfig`` or any object with them)."""
    return _same_fields(OpticsConfig, cfg)


def spectrum_from_jax(spectrum) -> LaserSpectrum:
    """Port :class:`LaserSpectrum` with the same fields as ``spectrum`` (a
    ``lithographysimulator_tpu.LaserSpectrum`` or any object with them)."""
    return _same_fields(LaserSpectrum, spectrum)


def perturbation_from_jax(perturb) -> ImagePerturbation:
    """Port :class:`..ops.perturb.ImagePerturbation` with the same fields as
    ``perturb`` (the JAX package's, or any object with them)."""
    return _same_fields(ImagePerturbation, perturb)


def mask3d_from_jax(model) -> BoundaryLayer | EdgeKernelM3D:
    """Port M3D model with the same fields as ``model``: an
    :class:`..ops.mask3d.EdgeKernelM3D` when it carries tap vectors, else a
    :class:`..ops.mask3d.BoundaryLayer` (the JAX package's classes, or any
    object with their fields)."""
    cls = EdgeKernelM3D if hasattr(model, "taps_v_rise") else BoundaryLayer
    return _same_fields(cls, model)


def wafer_stack_from_jax(stack) -> WaferStack:
    """Port :class:`..ops.filmstack.WaferStack` with the same fields as
    ``stack`` (the JAX package's, or any object with them)."""
    return _same_fields(WaferStack, stack)


def resist_from_jax(model) -> ResistModel | MackResist | DepthResist:
    """Port resist model with the same fields as ``model``: a
    :class:`..models.resist.DepthResist` (its nested ``mack`` carried over)
    when it has one, a :class:`..models.resist.MackResist` when it carries
    Dill/Mack fields, else a :class:`..models.resist.ResistModel` (the JAX
    package's classes, or any object with their fields)."""
    if hasattr(model, "mack"):
        fields = {f.name: getattr(model, f.name)
                  for f in dataclasses.fields(DepthResist)}
        fields["mack"] = _same_fields(MackResist, model.mack)
        return DepthResist(**fields)
    if hasattr(model, "dill_c"):
        return _same_fields(MackResist, model)
    return _same_fields(ResistModel, model)


def stochastic_from_jax(model) -> StochasticResist:
    """Port :class:`..models.stochastic.StochasticResist` with the same
    fields as ``model`` (the JAX package's, or any object with them)."""
    return _same_fields(StochasticResist, model)


def mask_rules_from_jax(rules) -> MaskRules:
    """Port :class:`..models.mrc.MaskRules` with the same fields as
    ``rules`` (the JAX package's, or any object with them)."""
    return _same_fields(MaskRules, rules)


def smo_problem_from_jax(problem) -> SMOProblem:
    """Port :class:`..optimize.SMOProblem` with the same fields as
    ``problem`` (the JAX package's, or any object with them): its config
    through :func:`config_from_jax` and its thick-mask model, if any,
    through :func:`mask3d_from_jax`."""
    fields = {f.name: getattr(problem, f.name)
              for f in dataclasses.fields(SMOProblem)}
    fields["config"] = config_from_jax(problem.config)
    if problem.mask3d is not None:
        fields["mask3d"] = mask3d_from_jax(problem.mask3d)
    return SMOProblem(**fields)


def mask_from_numpy(geometry, config, *, device) -> Mask:
    """A port :class:`Mask` on ``device`` from a host geometry array (e.g.
    ``np.asarray(jax_mask.geometry)``) and a config of either package."""
    return from_array(np.asarray(geometry), config_from_jax(config),
                      device=device)


def socs_from_numpy(kernels, eigenvalues, total_rank: int = -1, *,
                    device) -> SOCSKernels:
    """A port :class:`SOCSKernels` on ``device`` from host arrays, e.g. a
    JAX ``SOCSKernels`` read back as ``np.asarray(socs.kernels)``,
    ``np.asarray(socs.eigenvalues)`` and ``socs.total_rank``."""
    return SOCSKernels(
        kernels=torch.as_tensor(np.array(kernels, np.complex64), device=device),
        eigenvalues=torch.as_tensor(np.array(eigenvalues, np.float32),
                                    device=device),
        total_rank=int(total_rank))
