"""Carry the JAX package's imaging state over to the port.

This system has no weights: an optics config, a mask, a source map and an
aberration vector are its parameters. Source maps and aberration vectors
cross as numpy arrays (``np.asarray(x)`` of either package's value), which
every port entry point takes; the config and the mask need the two helpers
here. Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import OpticsConfig
from .models.mask import Mask, from_array


def config_from_jax(cfg) -> OpticsConfig:
    """Port :class:`OpticsConfig` with the same field values as ``cfg`` (a
    ``lithographysimulator_tpu.OpticsConfig`` or any object with them)."""
    return OpticsConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(OpticsConfig)})


def mask_from_numpy(geometry, config, *, device) -> Mask:
    """A port :class:`Mask` on ``device`` from a host geometry array (e.g.
    ``np.asarray(jax_mask.geometry)``) and a config of either package."""
    return from_array(np.asarray(geometry), config_from_jax(config),
                      device=device)

