"""Trial-sharded stochastic ensembles: Monte-Carlo exposures over a mesh.

Port of ``lithographysimulator_tpu/parallel/stochastic_sharded.py``.
Stochastic printing statistics are parallel over trials: entry d of the
mesh's 'source' axis runs trials ``d * trials_per_device`` up to
``(d + 1) * trials_per_device`` through the photon/acid chain of
:mod:`..models.stochastic` against its copy of the image, and the
print-count accumulators meet in one sum on the mesh's first device.

Trial ``i`` draws from its own generator, seeded from ``(seed, i)``
(:func:`..models.stochastic.trial_generator`), on whichever entry runs
it. So the sharded band equals the single-device band of the same
``devices x trials_per_device`` trials bit for bit: the counts are
integers below 2^24, exact in float32 in any order, and the band is
their float32 quotient by the trial count, as the ensembles' is. Against the JAX
package (``jax.random`` keys) the bands agree in distribution only.
"""

from __future__ import annotations

import torch

from ..config import OpticsConfig
from ..models.resist import _f32
from ..models.stochastic import StochasticResist, _trial_field
from .abbe_sharded import meet
from .mesh import SOURCE_AXIS, Mesh


def _band(image, config, model, mesh: Mesh, trials_per_device: int,
          seed: int, dz_nm) -> torch.Tensor:
    devices = mesh.axis_devices(SOURCE_AXIS)
    image = _f32(image, mesh.first)
    counts = []
    for d, dev in enumerate(devices):
        local = image.to(dev)
        count = torch.zeros(local.shape, dtype=torch.float32, device=dev)
        for t in range(d * trials_per_device, (d + 1) * trials_per_device):
            field = _trial_field(model, local, config, seed, t, dz_nm)
            count += (field > model.threshold).to(torch.float32)
        counts.append(count)
    band = meet(counts, mesh.first)
    # a true division (on CUDA torch multiplies by the rounded reciprocal of
    # a Python number), as the single-device ensembles' numpy band / trials
    return band / torch.full_like(band, len(devices) * trials_per_device)


def print_probability_sharded(
    image,
    config: OpticsConfig,
    model: StochasticResist,
    mesh: Mesh,
    *,
    trials_per_device: int,
    seed: int = 0,
) -> torch.Tensor:
    """(n, n) print-probability band on the mesh's first device from
    ``devices x trials_per_device`` stochastic exposures, trials sharded
    over ``mesh``'s 'source' axis. A host image goes to the first
    device; each entry gets a copy."""
    return _band(image, config, model, mesh, trials_per_device, seed, None)


def print_probability_volume_sharded(
    image_stack,
    config: OpticsConfig,
    model: StochasticResist,
    mesh: Mesh,
    *,
    dz_nm: float,
    trials_per_device: int,
    seed: int = 0,
) -> torch.Tensor:
    """(nz, n, n) volumetric print-probability band of the rigorous
    in-film stack (:meth:`..models.stochastic.StochasticResist.deprotection_volume`
    a trial), trial-sharded as :func:`print_probability_sharded`; equal
    bit for bit to the ``print_probability`` of
    :func:`..models.stochastic.stochastic_volume_ensemble` over the same
    trials and seed."""
    return _band(image_stack, config, model, mesh, trials_per_device, seed,
                 float(dz_nm))
