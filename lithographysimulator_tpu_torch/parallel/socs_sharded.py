"""Rank-sharded SOCS imaging: the eigenkernels split over a mesh.

Port of ``lithographysimulator_tpu/parallel/socs_sharded.py``. The SOCS sum
``I = sum_j lambda_j |F(phi_j M)|^2`` is parallel over the kernel index j:
each mesh entry images its shard of the kernel stack against the mask
spectrum with :func:`..ops.hopkins.socs_image` (on CUDA the int8 kernels),
and the partial images meet in one (n, n) float32 sum on the mesh's first
device. The Gau'23 post-process is linear, so post-processing each shard
and summing equals post-processing the total.
"""

from __future__ import annotations

import torch

from ..config import OpticsConfig
from ..ops.hopkins import SOCSKernels, socs_image
from .abbe_sharded import meet, shard_bounds
from .mesh import SOURCE_AXIS, Mesh


def pad_socs_rank(socs: SOCSKernels, multiple: int) -> SOCSKernels:
    """Zero-pad the kernel stack so the rank divides ``multiple`` (zero
    kernels with zero eigenvalues add exactly nothing to the image)."""
    pad = (-socs.rank) % multiple
    if pad == 0:
        return socs
    k, lam = socs.kernels, socs.eigenvalues
    return SOCSKernels(
        kernels=torch.cat([k, k.new_zeros((pad, *k.shape[1:]))]),
        eigenvalues=torch.cat([lam, lam.new_zeros(pad)]),
        total_rank=socs.total_rank)


def socs_image_sharded(
    spectrum,
    socs: SOCSKernels,
    config: OpticsConfig,
    mesh: Mesh,
    *,
    solver: str = "gau23",
    chunk: int = 4,
    engine: str = "auto",
) -> torch.Tensor:
    """(n, n) aerial image on the mesh's first device with the kernel
    stack sharded over ``mesh``'s 'source' axis: each entry images its
    ``rank / devices`` kernels (zero-padded so the rank divides
    ``devices * chunk``, :func:`pad_socs_rank`) and the partial images
    are summed."""
    devices = mesh.axis_devices(SOURCE_AXIS)
    socs = pad_socs_rank(socs, len(devices) * chunk)
    if not isinstance(spectrum, torch.Tensor):
        spectrum = torch.as_tensor(spectrum, device=socs.kernels.device)
    partials = []
    for dev, (lo, hi) in zip(devices, shard_bounds(socs.rank, len(devices))):
        shard = SOCSKernels(kernels=socs.kernels[lo:hi].to(dev),
                            eigenvalues=socs.eigenvalues[lo:hi].to(dev),
                            total_rank=socs.total_rank)
        partials.append(socs_image(spectrum.to(dev), shard, config,
                                   solver=solver, chunk=chunk, engine=engine))
    return meet(partials, mesh.first)
