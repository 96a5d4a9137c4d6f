"""Artifact persistence: aerial images, run reports and SOCS kernel sets.

Port of ``lithographysimulator_tpu/utils/artifacts.py`` with the same
``.npz`` layout (``kernels`` complex64, ``eigenvalues`` float32,
``total_rank``), so a kernel set saved by either package loads into the
other. Loading takes an explicit ``device``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from ..config import OpticsConfig
from ..ops.hopkins import SOCSKernels, _host


def config_fingerprint(config: OpticsConfig, **extra) -> str:
    """Stable short hash of an optical configuration (plus extra keys such
    as source or pupil descriptors) for cache file names; the same string
    as the JAX package's for the same fields. ``pupil_at_na``, which the
    JAX package lacks, enters only when set."""
    fields = dataclasses.asdict(config)
    if not fields["pupil_at_na"]:
        del fields["pupil_at_na"]
    payload = {"config": fields, **extra}
    blob = json.dumps(payload, sort_keys=True, default=repr).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save_image(path, image, report: dict | None = None) -> Path:
    """Save an aerial image (.npy) with an optional sidecar .json report."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, _host(image))
    if report is not None:
        Path(str(path.with_suffix("")) + ".report.json").write_text(
            json.dumps(report, indent=2, default=repr))
    return path


def load_image(path) -> np.ndarray:
    return np.load(Path(path))


def save_socs(path, socs: SOCSKernels) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path,
        kernels=_host(socs.kernels).astype(np.complex64),
        eigenvalues=_host(socs.eigenvalues).astype(np.float32),
        total_rank=np.asarray(socs.total_rank),
    )
    return path if path.suffix == ".npz" else path.with_suffix(path.suffix + ".npz")


def load_socs(path, *, device) -> SOCSKernels:
    with np.load(Path(path)) as data:
        return SOCSKernels(
            kernels=torch.as_tensor(data["kernels"], dtype=torch.complex64,
                                    device=device),
            eigenvalues=torch.as_tensor(data["eigenvalues"], dtype=torch.float32,
                                        device=device),
            total_rank=int(data["total_rank"]),
        )


class SOCSCache:
    """Disk cache of SOCS kernel sets keyed by optics+source fingerprints;
    kernel sets load onto ``device``."""

    def __init__(self, directory, *, device):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.device = device

    def path_for(self, fingerprint: str) -> Path:
        return self.directory / f"socs_{fingerprint}.npz"

    def get(self, fingerprint: str) -> SOCSKernels | None:
        path = self.path_for(fingerprint)
        return load_socs(path, device=self.device) if path.exists() else None

    def put(self, fingerprint: str, socs: SOCSKernels) -> Path:
        return save_socs(self.path_for(fingerprint), socs)
