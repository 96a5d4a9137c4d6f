"""The program's side of a cell: its objects, formed from a configuration
through the port's public API, as a user of the port would form them."""

from __future__ import annotations

import numpy as np


def lt():
    import lithographysimulator_tpu_torch

    return lithographysimulator_tpu_torch


def optics(cfg: dict, pixel_number: int | None = None):
    return lt().OpticsConfig(pixel_number=pixel_number or cfg["pixel_number"],
                             pixel_size=cfg["pixel_nm"],
                             wavelength=cfg["wavelength_nm"], na=cfg["na"])


def source_map(cfg: dict) -> np.ndarray:
    ill = cfg["illumination"]
    if ill["kind"] != "quasar":
        raise ValueError(f"no illumination {ill['kind']!r}")
    return lt().LightSource(optics(cfg), sigma_in=ill["sigma_in"],
                            sigma_out=ill["sigma_out"]).quasar(
        ill["poles"], ill["rotation_rad"])


def aberrations(cfg: dict) -> np.ndarray:
    return np.asarray(cfg["aberrations_osa"], np.float32)


def kernel_set(cfg: dict, device: str, rank: int | None = None):
    """The rank-``rank`` kernel set that ``simulate(solver='socs',
    socs_rank=rank)`` builds for the configuration's optics: the port's
    public ``randomized_socs`` of its pupil, with simulate's arguments."""
    rank = cfg["socs_rank"] if rank is None else rank
    m = lt()
    return m.randomized_socs(m.pupil_function(aberrations(cfg), optics(cfg),
                                              device=device),
                             source_map(cfg), optics(cfg), rank=rank)
