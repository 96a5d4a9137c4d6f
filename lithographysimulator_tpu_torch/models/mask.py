"""Binary mask geometry: container + procedural geometry factories.

Port of ``lithographysimulator_tpu/models/mask.py``. Geometry is a float32
{0, 1} tensor (complex64 for phase-shift masks) on the device the caller
names; the patterns are drawn on the host in numpy, then moved.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import OpticsConfig


@dataclasses.dataclass(frozen=True)
class Mask:
    """A square mask tied to an :class:`OpticsConfig`."""

    geometry: torch.Tensor  # (n, n) float32 in [0, 1], or complex64
    config: OpticsConfig

    def __post_init__(self):
        n = self.config.n
        if tuple(self.geometry.shape) != (n, n):
            raise ValueError(
                f"mask geometry {tuple(self.geometry.shape)} does not match "
                f"config grid {(n, n)}")

    @property
    def pixel_number(self) -> int:
        return self.config.n

    @property
    def pixel_size(self) -> float:
        return self.config.pixel_size


def from_array(geometry, config: OpticsConfig, *, device) -> Mask:
    """Wrap a square array as a Mask on ``device``. Real dtypes become
    float32, complex transmission (phase-shift masks) complex64. A grid size
    other than ``config.n`` re-sizes the config."""
    if isinstance(geometry, torch.Tensor):
        geometry = geometry.detach().cpu().numpy()
    host = np.asarray(geometry)
    dtype = torch.complex64 if np.iscomplexobj(host) else torch.float32
    arr = torch.as_tensor(host, dtype=dtype, device=device)
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValueError(f"mask geometry must be square 2-D, got {tuple(arr.shape)}")
    if arr.shape[0] != config.n:
        config = dataclasses.replace(config, pixel_number=arr.shape[0])
    return Mask(geometry=arr, config=config)


def demo_bars(config: OpticsConfig | None = None, *, device) -> Mask:
    """The reference's demo geometry: on a 64^2 grid, four 4-px-wide
    vertical bars, rows 9:55, columns starting at 16 with pitch 9; other
    grid sizes scale the pattern proportionally."""
    config = config or OpticsConfig()
    n = config.n
    geom = np.zeros((n, n), dtype=np.float32)
    s = n / 64.0
    r0, r1 = round(9 * s), round(55 * s)
    for bar in range(4):
        c0 = round((16 + 9 * bar) * s)
        c1 = round((20 + 9 * bar) * s)
        geom[r0:r1, c0:c1] = 1.0
    return Mask(geometry=torch.as_tensor(geom, device=device), config=config)


def _line_geometry(n, line_width_px, pitch_px, count, margin_px) -> np.ndarray:
    geom = np.zeros((n, n), dtype=np.float32)
    usable = n - 2 * margin_px
    if count is None:
        count = max(1, usable // pitch_px)
    start = margin_px + (usable - ((count - 1) * pitch_px + line_width_px)) // 2
    for i in range(count):
        c0 = start + i * pitch_px
        geom[margin_px : n - margin_px, c0 : c0 + line_width_px] = 1.0
    return geom


def lines_and_spaces(config: OpticsConfig, *, line_width_px: int,
                     pitch_px: int, count: int | None = None,
                     vertical: bool = True, margin_px: int = 0,
                     device) -> Mask:
    """General 1-D line/space grating."""
    geom = _line_geometry(config.n, line_width_px, pitch_px, count, margin_px)
    if not vertical:
        geom = np.ascontiguousarray(geom.T)
    return Mask(geometry=torch.as_tensor(geom, device=device), config=config)


def contact_holes(config: OpticsConfig, *, hole_px: int, pitch_px: int,
                  count: int | None = None, device) -> Mask:
    """2-D array of square contact holes."""
    n = config.n
    geom = np.zeros((n, n), dtype=np.float32)
    if count is None:
        count = max(1, n // pitch_px)
    start = (n - ((count - 1) * pitch_px + hole_px)) // 2
    for i in range(count):
        for j in range(count):
            r0 = start + i * pitch_px
            c0 = start + j * pitch_px
            geom[r0 : r0 + hole_px, c0 : c0 + hole_px] = 1.0
    return Mask(geometry=torch.as_tensor(geom, device=device), config=config)


def attenuated_psm(binary_mask: Mask, *, transmission: float = 0.06,
                   phase: float = np.pi) -> Mask:
    """Attenuated phase-shift mask: clear features transmit 1, the opaque
    background transmits sqrt(transmission) * exp(i*phase); complex64
    geometry on the binary mask's device."""
    bg = np.sqrt(transmission) * np.exp(1j * phase)
    geom = binary_mask.geometry.real.to(torch.float32)
    re = geom + (1.0 - geom) * float(bg.real)
    im = (1.0 - geom) * float(bg.imag)
    return dataclasses.replace(binary_mask, geometry=torch.complex(re, im))


def alternating_psm(config: OpticsConfig, *, line_width_px: int,
                    pitch_px: int, count: int | None = None,
                    margin_px: int = 0, device) -> Mask:
    """Alternating (Levenson) phase-shift mask: adjacent clear lines of a
    line/space grating alternate 0 / 180 degree phase (+1 / -1)."""
    geom = _line_geometry(config.n, line_width_px, pitch_px, count, margin_px)
    signed = np.zeros_like(geom)
    cols = np.nonzero(geom.any(axis=0))[0]
    if len(cols):
        breaks = np.nonzero(np.diff(cols) > 1)[0]
        starts = np.concatenate([[0], breaks + 1])
        ends = np.concatenate([breaks, [len(cols) - 1]])
        for k, (s0, e0) in enumerate(zip(starts, ends)):
            sign = 1.0 if k % 2 == 0 else -1.0
            sel = cols[s0 : e0 + 1]
            signed[:, sel] = sign * geom[:, sel]
    return Mask(geometry=torch.as_tensor(signed, device=device), config=config)
