"""Seeded line/space layouts, rasterized on the device.

A layout is one grating of lines along y across the whole clip: a pitch
drawn from ``spec["pitches_nm"]``, lines of ``spec["cd_of_pitch"]`` times
the pitch (half of it for equal lines and spaces), and a phase drawn
uniformly over the pitch. Only whole lines are drawn: where the clip's
left or right edge would cut a line, that line is left out, so every line
of the clip has its full width. The numbers are drawn on the host with numpy from
``(seed, stream)``, three a layout, and the pixels are formed on the device
in integer arithmetic, so the same seed gives the same layouts on every
device. Pitches and line widths are whole pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from .masks import rng_for


def whole_px(nm: float, pixel_nm: float) -> int:
    px = nm / pixel_nm
    if abs(px - round(px)) > 1e-9:
        raise ValueError(f"{nm} nm is not a whole number of {pixel_nm} nm pixels")
    return int(round(px))


def grating(side_px: int, pitch_px: int, cd_px: int, phase_px: int, *,
            device) -> torch.Tensor:
    """(side_px, side_px) float32 0/1 lines along y: column x is a line
    where ``(x - phase_px) mod pitch_px < cd_px``, for the lines that fit
    whole in the clip (a line the clip's edge would cut is left out)."""
    x = torch.arange(side_px, device=device, dtype=torch.int64)
    offset = torch.remainder(x - phase_px, pitch_px)
    start = x - offset
    on = (offset < cd_px) & (start >= 0) & (start + cd_px <= side_px)
    return on.to(torch.float32)[None, :].expand(side_px, side_px).contiguous()


def draw(rng: np.random.Generator, count: int, spec: dict,
         pixel_nm: float) -> list[tuple[int, int, int]]:
    """(pitch_px, cd_px, phase_px) of ``count`` layouts."""
    pitches = [whole_px(p, pixel_nm) for p in spec["pitches_nm"]]
    out = []
    for pick, u in zip(rng.integers(0, len(pitches), size=count),
                       rng.random(count)):
        pitch = pitches[int(pick)]
        cd = int(round(pitch * spec["cd_of_pitch"]))
        out.append((pitch, cd, int(u * pitch)))
    return out


def layouts(seed: int, stream: int, count: int, side_px: int, spec: dict,
            pixel_nm: float, *, device) -> tuple[torch.Tensor, list]:
    """((count, side_px, side_px) layouts, their (pitch_px, cd_px,
    phase_px)) of one seed and stream."""
    params = draw(rng_for(seed, stream), count, spec, pixel_nm)
    return (torch.stack([grating(side_px, *p, device=device) for p in params]),
            params)
