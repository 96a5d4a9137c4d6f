"""Seeded Manhattan layouts, rasterized on the device.

A layout is a grid of square blocks (``block`` px a side). Each block holds
one pattern drawn from the seed: vertical or horizontal lines and spaces, a
contact array, one rectangle, or nothing. Every block keeps an empty margin
of ``min_px`` on each side, and only whole features are drawn, so no
feature and no space anywhere in the layout is narrower than ``min_px``
(a block edge meets two margins). The parameters are drawn on the host with
numpy from ``(seed, stream)``, a few numbers a block, and the pixels are
formed on the device in a handful of whole-array operations of integer
arithmetic, so the same seed gives the same layout on every device.

Both configurations (a 1024^2 clip and the 8192^2 chip) and the reference
take their masks from here.
"""

from __future__ import annotations

import numpy as np
import torch

EMPTY, VLINES, HLINES, CONTACTS, RECT = range(5)
KIND_P = (0.1, 0.25, 0.25, 0.2, 0.2)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The numpy generator of one input stream of a run: any whole seed,
    negative or past 64 bits included."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2**64, int(stream)]))


def draw_blocks(rng: np.random.Generator, shape: tuple, spec: dict) -> dict:
    """Host parameters (int64 arrays of ``shape``) of every block."""
    b, m = spec["block_px"], spec["min_px"]
    inner = b - 2 * m
    kind = rng.choice(len(KIND_P), size=shape, p=KIND_P)
    width = rng.integers(m, spec["max_width_px"] + 1, size=shape)
    space = rng.integers(m, spec["max_space_px"] + 1, size=shape)
    # contacts: square, of a width up to max_contact_px
    contact = rng.integers(m, spec["max_contact_px"] + 1, size=shape)
    width = np.where(kind == CONTACTS, contact, width)
    h = rng.integers(m, inner + 1, size=shape)
    w = rng.integers(m, inner + 1, size=shape)
    y0 = m + (rng.random(shape) * (inner - h + 1)).astype(np.int64)
    x0 = m + (rng.random(shape) * (inner - w + 1)).astype(np.int64)
    return {"kind": kind, "width": width, "space": space,
            "y0": y0, "x0": x0, "y1": y0 + h, "x1": x0 + w}


def _whole_features(u, width, pitch, inner: int):
    """True where local coordinate ``u`` (from the block's margin) lies in a
    feature of ``width`` repeated at ``pitch`` that fits whole in ``inner``."""
    start = (u // pitch) * pitch
    return (u >= 0) & (u < inner) & (u - start < width) & (start + width <= inner)


def _ints(values, device) -> torch.Tensor:
    return torch.as_tensor(values, device=device, dtype=torch.int32)


def rasterize(params: dict, spec: dict, *, device) -> torch.Tensor:
    """(..., rows * block, cols * block) float32 0/1 layout from
    :func:`draw_blocks`' parameters of shape (..., rows, cols)."""
    b, m = spec["block_px"], spec["min_px"]
    inner = b - 2 * m
    p = {k: _ints(v, device) for k, v in params.items()}
    rows, cols = params["kind"].shape[-2:]
    yy = _ints(np.arange(rows * b), device)
    xx = _ints(np.arange(cols * b), device)
    by, ly = (yy // b)[:, None], (yy % b)[:, None]
    bx, lx = (xx // b)[None, :], (xx % b)[None, :]

    def per_pixel(name):
        return p[name][..., by, bx]

    kind, width = per_pixel("kind"), per_pixel("width")
    pitch = width + per_pixel("space")
    in_y = (ly >= m) & (ly < b - m)
    in_x = (lx >= m) & (lx < b - m)
    vlines = in_y & _whole_features(lx - m, width, pitch, inner)
    hlines = in_x & _whole_features(ly - m, width, pitch, inner)
    contacts = (_whole_features(lx - m, width, pitch, inner)
                & _whole_features(ly - m, width, pitch, inner))
    rect = ((ly >= per_pixel("y0")) & (ly < per_pixel("y1"))
            & (lx >= per_pixel("x0")) & (lx < per_pixel("x1")))
    on = (((kind == VLINES) & vlines) | ((kind == HLINES) & hlines)
          | ((kind == CONTACTS) & contacts) | ((kind == RECT) & rect))
    return on.float()


def layouts(seed: int, stream: int, count: int, side_px: int, spec: dict, *,
            device, group: int = 8) -> torch.Tensor:
    """(count, side_px, side_px) distinct layouts of one seed and stream,
    rasterized ``group`` at a time."""
    b = spec["block_px"]
    if side_px % b:
        raise ValueError(f"side {side_px} is not a multiple of the block {b}")
    blocks = side_px // b
    params = draw_blocks(rng_for(seed, stream), (count, blocks, blocks), spec)
    return torch.cat([rasterize({k: v[g:g + group] for k, v in params.items()},
                                spec, device=device)
                      for g in range(0, count, group)])
