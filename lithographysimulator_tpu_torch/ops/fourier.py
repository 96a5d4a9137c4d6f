"""Centered 2-D Fourier transforms and pad/crop arithmetic (torch.fft).

Port of ``lithographysimulator_tpu/ops/fourier.py``: DC sits at the array
center on both sides of every transform; the forward mask transform is the
unnormalized ``fft2`` and the imaging transform the unnormalized ``ifft2``
(``norm='forward'``). Pad and crop follow the reference's even/odd rule.
"""

from __future__ import annotations

import torch

_DIMS = (-2, -1)


def centered_fft2(field: torch.Tensor) -> torch.Tensor:
    """DC-centered unnormalized forward FFT over the trailing two dims."""
    shifted = torch.fft.fftshift(field, dim=_DIMS)
    return torch.fft.ifftshift(torch.fft.fft2(shifted, norm="backward"), dim=_DIMS)


def centered_ifft2(field: torch.Tensor) -> torch.Tensor:
    """DC-centered inverse FFT with no 1/N^2 factor (``norm='forward'``)."""
    shifted = torch.fft.fftshift(field, dim=_DIMS)
    return torch.fft.ifftshift(torch.fft.ifft2(shifted, norm="forward"), dim=_DIMS)


def pad_center(field: torch.Tensor, target: int) -> torch.Tensor:
    """Resize the trailing two dims to ``target``: ``p = (target - m) // 2``
    zeros on the low side and ``p + m % 2`` on the high side; a negative
    ``p`` crops instead (torch negative-pad semantics)."""
    m = field.shape[-1]
    if field.shape[-2] != m:
        raise ValueError("pad_center expects square trailing dims")
    p = (target - m) // 2
    if p < 0:
        start = -p
        return field[..., start : start + target, start : start + target]
    out = field.new_zeros(field.shape[:-2] + (target, target))
    out[..., p : p + m, p : p + m] = field
    return out


def crop_center(field: torch.Tensor, target: int) -> torch.Tensor:
    """Center-crop the trailing two dims from N to ``target`` with
    ``t = (N - target) // 2``; a negative ``t`` zero-pads by ``-t``."""
    big = field.shape[-1]
    t = (big - target) // 2
    if t >= 0:
        return field[..., t : t + target, t : t + target]
    size = big - 2 * t
    out = field.new_zeros(field.shape[:-2] + (size, size))
    out[..., -t : -t + big, -t : -t + big] = field
    return out
