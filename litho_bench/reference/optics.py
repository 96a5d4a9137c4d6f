"""Plain PyTorch reference of scalar aerial imaging, in float64.

It follows the upstream project's model as the configuration states it
(quarterwave0/LithographySimulator, ``imageformation.py``): the sigma plane
spans [-2, 2) in ``n`` steps, so the unit pupil covers its central half;
the pupil is ``exp(i 2 pi W)`` on the unit disk with ``W`` a sum of
OSA-ordered Zernike terms (term 4 given in nm of defocus, converted by
``NA^2 / (4 lambda)``); the source is an annulus with alternating angular
sectors removed (a quasar); the mask spectrum is the Gau'23 wavelength
scaling (bilinear upsampling by ``epsilon = N / beta``, a centered
zero-pad to the power-of-two ``N`` nearest ``beta``, a centered FFT, a
crop back to ``n``); a coherent field is the centered inverse FFT of
``N`` points of a product on the sigma plane, cropped to ``n``; and the
image is downsampled by ``1 / epsilon`` and padded back to ``n``.

Nothing here imports the program: every matrix is formed again from the
configuration. Arrays are float64 and complex128 unless a caller asks for
less (the precision controls do).
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64, C128 = torch.float64, torch.complex128


def scaling(cfg: dict) -> tuple[float, int, float]:
    """(beta, N, epsilon) of the Gau'23 wavelength scaling."""
    n = cfg["pixel_number"]
    beta = cfg["wavelength_nm"] / ((4.0 / n) * cfg["pixel_nm"])
    table = [2 ** k for k in range(1, 15)]
    big_n = min(table, key=lambda s: (abs(s - beta), s))
    return beta, big_n, big_n / beta


def sigma_axis(n: int) -> np.ndarray:
    return -2.0 + (4.0 / n) * np.arange(n, dtype=np.float64)


def polar(n: int) -> tuple[np.ndarray, np.ndarray]:
    s = sigma_axis(n)
    r = np.hypot(s[None, :], s[:, None])
    theta = np.arctan2(s[:, None], np.broadcast_to(s[None, :], (n, n)))
    return r, theta


def quasar_source(cfg: dict) -> np.ndarray:
    """(n, n) float32 0/1 source map."""
    src = cfg["illumination"]
    r, theta = polar(cfg["pixel_number"])
    theta = np.mod(theta + src["rotation_rad"], 2.0 * np.pi)
    ring = (r >= src["sigma_in"]) & (r <= src["sigma_out"])
    gap = np.pi / src["poles"]
    keep = np.ones_like(ring)
    for g in range(src["poles"]):
        keep &= ~((2 * g * gap < theta) & (theta < (2 * g + 1) * gap))
    return (ring & keep).astype(np.float32)


def _zernike(j: int, r: np.ndarray, theta: np.ndarray) -> np.ndarray:
    order = math.ceil(0.5 * (-3.0 + math.sqrt(9.0 + 8.0 * j)))
    m = 2 * j - order * (order + 2)
    am = abs(m)
    radial = np.zeros_like(r)
    for k in range((order - am) // 2 + 1):
        radial += ((-1) ** k * math.factorial(order - k)
                   / (math.factorial(k) * math.factorial((order + am) // 2 - k)
                      * math.factorial((order - am) // 2 - k))) * r ** (order - 2 * k)
    norm = math.sqrt((2 * order + 1) / (2 if m == 0 else 1))
    angular = np.cos(m * theta) if m >= 0 else np.sin(am * theta)
    return np.where(r <= 1.0, norm * radial * angular, 0.0)


def pupil(cfg: dict, *, device, dtype=C128) -> torch.Tensor:
    """(n, n) complex pupil on the sigma plane."""
    n = cfg["pixel_number"]
    r, theta = polar(n)
    coeffs = np.asarray(cfg["aberrations_osa"], np.float64).copy()
    if len(coeffs) > 4:
        coeffs[4] *= cfg["na"] ** 2 / (4.0 * cfg["wavelength_nm"])
    wave = sum(c * _zernike(j, r, theta) for j, c in enumerate(coeffs) if c)
    p = np.exp(2j * np.pi * wave) * (r <= 1.0)
    return torch.as_tensor(p, device=device).to(dtype)


def _interp(n_in: int, scale: float) -> np.ndarray:
    """(floor(n_in * scale), n_in) bilinear matrix: source coordinate
    (dst + 0.5) / scale - 0.5, clamped to the array."""
    out = int(math.floor(n_in * scale))
    src = np.clip((np.arange(out) + 0.5) / scale - 0.5, 0.0, n_in - 1.0)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w = np.zeros((out, n_in))
    np.add.at(w, (np.arange(out), lo), 1.0 - (src - lo))
    np.add.at(w, (np.arange(out), hi), src - lo)
    return w


def _resize(img: torch.Tensor, scale: float) -> torch.Tensor:
    n = img.shape[-1]
    if int(math.floor(n * scale)) == n:
        return img
    w = torch.as_tensor(_interp(n, scale), device=img.device, dtype=img.dtype)
    return w @ img @ w.T


def _pad(x: torch.Tensor, size: int) -> torch.Tensor:
    m = x.shape[-1]
    p = (size - m) // 2
    if p < 0:
        return x[..., -p:-p + size, -p:-p + size]
    out = x.new_zeros(x.shape[:-2] + (size, size))
    out[..., p:p + m, p:p + m] = x
    return out


def _crop(x: torch.Tensor, size: int) -> torch.Tensor:
    t = (x.shape[-1] - size) // 2
    if t >= 0:
        return x[..., t:t + size, t:t + size]
    return _pad(x, size)


def _centered(fn, x: torch.Tensor, **kw) -> torch.Tensor:
    dims = (-2, -1)
    return torch.fft.ifftshift(fn(torch.fft.fftshift(x, dim=dims), dim=dims,
                                  **kw), dim=dims)


def spectrum(geometry: torch.Tensor, cfg: dict, dtype=C128) -> torch.Tensor:
    """(n, n) mask spectrum of a real (n, n) geometry."""
    _, big_n, eps = scaling(cfg)
    real = F64 if dtype == C128 else torch.float32
    scaled = _resize(geometry.to(real), eps)
    return _crop(_centered(torch.fft.fft2, _pad(scaled, big_n).to(dtype),
                           norm="backward"), cfg["pixel_number"])


def fields(products: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, n, n) coherent fields of (B, n, n) sigma-plane products."""
    _, big_n, _ = scaling(cfg)
    return _crop(_centered(torch.fft.ifft2, _pad(products, big_n),
                           norm="forward"), cfg["pixel_number"])


def finish(acc: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The summed intensity on the wafer grid: downsample, pad back."""
    _, _, eps = scaling(cfg)
    return _pad(_resize(acc, 1.0 / eps), cfg["pixel_number"])


def socs_image(spec: torch.Tensor, kernels: torch.Tensor,
               eigenvalues: torch.Tensor, cfg: dict, *,
               block: int = 8) -> torch.Tensor:
    """``sum_j lambda_j |F(phi_j M)|^2`` of sigma-plane kernels, in the
    spectrum's precision, ``block`` kernels at a time."""
    real = spec.real.dtype
    acc = torch.zeros(spec.shape, dtype=real, device=spec.device)
    lam = eigenvalues.to(device=spec.device, dtype=real)
    for c in range(0, kernels.shape[0], block):
        f = fields(kernels[c:c + block].to(spec.dtype) * spec, cfg)
        acc += torch.einsum("b,bij->ij", lam[c:c + block], f.real ** 2 + f.imag ** 2)
    return finish(acc, cfg)


def abbe_image(spec: torch.Tensor, pup: torch.Tensor, source: np.ndarray,
               cfg: dict, *, block: int = 16) -> torch.Tensor:
    """The exact (Abbe) image: ``sum_s w_s |F(P(. - s) M)|^2`` over every
    live source point, the pupil shifted by the point's integer offset."""
    n = cfg["pixel_number"]
    idx = np.argwhere(source > 0)
    w = torch.as_tensor(source[idx[:, 0], idx[:, 1]], device=spec.device,
                        dtype=spec.real.dtype)
    shifts = idx - n // 2
    acc = torch.zeros(spec.shape, dtype=spec.real.dtype, device=spec.device)
    pup = pup.to(spec.dtype)
    for c in range(0, len(idx), block):
        rolled = torch.stack([torch.roll(pup, (int(dy), int(dx)), (0, 1))
                              for dy, dx in shifts[c:c + block]])
        f = fields(rolled * spec, cfg)
        acc += torch.einsum("b,bij->ij", w[c:c + block], f.real ** 2 + f.imag ** 2)
    return finish(acc, cfg)


def nrms(image: torch.Tensor, ref: torch.Tensor) -> float:
    """Normalized RMS of ``image - ref`` over the reference's peak."""
    d = image.to(F64) - ref.to(F64)
    return float(torch.sqrt(torch.mean(d * d)) / ref.to(F64).abs().max())
