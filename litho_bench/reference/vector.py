"""Plain PyTorch reference of the polarized (vector) exact image of a
hyper-NA immersion scanner, in float64.

The model, written from the physics and not from the program:

* The pupil's edge is at spatial frequency NA / lambda when the
  configuration says ``pupil_at_na`` (sigma in NA units, as a scanner's
  illuminator is stated), else at 1 / lambda. The Gau'23 mask spectrum and
  the downsampling of :mod:`.optics` then scale by
  ``beta = lambda / (NA delta_k pixel)``.
* A plane wave leaving the pupil at ``sigma`` travels in the image-side
  medium (index ``n_i``) at ``sin(theta) = NA |sigma| / n_i``. Its
  tangential (TE) part keeps its direction; its radial (TM) part tilts, so
  the in-plane field of a unit radial input is ``cos(theta)`` and the
  longitudinal one ``-sin(theta)``. With ``e_r = sigma / |sigma|`` the
  3 x 2 Jones pupil is ``V_xy = I - (1 - cos(theta)) e_r e_r^T`` (the same as
  ``e_t e_t^T + cos(theta) e_r e_r^T``) and ``V_z = -sin(theta) e_r^T``.
  Since ``(1 - cos) / |sigma|^2 = (NA / n_i)^2 / (1 + cos)`` and
  ``sin(theta) e_r = (NA / n_i) sigma``, both are written here without a
  division by ``|sigma|``, so the axis needs no case of its own. The
  radiometric factor of a demagnifying lens that keeps the sine condition,
  ``1 / sqrt(cos(theta))``, multiplies all three rows (``apodize``).
* Each source point ``s`` (an integer offset on the sigma grid, the pupil
  shifted by ``s`` as :func:`.optics.abbe_image` shifts it) and each field
  component ``c`` give one coherent field: the Fourier sum over the
  product of the shifted component pupil and the mask spectrum, evaluated
  at the ``n`` image points of the ``N``-point grid. The product is
  nonzero only on the shifted unit disk, a box of ``n / 2 + 1`` samples a
  side, so the sum runs over that box: ``E = T_r X T_c^T`` with ``T`` the
  matrix of the centered ``N``-point inverse transform restricted to the
  box's rows and columns.
* The image is ``sum_p q_p sum_s w_s sum_c |E_{p,s,c}|^2`` over the Jones
  states ``p`` of the polarization, downsampled by ``1 / epsilon`` and
  padded back to ``n`` as the scalar model's image is.

Nothing here imports the program. Arrays are float64 and complex128 unless
a caller asks for complex64 (the precision controls do).
"""

from __future__ import annotations

import numpy as np
import torch

from . import optics as ro

F64, C128 = ro.F64, ro.C128

STATES = {"x": [(1.0, (1.0, 0.0))], "y": [(1.0, (0.0, 1.0))],
          "unpolarized": [(0.5, (1.0, 0.0)), (0.5, (0.0, 1.0))]}


def grid_config(cfg: dict) -> dict:
    """The configuration whose pupil edge at 1 / lambda' is this one's at
    NA / lambda (``pupil_at_na``): the sigma grid, and so the Gau'23
    scaling of :mod:`.optics`, depends on the wavelength only as
    ``lambda' = lambda / NA``."""
    if not cfg.get("pupil_at_na", False):
        return cfg
    return dict(cfg, wavelength_nm=cfg["wavelength_nm"] / cfg["na"])


def dipole_source(cfg: dict) -> np.ndarray:
    """(n, n) float32 0/1 map of a dipole: two poles on the ``axis`` of
    ``opening_deg`` each, between ``sigma_in`` and ``sigma_out``."""
    ill = cfg["illumination"]
    r, theta = ro.polar(cfg["pixel_number"])
    if ill["axis"] == "y":
        theta = theta - np.pi / 2
    half = np.deg2rad(ill["opening_deg"]) / 2.0
    off_axis = np.abs(np.angle(np.exp(1j * theta) ** 2)) / 2.0  # 0 on the axis
    ring = (r >= ill["sigma_in"]) & (r <= ill["sigma_out"])
    return (ring & (off_axis <= half)).astype(np.float32)


def jones_pupil(cfg: dict, jones, *, apodize: bool = True) -> np.ndarray:
    """(3, n, n) complex128 wafer-side field components (x, y, z) of a unit
    input of Jones vector ``jones`` at every pupil position, zero outside
    the propagating unit disk."""
    r, _ = ro.polar(cfg["pixel_number"])
    s = ro.sigma_axis(cfg["pixel_number"])
    sx, sy = np.broadcast_arrays(s[None, :], s[:, None])
    k = cfg["na"] / cfg.get("immersion_index", 1.0)  # sin(theta) = k |sigma|
    sin2 = (k * r) ** 2
    inside = (r <= 1.0) & (sin2 < 1.0)
    cos_t = np.sqrt(np.where(inside, 1.0 - sin2, 1.0))
    tilt = k * k / (1.0 + cos_t)  # (1 - cos) / |sigma|^2
    jx, jy = (complex(j) for j in jones)
    along = sx * jx + sy * jy  # sigma . J
    out = np.stack([jx - tilt * sx * along, jy - tilt * sy * along,
                    -k * along])
    if apodize:
        out = out / np.sqrt(cos_t)
    return out * inside


def _transform_rows(cfg: dict, device, dtype) -> torch.Tensor:
    """(n, n) ``T[a, q] = exp(2 pi i (a - n/2)(q - n/2) / N)``: image point
    ``a`` of the centered ``N``-point inverse transform of a spectrum
    sample ``q`` of the ``n``-point sigma grid."""
    n = cfg["pixel_number"]
    _, big_n, _ = ro.scaling(grid_config(cfg))
    if big_n < n:
        raise ValueError(f"the reference needs N >= n (N {big_n}, n {n})")
    a = np.arange(n, dtype=np.float64) - n / 2
    return torch.as_tensor(np.exp(2j * np.pi * np.outer(a, a) / big_n),
                           device=device).to(dtype)


def image(geometry: torch.Tensor, source: np.ndarray, cfg: dict,
          polarization: str, *, block: int = 8, dtype=C128) -> torch.Tensor:
    """The vector exact image of ``geometry`` under the (n, n) ``source``
    map, the configuration's pupil and the ``polarization`` ('x', 'y' or
    'unpolarized'), ``block`` source points at a time."""
    n = cfg["pixel_number"]
    device = geometry.device
    real = F64 if dtype == C128 else torch.float32
    spec = ro.spectrum(geometry, grid_config(cfg), dtype)
    idx = np.argwhere(source > 0)
    shifts = idx - n // 2
    if len(idx) and np.abs(shifts).max() >= n // 4:
        raise ValueError("a source point shifts the pupil past the grid")
    weights = torch.as_tensor(source[idx[:, 0], idx[:, 1]], device=device,
                              dtype=real)
    t = _transform_rows(cfg, device, dtype)
    box, lo = n // 2 + 1, n // 4  # the unit disk spans rows lo .. lo + n/2
    scalar = ro.pupil(cfg, device=device, dtype=dtype)[lo:lo + box, lo:lo + box]
    span = torch.arange(box, device=device)
    acc = torch.zeros((n, n), dtype=real, device=device)
    for weight, jones in STATES[polarization]:
        comps = torch.as_tensor(jones_pupil(cfg, jones, apodize=cfg["apodize"]),
                                device=device)
        pup = comps[:, lo:lo + box, lo:lo + box].to(dtype) * scalar
        for c in range(0, len(idx), block):
            s = torch.as_tensor(shifts[c:c + block], device=device)
            rows = lo + s[:, :1] + span  # (B, box) spectrum rows of each point
            cols = lo + s[:, 1:] + span
            window = spec[rows[:, :, None], cols[:, None, :]]  # (B, box, box)
            x = pup[None] * window[:, None]  # (B, C, box, box)
            t_r = t[:, rows].permute(1, 0, 2)[:, None]  # (B, 1, n, box)
            t_c = t[:, cols].permute(1, 2, 0)[:, None]  # (B, 1, box, n)
            e = t_r @ (x @ t_c)
            power = (e.real ** 2 + e.imag ** 2).sum(dim=1)
            acc += weight * torch.einsum("b,bij->ij", weights[c:c + block], power)
    return ro.finish(acc, grid_config(cfg))
