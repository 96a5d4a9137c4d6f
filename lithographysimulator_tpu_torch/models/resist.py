"""Photoresist response models and critical-dimension metrology.

Port of ``lithographysimulator_tpu/models/resist.py``: the lumped models
(aerial image -> optional acid-diffusion blur -> hard or sigmoid develop),
the thin-film Dill/Mack model, the depth-resolved :class:`DepthResist`
(Beer-Lambert absorption, standing waves, PEB, and vertical or eikonal 3-D
development), and the CD, NILS, EPE and process-window measurements.

The models are plain torch on the device of the image they are given
(host data needs ``device=``), in float32 as the JAX package runs them,
and every smooth one is differentiable through autograd. The measurement
functions are the JAX package's numpy code, copied: they read any tensor
back to the host first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._tensors import per_device_cache, to_tensor
from ..config import OpticsConfig


def _f32(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor (host data needs ``device``)."""
    return to_tensor(x, device=device, dtype=torch.float32)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_field(x):
    """A tensor as it is, anything else as a numpy array."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _cut_lines(field, axis: int, row_step: int, *, float64: bool = True):
    """(host array, indices) of the cut lines a table reads: every
    ``row_step``-th row of a 2-D ``field`` (``axis=1``) or column
    (``axis=0``, transposed), in float64 or, with ``float64=False``, in
    the field's own dtype. The lines are picked before the read-back, so a
    chip on the device moves only them to the host."""
    field = _as_field(field)
    if field.ndim != 2:
        raise ValueError(f"expected a 2-D profile, got shape {tuple(field.shape)}")
    lines = field.T if axis == 0 else field
    rows_kept = np.arange(0, lines.shape[0], row_step)
    host = _host(lines[::row_step])
    return np.asarray(host, np.float64) if float64 else np.asarray(host), rows_kept


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum then minimum, so a value on a bound shares its
    gradient as JAX's does."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.max(x), 1e-30)


def gaussian_transfer(n: int, pixel_size_nm: float, sigma_nm: float) -> np.ndarray:
    """(n, n) float64 frequency response of a Gaussian blur of 1-sigma
    ``sigma_nm`` on an n x n grid of ``pixel_size_nm`` pixels (FFT order)."""
    freqs = np.fft.fftfreq(n, d=pixel_size_nm)  # cycles/nm
    return np.exp(-2.0 * (np.pi * sigma_nm) ** 2
                  * (freqs[None, :] ** 2 + freqs[:, None] ** 2))


@per_device_cache(maxsize=2)
def _transfer(n: int, pixel_size_nm: float, sigma_nm: float,
              device: torch.device) -> torch.Tensor:
    """:func:`gaussian_transfer` rounded to complex64 (as the JAX package
    rounds it) on ``device``. Cached: a Monte-Carlo ensemble blurs every
    trial with it, and forming it on the host and copying it over took
    longer than a trial's work on the card. Holds at most two (n, n)
    complex64 tensors."""
    return torch.as_tensor(
        gaussian_transfer(n, pixel_size_nm, sigma_nm).astype(np.complex64),
        device=device)


def fft_blur(field: torch.Tensor, pixel_size_nm: float,
             sigma_nm: float) -> torch.Tensor:
    """Gaussian blur of 1-sigma ``sigma_nm`` over the last two axes:
    the real part of ifft2(fft2(field) * transfer)."""
    t = _transfer(field.shape[-1], float(pixel_size_nm), float(sigma_nm),
                  field.device)
    return torch.fft.ifft2(torch.fft.fft2(field) * t).real


@dataclasses.dataclass(frozen=True)
class ResistModel:
    """Lumped resist response.

    threshold: develop threshold as a fraction of the image maximum (for
    normalized images pass absolute threshold and normalize=False).
    steepness: sigmoid sharpness for the differentiable model (per unit of
    normalized intensity); larger approaches a hard threshold.
    diffusion_nm: Gaussian acid-diffusion length (1-sigma, nm); 0 disables.
    """

    threshold: float = 0.3
    steepness: float = 50.0
    diffusion_nm: float = 0.0

    def blur(self, image, config: OpticsConfig, *, device=None) -> torch.Tensor:
        """Gaussian diffusion blur applied in the frequency domain."""
        image = _f32(image, device)
        if self.diffusion_nm <= 0.0:
            return image
        return fft_blur(image, config.pixel_size, self.diffusion_nm)

    def develop(self, image, config: OpticsConfig, *, normalize: bool = True,
                device=None) -> torch.Tensor:
        """Differentiable resist profile in [0, 1] (1 = resist removed, for a
        positive-tone resist under bright-field exposure)."""
        blurred = self.blur(image, config, device=device)
        if normalize:
            blurred = _normalized(blurred)
        return torch.sigmoid(self.steepness * (blurred - self.threshold))

    def develop_binary(self, image, config: OpticsConfig, *,
                       normalize: bool = True, device=None) -> torch.Tensor:
        """Hard-threshold develop: {0, 1} resist pattern."""
        blurred = self.blur(image, config, device=device)
        if normalize:
            blurred = _normalized(blurred)
        return (blurred > self.threshold).to(torch.float32)


def critical_dimension(profile, config: OpticsConfig, *, row: int | None = None,
                       threshold: float = 0.5) -> float:
    """Width (nm) of the first contiguous above-threshold run along a row cut
    of a developed profile — the printed feature's critical dimension."""
    field = _as_field(profile)
    cut = _host(field[field.shape[-1] // 2 if row is None else row])
    above = cut > threshold
    if not above.any():
        return 0.0
    idx = np.nonzero(above)[0]
    # first contiguous run
    breaks = np.nonzero(np.diff(idx) > 1)[0]
    end = idx[breaks[0]] if len(breaks) else idx[-1]
    start = idx[0]
    return float((end - start + 1) * config.pixel_size)


# ---------------------------------------------------------------------------
# Full-chip CD metrology: multi-feature extraction, CD uniformity, EPE
# ---------------------------------------------------------------------------


def feature_table(profile, config: OpticsConfig, *, axis: int = 1,
                  threshold: float = 0.5, row_step: int = 1) -> dict:
    """ALL contiguous above-threshold runs along every cut line, vectorized.

    ``axis=1`` cuts along rows (features measured horizontally), ``axis=0``
    along columns. Edges are subpixel: the crossing is linearly
    interpolated where the profile passes ``threshold``, so CDs vary
    continuously with dose and focus. ``row_step`` subsamples the cut lines.

    Returns arrays over features: ``row`` (cut index), ``rise_px`` /
    ``fall_px`` (subpixel edge positions along the cut), ``width_nm``,
    ``center_nm``. A tensor's kept cut lines alone are read back."""
    arr, rows_kept = _cut_lines(profile, axis, row_step, float64=False)
    n_cols = arr.shape[1]
    # compared and interpolated in float64 (exact for the field's values),
    # without a float64 copy of every cut line
    padded = np.zeros((arr.shape[0], n_cols + 2), bool)
    np.greater(arr, threshold, out=padded[:, 1:-1],
               signature=(np.float64, np.float64, np.bool_))
    # A run starts at its first above-threshold pixel and ends one past
    # its last, where the padded line changes. np.flatnonzero is
    # row-major, and a row's changes alternate start, end from the first.
    changes = np.flatnonzero(padded[:, 1:] != padded[:, :-1])
    rows, cols = np.divmod(changes, n_cols + 1)
    r_s, s = rows[0::2], cols[0::2]
    r_e, e = rows[1::2], cols[1::2]

    def at(r, c):
        return arr[r, c].astype(np.float64)

    prev = at(r_s, np.maximum(s - 1, 0))
    cur = at(r_s, np.minimum(s, n_cols - 1))
    frac_r = (threshold - prev) / np.maximum(cur - prev, 1e-30)
    rise = np.where(s > 0, s - 1 + np.clip(frac_r, 0.0, 1.0), s - 0.5)
    last = at(r_e, np.minimum(e - 1, n_cols - 1))
    nxt = at(r_e, np.minimum(e, n_cols - 1))
    frac_f = (last - threshold) / np.maximum(last - nxt, 1e-30)
    fall = np.where(e < n_cols, e - 1 + np.clip(frac_f, 0.0, 1.0), e - 0.5)
    px = config.pixel_size
    return {
        "row": rows_kept[r_s],
        "rise_px": rise,
        "fall_px": fall,
        "width_nm": (fall - rise) * px,
        "center_nm": 0.5 * (rise + fall) * px,
        "axis": axis,
    }


def _block_map(rows, cols, values, n: int, blocks: int) -> np.ndarray:
    """(blocks, blocks) mean of ``values`` per chip region (NaN where a
    region has none), from cut-line rows and along-cut columns in px."""
    bi = np.clip((rows * blocks) // n, 0, blocks - 1).astype(int)
    bj = np.clip((cols * blocks) // n, 0, blocks - 1).astype(int)
    acc = np.zeros((blocks, blocks))
    cnt = np.zeros((blocks, blocks))
    np.add.at(acc, (bi, bj), values)
    np.add.at(cnt, (bi, bj), 1.0)
    with np.errstate(invalid="ignore"):
        return np.where(cnt > 0, acc / np.maximum(cnt, 1), np.nan)


def cd_uniformity(profile, config: OpticsConfig, *, threshold: float = 0.5,
                  axis: int = 1, row_step: int | None = None,
                  map_blocks: int | None = 16,
                  min_width_nm: float = 0.0) -> dict:
    """Full-chip CD-uniformity statistics + coarse CDU map: mean / sigma
    (the usual 'CDU' number is 3 sigma) / range / count of every printed
    feature's width along ``axis``, and a ``(map_blocks, map_blocks)`` map
    of the mean CD per chip region (NaN where none prints).
    ``min_width_nm`` drops sub-resolution slivers from the statistics."""
    n = _as_field(profile).shape[0]
    if row_step is None:
        row_step = max(1, n // 512)  # cap the table at ~512 cut lines
    feats = feature_table(profile, config, axis=axis, threshold=threshold,
                          row_step=row_step)
    widths = feats["width_nm"]
    keep = widths >= min_width_nm
    widths = widths[keep]
    out = {
        "count": int(widths.size),
        "mean_cd_nm": float(widths.mean()) if widths.size else 0.0,
        "sigma_cd_nm": float(widths.std()) if widths.size else 0.0,
        "range_cd_nm": (float(widths.max() - widths.min())
                        if widths.size else 0.0),
        "axis": axis,
    }
    out["cdu_3sigma_nm"] = 3.0 * out["sigma_cd_nm"]
    if map_blocks:
        rows = feats["row"][keep]
        cols = feats["center_nm"][keep] / config.pixel_size
        if axis == 0:
            rows, cols = cols, rows
        out["cd_map_nm"] = _block_map(rows, cols, widths, n, map_blocks)
    return out


def nils_table(image, config: OpticsConfig, *, threshold: float = 0.3,
               axis: int = 1, row_step: int | None = None,
               normalize: bool = True) -> dict:
    """Normalized Image Log-Slope at every feature edge (NILS = CD *
    |d ln I / dx| at the resist threshold crossing): subpixel crossings
    from :func:`feature_table`, the intensity gradient along the cut
    (central differences) interpolated at each crossing. Returns per-edge
    ILS (1/nm), per-feature NILS (with that feature's own CD) and summary
    statistics. Only the kept cut lines of a tensor are read back."""
    field = _as_field(image)
    if field.ndim != 2:
        raise ValueError(f"expected a 2-D image, got shape {tuple(field.shape)}")
    n = field.shape[1 - axis]  # cut lines
    if row_step is None:
        row_step = max(1, n // 512)
    arr, rows_kept = _cut_lines(field, axis, row_step)
    if normalize:
        arr = arr / max(float(field.max()), 1e-30)
    feats = feature_table(arr, config, axis=1, threshold=threshold)
    empty = {"count": 0, "mean_nils": 0.0, "min_nils": 0.0,
             "mean_ils_per_nm": 0.0, "threshold": threshold, "axis": axis}
    if feats["row"].size == 0:
        return empty
    px = config.pixel_size
    grad = np.gradient(arr, px, axis=1)  # dI/dx in 1/nm units

    # drop array-boundary-truncated runs: their clipped 'edge' is the frame,
    # not a threshold crossing, and its near-zero gradient poisons the mean
    interior = (feats["rise_px"] > 0) & (feats["fall_px"] < arr.shape[1] - 1)
    feats = {k: (v[interior] if isinstance(v, np.ndarray) else v)
             for k, v in feats.items()}
    if feats["row"].size == 0:
        return empty

    def ils_at(rows, pos_px):
        i0 = np.clip(np.floor(pos_px).astype(int), 0, arr.shape[1] - 2)
        frac = np.clip(pos_px - i0, 0.0, 1.0)
        g = (1 - frac) * grad[rows, i0] + frac * grad[rows, i0 + 1]
        # at the crossing, I = threshold by construction
        return np.abs(g) / max(threshold, 1e-30)

    ils_rise = ils_at(feats["row"], feats["rise_px"])
    ils_fall = ils_at(feats["row"], feats["fall_px"])
    ils = np.concatenate([ils_rise, ils_fall])
    nils = 0.5 * (ils_rise + ils_fall) * feats["width_nm"]
    return {
        "count": int(nils.size),
        "mean_nils": float(nils.mean()),
        "min_nils": float(nils.min()),
        "mean_ils_per_nm": float(ils.mean()),
        "nils": nils,
        "ils_per_nm": ils,
        "width_nm": feats["width_nm"],
        "row": rows_kept[feats["row"]],
        "center_nm": feats["center_nm"],
        "threshold": threshold,
        "axis": axis,
    }


def hotspots(image, config: OpticsConfig, *, threshold: float = 0.3,
             nils_limit: float = 1.5, axis: int = 1,
             row_step: int | None = None, top: int = 50) -> dict:
    """Features whose NILS falls below a printability floor: the count, the
    fraction below the limit, and ``locations``, up to ``top`` (y_nm, x_nm,
    nils) rows sorted weakest-first in the image frame."""
    tab = nils_table(image, config, threshold=threshold, axis=axis,
                     row_step=row_step)
    if tab["count"] == 0:
        return {"count": 0, "fraction_below": 0.0,
                "locations": np.zeros((0, 3)), "nils_limit": nils_limit}
    nils = tab["nils"]
    below = nils < nils_limit
    order = np.argsort(nils[below])[:top]
    px = config.pixel_size
    along = tab["center_nm"][below][order]          # along the cut
    across = tab["row"][below][order] * px          # cut line position
    ys, xs = (across, along) if axis == 1 else (along, across)
    locations = np.stack([ys, xs, nils[below][order]], axis=1)
    return {
        "count": int(below.sum()),
        "fraction_below": float(below.mean()),
        "locations": locations,
        "nils_limit": nils_limit,
        "min_nils": tab["min_nils"],
    }


def _match_features(pf: dict, tf: dict, px: float, n: int, *,
                    max_match_nm: float | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Match target features to printed features on the same cut line:
    for each target feature the index of the nearest-center printed
    feature on its row, and whether it lies within ``max_match_nm``
    (default half the target width + one pixel)."""
    span = float(n) * px
    # composite sort key: row major, center minor (rows already sorted)
    p_key = pf["row"] * (2.0 * span) + pf["center_nm"]
    t_rows = tf["row"]
    t_centers = tf["center_nm"]
    idx = np.searchsorted(p_key, t_rows * (2.0 * span) + t_centers)
    cand = np.stack([np.clip(idx - 1, 0, max(len(p_key) - 1, 0)),
                     np.clip(idx, 0, max(len(p_key) - 1, 0))])
    if len(p_key) == 0:
        return np.zeros(len(t_rows), int), np.zeros(len(t_rows), bool)
    same_row = pf["row"][cand] == t_rows[None, :]
    dist = np.abs(pf["center_nm"][cand] - t_centers[None, :])
    dist = np.where(same_row, dist, np.inf)
    pick = np.argmin(dist, axis=0)
    best = cand[pick, np.arange(len(t_rows))]
    best_dist = dist[pick, np.arange(len(t_rows))]
    limit = (0.5 * tf["width_nm"] + px if max_match_nm is None
             else np.full(len(t_rows), float(max_match_nm)))
    return best, best_dist <= limit


def aligned_edge_positions(profile, target_table: dict,
                           config: OpticsConfig, *,
                           threshold: float = 0.5, axis: int = 1,
                           row_step: int = 1,
                           max_match_nm: float | None = None
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Subpixel printed edge positions aligned to a fixed target edge list
    (``target_table``, the target's :func:`feature_table`): ``(rise_nm,
    fall_nm)`` of length ``len(target_table['row'])``, NaN where the target
    feature did not print or bridged past the match window."""
    pf = feature_table(profile, config, axis=axis, threshold=threshold,
                       row_step=row_step)
    px = config.pixel_size
    n = _as_field(profile).shape[axis == 0]
    best, matched = _match_features(pf, target_table, px, n,
                                    max_match_nm=max_match_nm)
    n_t = len(target_table["row"])
    rise = np.full(n_t, np.nan)
    fall = np.full(n_t, np.nan)
    if len(pf["row"]) and n_t:
        rise[matched] = pf["rise_px"][best[matched]] * px
        fall[matched] = pf["fall_px"][best[matched]] * px
    return rise, fall


def edge_placement_errors(profile, target_geometry, config: OpticsConfig, *,
                          threshold: float = 0.5, axis: int = 1,
                          row_step: int = 1,
                          max_match_nm: float | None = None) -> dict:
    """Per-edge placement errors of the printed pattern vs the target:
    each target feature matched to the nearest-center printed feature on
    its cut line; the signed rise/fall errors (printed - target, nm) with
    summary statistics, and the counts of unmatched target features
    (missing) and unmatched printed ones (spurious)."""
    pf = feature_table(profile, config, axis=axis, threshold=threshold,
                       row_step=row_step)
    tf = feature_table(target_geometry, config, axis=axis,
                       threshold=threshold, row_step=row_step)
    px = config.pixel_size
    n = _as_field(profile).shape[axis == 0]
    best, matched = _match_features(pf, tf, px, n,
                                    max_match_nm=max_match_nm)
    p_key, t_rows = pf["row"], tf["row"]
    if len(p_key) == 0 or len(t_rows) == 0:
        epe_rise = epe_fall = np.zeros((0,))
    else:
        epe_rise = ((pf["rise_px"][best] - tf["rise_px"]) * px)[matched]
        epe_fall = ((pf["fall_px"][best] - tf["fall_px"]) * px)[matched]
    all_epe = np.concatenate([epe_rise, epe_fall])
    spurious = len(p_key) - len(np.unique(best[matched]))
    return {
        "epe_rise_nm": epe_rise,
        "epe_fall_nm": epe_fall,
        "mean_abs_epe_nm": float(np.abs(all_epe).mean()) if all_epe.size else 0.0,
        "max_abs_epe_nm": float(np.abs(all_epe).max()) if all_epe.size else 0.0,
        "sigma_epe_nm": float(all_epe.std()) if all_epe.size else 0.0,
        "matched": int(matched.sum()),
        "missing": int((~matched).sum()),
        "spurious": int(max(spurious, 0)),
    }


def exposure_latitude(image, config: OpticsConfig, model: ResistModel,
                      doses, *, device=None) -> list[float]:
    """CDs across a dose sweep of ONE aerial image: develop ``image * dose``
    for each dose and measure the printed CD (one focus-exposure-matrix
    column)."""
    image = _f32(image, device)
    if image.ndim != 2:
        raise ValueError(
            f"exposure_latitude takes one (n, n) image, got shape "
            f"{tuple(image.shape)}; loop over focal planes for a full FEM")
    return [critical_dimension(model.develop_binary(image * dose, config,
                                                    normalize=False), config)
            for dose in doses]


def pattern_fidelity(profile, target_geometry, config: OpticsConfig) -> dict:
    """Printed-pattern vs target-layout metrics: IoU, XOR area (nm^2), and a
    mean edge-placement-error estimate (XOR area / target perimeter)."""
    printed = _host(profile) > 0.5
    target = _host(target_geometry) > 0.5
    inter = np.logical_and(printed, target).sum()
    union = np.logical_or(printed, target).sum()
    xor_px = np.logical_xor(printed, target).sum()
    # 4-neighborhood perimeter of the target, in pixels
    per = 0
    per += np.logical_xor(target[1:, :], target[:-1, :]).sum()
    per += np.logical_xor(target[:, 1:], target[:, :-1]).sum()
    per += target[0, :].sum() + target[-1, :].sum()
    per += target[:, 0].sum() + target[:, -1].sum()
    px = config.pixel_size
    return {
        "iou": float(inter / union) if union else 1.0,
        "xor_area_nm2": float(xor_px) * px * px,
        "mean_epe_nm": (float(xor_px) / float(per) * px) if per else 0.0,
    }


@dataclasses.dataclass(frozen=True)
class MackResist:
    """Thin-film physical resist: Dill exposure + Mack development rate.

    Exposure turns normalized intensity I and dose D into remaining
    photo-active compound m = exp(-C * D * I); development clears resist
    where the Mack rate

        r(m) = r_max * (a + 1)(1 - m)^n / (a + (1 - m)^n) + r_min,
        a = (n + 1)/(n - 1) * (1 - m_th)^n

    integrated over ``develop_s`` exceeds ``thickness_nm``. Every piece is
    smooth, so profiles are differentiable."""

    dill_c: float = 0.05       # per unit normalized dose
    r_max_nm_s: float = 100.0  # development rate of fully exposed resist
    r_min_nm_s: float = 0.1    # dark erosion rate
    mack_n: float = 4.0        # dissolution selectivity
    m_threshold: float = 0.6   # inhibitor threshold
    thickness_nm: float = 100.0
    develop_s: float = 30.0

    def latent_image(self, image, dose: float = 1.0, *,
                     device=None) -> torch.Tensor:
        intensity = _normalized(_f32(image, device))
        return torch.exp(-self.dill_c * dose * 100.0 * intensity)

    def development_rate(self, m: torch.Tensor) -> torch.Tensor:
        n = self.mack_n
        a = (n + 1.0) / (n - 1.0) * (1.0 - self.m_threshold) ** n
        one_minus = _clip(1.0 - m, 0.0, 1.0)
        rate = self.r_max_nm_s * (a + 1.0) * one_minus**n / (a + one_minus**n)
        return rate + self.r_min_nm_s

    def cleared_depth_nm(self, image, dose: float = 1.0, *,
                         device=None) -> torch.Tensor:
        return self.development_rate(
            self.latent_image(image, dose, device=device)) * self.develop_s

    def develop(self, image, dose: float = 1.0, *, steepness: float = 0.2,
                device=None) -> torch.Tensor:
        """Differentiable cleared fraction in [0, 1] (1 = resist removed)."""
        depth = self.cleared_depth_nm(image, dose, device=device)
        return torch.sigmoid(steepness * (depth - self.thickness_nm))

    def develop_binary(self, image, dose: float = 1.0, *,
                       device=None) -> torch.Tensor:
        return (self.cleared_depth_nm(image, dose, device=device)
                >= self.thickness_nm).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class DepthResist:
    """Depth-resolved positive resist: Beer-Lambert absorption, substrate
    standing waves and through-film defocus shape a 3-D latent image;
    development is integrated vertically, or propagated as a 3-D front
    (lateral etch and undercut) by the eikonal solver (:mod:`..ops.eikonal`).

    The film of ``mack.thickness_nm`` is ``nz`` slabs at depths z_k (cell
    centers, z = 0 at the resist top). The latent image is

        I(x, y, z) = I_stack(x, y, z) * D(z)
        m(x, y, z) = exp(-C * dose * I)                       (Dill exposure)

    with the standing-wave depth profile (Mack, "Fundamental Principles of
    Optical Lithography" ch. 4)

        D(z) = e^(-a z) + R e^(-a (2 T - z))
               + 2 sqrt(R) e^(-a T) cos(4 pi n_resist (T - z) / lambda),

    normalized to D(0) = 1. An optional post-exposure bake blurs m in 3-D
    (``peb_diffusion_nm``). ``I_stack`` is one aerial image (broadcast
    through depth) or a (nz, n, n) focal stack at :meth:`film_defocus_nm`,
    or the rigorous in-film stack with :meth:`rigorous`.

    Development: vertical (:meth:`cleared_depth_nm`, each column on its
    own, t(z) = int_0^z dz'/r(m)), or lateral (:meth:`arrival_times` /
    :meth:`develop_profile`, the eikonal |grad t| = 1/r)."""

    mack: MackResist = MackResist()
    absorbance_per_um: float = 0.5  # lumped Dill A + B, 1/um
    nz: int = 8
    substrate_reflectivity: float = 0.0  # intensity reflectance R of substrate
    n_resist: float = 1.7               # resist refractive index
    wavelength_nm: float = 193.0        # exposure wavelength (standing waves)
    peb_diffusion_nm: float = 0.0       # post-exposure-bake 1-sigma diffusion
    # Surface inhibition (Mack ch. 7): the development rate near the resist
    # top is suppressed to ``surface_rate_factor`` of bulk, relaxing over
    # ``inhibition_depth_nm``: r(m, z) = r(m) (1 - (1 - f) exp(-z / delta)).
    surface_rate_factor: float = 1.0    # 1.0 disables
    inhibition_depth_nm: float = 0.0
    # Etch-rate anisotropy: the lateral rate is ``lateral_rate_factor`` x
    # the vertical rate, with an extra surface term
    # ``lateral_surface_factor`` relaxing over ``inhibition_depth_nm``;
    # enters the eikonal solve only (the vertical chain is unaffected).
    lateral_rate_factor: float = 1.0    # bulk lateral/vertical ratio
    lateral_surface_factor: float = 1.0  # extra lateral suppression at z=0

    def rigorous(self) -> "DepthResist":
        """A copy with the analytic depth attenuation disabled, for latent
        images from the rigorous film-stack imager
        (:func:`...simulate.film_stack_images`), whose stack already carries
        the absorption and the exact standing waves."""
        return dataclasses.replace(
            self, absorbance_per_um=0.0, substrate_reflectivity=0.0)

    def lateral_factor_profile(self) -> np.ndarray | None:
        """(nz,) lateral/vertical rate ratio at slab depths, or None when
        isotropic (both knobs at 1)."""
        bulk = self.lateral_rate_factor
        surf = self.lateral_surface_factor
        if bulk >= 1.0 and surf >= 1.0:
            return None
        profile = np.full(self.nz, bulk)
        if surf < 1.0 and self.inhibition_depth_nm > 0.0:
            profile = profile * (1.0 - (1.0 - surf) * np.exp(
                -self.depths_nm / self.inhibition_depth_nm))
        elif surf < 1.0:
            # no relaxation depth given: uniform extra suppression
            profile = profile * surf
        return profile

    def rate_depth_factor(self) -> np.ndarray:
        """(nz,) multiplicative development-rate factor at slab depths."""
        if self.surface_rate_factor >= 1.0 or self.inhibition_depth_nm <= 0.0:
            return np.ones(self.nz)
        return 1.0 - (1.0 - self.surface_rate_factor) * np.exp(
            -self.depths_nm / self.inhibition_depth_nm)

    def _rate(self, m: torch.Tensor) -> torch.Tensor:
        """(nz, n, n) development rate with the surface-inhibition profile."""
        rate = self.mack.development_rate(m)
        factor = self.rate_depth_factor()
        if (factor != 1.0).any():
            rate = rate * torch.as_tensor(factor, dtype=rate.dtype,
                                          device=rate.device)[:, None, None]
        return rate

    @property
    def depths_nm(self) -> np.ndarray:
        """Slab-center depths below the resist top, (nz,)."""
        dz = self.mack.thickness_nm / self.nz
        return (np.arange(self.nz) + 0.5) * dz

    def film_defocus_nm(self, *, n_resist: float | None = None,
                        best_focus_nm: float = 0.0) -> np.ndarray:
        """Defocus values (nm) to image each slab at: optical path inside the
        film scales by 1/n_resist, zeroed at mid-film + ``best_focus_nm``."""
        mid = self.mack.thickness_nm / 2.0
        n_r = self.n_resist if n_resist is None else n_resist
        return best_focus_nm + (self.depths_nm - mid) / n_r

    def depth_profile(self) -> np.ndarray:
        """(nz,) relative intensity D(z) at the slab centers: Beer-Lambert
        attenuation plus the substrate standing wave, normalized to D(0)=1."""
        a = self.absorbance_per_um * 1e-3  # 1/nm
        t_film = self.mack.thickness_nm
        rho = np.sqrt(max(self.substrate_reflectivity, 0.0))

        def d_of(z):
            return (np.exp(-a * z)
                    + rho * rho * np.exp(-a * (2.0 * t_film - z))
                    + 2.0 * rho * np.exp(-a * t_film)
                    * np.cos(4.0 * np.pi * self.n_resist
                             * (t_film - z) / self.wavelength_nm))

        return d_of(self.depths_nm) / d_of(0.0)

    def _peb_blur(self, m: torch.Tensor,
                  pixel_size_nm: float | None) -> torch.Tensor:
        """3-D Gaussian PEB diffusion of the latent image m: FFT blur
        laterally (periodic, the imaging engine's circular convention), a
        truncated, row-normalized dense kernel through depth (zero-flux
        film boundaries preserve a uniform m). The depth contraction is a
        float32 matmul (TF32 is off)."""
        sigma = self.peb_diffusion_nm
        if sigma <= 0.0:
            return m
        if pixel_size_nm is None:
            raise ValueError(
                "peb_diffusion_nm > 0 needs pixel_size_nm to scale the "
                "lateral blur (pass it to latent/arrival_times/...)")
        transfer = torch.as_tensor(
            gaussian_transfer(m.shape[-1], pixel_size_nm, sigma),
            dtype=torch.float32, device=m.device)
        m = torch.fft.ifft2(torch.fft.fft2(m) * transfer).real
        z = self.depths_nm
        k = np.exp(-((z[:, None] - z[None, :]) ** 2) / (2.0 * sigma**2))
        k /= k.sum(axis=1, keepdims=True)
        k = torch.as_tensor(k, dtype=torch.float32, device=m.device)
        return torch.einsum("kz,zij->kij", k, m)

    def latent(self, image_stack, dose: float = 1.0, *,
               normalize: bool = True, pixel_size_nm: float | None = None,
               device=None) -> torch.Tensor:
        """(nz, n, n) remaining photo-active compound m (after PEB if
        ``peb_diffusion_nm`` > 0, which needs ``pixel_size_nm``)."""
        stack = _f32(image_stack, device)
        if stack.ndim == 2:
            stack = stack.expand(self.nz, *stack.shape)
        if stack.shape[0] != self.nz:
            raise ValueError(
                f"image stack has {stack.shape[0]} planes, expected nz={self.nz}")
        if normalize:
            stack = _normalized(stack)
        atten = torch.as_tensor(self.depth_profile(), dtype=stack.dtype,
                                device=stack.device)
        stack = stack * atten[:, None, None]
        m = torch.exp(-self.mack.dill_c * dose * 100.0 * stack)
        return self._peb_blur(m, pixel_size_nm)

    def cleared_depth_nm(self, image_stack, dose: float = 1.0, *,
                         normalize: bool = True,
                         pixel_size_nm: float | None = None,
                         device=None) -> torch.Tensor:
        """(n, n) etch-front depth after ``mack.develop_s`` of development
        (vertical propagation: each column etches independently)."""
        m = self.latent(image_stack, dose, normalize=normalize,
                        pixel_size_nm=pixel_size_nm, device=device)
        rate = self._rate(m)  # (nz, n, n), nm/s
        dz = self.mack.thickness_nm / self.nz
        dt = dz / rate  # time to etch through each slab
        t_bottom = torch.cumsum(dt, dim=0)
        t_top = t_bottom - dt
        frac = _clip((self.mack.develop_s - t_top) / dt, 0.0, 1.0)
        return dz * torch.sum(frac, dim=0)

    # -- lateral development (eikonal front propagation) ----------------------

    def _arrival_and_rate(self, image_stack, dose: float, *,
                          pixel_size_nm: float, iterations: int | None,
                          normalize: bool, device):
        from ..ops.eikonal import arrival_times as _eikonal

        m = self.latent(image_stack, dose, normalize=normalize,
                        pixel_size_nm=pixel_size_nm, device=device)
        rate = self._rate(m)  # (nz, n, n), nm/s
        dz = self.mack.thickness_nm / self.nz
        if iterations is None:
            iterations = self.nz + 48
        t = _eikonal(1.0 / rate, (dz, pixel_size_nm, pixel_size_nm),
                     iterations=iterations,
                     lateral_factor=self.lateral_factor_profile())
        return t, rate

    def arrival_times(self, image_stack, dose: float = 1.0, *,
                      pixel_size_nm: float, iterations: int | None = None,
                      normalize: bool = True, device=None) -> torch.Tensor:
        """(nz, n, n) etch-front arrival time (s) at each slab bottom, by the
        eikonal model |grad t| = 1/r, lateral etch and undercut included.
        ``iterations`` bounds the front's travel in cells (default nz + 48;
        unconverged voxels hold upper bounds). With laterally uniform rates
        this equals cumsum(dz / r)."""
        return self._arrival_and_rate(
            image_stack, dose, pixel_size_nm=pixel_size_nm,
            iterations=iterations, normalize=normalize, device=device)[0]

    def develop_profile(self, image_stack, dose: float = 1.0, *,
                        pixel_size_nm: float, iterations: int | None = None,
                        steepness: float = 5.0, normalize: bool = True,
                        device=None) -> torch.Tensor:
        """(nz, n, n) differentiable cleared fraction in [0, 1] per voxel
        (1 = resist removed) after ``mack.develop_s`` of 3-D development."""
        t = self.arrival_times(image_stack, dose, pixel_size_nm=pixel_size_nm,
                               iterations=iterations, normalize=normalize,
                               device=device)
        return torch.sigmoid(steepness * (self.mack.develop_s - t))

    def develop_profile_binary(self, image_stack, dose: float = 1.0, *,
                               pixel_size_nm: float,
                               iterations: int | None = None,
                               normalize: bool = True,
                               device=None) -> torch.Tensor:
        t = self.arrival_times(image_stack, dose, pixel_size_nm=pixel_size_nm,
                               iterations=iterations, normalize=normalize,
                               device=device)
        return (t <= self.mack.develop_s).to(torch.float32)

    def cleared_depth_nm_lateral(self, image_stack, dose: float = 1.0, *,
                                 pixel_size_nm: float,
                                 iterations: int | None = None,
                                 normalize: bool = True,
                                 device=None) -> torch.Tensor:
        """(n, n) per-column removed thickness under 3-D development, voids
        included: per-slab occupancy with the slab's local fill time dz/r
        (a slab reached laterally or from below counts even when the slab
        above it is never cleared)."""
        t_bottom, rate = self._arrival_and_rate(
            image_stack, dose, pixel_size_nm=pixel_size_nm,
            iterations=iterations, normalize=normalize, device=device)
        dz = self.mack.thickness_nm / self.nz
        dt_slab = dz / rate
        frac = _clip((self.mack.develop_s - (t_bottom - dt_slab)) / dt_slab,
                     0.0, 1.0)
        return dz * torch.sum(frac, dim=0)

    def height_map_nm(self, image_stack, dose: float = 1.0, *,
                      normalize: bool = True,
                      pixel_size_nm: float | None = None,
                      device=None) -> torch.Tensor:
        """(n, n) remaining resist thickness after development."""
        return self.mack.thickness_nm - self.cleared_depth_nm(
            image_stack, dose, normalize=normalize,
            pixel_size_nm=pixel_size_nm, device=device)

    def develop(self, image_stack, dose: float = 1.0, *,
                steepness: float = 0.2, normalize: bool = True,
                pixel_size_nm: float | None = None,
                device=None) -> torch.Tensor:
        """Differentiable cleared-to-substrate fraction in [0, 1]."""
        depth = self.cleared_depth_nm(image_stack, dose, normalize=normalize,
                                      pixel_size_nm=pixel_size_nm,
                                      device=device)
        return torch.sigmoid(
            steepness * (depth - (1.0 - 1e-6) * self.mack.thickness_nm))

    def develop_binary(self, image_stack, dose: float = 1.0, *,
                       normalize: bool = True,
                       pixel_size_nm: float | None = None,
                       device=None) -> torch.Tensor:
        depth = self.cleared_depth_nm(image_stack, dose, normalize=normalize,
                                      pixel_size_nm=pixel_size_nm,
                                      device=device)
        return (depth >= (1.0 - 1e-6) * self.mack.thickness_nm).to(torch.float32)


def swing_curve(thicknesses_nm, resist: DepthResist, *, device,
                dose_hi: float = 64.0, iters: int = 24,
                wafer_stack=None, immersion_index: float = 1.0) -> dict:
    """E0 (dose-to-clear) swing curve vs resist film thickness, on
    ``device``. For each thickness the film's depth profile is rebuilt and
    the dose-to-clear found by bisection on the vertical develop under
    uniform unit exposure. ``wafer_stack`` (a
    :class:`..ops.filmstack.WaferStack`, resist thickness overridden per
    point) takes the exposure profile from the rigorous open-frame Airy
    solution instead of the analytic D(z); ``immersion_index`` sets the
    medium above the resist for that path.

    Returns ``{"thickness_nm", "dose_to_clear", "swing_ratio",
    "period_nm_theory"}``; ``swing_ratio`` = (max - min) / mean of the
    detrended curve."""
    thicknesses = np.asarray(thicknesses_nm, np.float64)
    doses = []
    flat = torch.ones((2, 2), dtype=torch.float32, device=device)
    if wafer_stack is not None:
        from ..ops.filmstack import open_frame_profile

        # minimal config: open_frame_profile only reads wavelength and the
        # top-medium index from it
        probe_config = OpticsConfig(pixel_number=8,
                                    wavelength=resist.wavelength_nm,
                                    immersion_index=float(immersion_index))
    for t_film in thicknesses:
        r = dataclasses.replace(
            resist, mack=dataclasses.replace(resist.mack,
                                             thickness_nm=float(t_film)))
        if wafer_stack is None:
            exposure = flat
        else:
            stack_t = dataclasses.replace(wafer_stack,
                                          thickness_nm=float(t_film))
            profile = open_frame_profile(stack_t, probe_config, r.depths_nm,
                                         normalize=False)
            r = r.rigorous()  # profile already carries the attenuation
            exposure = torch.as_tensor(profile, dtype=torch.float32,
                                       device=device)[:, None, None] * flat

        def cleared(dose):
            return float(r.cleared_depth_nm(exposure, dose, normalize=False)[0, 0])

        lo, hi = 0.0, dose_hi
        if cleared(hi) < t_film - 1e-6:
            doses.append(np.nan)  # not clearable within the dose bracket
            continue
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            if cleared(mid) >= t_film:
                hi = mid
            else:
                lo = mid
        doses.append(0.5 * (lo + hi))
    doses = np.asarray(doses)
    good = np.isfinite(doses)
    if good.sum() >= 3:
        # detrend (absorption makes E0 grow with thickness) then measure
        # the oscillation amplitude
        coef = np.polyfit(thicknesses[good], doses[good], 1)
        resid = doses[good] - np.polyval(coef, thicknesses[good])
        mean = float(doses[good].mean())
        swing = float((resid.max() - resid.min()) / mean) if mean > 0 else 0.0
    else:
        swing = 0.0
    return {
        "thickness_nm": thicknesses,
        "dose_to_clear": doses,
        "swing_ratio": swing,
        "period_nm_theory": resist.wavelength_nm / (2.0 * resist.n_resist),
    }


def _bias_mask(geom: np.ndarray, px: int) -> np.ndarray:
    """Horizontal +-px edge bias (the mask perturbation MEEF differentiates
    against), zero-filled at the field boundary."""
    def shift0(g, s):
        out = np.zeros_like(g)
        if s > 0:
            out[:, s:] = g[:, :-s]
        elif s < 0:
            out[:, :s] = g[:, -s:]
        else:
            out[:] = g
        return out

    out = geom.copy()
    for _ in range(abs(px)):
        if px > 0:  # dilate horizontally (wider lines)
            out = np.maximum(out, np.maximum(shift0(out, 1), shift0(out, -1)))
        elif px < 0:  # erode (features at the field edge shrink)
            out = np.minimum(out, np.minimum(shift0(out, 1), shift0(out, -1)))
    return out


def meef(mask_geometry, image_fn, config: OpticsConfig, model: ResistModel, *,
         bias_px: int = 1) -> float:
    """Mask Error Enhancement Factor: d(printed CD)/d(mask CD), by central
    finite difference of a +-``bias_px`` edge bias on the mask's vertical
    features. ``image_fn(geometry) -> aerial image`` (a tensor) is the
    caller's imaging pipeline."""
    geom = _host(mask_geometry)
    cds = []
    for px in (-bias_px, bias_px):
        profile = model.develop_binary(image_fn(_bias_mask(geom, px)), config)
        cds.append(critical_dimension(profile, config))
    mask_delta_nm = 4 * bias_px * config.pixel_size  # both edges, both signs
    if mask_delta_nm == 0:
        return 0.0
    return float((cds[1] - cds[0]) / mask_delta_nm)


def meef_table(mask_geometry, image_fn, config: OpticsConfig,
               model: ResistModel, *, bias_px: int = 1, axis: int = 1,
               row_step: int | None = None, map_blocks: int | None = 16,
               max_match_nm: float | None = None) -> dict:
    """Per-feature MEEF across the whole chip + a per-region MEEF map: the
    +-bias_px prints are feature-extracted, features matched between them
    by (cut line, nearest center), and each pair's finite difference
    aggregated into mean / sigma / max and a ``(map_blocks, map_blocks)``
    map (NaN where no feature)."""
    geom = _host(mask_geometry)
    n = geom.shape[0]
    if row_step is None:
        row_step = max(1, n // 512)
    px_nm = config.pixel_size
    if max_match_nm is None:
        max_match_nm = (2 * bias_px + 2) * px_nm
    tables = {}
    for px in (-bias_px, bias_px):
        profile = model.develop_binary(image_fn(_bias_mask(geom, px)), config)
        tables[px] = feature_table(profile, config, axis=axis,
                                   row_step=row_step)
    minus, plus = tables[-bias_px], tables[bias_px]
    mask_delta_nm = 4 * bias_px * px_nm
    rows_m, rows_p = minus["row"], plus["row"]
    vals, v_rows, v_centers = [], [], []
    for r in np.unique(rows_m):
        sel_m = rows_m == r
        sel_p = rows_p == r
        if not sel_p.any():
            continue
        cm, wm = minus["center_nm"][sel_m], minus["width_nm"][sel_m]
        cp, wp = plus["center_nm"][sel_p], plus["width_nm"][sel_p]
        order = np.argsort(cp)
        cp, wp = cp[order], wp[order]
        idx = np.clip(np.searchsorted(cp, cm), 0, len(cp) - 1)
        idx_lo = np.maximum(idx - 1, 0)
        pick = np.where(np.abs(cp[idx] - cm) <= np.abs(cp[idx_lo] - cm),
                        idx, idx_lo)
        good = np.abs(cp[pick] - cm) <= max_match_nm
        vals.append((wp[pick][good] - wm[good]) / mask_delta_nm)
        v_rows.append(np.full(int(good.sum()), r))
        v_centers.append(cm[good])
    if not vals or sum(v.size for v in vals) == 0:
        return {"count": 0, "mean_meef": 0.0, "sigma_meef": 0.0,
                "max_meef": 0.0, "axis": axis}
    vals = np.concatenate(vals)
    v_rows = np.concatenate(v_rows)
    v_centers = np.concatenate(v_centers)
    out = {
        "count": int(vals.size),
        "mean_meef": float(vals.mean()),
        "sigma_meef": float(vals.std()),
        "max_meef": float(vals.max()),
        "axis": axis,
    }
    if map_blocks:
        rows = v_rows.astype(float)
        cols = v_centers / px_nm
        if axis == 0:
            rows, cols = cols, rows
        out["meef_map"] = _block_map(rows, cols, vals, n, map_blocks)
    return out


def process_window(focus_exposure_cds, defocus_nm, doses, *,
                   target_cd_nm: float, tolerance: float = 0.10) -> dict:
    """Depth of focus and exposure latitude from a focus-exposure matrix:
    ``focus_exposure_cds[i][j]`` is the printed CD at ``defocus_nm[i]``,
    ``doses[j]``; a cell is in spec when its CD is within ``tolerance`` of
    ``target_cd_nm``. Returns the largest in-spec defocus range at any one
    dose (DoF) and the largest in-spec dose range at any one focus (EL)."""
    cds = np.asarray(focus_exposure_cds, np.float64)
    defocus_nm = np.asarray(defocus_nm, np.float64)
    doses = np.asarray(doses, np.float64)
    in_spec = np.abs(cds - target_cd_nm) <= tolerance * target_cd_nm

    def longest_true_span(flags, coords):
        best = 0.0
        i = 0
        while i < len(flags):
            if flags[i]:
                j = i
                while j + 1 < len(flags) and flags[j + 1]:
                    j += 1
                # abs(): supports descending defocus/dose sweeps too
                best = max(best, abs(float(coords[j] - coords[i])))
                i = j + 1
            else:
                i += 1
        return best

    dof = max((longest_true_span(in_spec[:, j], defocus_nm)
               for j in range(len(doses))), default=0.0)
    el = max((longest_true_span(in_spec[i, :], doses)
              for i in range(len(defocus_nm))), default=0.0)
    return {"depth_of_focus_nm": dof, "exposure_latitude": el,
            "in_spec_fraction": float(in_spec.mean())}
