"""Plain PyTorch reference of a stochastic resist's Monte-Carlo ensemble:
the photon draws as data, everything after them in float64.

The model, written from its definition and not from the program:

* **The draws.** Trial ``i`` of an ensemble seeded ``s`` draws from a
  ``torch.Generator`` seeded with the first 64-bit word of NumPy's
  ``SeedSequence([s mod 2^64, i])``. The absorbed photons of a pixel are
  ``Poisson(dose * A_px * I / max I)``, the mean formed in float32 from the
  image the program imaged, on its device, so the program and this
  reference draw the same counts.
* **The chain** (float64 unless a caller asks for less): acids
  ``QE * N``; with a photo-acid generator of ``pag`` a pixel, its depletion
  ``pag (1 - exp(-acid / pag))``; over the same of the dose at intensity 1,
  so that an unexposed-to-saturated scale runs from 0 to 1; the periodic
  Gaussian blur of the acid's diffusion (transfer
  ``exp(-2 pi^2 sigma^2 (f_x^2 + f_y^2))``); the printed contour where the
  field exceeds the threshold. The deterministic field is the blur of
  ``I / max I``.
* **Edges.** Along each cut line (every ``row_step``-th row; the lines
  run along y), every run above the threshold has a rising and a falling
  edge at the linearly interpolated crossing; a run that starts at the
  clip's first pixel starts half a pixel before it, one that ends at its
  last pixel ends half a pixel after it. A run's width is fall - rise, its
  centre their mean.
* **Tracking.** The lines are the deterministic field's: the centres of
  its runs on the cut lines, sorted and split where two neighbours lie
  farther apart than the larger of their median width and two pixels; a
  line is the mean of its cluster. Each run of a trial belongs to the
  nearest line. A line with fewer runs in a trial than an eighth of the
  ``R`` cut lines (and at least 4) is a fragment there, and is left out
  of that trial's LER and LWR.
* **Statistics.** A trial's LER is the mean over its lines of 3 sigma of
  each edge's positions (both edges), its LWR the mean of 3 sigma of the
  widths, its mean CD the mean width of all its runs (0 where nothing
  prints); the ensemble's LER, LWR and mean CD are the means over the
  trials that have them, its LCDU 3 sigma of the trials' mean CDs (sigma
  with ``ddof`` 0 throughout). Bridges and breaks: on every row of the
  contour, fewer (a bridge) or more (a break) runs than the deterministic
  contour has, over the rows where that one prints and the trials. The
  print probability is the share of trials that print a pixel.
* **The edge PSD** (Mack's convention): over the longest interval of cut
  lines on which the deterministic field prints all of its lines, each
  line of a trial with a run on every cut line of the interval gives two
  traces (rise and fall, in nm; on a cut line with several runs, the one
  nearest the median centre of the line's runs); ``PSD_k = 2 d
  |DFT(x - mean x)_k|^2 / R`` at ``f_k = k / (R d)``, ``k = 1 .. R/2``
  (the Nyquist bin halved for even ``R``), ``d`` the cut lines' spacing;
  averaged over the traces; ``sigma = sqrt(sum PSD / (R d))``.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

F64 = torch.float64


def trial_seed(seed: int, trial: int) -> int:
    """The generator seed of trial ``trial`` of an ensemble seeded ``seed``."""
    state = np.random.SeedSequence([int(seed) % 2**64, int(trial)])
    return int(state.generate_state(1, np.uint64)[0])


def photon_mean(image: torch.Tensor, resist: dict, pixel_nm: float) -> torch.Tensor:
    """The float32 mean photon count of each pixel, on the image's device."""
    img = image.to(torch.float32)
    rel = img / torch.clamp_min(torch.max(img), 1e-30)
    return (resist["dose_photons_per_nm2"] * pixel_nm ** 2) * rel


def draw(mean: torch.Tensor, seed: int, trial: int) -> torch.Tensor:
    """Trial ``trial``'s photon counts (float32)."""
    gen = torch.Generator(device=mean.device)
    gen.manual_seed(trial_seed(seed, trial))
    return torch.poisson(mean[None], generator=gen)[0]


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` held in ``dtype``; float16 is computed in float32 and rounded
    to float16 after each step (the transforms have no float16 path for
    every size)."""
    if dtype == torch.float16:
        return x.to(torch.float16).to(torch.float32)
    return x.to(dtype)


def blur(x: torch.Tensor, pixel_nm: float, sigma_nm: float,
         dtype=F64) -> torch.Tensor:
    """The periodic Gaussian blur of 1-sigma ``sigma_nm`` over the last two
    axes."""
    if sigma_nm <= 0:
        return x
    work = F64 if dtype == F64 else torch.float32
    h, w = x.shape[-2:]
    fy = torch.fft.fftfreq(h, d=pixel_nm, dtype=work, device=x.device)
    fx = torch.fft.fftfreq(w, d=pixel_nm, dtype=work, device=x.device)
    transfer = torch.exp(-2.0 * (math.pi * sigma_nm) ** 2
                         * (fx[None, :] ** 2 + fy[:, None] ** 2))
    out = torch.fft.ifft2(torch.fft.fft2(x.to(work)) * transfer).real
    return _rounded(out, dtype)


def deprotection(counts: torch.Tensor, resist: dict, pixel_nm: float,
                 dtype=F64) -> torch.Tensor:
    """The blurred deprotection field of one trial's photon counts."""
    area = pixel_nm ** 2
    qe = resist["quantum_efficiency"]
    acid = _rounded(qe * counts.to(F64), dtype)
    full = resist["dose_photons_per_nm2"] * area * qe
    pag = resist["pag_per_nm2"] * area
    if pag > 0:
        acid = _rounded(-pag * torch.expm1(-acid / pag), dtype)
        full = -pag * math.expm1(-full / pag)
    return blur(_rounded(acid / full, dtype), pixel_nm, resist["diffusion_nm"],
                dtype)


def deterministic(image: torch.Tensor, resist: dict, pixel_nm: float,
                  dtype=F64) -> torch.Tensor:
    """The zero-noise field: the blur of ``I / max I``."""
    img = image.to(F64)
    return blur(_rounded(img / img.max(), dtype), pixel_nm,
                resist["diffusion_nm"], dtype)


def runs(lines: torch.Tensor, threshold: float) -> dict:
    """Every run above ``threshold`` along the last axis of (R, n)
    ``lines``: ``line`` (index), ``rise``, ``fall`` (px), as numpy."""
    f = lines.to(F64)
    n = f.shape[-1]
    above = F.pad((f > threshold).to(torch.int8), (1, 1))
    step = above[:, 1:] - above[:, :-1]  # (R, n + 1)
    r_s, s = torch.nonzero(step == 1, as_tuple=True)  # first pixel of a run
    r_e, e = torch.nonzero(step == -1, as_tuple=True)  # one past its last
    prev, cur = f[r_s, (s - 1).clamp(min=0)], f[r_s, s.clamp(max=n - 1)]
    rise = torch.where(s > 0, s - 1 + (threshold - prev) / (cur - prev), s - 0.5)
    last, nxt = f[r_e, (e - 1).clamp(min=0)], f[r_e, e.clamp(max=n - 1)]
    fall = torch.where(e < n, e - 1 + (last - threshold) / (last - nxt), e - 0.5)
    return {"line": r_s.cpu().numpy(), "rise": rise.cpu().numpy(),
            "fall": fall.cpu().numpy()}


def run_counts(contour: torch.Tensor) -> torch.Tensor:
    """Runs a row of a boolean (..., n) contour."""
    c = contour.to(torch.int8)
    return c[..., 0].to(torch.int64) + (c[..., 1:] > c[..., :-1]).sum(-1)


def line_centres(det_lines: torch.Tensor, threshold: float,
                 pixel_nm: float) -> np.ndarray | None:
    """The deterministic field's lines: cluster means of its runs' centres
    (nm) on the cut lines, or None where nothing prints."""
    r = runs(det_lines, threshold)
    if r["line"].size == 0:
        return None
    centres = np.sort(0.5 * (r["rise"] + r["fall"]) * pixel_nm)
    gap = max(float(np.median((r["fall"] - r["rise"]) * pixel_nm)), 2.0 * pixel_nm)
    breaks = np.flatnonzero(np.diff(centres) > gap) + 1
    return np.array([c.mean() for c in np.split(centres, breaks)])


def nearest(centres_nm: np.ndarray, lines_nm: np.ndarray) -> np.ndarray:
    """Index of the nearest line of each centre."""
    return np.abs(centres_nm[:, None] - lines_nm[None, :]).argmin(axis=1)


def _std_by(ids: np.ndarray, x: np.ndarray, groups: int) -> np.ndarray:
    count = np.bincount(ids, minlength=groups)
    mean = np.bincount(ids, x, minlength=groups) / np.maximum(count, 1)
    return np.sqrt(np.bincount(ids, (x - mean[ids]) ** 2, minlength=groups)
                   / np.maximum(count, 1))


def trial_edges(r: dict, lines_nm: np.ndarray, cut_lines: int,
                pixel_nm: float) -> tuple[float, float, float]:
    """(LER, LWR, mean CD) of one trial's runs."""
    if r["line"].size == 0:
        return math.nan, math.nan, 0.0
    rise, fall = r["rise"] * pixel_nm, r["fall"] * pixel_nm
    width = fall - rise
    ids = nearest(0.5 * (rise + fall), lines_nm)
    g = len(lines_nm)
    tracked = np.bincount(ids, minlength=g) >= max(4, cut_lines // 8)
    if not tracked.any():
        return math.nan, math.nan, float(width.mean())
    ler = np.concatenate([3.0 * _std_by(ids, rise, g)[tracked],
                          3.0 * _std_by(ids, fall, g)[tracked]]).mean()
    lwr = (3.0 * _std_by(ids, width, g)[tracked]).mean()
    return float(ler), float(lwr), float(width.mean())


def psd_interval(det_lines: torch.Tensor, threshold: float, pixel_nm: float,
                 lines_nm: np.ndarray) -> tuple[int, int] | None:
    """The longest interval of cut lines [lo, hi] on which the
    deterministic field prints the most lines it prints on any."""
    r = runs(det_lines, threshold)
    if r["line"].size == 0:
        return None
    ids = nearest(0.5 * (r["rise"] + r["fall"]) * pixel_nm, lines_nm)
    cover = np.zeros((len(lines_nm), det_lines.shape[0]), bool)
    cover[ids, r["line"]] = True
    count = cover.sum(axis=0)
    best, lo = (0, 0, 0), None
    for k, good in enumerate(np.append(count == count.max(), False)):
        if good and lo is None:
            lo = k
        elif not good and lo is not None:
            if k - lo > best[0]:
                best = (k - lo, lo, k - 1)
            lo = None
    return best[1], best[2]


def edge_traces(r: dict, lines_nm: np.ndarray, cut_lines: int,
                pixel_nm: float) -> list[np.ndarray]:
    """Rise and fall traces (nm, one value a cut line) of every line with a
    run on each of ``cut_lines``; the run nearest the line's median centre
    where a cut line has several."""
    if r["line"].size == 0:
        return []
    centre = 0.5 * (r["rise"] + r["fall"]) * pixel_nm
    ids = nearest(centre, lines_nm)
    out = []
    for g in np.unique(ids):
        sel = np.flatnonzero(ids == g)
        at = r["line"][sel]
        if np.unique(at).size != cut_lines:
            continue
        dist = np.abs(centre[sel] - np.median(centre[sel]))
        order = np.lexsort((dist, at))  # by cut line, then distance
        first = np.append(True, at[order][1:] != at[order][:-1])
        pick = sel[order[first]]
        out.append(r["rise"][pick] * pixel_nm)
        out.append(r["fall"][pick] * pixel_nm)
    return out


def psd_of(traces: list[np.ndarray], spacing_nm: float) -> np.ndarray:
    """Summed one-sided PSD (nm^3, DC left out) of equal-length traces."""
    r = len(traces[0])
    x = np.stack(traces)
    spec = np.abs(np.fft.rfft(x - x.mean(axis=1, keepdims=True), axis=1)
                  [:, 1:r // 2 + 1]) ** 2
    psd = 2.0 * spacing_nm * spec / r
    if r % 2 == 0:
        psd[:, -1] *= 0.5
    return psd.sum(axis=0)


def ensemble(image: torch.Tensor, cfg: dict, *, seed: int, trials: int,
             row_step: int | None = None, psd: bool = True,
             dtype=F64) -> dict:
    """The ensemble's outputs for the program's image ``image`` (n, n) on
    its device: ``ler_nm``, ``lwr_nm``, ``lcdu_nm``, ``mean_cd_nm``,
    ``deterministic_cd_nm``, ``bridge_rate``, ``break_rate``,
    ``print_probability`` (float64 numpy), ``lines`` and,
    with ``psd``, ``psd`` (``psd_nm3``, ``sigma_nm``, ``n_edges``).
    Cut lines along rows (lines along y)."""
    resist, px = cfg["resist"], cfg["pixel_nm"]
    thr = resist["threshold"]
    n = image.shape[-1]
    row_step = row_step or max(1, n // 512)
    det = deterministic(image, resist, px, dtype)
    det_lines = det[::row_step]
    cut = det_lines.shape[0]
    lines_nm = line_centres(det_lines, thr, px)
    if lines_nm is None:
        raise ValueError("the deterministic field prints nothing")
    d = runs(det_lines, thr)
    det_cd = float(((d["fall"] - d["rise"]) * px).mean())
    ref_runs = run_counts(det > thr)
    live = ref_runs > 0
    interval = psd_interval(det_lines, thr, px, lines_nm) if psd else None
    mean = photon_mean(image, resist, px)
    band = torch.zeros((n, n), dtype=F64, device=image.device)
    bridged = broken = 0
    lers, lwrs, cds, psd_sum, edges = [], [], [], None, 0
    for i in range(trials):
        field = deprotection(draw(mean, seed, i), resist, px, dtype)
        contour = field > thr
        band += contour
        k = run_counts(contour)
        bridged += int((k[live] < ref_runs[live]).sum())
        broken += int((k[live] > ref_runs[live]).sum())
        r = runs(field[::row_step], thr)
        ler, lwr, cd = trial_edges(r, lines_nm, cut, px)
        lers.append(ler), lwrs.append(lwr), cds.append(cd)
        if interval is not None and interval[1] - interval[0] + 1 >= 8:
            lo, hi = interval
            sel = (r["line"] >= lo) & (r["line"] <= hi)
            part = {"line": r["line"][sel] - lo, "rise": r["rise"][sel],
                    "fall": r["fall"][sel]}
            traces = edge_traces(part, lines_nm, hi - lo + 1, px)
            if traces:
                s = psd_of(traces, px * row_step)
                psd_sum = s if psd_sum is None else psd_sum + s
                edges += len(traces)
    cells = int(live.sum()) * trials
    out = {"ler_nm": float(np.nanmean(lers)), "lwr_nm": float(np.nanmean(lwrs)),
           "lcdu_nm": 3.0 * float(np.nanstd(cds)),
           "mean_cd_nm": float(np.nanmean(cds)), "deterministic_cd_nm": det_cd,
           "bridge_rate": bridged / cells if cells else 0.0,
           "break_rate": broken / cells if cells else 0.0,
           "print_probability": (band / trials).cpu().numpy(),
           "lines": len(lines_nm), "trials": trials}
    if psd:
        if psd_sum is None:
            out["psd"] = {"psd_nm3": None, "sigma_nm": math.nan, "n_edges": 0}
        else:
            rows = interval[1] - interval[0] + 1
            avg = psd_sum / edges
            out["psd"] = {"psd_nm3": avg, "n_edges": edges,
                          "sigma_nm": math.sqrt(avg.sum() / (rows * px * row_step))}
    return out
