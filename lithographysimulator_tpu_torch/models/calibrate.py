"""Resist model calibration: fit model parameters to measured gauge CDs.

Port of ``lithographysimulator_tpu/models/calibrate.py`` (numpy, as there),
bound to the port's :mod:`.resist`. Expose a set of gauge structures,
measure their CDs (CD-SEM), then fit the resist model's free parameters so
simulated CDs reproduce the measurements: for ``ResistModel`` (threshold,
diffusion) and ``MackResist`` (any of its float fields), against aerial
images from any solver path (a tensor is read back to the host).

Simulated gauge CDs are measured on the CONTINUOUS post-diffusion field
(subpixel threshold crossings via :func:`.resist.feature_table`), where the
CD is smooth in every model parameter, so the dependency-free Nelder-Mead
below converges in tens of iterations for 1-3 parameter fits.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import OpticsConfig
from .resist import (MackResist, ResistModel, _host, feature_table,
                     gaussian_transfer)

_DEFAULT_BOUNDS = {
    "threshold": (0.02, 0.95),
    "diffusion_nm": (0.0, 60.0),
    "steepness": (5.0, 500.0),
    # MackResist fields
    "dill_c": (0.005, 0.5),
    "r_max_nm_s": (5.0, 1000.0),
    "r_min_nm_s": (0.0, 10.0),
    "mack_n": (1.5, 16.0),
    "m_threshold": (0.05, 0.95),
    "thickness_nm": (20.0, 500.0),
    "develop_s": (1.0, 300.0),
}


def _nelder_mead(f, x0: np.ndarray, *, steps: np.ndarray, iters: int,
                 ftol: float) -> tuple[np.ndarray, float, int]:
    """Minimal dependency-free Nelder-Mead (reflection 1, expansion 2,
    contraction 0.5, shrink 0.5). Returns (x_best, f_best, evals)."""
    n = len(x0)
    simplex = [np.asarray(x0, np.float64)]
    for i in range(n):
        v = simplex[0].copy()
        v[i] += steps[i]
        simplex.append(v)
    vals = [f(v) for v in simplex]
    evals = n + 1
    for _ in range(iters):
        order = np.argsort(vals)
        simplex = [simplex[i] for i in order]
        vals = [vals[i] for i in order]
        if abs(vals[-1] - vals[0]) <= ftol:
            break
        centroid = np.mean(simplex[:-1], axis=0)
        xr = centroid + (centroid - simplex[-1])
        fr = f(xr)
        evals += 1
        if fr < vals[0]:
            xe = centroid + 2.0 * (centroid - simplex[-1])
            fe = f(xe)
            evals += 1
            simplex[-1], vals[-1] = (xe, fe) if fe < fr else (xr, fr)
        elif fr < vals[-2]:
            simplex[-1], vals[-1] = xr, fr
        else:
            xc = centroid + 0.5 * (simplex[-1] - centroid)
            fc = f(xc)
            evals += 1
            if fc < vals[-1]:
                simplex[-1], vals[-1] = xc, fc
            else:  # shrink toward the best vertex
                for i in range(1, n + 1):
                    simplex[i] = simplex[0] + 0.5 * (simplex[i] - simplex[0])
                    vals[i] = f(simplex[i])
                evals += n
    best = int(np.argmin(vals))
    return simplex[best], float(vals[best]), evals


def _blur_np(image: np.ndarray, diffusion_nm: float, px: float
             ) -> np.ndarray:
    """Gaussian diffusion blur in numpy on the host (the calibration loop
    evaluates the objective hundreds of times on small gauges); mirrors
    ResistModel.blur's frequency-domain transfer exactly."""
    if diffusion_nm <= 0.0:
        return image
    transfer = gaussian_transfer(image.shape[-1], px, diffusion_nm)
    return np.real(np.fft.ifft2(np.fft.fft2(image) * transfer))


def gauge_cd(model, image, config: OpticsConfig, *, axis: int = 1,
             row_step: int | None = None, cd_stat: str = "median",
             dose: float = 1.0) -> float:
    """Simulated CD (nm) of one gauge: subpixel threshold crossings of the
    model's continuous response field (smooth in the model parameters —
    see module docstring), in numpy on the host."""
    stat_fn = {"median": np.median, "mean": np.mean,
               "min": np.min, "max": np.max}[cd_stat]
    arr = np.asarray(_host(image), np.float64)
    if row_step is None:
        row_step = max(1, arr.shape[0] // 64)
    if isinstance(model, MackResist):
        # numpy mirror of MackResist.develop (real-valued, elementwise)
        inorm = arr / max(arr.max(), 1e-30)
        m = np.exp(-model.dill_c * dose * 100.0 * inorm)
        nn = model.mack_n
        a = (nn + 1.0) / (nn - 1.0) * (1.0 - model.m_threshold) ** nn
        one_minus = np.clip(1.0 - m, 0.0, 1.0)
        rate = (model.r_max_nm_s * (a + 1.0) * one_minus**nn
                / (a + one_minus**nn) + model.r_min_nm_s)
        depth = rate * model.develop_s
        field = 1.0 / (1.0 + np.exp(-0.2 * (depth - model.thickness_nm)))
        threshold = 0.5
    else:
        field = _blur_np(arr, float(model.diffusion_nm), config.pixel_size)
        field = field / max(field.max(), 1e-30)
        threshold = float(model.threshold)
    widths = feature_table(field, config, axis=axis, threshold=threshold,
                           row_step=row_step)["width_nm"]
    return float(stat_fn(widths)) if widths.size else 0.0


def calibrate_resist(images, measured_cd_nm, config: OpticsConfig, *,
                     model=None, fit=("threshold", "diffusion_nm"),
                     bounds: dict | None = None, axis: int = 1,
                     row_step: int | None = None, cd_stat: str = "median",
                     doses=None, iters: int = 150,
                     ftol_nm: float = 1e-4) -> dict:
    """Fit the named float fields of ``model`` so simulated gauge CDs match
    the measurements, in the least-squares (RMS) sense.

    images: aerial images, one per gauge (any solver output; normalized
    internally). measured_cd_nm: the measured CD per gauge. ``fit`` names
    dataclass fields of ``model`` (``ResistModel`` default: threshold +
    diffusion); everything else stays frozen. ``doses`` optionally gives a
    per-gauge dose (MackResist only). Bounds clip the search (defaults per
    field in ``_DEFAULT_BOUNDS``).

    Returns ``{"model": fitted model, "rms_nm", "cd_nm": per-gauge fitted
    CDs, "residual_nm": fitted - measured, "evals", "params"}``."""
    model = ResistModel() if model is None else model
    measured = np.asarray(measured_cd_nm, np.float64)
    images = [np.asarray(_host(im), np.float64) for im in images]
    if len(images) != measured.size:
        raise ValueError(
            f"{len(images)} gauge images vs {measured.size} measured CDs")
    if not fit:
        raise ValueError("fit must name at least one model field")
    field_names = {f.name for f in dataclasses.fields(model)}
    unknown = [name for name in fit if name not in field_names]
    if unknown:
        raise ValueError(f"unknown model field(s) {unknown}; "
                         f"model has {sorted(field_names)}")
    doses = ([1.0] * len(images) if doses is None
             else [float(d) for d in doses])
    lohi = np.asarray([(bounds or {}).get(name,
                                          _DEFAULT_BOUNDS.get(name,
                                                              (1e-6, 1e6)))
                       for name in fit], np.float64)

    def with_params(x) -> object:
        x = np.clip(x, lohi[:, 0], lohi[:, 1])
        return dataclasses.replace(
            model, **{name: float(v) for name, v in zip(fit, x)})

    def cds_for(m) -> np.ndarray:
        return np.asarray([
            gauge_cd(m, im, config, axis=axis, row_step=row_step,
                     cd_stat=cd_stat, dose=d)
            for im, d in zip(images, doses)])

    span = lohi[:, 1] - lohi[:, 0]

    def objective(x) -> float:
        # out-of-bounds distance is PENALIZED, not silently clipped — a
        # clipped-flat boundary stalls Nelder-Mead (the simplex collapses
        # against it: every out-of-bounds reflection looks identical)
        overshoot = np.maximum(lohi[:, 0] - x, 0) + np.maximum(
            x - lohi[:, 1], 0)
        resid = cds_for(with_params(x)) - measured
        return float(np.sqrt(np.mean(resid**2))
                     + 100.0 * np.sum(overshoot / span))

    x0 = np.asarray([float(getattr(model, name)) for name in fit])
    x0 = np.clip(x0, lohi[:, 0], lohi[:, 1])
    evals = 0
    x_best, f_best = x0, np.inf
    # restarts re-seed the simplex around the incumbent: one Nelder-Mead
    # run can converge prematurely after a shrink cascade; a fresh simplex
    # at the incumbent escapes or confirms cheaply (few-param fits)
    for restart in range(4):
        steps = np.maximum((0.10 if restart == 0 else 0.03) * span, 1e-3)
        x_new, f_new, ev = _nelder_mead(objective, x_best, steps=steps,
                                        iters=iters, ftol=ftol_nm)
        evals += ev
        improved = f_new < f_best - ftol_nm
        if f_new < f_best:
            x_best, f_best = x_new, f_new
        if not improved and restart > 0:
            break
    fitted = with_params(x_best)
    cds = cds_for(fitted)
    return {
        "model": fitted,
        "rms_nm": float(np.sqrt(np.mean((cds - measured) ** 2))),
        "cd_nm": cds,
        "residual_nm": cds - measured,
        "evals": evals,
        "params": {name: float(getattr(fitted, name)) for name in fit},
    }
