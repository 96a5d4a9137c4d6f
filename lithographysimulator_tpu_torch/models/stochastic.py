"""Stochastic resist: photon shot noise, acid statistics, LER/LWR/LCDU and
stochastic defect rates from Monte-Carlo printed-contour ensembles.

Port of ``lithographysimulator_tpu/models/stochastic.py``. The chain per
trial, on the image's device:

    relative image I(x)
      -> absorbed photons  N(x) ~ Poisson(dose * A_px * I(x))
      -> generated acids   a(x) = QE * N(x), optionally PAG-depletion
         saturated a -> PAG * (1 - exp(-a / PAG))
      -> acid diffusion    Gaussian FFT blur (sigma = diffusion_nm)
      -> develop           threshold -> binary contour

Random streams: trial ``i`` of an ensemble seeded ``seed`` draws from its
own ``torch.Generator``, seeded from ``(seed, i)`` (:func:`trial_generator`),
and runs the chain by itself (a batch-1 FFT). So a trial's field depends on
``(seed, i)`` only, never on ``trial_chunk`` or on the host chunking, and
the same seed gives the same fields bit for bit. ``torch.Generator`` and
``jax.random`` draw different numbers: against the JAX package the
ensembles agree in their statistics, not their bits.

The metrics (LER, LWR, LCDU, bridge/break rates, the edge PSD and its
Palasantzas fit) are the JAX package's numpy code, copied, on the subpixel
edges of :func:`.resist.feature_table`.

Spans (recorded while a ``torch.profiler`` trace runs, :mod:`.._spans`) of
an ensemble call: ``litho.stochastic`` (``trials``, ``n``) over the whole
call; under it ``.deterministic`` (the zero-noise field, its read-back and
the reference anchors), and per host chunk ``.trials`` (the device chain,
waited for), ``.readback`` (the chunk's rows, runs and band to the host),
``.edges`` (the edge tables and the run-count compare) and ``.psd`` (the
chunk's edge PSD; the last one also the averaged PSD and its fit). The
counters ``stochastic.trials`` and ``stochastic.readback_bytes`` count the
trials run and every byte an ensemble call reads back to the host
(deterministic field included), traced or not.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .._spans import Counters, span
from ..config import OpticsConfig
from .resist import _f32, _normalized, feature_table, fft_blur

# A host chunk's row summaries (trials x ceil(n / row_step) x n float32 and
# the run counts) live on the card until read back, then on the host. 8 GB,
# a tenth of the H100's 80 GB, leaves the rest to one trial chunk's fields
# (trial_chunk x n^2 float32: 4 GB at 8192^2 and a chunk of 16) and one
# trial's FFT workspace.
_SUMMARY_BYTES = 8 << 30

_COUNTS = Counters("stochastic", ("trials", "readback_bytes"))


def stochastic_counts() -> dict:
    """The trials the ensembles ran and the bytes they read back to the
    host (``trials``, ``readback_bytes``), since the process started."""
    return _COUNTS.snapshot()


def _read_back(*tensors) -> list[np.ndarray]:
    """The tensors on the host, their bytes counted as read back."""
    out = [t.cpu().numpy() for t in tensors]
    _COUNTS.add("readback_bytes", sum(a.nbytes for a in out))
    return out


def _device_chain(image, config, model, trials, seed, trial_chunk,
                  row_step, dz_nm=None):
    """:func:`_summary` of one host chunk, counted and waited for: the
    ``.trials`` span holds the chunk's device work, and ``.readback`` only
    the copy."""
    with span("litho.stochastic.trials"):
        out = _summary(image, config, model, trials, seed, trial_chunk,
                       row_step, dz_nm)
        if image.device.type == "cuda":
            torch.cuda.synchronize(image.device)
    _COUNTS.add("trials", len(trials))
    return out


def trial_generator(seed: int, trial: int, device) -> torch.Generator:
    """The ``torch.Generator`` of trial ``trial`` of an ensemble seeded
    ``seed``, on ``device``: seeded from a NumPy ``SeedSequence`` of the
    pair, so the streams of different trials and seeds are independent."""
    state = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFFFFFFFFFF, int(trial)]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


@dataclasses.dataclass(frozen=True)
class StochasticResist:
    """Counting-statistics resist model.

    dose_photons_per_nm2: absorbed-photon areal density at relative
        intensity 1.0 (30 mJ/cm^2 is ~20 photons/nm^2 at EUV, ~290 at ArF).
    quantum_efficiency: acids generated per absorbed photon.
    pag_per_nm2: photo-acid generator areal density for depletion
        saturation (0 disables: acid strictly proportional to photons).
    diffusion_nm: Gaussian acid-diffusion length (1-sigma, nm).
    threshold: develop threshold on the normalized deprotection field (the
        zero-noise limit is :meth:`.resist.ResistModel.develop_binary` at
        the same threshold and blur when pag_per_nm2 = 0).
    noise: 'poisson' (exact counting statistics) or 'gaussian'
        (mean + sqrt(mean) * normal, clamped at 0).
    """

    dose_photons_per_nm2: float = 20.0
    quantum_efficiency: float = 1.0
    pag_per_nm2: float = 0.0
    diffusion_nm: float = 5.0
    threshold: float = 0.3
    noise: str = "poisson"

    def __post_init__(self):
        if self.dose_photons_per_nm2 <= 0:
            raise ValueError("dose_photons_per_nm2 must be > 0")
        if not (0 < self.quantum_efficiency <= 1.0):
            raise ValueError("quantum_efficiency must be in (0, 1]")
        if self.noise not in ("poisson", "gaussian"):
            raise ValueError(f"noise must be poisson/gaussian, got {self.noise!r}")

    def _z_blur(self, nz: int, dz_nm: float) -> np.ndarray:
        """Row-normalized Gaussian acid-diffusion matrix over slab centers
        (reflecting film boundaries: each row renormalizes, no leak)."""
        z = np.arange(nz, dtype=np.float64) * float(dz_nm)
        g = np.exp(-0.5 * ((z[:, None] - z[None, :])
                           / max(self.diffusion_nm, 1e-9)) ** 2)
        return (g / g.sum(axis=1, keepdims=True)).astype(np.float32)

    def _blur(self, field: torch.Tensor, config: OpticsConfig,
              dz_nm: float) -> torch.Tensor:
        """3-D acid diffusion of an (nz, n, n) field: the periodic in-plane
        FFT blur, then the reflecting Gaussian through depth when nz > 1."""
        if self.diffusion_nm <= 0:
            return field
        field = fft_blur(field, config.pixel_size, self.diffusion_nm)
        nz = field.shape[0]
        if nz > 1:
            blur = torch.as_tensor(self._z_blur(nz, dz_nm), device=field.device)
            field = torch.einsum("zw,wyx->zyx", blur, field)
        return field

    def _sample(self, generator: torch.Generator,
                mean: torch.Tensor) -> torch.Tensor:
        if self.noise == "poisson":
            return torch.poisson(mean, generator=generator)
        normal = torch.randn(mean.shape, generator=generator,
                             dtype=torch.float32, device=mean.device)
        return torch.clamp_min(mean + torch.sqrt(mean) * normal, 0.0)

    def _volume(self, generator: torch.Generator, rel: torch.Tensor,
                config: OpticsConfig, dz_nm: float) -> torch.Tensor:
        """One stochastic (nz, n, n) deprotection volume of a stack ``rel``
        already normalized to its max: the areal dose splits over the nz
        slabs, PAG depletion saturates per voxel against the per-slab PAG
        budget, then the 3-D blur. With nz = 1 it is :meth:`deprotection`."""
        nz = rel.shape[0]
        area = config.pixel_size ** 2
        slab_dose = self.dose_photons_per_nm2 * area / nz
        acid = self.quantum_efficiency * self._sample(generator, slab_dose * rel)
        norm = slab_dose * self.quantum_efficiency
        if self.pag_per_nm2 > 0:
            pag = self.pag_per_nm2 * area / nz
            acid = pag * (1.0 - torch.exp(-acid / pag))
            norm = pag * (1.0 - np.exp(-norm / pag))
        return self._blur(acid / norm, config, dz_nm)

    def deprotection(self, generator: torch.Generator, image,
                     config: OpticsConfig, *, device=None) -> torch.Tensor:
        """One stochastic (diffusion-blurred) deprotection FIELD drawn from
        ``generator`` — the continuous field, so threshold crossings stay
        subpixel; the printed contour is ``field > threshold``. ``image`` is
        a raw aerial image (normalized internally by its max)."""
        rel = _normalized(_f32(image, device))
        return self._volume(generator, rel[None], config, 0.0)[0]

    def contour(self, generator: torch.Generator, image,
                config: OpticsConfig, *, device=None) -> torch.Tensor:
        """One stochastic printed contour {0, 1}."""
        return (self.deprotection(generator, image, config, device=device)
                > self.threshold).to(torch.float32)

    def deterministic_field(self, image, config: OpticsConfig, *,
                            device=None) -> torch.Tensor:
        """Zero-noise (infinite-dose) deprotection field."""
        rel = _normalized(_f32(image, device))
        return self._blur(rel[None], config, 0.0)[0]

    def deterministic_contour(self, image, config: OpticsConfig, *,
                              device=None) -> torch.Tensor:
        """Zero-noise limit of :meth:`contour`: the reference contour that
        defect rates compare against."""
        return (self.deterministic_field(image, config, device=device)
                > self.threshold).to(torch.float32)

    def deprotection_volume(self, generator: torch.Generator, image_stack,
                            config: OpticsConfig, *, dz_nm: float,
                            device=None) -> torch.Tensor:
        """One stochastic (nz, n, n) deprotection VOLUME — per-slab counting
        statistics on the rigorous in-film exposure
        (:func:`...simulate.film_stack_images`): each slab absorbs
        ``dose/nz`` per unit area at relative intensity 1, scaled by the
        local intensity normalized to the stack max, so dim slabs see
        proportionally larger shot noise. Acid diffusion is 3-D (``dz_nm``
        slab spacing). ``nz = 1`` equals :meth:`deprotection` for the same
        generator state, bit for bit."""
        rel = _normalized(_f32(image_stack, device))
        return self._volume(generator, rel, config, dz_nm)

    def deterministic_volume(self, image_stack, config: OpticsConfig, *,
                             dz_nm: float, device=None) -> torch.Tensor:
        """Zero-noise limit of :meth:`deprotection_volume`: the jointly
        normalized, 3-D-blurred exposure stack."""
        rel = _normalized(_f32(image_stack, device))
        return self._blur(rel, config, dz_nm)


def _oriented(image, axis: int, device) -> torch.Tensor:
    """The image (or stack) with its cut lines along the last axis."""
    x = _f32(image, device)
    return x if axis == 1 else x.transpose(-1, -2).contiguous()


def _trial_field(model: StochasticResist, image: torch.Tensor,
                 config: OpticsConfig, seed: int, trial: int,
                 dz_nm: float | None) -> torch.Tensor:
    """Trial ``trial``'s deprotection field (2-D image) or volume (stack
    with ``dz_nm``)."""
    gen = trial_generator(seed, trial, image.device)
    if dz_nm is None:
        return model.deprotection(gen, image, config)
    return model.deprotection_volume(gen, image, config, dz_nm=dz_nm)


def _run_counts(contour: torch.Tensor) -> torch.Tensor:
    """Above-threshold runs along the last axis (rising edges, the first
    pixel counting as one when it is set), int32."""
    c = contour.to(torch.int8)
    rises = (c[..., 1:] > c[..., :-1]).sum(dim=-1)
    return (c[..., 0].to(torch.int64) + rises).to(torch.int32)


def _summary(image: torch.Tensor, config: OpticsConfig,
             model: StochasticResist, trials, seed: int, trial_chunk: int,
             row_step: int, dz_nm: float | None = None):
    """(rows, runs, band) of the trials ``trials`` (indices) on an oriented
    image or stack: per trial the row_step-sampled continuous cut lines and
    the per-cut-line run counts of the contour, and the summed contour.
    ``trial_chunk`` fields are live at once."""
    trials = list(trials)
    shape = image.shape
    rows = torch.empty((len(trials), *shape[:-2], -(-shape[-2] // row_step),
                        shape[-1]), dtype=torch.float32, device=image.device)
    runs = torch.empty((len(trials), *shape[:-1]), dtype=torch.int32,
                       device=image.device)
    band = torch.zeros(shape, dtype=torch.float32, device=image.device)
    for start in range(0, len(trials), trial_chunk):
        ids = trials[start:start + trial_chunk]
        fields = torch.stack([_trial_field(model, image, config, seed, t, dz_nm)
                              for t in ids])
        contour = fields > model.threshold
        rows[start:start + len(ids)] = fields[..., ::row_step, :]
        runs[start:start + len(ids)] = _run_counts(contour)
        band += contour.sum(dim=0, dtype=torch.float32)
    return rows, runs, band


def exposure_summary(image, config: OpticsConfig, model: StochasticResist, *,
                     trials: int, seed: int = 0, trial_chunk: int = 16,
                     row_step: int = 1, axis: int = 1, device=None):
    """(field_rows (T, ceil(n/row_step), n), run_counts (T, n), band_sum
    (n, n)) for ``trials`` stochastic exposures, on the image's device —
    the lean summary :func:`stochastic_ensemble` reads back (cut lines
    along ``axis``; outputs in cut-line-major orientation)."""
    img = _oriented(image, axis, device)
    return _summary(img, config, model, range(trials), seed,
                    max(1, min(trial_chunk, trials)), row_step)


def exposure_trials(image, config: OpticsConfig, model: StochasticResist, *,
                    trials: int = 64, seed: int = 0, trial_chunk: int = 16,
                    binary: bool = True, device=None) -> torch.Tensor:
    """(trials, n, n) stochastic exposures on the image's device: binary
    printed contours (default) or the continuous deprotection fields
    (``binary=False``). ``trial_chunk`` fields are formed before they are
    written out (the whole result is live regardless)."""
    img = _f32(image, device)
    out = torch.empty((trials, *img.shape), dtype=torch.float32,
                      device=img.device)
    chunk = max(1, min(trial_chunk, trials))
    for start in range(0, trials, chunk):
        ids = range(start, min(start + chunk, trials))
        fields = torch.stack([_trial_field(model, img, config, seed, t, None)
                              for t in ids])
        out[start:start + len(ids)] = (
            (fields > model.threshold).to(torch.float32) if binary else fields)
    return out


def _host_chunk(n: int, row_step: int, trials: int) -> int:
    bytes_per_trial = (-(-n // row_step)) * n * 4 + n * 4
    return max(1, min(trials, _SUMMARY_BYTES // max(bytes_per_trial, 1)))


def stochastic_volume_ensemble(image_stack, config: OpticsConfig,
                               model: StochasticResist | None = None, *,
                               dz_nm: float, trials: int = 32, seed: int = 0,
                               axis: int = 1, row_step: int | None = None,
                               trial_chunk: int = 8, device=None) -> dict:
    """Monte-Carlo VOLUMETRIC stochastic printing summary for one rigorous
    (nz, n, n) in-film exposure stack — the z-resolved analog of
    :func:`stochastic_ensemble`, on the stack's device.

    Per slab: LER/LWR (3 sigma, nm), LCDU across trials, mean CD, and
    bridge/break rates against that slab's own deterministic contour; and
    the (nz, n, n) per-voxel print probability. ``dz_nm`` is the slab
    spacing of the stack (typically ``resist.mack.thickness_nm /
    resist.nz``)."""
    model = model or StochasticResist()
    stack = _f32(image_stack, device)
    nz, n = stack.shape[0], stack.shape[-1]
    if row_step is None:
        row_step = max(1, n // 512)
    with span("litho.stochastic", trials=trials, n=n, nz=nz):
        with span("litho.stochastic.deterministic"):
            (det,) = _read_back(model.deterministic_volume(
                stack, config, dz_nm=float(dz_nm)))
            det_or = det if axis == 1 else det.transpose(0, 2, 1)
            ref_centers = [_reference_centers(det_or[s], config, axis=1,
                                              threshold=model.threshold,
                                              row_step=row_step)
                           for s in range(nz)]
        stack = _oriented(stack, axis, None)
        summary = _device_chain(stack, config, model, range(trials), seed,
                                max(1, min(trial_chunk, trials)), row_step,
                                float(dz_nm))
        with span("litho.stochastic.readback"):
            rows, runs, band = _read_back(*summary)
        del summary

        slabs = []
        with span("litho.stochastic.edges"):
            for s in range(nz):
                le, lw, mc = _edge_stats_trials(rows[:, s], config, axis=1,
                                                threshold=model.threshold,
                                                row_step=1,
                                                ref_centers=ref_centers[s])
                stats = _aggregate_edge_stats(le, lw, mc)
                pad_ref = np.pad(det_or[s] > model.threshold,
                                 ((0, 0), (1, 1))).astype(np.int8)
                ref_runs = (np.diff(pad_ref, axis=1) == 1).sum(axis=1)
                live = ref_runs > 0
                if live.any():
                    cells = int(live.sum()) * trials
                    stats["break_rate"] = float(
                        (runs[:, s][:, live] > ref_runs[None, live]).sum()) / cells
                    stats["bridge_rate"] = float(
                        (runs[:, s][:, live] < ref_runs[None, live]).sum()) / cells
                else:
                    stats["break_rate"] = stats["bridge_rate"] = 0.0
                stats["depth_nm"] = s * float(dz_nm)
                slabs.append(stats)

    prob = band / trials
    if axis == 0:
        prob = prob.transpose(0, 2, 1)
    return {
        "trials": trials,
        "nz": nz,
        "dz_nm": float(dz_nm),
        "slabs": slabs,
        "ler_top_nm": slabs[0]["ler_nm"],
        "ler_bottom_nm": slabs[-1]["ler_nm"],
        "bridge_rate_bottom": slabs[-1]["bridge_rate"],
        "print_probability": prob.astype(np.float32),
    }


def _reference_centers(ref_field: np.ndarray, config: OpticsConfig, *,
                       axis: int, threshold: float,
                       row_step: int) -> np.ndarray | None:
    """Sorted feature-center anchors from the noise-free deterministic
    field: its run centers clustered at gaps > max(median width, 2 px).
    Trial runs then track the nearest anchor."""
    feats = feature_table(ref_field, config, axis=axis, threshold=threshold,
                          row_step=row_step)
    centers = np.sort(np.asarray(feats["center_nm"], np.float64))
    if centers.size == 0:
        return None
    gap = max(float(np.median(feats["width_nm"])), 2.0 * config.pixel_size)
    splits = np.nonzero(np.diff(centers) > gap)[0] + 1
    return np.asarray([c.mean() for c in np.split(centers, splits)])


def _trial_tables(fields, config: OpticsConfig, *, axis: int = 1,
                  threshold: float = 0.5, row_step: int = 1) -> list:
    """:func:`.resist.feature_table` of each trial's field (or cut lines)."""
    return [feature_table(f, config, axis=axis, threshold=threshold,
                          row_step=row_step) for f in fields]


def _features(fid: np.ndarray) -> list[np.ndarray]:
    """Each feature's runs (indices in table order), by ascending id."""
    order = np.argsort(fid, kind="stable")
    return np.split(order, np.flatnonzero(np.diff(fid[order])) + 1)


def _edge_stats_tables(tables, config: OpticsConfig, *, min_runs: int,
                       ref_centers=None):
    """Per-trial (ler, lwr, mean_cd) lists of the trials' feature tables;
    a feature with fewer than ``min_runs`` runs is a fragment, not
    tracked."""
    px = config.pixel_size
    lers, lwrs, mean_cds = [], [], []
    for feats in tables:
        if len(feats["row"]) == 0:
            lers.append(np.nan), lwrs.append(np.nan), mean_cds.append(0.0)
            continue
        rise = feats["rise_px"] * px
        fall = feats["fall_px"] * px
        width = feats["width_nm"]
        fid = _assign_feature_ids(feats["center_nm"], width, ref_centers, px)
        ler_vals, lwr_vals = [], []
        for sel in _features(fid):
            if sel.size < min_runs:
                continue  # fragment, not a tracked feature
            ler_vals.append(3.0 * np.std(rise[sel]))
            ler_vals.append(3.0 * np.std(fall[sel]))
            lwr_vals.append(3.0 * np.std(width[sel]))
        lers.append(np.mean(ler_vals) if ler_vals else np.nan)
        lwrs.append(np.mean(lwr_vals) if lwr_vals else np.nan)
        mean_cds.append(float(np.mean(width)))
    return lers, lwrs, mean_cds


def _edge_stats_trials(fields: np.ndarray, config: OpticsConfig, *,
                       axis: int = 1, threshold: float = 0.5,
                       row_step: int = 1, ref_centers=None):
    """Per-trial (ler, lwr, mean_cd) lists — the streamable half of
    :func:`_edge_stats`."""
    tables = _trial_tables(fields, config, axis=axis, threshold=threshold,
                           row_step=row_step)
    return _edge_stats_tables(
        tables, config, min_runs=max(4, fields.shape[1] // row_step // 8),
        ref_centers=ref_centers)


def _aggregate_edge_stats(lers, lwrs, mean_cds) -> dict:
    return {
        "ler_nm": float(np.nanmean(lers)),
        "lwr_nm": float(np.nanmean(lwrs)),
        "lcdu_nm": 3.0 * float(np.nanstd(mean_cds)),
        "mean_cd_nm": float(np.nanmean(mean_cds)),
    }


def _edge_stats(fields: np.ndarray, config: OpticsConfig, *,
                axis: int = 1, threshold: float = 0.5,
                row_step: int = 1, ref_centers=None) -> dict:
    """Per-trial subpixel edge statistics on the continuous fields: LER
    (3 sigma of each edge's position along the feature), LWR (3 sigma of
    local widths) and per-trial mean CD (for LCDU across trials)."""
    return _aggregate_edge_stats(*_edge_stats_trials(
        fields, config, axis=axis, threshold=threshold, row_step=row_step,
        ref_centers=ref_centers))


def stochastic_ensemble(image, config: OpticsConfig,
                        model: StochasticResist | None = None, *,
                        trials: int = 64, seed: int = 0,
                        axis: int = 1, row_step: int | None = None,
                        trial_chunk: int = 16, psd: bool = False,
                        device=None) -> dict:
    """Monte-Carlo stochastic printing summary for one aerial image, on the
    image's device.

    Returns LER/LWR (nm, 3 sigma), LCDU across trials (nm, 3 sigma),
    bridge/break defect rates vs the deterministic contour, the mean
    contour (print probability per pixel, the 'stochastic band'), and the
    trial count. Trials stream through the host in chunks of at most
    ``_SUMMARY_BYTES`` of row summaries, so a full-chip ensemble never
    holds (trials, n, n) at once.

    ``psd=True`` also accumulates the averaged edge PSD from the same
    streamed trial rows (result key ``"psd"``, a :func:`stochastic_psd`
    dict); its frequency ceiling follows ``row_step``."""
    model = model or StochasticResist()
    image = _f32(image, device)
    n = image.shape[0]
    if row_step is None:
        row_step = max(1, n // 512)  # cap full-chip cut lines at ~512
    host_chunk = _host_chunk(n, row_step, trials)
    with span("litho.stochastic", trials=trials, n=n):
        with span("litho.stochastic.deterministic"):
            (det_field,) = _read_back(model.deterministic_field(image, config))
            reference = (det_field > model.threshold).astype(np.float32)
            ref_centers = _reference_centers(det_field, config, axis=axis,
                                             threshold=model.threshold,
                                             row_step=row_step)
            ref_oriented = reference if axis == 1 else reference.T
            pad_ref = np.pad(ref_oriented > 0.5,
                             ((0, 0), (1, 1))).astype(np.int8)
            ref_runs = (np.diff(pad_ref, axis=1) == 1).sum(axis=1)
            live = ref_runs > 0
            det_cd = _edge_stats(det_field[None], config, axis=axis,
                                 threshold=model.threshold,
                                 row_step=row_step)["mean_cd_nm"]
            if psd:
                psd_spacing = config.pixel_size * row_step
                det_rows_psd = (det_field if axis == 1
                                else det_field.T)[::row_step]
                psd_band = _print_band(det_rows_psd, config,
                                       threshold=model.threshold,
                                       ref_centers=ref_centers)
                psd_rows = (det_rows_psd.shape[0] if psd_band is None
                            else psd_band[1] - psd_band[0] + 1)
                psd_sum = None
                psd_edges = 0
        img = _oriented(image, axis, None)
        lers, lwrs, mean_cds = [], [], []
        prob_sum = np.zeros((n, n), np.float64)
        broken = bridged = live_cells = 0
        for start in range(0, trials, host_chunk):
            m_tr = min(host_chunk, trials - start)
            summary = _device_chain(img, config, model,
                                    range(start, start + m_tr), seed,
                                    max(1, min(trial_chunk, m_tr)), row_step)
            with span("litho.stochastic.readback"):
                rows, runs, band = _read_back(*summary)
            del summary
            with span("litho.stochastic.edges"):
                tables = _trial_tables(rows, config, threshold=model.threshold)
                le, lw, mc = _edge_stats_tables(
                    tables, config, min_runs=max(4, rows.shape[1] // 8),
                    ref_centers=ref_centers)
                lers += le, ; lwrs += lw, ; mean_cds += mc,
                if live.any():
                    broken += int((runs[:, live] > ref_runs[None, live]).sum())
                    bridged += int((runs[:, live] < ref_runs[None, live]).sum())
                    live_cells += int(live.sum()) * m_tr
            if psd and psd_rows >= 8:
                with span("litho.stochastic.psd"):
                    lo, hi = (0, rows.shape[1] - 1) if psd_band is None else psd_band
                    part = _tables_psd([_band_table(t, lo, hi) for t in tables],
                                       psd_rows, config, spacing_nm=psd_spacing,
                                       ref_centers=ref_centers, fit=False)
                if part["n_edges"]:
                    add = part["psd_nm3"] * part["n_edges"]
                    psd_sum = add if psd_sum is None else psd_sum + add
                    psd_edges += part["n_edges"]
            prob_sum += band if axis == 1 else band.T
        lers = np.concatenate(lers); lwrs = np.concatenate(lwrs)
        mean_cds = np.concatenate(mean_cds)
        out = _aggregate_edge_stats(lers, lwrs, mean_cds)
        out["break_rate"] = broken / live_cells if live_cells else 0.0
        out["bridge_rate"] = bridged / live_cells if live_cells else 0.0
        out["trials"] = trials
        out["print_probability"] = (prob_sum / trials).astype(np.float32)
        out["deterministic_cd_nm"] = det_cd
        if psd:
            with span("litho.stochastic.psd"):
                spec = _psd_summary(psd_sum, psd_edges, max(psd_rows, 2),
                                    psd_spacing, fit=True)
            spec["trials"] = trials
            out["psd"] = spec
    return out


def _assign_feature_ids(center_nm, width_nm, ref_centers, px):
    """Feature id per table entry: nearest deterministic anchor when
    anchors exist, else rounded-center grouping by a pitch estimate."""
    if ref_centers is not None and ref_centers.size:
        if len(ref_centers) > 1:
            idx = np.clip(np.searchsorted(ref_centers, center_nm),
                          1, len(ref_centers) - 1)
            lo = np.maximum(idx - 1, 0)
            return np.where(
                np.abs(ref_centers[idx] - center_nm)
                <= np.abs(ref_centers[lo] - center_nm), idx, lo)
        return np.zeros(len(center_nm), np.int64)
    pitch = max(float(np.median(width_nm)) * 2.0, px)
    return np.round(center_nm / pitch).astype(np.int64)


def _complete_edge_traces(contour, config, *, threshold, ref_centers):
    """:func:`_table_traces` of the cut lines ``contour`` (R, n)."""
    return _table_traces(feature_table(contour, config, axis=1,
                                       threshold=threshold, row_step=1),
                         contour.shape[0], config, ref_centers=ref_centers)


def _table_traces(feats, rows_total: int, config, *, ref_centers):
    """Rise/fall edge-position traces (nm, one value per cut line) for
    every feature of a feature table that prints on EVERY one of its
    ``rows_total`` cut lines, in ascending feature id; a cut line with
    several runs anchored to one feature contributes the run closest to
    the median of the feature's run centers (the first in table order on a
    tie)."""
    px = config.pixel_size
    if len(feats["row"]) == 0:
        return []
    fid = _assign_feature_ids(feats["center_nm"], feats["width_nm"],
                              ref_centers, px)
    by_id = np.argsort(fid, kind="stable")
    ids, rows = fid[by_id], feats["row"][by_id]
    centers = feats["center_nm"][by_id]
    first = np.flatnonzero(np.concatenate(([True], ids[1:] != ids[:-1])))
    count = np.diff(np.append(first, len(ids)))
    # a feature's runs on one cut line lie together, in table order
    block = np.concatenate(([True], (ids[1:] != ids[:-1])
                            | (rows[1:] != rows[:-1])))
    complete = np.add.reduceat(block.astype(np.int64), first) == rows_total
    if not complete.any():
        return []
    # np.median: the middle centre, or the mean of the middle two
    ranked = np.sort(centers)
    ranked = ranked[np.argsort(ids[np.argsort(centers, kind="stable")],
                               kind="stable")]
    hi = first + count // 2
    median = np.where(count % 2 == 1, ranked[hi],
                      (ranked[np.maximum(hi - 1, first)] + ranked[hi]) / 2)
    group = np.repeat(np.arange(len(first)), count)
    dist = np.abs(centers - median[group])
    line = np.cumsum(block) - 1
    nearest = np.minimum.reduceat(dist, np.flatnonzero(block))
    hits = np.flatnonzero(dist == nearest[line])
    kept = hits[np.concatenate(([True], line[hits][1:] != line[hits][:-1]))]
    kept = kept[complete[group[kept]]].reshape(-1, rows_total)
    traces = []
    for run in by_id[kept]:
        traces.append(feats["rise_px"][run] * px)
        traces.append(feats["fall_px"][run] * px)
    return traces


def _band_table(feats: dict, lo: int, hi: int) -> dict:
    """The runs of a feature table on cut lines ``lo .. hi``, renumbered
    from 0: the table :func:`.resist.feature_table` gives of those lines."""
    sel = (feats["row"] >= lo) & (feats["row"] <= hi)
    out = {k: v[sel] for k, v in feats.items() if k != "axis"}
    out["row"] = out["row"] - lo
    out["axis"] = feats["axis"]
    return out


def _print_band(det_rows, config, *, threshold, ref_centers):
    """Longest contiguous cut-line interval [lo, hi] over which the
    deterministic field prints its maximal anchor count (PSD traces must
    be uniformly sampled; field edges and line ends do not print)."""
    feats = feature_table(det_rows, config, axis=1, threshold=threshold,
                          row_step=1)
    if len(feats["row"]) == 0:
        return None
    fid = _assign_feature_ids(feats["center_nm"], feats["width_nm"],
                              ref_centers, config.pixel_size)
    n_rows = det_rows.shape[0]
    anchors = np.unique(fid)
    cover = np.zeros((len(anchors), n_rows), bool)
    for i, u in enumerate(anchors):
        cover[i, np.unique(feats["row"][fid == u])] = True
    count = cover.sum(axis=0)
    good = np.concatenate(([0], (count == count.max()).astype(np.int8), [0]))
    d = np.diff(good)
    starts, ends = np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]
    k = int(np.argmax(ends - starts))
    return int(starts[k]), int(ends[k] - 1)


def edge_psd(fields, config, *, axis=1, threshold=0.5, spacing_nm=None,
             ref_centers=None, fit=True, row_band=None):
    """Averaged one-sided LER power spectral density of a trial ensemble.

    ``fields`` is (T, R, n): T trials of R uniformly spaced continuous cut
    lines (what :func:`exposure_summary` returns), or full (T, n, n) fields
    with ``axis`` selecting the cut direction. Every feature that prints on
    all analyzed cut lines contributes its rise and fall traces;
    ``row_band=(lo, hi)`` restricts the analysis to a cut-line interval.

    PSD convention (Mack, J. Micro/Nanolith. MEMS MOEMS 12(3), 2013): for
    edge positions x_i (nm) at spacing d (nm), PSD_k = 2 d |DFT(x -
    mean)|_k^2 / N at f_k = k/(N d), so sum_k PSD_k * df = Var(x); units
    nm^3, DC dropped. Returns freq_per_nm, psd_nm3, n_edges, sigma_nm /
    ler_3s_nm (Parseval), and with ``fit=True`` the Palasantzas parameters
    of :func:`fit_psd_model`."""
    if isinstance(fields, torch.Tensor):
        fields = fields.detach().cpu().numpy()
    fields = np.asarray(fields)
    if axis == 0:
        fields = fields.transpose(0, 2, 1)
    if row_band is not None:
        fields = fields[:, row_band[0]:row_band[1] + 1]
    n_rows = fields.shape[1]
    if n_rows < 8:
        raise ValueError(f"need >= 8 cut lines for a PSD, got {n_rows}")
    return _tables_psd(_trial_tables(fields, config, threshold=threshold),
                       n_rows, config, spacing_nm=spacing_nm,
                       ref_centers=ref_centers, fit=fit)


def _tables_psd(tables, n_rows: int, config, *, spacing_nm=None,
                ref_centers=None, fit=True) -> dict:
    """:func:`edge_psd` of the trials' feature tables of ``n_rows`` cut
    lines each."""
    spacing = float(spacing_nm or config.pixel_size)
    psd_sum = np.zeros(n_rows // 2, np.float64)
    n_edges = 0
    for feats in tables:
        traces = _table_traces(feats, n_rows, config, ref_centers=ref_centers)
        if not traces:
            continue
        # a trial's traces in one array; summed one by one, in order
        x = np.stack(traces)
        x = x - x.mean(axis=1, keepdims=True)
        spec = np.abs(np.fft.rfft(x, axis=1)[:, 1:n_rows // 2 + 1]) ** 2
        psd = 2.0 * spacing * spec / n_rows
        if n_rows % 2 == 0:
            psd[:, -1] *= 0.5  # Nyquist bin is not duplicated
        for row in psd:
            psd_sum += row
        n_edges += len(traces)
    out = {
        "freq_per_nm": np.fft.rfftfreq(n_rows, d=spacing)[1:n_rows // 2 + 1],
        "n_edges": n_edges,
        "spacing_nm": spacing,
    }
    if n_edges == 0:
        out["psd_nm3"] = psd_sum
        out["sigma_nm"] = out["ler_3s_nm"] = float("nan")
        return out
    psd = psd_sum / n_edges
    df = 1.0 / (n_rows * spacing)
    sigma = math.sqrt(float(psd.sum() * df))
    out["psd_nm3"] = psd
    out["sigma_nm"] = sigma
    out["ler_3s_nm"] = 3.0 * sigma
    out["acf_corr_length_nm"] = acf_correlation_length(
        out["freq_per_nm"], psd, spacing)
    if fit:
        out.update(_fit_or_nan(out["freq_per_nm"], psd))
    return out


_NAN_FIT = {"corr_length_nm": float("nan"), "alpha": float("nan"),
            "psd0_nm3": float("nan"), "model_sigma_nm": float("nan"),
            "fit_rms_log": float("nan")}


def _fit_or_nan(freq_per_nm, psd_nm3) -> dict:
    """Palasantzas fit, degenerate-safe: a near-zero-noise ensemble whose
    averaged PSD has < 4 positive samples gets NaN parameters."""
    try:
        return fit_psd_model(freq_per_nm, psd_nm3)
    except ValueError:
        return dict(_NAN_FIT)


def acf_correlation_length(freq_per_nm, psd_nm3, spacing_nm):
    """Model-free correlation length: the lag where the edge autocorrelation
    (Wiener-Khinchin transform of the one-sided PSD) first drops below 1/e,
    linearly interpolated."""
    f = np.asarray(freq_per_nm, np.float64)
    p = np.asarray(psd_nm3, np.float64)
    var = p.sum()
    if not var > 0:
        return float("nan")
    lags = spacing_nm * np.arange(len(f) + 1)
    acf = (p[None, :] * np.cos(2.0 * np.pi * lags[:, None] * f[None, :])
           ).sum(axis=1) / var
    target = 1.0 / math.e
    below = np.nonzero(acf < target)[0]
    if below.size == 0:
        return float(lags[-1])  # never decorrelates over the trace
    j = below[0]
    if j == 0:
        return 0.0
    frac = (acf[j - 1] - target) / max(acf[j - 1] - acf[j], 1e-30)
    return float(lags[j - 1] + frac * spacing_nm)


def fit_psd_model(freq_per_nm, psd_nm3):
    """Palasantzas LER model fit:
    PSD(f) = P0 / (1 + (2 pi f xi)^2)^(alpha + 1/2).

    For a fixed correlation length xi the log model is linear in
    (log P0, alpha): a 1-D search over xi with a closed-form least-squares
    solve per candidate. Returns corr_length_nm (xi), alpha, psd0_nm3
    (P0), model_sigma_nm (valid for alpha > 0) and the log-space RMS
    residual."""
    f = np.asarray(freq_per_nm, np.float64)
    p = np.asarray(psd_nm3, np.float64)
    keep = p > 0
    f, p = f[keep], p[keep]
    if f.size < 4:
        raise ValueError("need >= 4 positive PSD samples to fit")
    logp = np.log(p)

    def _grid_fit(fv, lv):
        best = None
        # xi between a tenth of the shortest and 10x the longest resolvable
        # wavelength; log-spaced (the residual is smooth in log xi)
        for xi in np.geomspace(0.1 / fv[-1], 10.0 / fv[0], 96):
            u = np.log1p((2.0 * np.pi * fv * xi) ** 2)
            basis = np.stack([np.ones_like(u), -u], axis=1)
            sol, *_ = np.linalg.lstsq(basis, lv, rcond=None)
            resid = lv - basis @ sol
            rms = float(np.sqrt(np.mean(resid ** 2)))
            if best is None or rms < best[0]:
                best = (rms, xi, sol, resid)
        return best

    rms, xi, sol, resid = _grid_fit(f, logp)
    # one trimmed refit: a few near-zero bins are huge log-space outliers
    # that drag the slope
    keep2 = np.abs(resid) <= 3.0 * max(rms, 1e-12)
    if keep2.sum() >= 4 and not keep2.all():
        rms, xi, sol, _ = _grid_fit(f[keep2], logp[keep2])
    logp0, slope = sol
    alpha = float(slope - 0.5)
    p0 = float(np.exp(logp0))
    if alpha > 0:
        model_sigma = math.sqrt(
            p0 * math.sqrt(math.pi) * math.gamma(alpha)
            / (4.0 * math.pi * xi * math.gamma(alpha + 0.5)))
    else:  # integral diverges; report NaN rather than a fake number
        model_sigma = float("nan")
    return {
        "corr_length_nm": float(xi),
        "alpha": alpha,
        "psd0_nm3": p0,
        "model_sigma_nm": model_sigma,
        "fit_rms_log": rms,
    }


def _psd_summary(psd_sum, n_edges: int, n_rows: int, spacing: float, *,
                 fit: bool) -> dict:
    """The averaged-PSD result dict from accumulated per-chunk partials;
    ``n_edges == 0`` yields the NaN result rather than raising."""
    out = {
        "freq_per_nm": np.fft.rfftfreq(n_rows, d=spacing)[1:n_rows // 2 + 1],
        "n_edges": n_edges,
        "spacing_nm": spacing,
    }
    if n_edges == 0:
        out["psd_nm3"] = np.zeros(n_rows // 2)
        out["sigma_nm"] = out["ler_3s_nm"] = float("nan")
        if fit:
            out.update(_NAN_FIT)
        return out
    psd = psd_sum / n_edges
    df = 1.0 / (n_rows * spacing)
    sigma = math.sqrt(float(psd.sum() * df))
    out["psd_nm3"] = psd
    out["sigma_nm"] = sigma
    out["ler_3s_nm"] = 3.0 * sigma
    out["acf_corr_length_nm"] = acf_correlation_length(
        out["freq_per_nm"], psd, spacing)
    if fit:
        out.update(_fit_or_nan(out["freq_per_nm"], psd))
    return out


def stochastic_psd(image, config, model=None, *, trials=64, seed=0, axis=1,
                   row_step=1, trial_chunk=16, fit=True, device=None):
    """LER PSD + Palasantzas parameters for one aerial image, on the
    image's device: the trial summaries stream through the host as in
    :func:`stochastic_ensemble`, and the averaged edge PSD accumulates over
    all trials. ``row_step`` coarsens the highest resolvable frequency
    (1 / (2 row_step px)); the default samples every cut line."""
    model = model or StochasticResist()
    image = _f32(image, device)
    n = image.shape[0]
    host_chunk = _host_chunk(n, row_step, trials)
    spacing = config.pixel_size * row_step
    with span("litho.stochastic", trials=trials, n=n):
        with span("litho.stochastic.deterministic"):
            (det_field,) = _read_back(model.deterministic_field(image, config))
            ref_centers = _reference_centers(det_field, config, axis=axis,
                                             threshold=model.threshold,
                                             row_step=row_step)
            det_rows = (det_field if axis == 1 else det_field.T)[::row_step]
            band = _print_band(det_rows, config, threshold=model.threshold,
                               ref_centers=ref_centers)
        n_rows = det_rows.shape[0] if band is None else band[1] - band[0] + 1
        if n_rows < 8:
            # a print band under 8 cut lines cannot support a PSD: the
            # n_edges = 0 NaN result instead of a raise mid-run
            out = _psd_summary(None, 0, max(n_rows, 2), spacing, fit=fit)
            out["trials"] = trials
            return out
        img = _oriented(image, axis, None)
        psd_sum = None
        n_edges = 0
        for start in range(0, trials, host_chunk):
            m_tr = min(host_chunk, trials - start)
            summary = _device_chain(img, config, model,
                                    range(start, start + m_tr), seed,
                                    max(1, min(trial_chunk, m_tr)), row_step)
            with span("litho.stochastic.readback"):
                (rows,) = _read_back(summary[0])
            del summary
            with span("litho.stochastic.psd"):
                part = edge_psd(rows, config, axis=1,
                                threshold=model.threshold, spacing_nm=spacing,
                                ref_centers=ref_centers, fit=False,
                                row_band=band)
            if part["n_edges"]:
                add = part["psd_nm3"] * part["n_edges"]
                psd_sum = add if psd_sum is None else psd_sum + add
                n_edges += part["n_edges"]
        with span("litho.stochastic.psd"):
            out = _psd_summary(psd_sum, n_edges, n_rows, spacing, fit=fit)
    out["trials"] = trials
    return out
