"""Full-chip metrology: focus-exposure matrices, MEEF, ORC and defect
dispositions on the tiled path.

Port of ``lithographysimulator_tpu/metrology.py``. One SOCS kernel build
and one tiled full-chip image per focal plane (:mod:`.ops.tiled`), then
the dose axis, the develops and the CD measurements on the stitched image.
The focus stack and every develop stay on the device: the functions here
return the stack as a ``(F, M, M)`` float32 tensor on the device it was
imaged on (on the CPU as on CUDA), and only the cut lines the numpy
metrology reads (feature and edge tables) move to the host. The summaries
(``tiled_fem``, ``tiled_stochastic``, ``orc_check``, the MEEF functions,
``defect_printability``, ``dose_correction_map``) are host dicts and
numbers as in the JAX package; ``apply_dose_map`` returns a tensor.

Host data (a numpy chip, a ``window_fn``) needs ``device=``; a tensor chip
images on its own device, and a prebuilt kernel set on the kernels'.
"""

from __future__ import annotations

import numpy as np
import torch

from ._tensors import to_tensor
from .config import OpticsConfig
from .models.resist import (ResistModel, aligned_edge_positions,
                            cd_uniformity, critical_dimension,
                            edge_placement_errors, feature_table, hotspots,
                            meef, nils_table, process_window)
from .ops.focus import focus_stack_aberrations
from .ops.tiled import chip_tensor, tiled_socs_image


def _device(mask, device) -> torch.device:
    """``device``, else the device of a tensor ``mask``; host data needs
    an explicit device (no silent CPU)."""
    if device is not None:
        return torch.device(device)
    if isinstance(mask, torch.Tensor):
        return mask.device
    raise ValueError("host data needs an explicit device= (e.g. 'cuda' or 'cpu')")


def _builder(tile_config: OpticsConfig, rank: int, source_map, device, *,
             polarization, apodize, chromatic):
    """``build(aberrations) -> SOCSKernels`` on ``device``: the port's
    :func:`..simulate._socs_build` with the setup's channel rotation (the
    JAX package's ``_socs_build_with_channels``)."""
    from .models.pupil import pupil_function
    from .simulate import _channel_rotation_cached, _socs_build

    rot = _channel_rotation_cached(tile_config, polarization, apodize,
                                   chromatic, str(device))
    src = to_tensor(source_map, device=device, dtype=torch.float32)

    def build(aberrations, **kw):
        ab = np.asarray(aberrations, np.float32)
        return _socs_build(tile_config, rank, ab, src,
                           pupil_function(ab, tile_config, device=device),
                           polarization=polarization, apodize=apodize,
                           chromatic=chromatic, rot=rot, **kw)

    return build


def _perturbed(image: torch.Tensor, perturb, tile_config) -> torch.Tensor:
    if perturb is None or not perturb.active:
        return image
    from .ops.perturb import apply_perturbation

    return apply_perturbation(image, perturb, tile_config.pixel_size)


def tiled_focus_images(
    mask_big,
    tile_config: OpticsConfig,
    source_map,
    defocus_nm,
    *,
    base_aberrations=None,
    rank: int = 128,
    halo: int | None = None,
    engine: str = "auto",
    tiles_per_dispatch: int = 8,
    socs_builder=None,
    window_fn=None,
    big_n: int | None = None,
    field_aberrations=None,
    field_points: int = 3,
    field_blend: str = "linear",
    polarization=None,
    apodize: bool = True,
    chromatic=None,
    warm_start: bool = True,
    warm_power_iters: int = 0,
    perturb=None,
    progress_cb=None,
    mask3d=None,
    device=None,
) -> torch.Tensor:
    """(F, M, M) float32 full-chip aerial images through focus, on the
    device: per plane, one SOCS build for the defocused pupil and one tiled
    stitch; one plane's kernel set is live at a time.

    ``socs_builder`` (optional) maps an aberration vector to a SOCSKernels
    set on the device. ``warm_start`` (default on): each plane's build
    restarts from the previous plane's Ritz basis with ``warm_power_iters``
    power iterations, so an F-plane sweep pays one cold build and F-1 warm
    ones; off where the standard-memory build would not fit the device
    (the lean build keeps no basis) and with a custom ``socs_builder``.

    ``polarization``/``apodize`` build every plane with the vector physics,
    ``chromatic`` (a :class:`.config.LaserSpectrum`) polychromatic.
    ``field_aberrations(fx, fy) -> OSA coefficients`` makes the optics vary
    across the chip (:func:`.ops.tiled.tiled_socs_image_field`, each
    plane's defocus added to the map's entry 4); not on the streaming path,
    and ``base_aberrations``/``socs_builder`` are then ignored. Pass
    ``window_fn`` + ``big_n`` instead of ``mask_big`` to stream the chip
    through :func:`.ops.tiled.tiled_socs_image_stream`."""
    from .ops.hopkins import lean_auto
    from .ops.tiled import tiled_socs_image_field, tiled_socs_image_stream

    if (window_fn is None) == (mask_big is None):
        raise ValueError("pass exactly one of mask_big or (window_fn, big_n)")
    if window_fn is not None and big_n is None:
        raise ValueError("window_fn requires big_n")
    device = _device(mask_big, device)
    if mask_big is not None:
        mask_big = chip_tensor(mask_big, device)
    defocus = np.asarray(defocus_nm, np.float64).reshape(-1)
    size = big_n if window_fn is not None else mask_big.shape[-1]
    out = torch.empty((len(defocus), size, size), dtype=torch.float32,
                      device=device)
    if field_aberrations is not None:
        if window_fn is not None:
            raise ValueError(
                "field_aberrations is not supported on the streaming path")
        for pi, d in enumerate(defocus):
            def fn(fx, fy, _d=float(d)):
                c = np.array(field_aberrations(fx, fy), np.float32).copy()
                if c.shape[0] < 5:
                    c = np.pad(c, (0, 5 - c.shape[0]))
                c[4] += _d
                return c

            out[pi] = _perturbed(tiled_socs_image_field(
                mask_big, tile_config, source_map, fn,
                field_points=field_points, blend=field_blend, rank=rank,
                halo=halo, engine=engine,
                tiles_per_dispatch=tiles_per_dispatch,
                polarization=polarization, apodize=apodize,
                chromatic=chromatic, mask3d=mask3d), perturb, tile_config)
        return out
    if base_aberrations is None:
        base_aberrations = np.zeros((5,), np.float32)
    if socs_builder is not None:
        build = socs_builder
    else:
        cold = _builder(tile_config, rank, source_map, device,
                        polarization=polarization, apodize=apodize,
                        chromatic=chromatic)
        if warm_start and not lean_auto(rank + 16, tile_config.n,
                                        device=device):
            basis_box = [None]

            def build(aberr):
                if basis_box[0] is None:
                    socs, basis_box[0] = cold(aberr, return_basis=True)
                else:
                    socs, basis_box[0] = cold(
                        aberr, power_iters=warm_power_iters,
                        init_basis=basis_box[0], return_basis=True)
                return socs
        else:
            build = cold
    stack_ab = focus_stack_aberrations(base_aberrations, defocus)
    for pi, aberr in enumerate(stack_ab):
        socs = build(aberr)
        if window_fn is not None:
            img = tiled_socs_image_stream(
                window_fn, big_n, socs, tile_config, halo=halo,
                engine=engine, tiles_per_dispatch=tiles_per_dispatch,
                mask3d=mask3d)
        else:
            img = tiled_socs_image(
                mask_big, socs, tile_config, halo=halo, engine=engine,
                tiles_per_dispatch=tiles_per_dispatch, mask3d=mask3d)
        del socs
        out[pi] = _perturbed(img, perturb, tile_config)
        if progress_cb is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            progress_cb((pi + 1) / len(stack_ab))
    return out


def tiled_fem(
    mask_big,
    tile_config: OpticsConfig,
    source_map,
    *,
    defocus_nm,
    doses,
    target_cd_nm: float | None = None,
    resist: ResistModel | None = None,
    tolerance: float = 0.10,
    base_aberrations=None,
    rank: int = 128,
    row: int | None = None,
    halo: int | None = None,
    engine: str = "auto",
    tiles_per_dispatch: int = 8,
    window_fn=None,
    big_n: int | None = None,
    field_aberrations=None,
    field_points: int = 3,
    field_blend: str = "linear",
    polarization=None,
    apodize: bool = True,
    chromatic=None,
    warm_start: bool = True,
    cd_stat: str = "median",
    cd_axis: int = 1,
    cd_row_step: int | None = None,
    target_geometry=None,
    progress_cb=None,
    hotspot_nils: float | None = None,
    perturb=None,
    pv_bands: bool = False,
    mask3d=None,
    socs_builder=None,
    device=None,
) -> dict:
    """Full-chip focus-exposure matrix -> process window, in one call
    (streaming ``window_fn`` + ``big_n``, ``field_aberrations`` and
    ``socs_builder`` as :func:`tiled_focus_images`).

    Every (focus, dose) cell develops on the device and measures ALL
    printed features (:func:`.models.resist.feature_table` on every
    ``cd_row_step``-th cut line, read back alone) and reports their
    ``cd_stat`` ('median'/'mean'/'min'/'max'); an explicit ``row`` measures
    that single cut instead. The nominal cell (middle focus, dose nearest
    1) adds the CD uniformity (``cdu``), NILS, ``hotspots`` (with
    ``hotspot_nils``) and, against ``target_geometry`` or the in-memory
    chip, per-edge placement errors (``epe``). All planes share one
    normalization, the stack's maximum, so the dose axis means the same
    thing at every focus.

    Returns ``{"cd_nm": (F, D) ndarray, "defocus_nm", "doses",
    "target_cd_nm", "depth_of_focus_nm", "exposure_latitude",
    "in_spec_fraction", "cdu", "epe", "nils", "hotspots", "pv"}`` (host
    values). ``target_cd_nm=None`` self-calibrates to the nominal cell's
    CD. ``pv_bands=True`` accumulates the outer (union) and inner
    (intersection) printed contours over the cells on the device, and
    per-edge band widths against the target's edge list (``pv``: uint8
    maps, band area fraction, edge band statistics, open edges)."""
    resist = resist or ResistModel()
    device = _device(mask_big, device)
    stack = tiled_focus_images(
        mask_big, tile_config, source_map, defocus_nm,
        base_aberrations=base_aberrations, rank=rank, halo=halo,
        engine=engine, tiles_per_dispatch=tiles_per_dispatch,
        socs_builder=socs_builder, window_fn=window_fn, big_n=big_n,
        field_aberrations=field_aberrations, field_points=field_points,
        field_blend=field_blend, polarization=polarization, apodize=apodize,
        chromatic=chromatic, warm_start=warm_start, perturb=perturb,
        mask3d=mask3d, device=device,
        progress_cb=(None if progress_cb is None
                     else lambda f: progress_cb(0.8 * f)))
    scale = stack.new_tensor(max(float(stack.max()), 1e-30))
    doses = np.asarray(doses, np.float64)
    stat_fn = {"median": np.median, "mean": np.mean,
               "min": np.min, "max": np.max}.get(cd_stat)
    if stat_fn is None:
        raise ValueError(f"unknown cd_stat {cd_stat!r}")
    chip_n = stack.shape[-1]
    if cd_row_step is None:
        cd_row_step = max(1, chip_n // 256)  # cap per-cell cut lines at ~256

    def measure(profile):
        if row is not None:
            return critical_dimension(profile, tile_config, row=row)
        widths = feature_table(profile, tile_config, axis=cd_axis,
                               row_step=cd_row_step)["width_nm"]
        return float(stat_fn(widths)) if widths.size else 0.0

    target = target_geometry if target_geometry is not None else mask_big
    i_mid = len(stack) // 2
    j_nom = int(np.argmin(np.abs(doses - 1.0)))
    cds = np.empty((len(stack), len(doses)))
    cdu = epe = nils = spots = None
    pv_target_table = None
    pv_inner = pv_outer = None
    pv_rise: list = []
    pv_fall: list = []
    if pv_bands and target is not None:
        pv_target_table = feature_table(target, tile_config, axis=cd_axis,
                                        row_step=cd_row_step)
    for i in range(len(stack)):
        norm = stack[i] / scale
        for j, dose in enumerate(doses):
            exposure = norm * float(dose)
            profile = resist.develop_binary(exposure, tile_config,
                                            normalize=False)
            cds[i, j] = measure(profile)
            if pv_bands:
                pb = profile > 0.5
                pv_inner = pb if pv_inner is None else (pv_inner & pb)
                pv_outer = pb if pv_outer is None else (pv_outer | pb)
                if pv_target_table is not None:
                    r, f = aligned_edge_positions(
                        profile, pv_target_table, tile_config, axis=cd_axis,
                        row_step=cd_row_step)
                    pv_rise.append(r)
                    pv_fall.append(f)
            if progress_cb is not None:
                done = i * len(doses) + j + 1
                progress_cb(0.8 + 0.2 * done / (len(stack) * len(doses)))
            if i == i_mid and j == j_nom:
                cdu = cd_uniformity(profile, tile_config, axis=cd_axis,
                                    row_step=cd_row_step)
                nils = nils_table(exposure, tile_config,
                                  threshold=resist.threshold, axis=cd_axis,
                                  row_step=cd_row_step, normalize=False)
                if hotspot_nils is not None:
                    spots = hotspots(exposure, tile_config,
                                     threshold=resist.threshold,
                                     nils_limit=hotspot_nils, axis=cd_axis,
                                     row_step=cd_row_step)
                    spots["locations"] = np.round(
                        spots["locations"], 2).tolist()
                if target is not None:
                    epe = edge_placement_errors(
                        profile, target, tile_config, axis=cd_axis,
                        row_step=cd_row_step)
    if target_cd_nm is None:
        target_cd_nm = float(cds[i_mid, j_nom])
    summary = process_window(cds, defocus_nm, doses,
                             target_cd_nm=target_cd_nm, tolerance=tolerance)
    pv = None
    if pv_bands:
        band_map = pv_outer & ~pv_inner
        if pv_rise:
            rise = np.stack(pv_rise)  # (conditions, target features)
            fall = np.stack(pv_fall)
            full = (~np.isnan(rise).any(0)) & (~np.isnan(fall).any(0))
            widths = np.concatenate([
                rise[:, full].max(0) - rise[:, full].min(0),
                fall[:, full].max(0) - fall[:, full].min(0),
            ]) if full.any() else np.zeros(0)
            open_edges = 2 * int((~full).sum())
        else:
            widths = np.zeros(0)
            open_edges = 0
        pv = {
            "outer": pv_outer.to(torch.uint8).cpu().numpy(),
            "inner": pv_inner.to(torch.uint8).cpu().numpy(),
            "band": band_map.to(torch.uint8).cpu().numpy(),
            "band_area_frac": float(band_map.double().mean()),
            "edge_band_mean_nm": (float(widths.mean()) if widths.size
                                  else 0.0),
            "edge_band_max_nm": float(widths.max()) if widths.size else 0.0,
            "edge_band_sigma_nm": (float(widths.std()) if widths.size
                                   else 0.0),
            "edges_measured": int(widths.size),
            "edges_open": open_edges,
            "conditions": int(len(stack) * len(doses)),
        }
    return {
        "pv": pv,
        "cd_nm": cds,
        "defocus_nm": np.asarray(defocus_nm, np.float64),
        "doses": doses,
        "target_cd_nm": target_cd_nm,
        "cdu": cdu,
        "epe": epe,
        "nils": None if nils is None else {
            k: nils[k] for k in ("count", "mean_nils", "min_nils",
                                 "mean_ils_per_nm")},
        "hotspots": spots,
        **summary,
    }


def tiled_stochastic(
    mask_big,
    tile_config: OpticsConfig,
    source_map,
    *,
    model=None,
    trials: int = 32,
    seed: int = 0,
    base_aberrations=None,
    rank: int = 64,
    halo: int | None = None,
    tiles_per_dispatch: int = 8,
    window_fn=None,
    big_n: int | None = None,
    polarization=None,
    apodize: bool = True,
    chromatic=None,
    axis: int = 1,
    trial_chunk: int = 8,
    psd: bool = False,
    psd_row_step: int | None = None,
    progress_cb=None,
    mask3d=None,
    device=None,
) -> dict:
    """Full-chip stochastic printing: one tiled aerial image on the device,
    then the Monte-Carlo photon/acid ensemble over the whole stitched
    raster (:func:`.models.stochastic.stochastic_ensemble`: LER / LWR /
    LCDU, bridge/break rates, print-probability band) plus ``big_n``.
    Trials draw from per-trial generators (ROADMAP D2), so the ensemble
    agrees with the JAX package's in distribution. ``psd=True`` flattens
    the edge PSD into top-level ``psd_*`` keys (from the ensemble's own
    rows, or a dedicated ``psd_row_step`` pass)."""
    from .models.stochastic import StochasticResist, stochastic_ensemble

    model = model or StochasticResist()
    image = tiled_focus_images(
        mask_big, tile_config, source_map, [0.0],
        base_aberrations=base_aberrations, rank=rank, halo=halo,
        tiles_per_dispatch=tiles_per_dispatch, window_fn=window_fn,
        big_n=big_n, polarization=polarization,
        apodize=apodize, chromatic=chromatic, mask3d=mask3d, device=device,
        progress_cb=(None if progress_cb is None
                     else lambda f: progress_cb(0.6 * f)))[0]
    out = stochastic_ensemble(image, tile_config, model, trials=trials,
                              seed=seed, axis=axis, trial_chunk=trial_chunk,
                              psd=psd and psd_row_step is None)
    if psd:
        if psd_row_step is None:
            spec = out.pop("psd")
        else:
            from .models.stochastic import stochastic_psd

            spec = stochastic_psd(image, tile_config, model, trials=trials,
                                  seed=seed, axis=axis,
                                  row_step=psd_row_step,
                                  trial_chunk=trial_chunk)
        # top-level keys: the serving layer streams only top-level arrays
        for k, v in spec.items():
            out[k if k.startswith("psd") else f"psd_{k}"] = v
    if progress_cb is not None:
        progress_cb(1.0)
    out["big_n"] = int(image.shape[0])
    return out


def orc_check(
    mask_big,
    target_big,
    tile_config: OpticsConfig,
    source_map,
    *,
    resist: ResistModel | None = None,
    rank: int = 128,
    halo: int | None = None,
    tiles_per_dispatch: int = 8,
    polarization=None,
    chromatic=None,
    perturb=None,
    mrc_rules=None,
    hotspot_nils: float | None = 1.5,
    epe_spec_nm: float | None = None,
    axis: int = 1,
    process_corners: dict | None = None,
    mask3d=None,
    device=None,
) -> dict:
    """OPC verification (ORC): one full-chip deck over a candidate mask.

    Images ``mask_big`` once through the tiled path, develops it on the
    device, and runs the sign-off checks: pattern fidelity and per-edge
    EPE against ``target_big``, NILS and weakest-NILS hotspots on the
    aerial image, and (with ``mrc_rules``, a :class:`.models.mrc.MaskRules`)
    mask rule checks on the mask itself. ``pass_``: no missing or spurious
    feature, max |EPE| within ``epe_spec_nm`` (when given), MRC clean (when
    checked). ``process_corners`` (``defocus_nm`` / ``doses`` lists,
    optional ``max_edge_band_nm`` and ``max_open_edges``, default 0) also
    runs the FEM with PV bands and gates ``pass_`` on open edges and the
    per-edge band width; it adds ``pv`` and ``process_window``."""
    from .models.mrc import mrc_check
    from .models.resist import pattern_fidelity

    resist = resist or ResistModel()
    device = _device(mask_big, device)
    image = tiled_focus_images(
        mask_big, tile_config, source_map, [0.0], rank=rank, halo=halo,
        tiles_per_dispatch=tiles_per_dispatch, polarization=polarization,
        chromatic=chromatic, perturb=perturb, mask3d=mask3d,
        device=device)[0]
    norm = image / image.new_tensor(max(float(image.max()), 1e-30))
    profile = resist.develop_binary(norm, tile_config, normalize=False)
    out: dict = {"fidelity": pattern_fidelity(profile, target_big,
                                              tile_config)}
    epe = edge_placement_errors(profile, target_big, tile_config, axis=axis,
                                row_step=max(1, profile.shape[0] // 512))
    out["epe"] = {k: v for k, v in epe.items() if not k.startswith("epe_")}
    nt = nils_table(norm, tile_config, threshold=resist.threshold, axis=axis)
    out["nils"] = {k: nt[k] for k in ("count", "mean_nils", "min_nils",
                                      "mean_ils_per_nm")}
    if hotspot_nils is not None:
        spots = hotspots(norm, tile_config, threshold=resist.threshold,
                         nils_limit=hotspot_nils, axis=axis)
        spots["locations"] = np.round(
            np.asarray(spots["locations"]), 2).tolist()[:20]
        out["hotspots"] = spots
    if mrc_rules is not None:
        check = mrc_check(mask_big, tile_config, mrc_rules)
        out["mrc"] = {k: v for k, v in check.items()
                      if not isinstance(v, np.ndarray)}
    ok = (out["epe"]["missing"] == 0 and out["epe"]["spurious"] == 0)
    if epe_spec_nm is not None:
        ok = ok and out["epe"]["max_abs_epe_nm"] <= epe_spec_nm
    if mrc_rules is not None:
        ok = ok and out["mrc"]["clean"]
    if process_corners is not None:
        fem = tiled_fem(
            mask_big, tile_config, source_map,
            defocus_nm=process_corners.get("defocus_nm",
                                           [-60.0, 0.0, 60.0]),
            doses=process_corners.get("doses", [0.95, 1.0, 1.05]),
            resist=resist, rank=rank, halo=halo,
            tiles_per_dispatch=tiles_per_dispatch,
            polarization=polarization, chromatic=chromatic,
            perturb=perturb, target_geometry=target_big, cd_axis=axis,
            pv_bands=True, mask3d=mask3d, device=device)
        pv = fem["pv"]
        out["pv"] = {k: v for k, v in pv.items()
                     if k not in ("outer", "inner", "band")}
        out["process_window"] = {
            "depth_of_focus_nm": fem["depth_of_focus_nm"],
            "exposure_latitude": fem["exposure_latitude"],
        }
        ok = ok and pv["edges_open"] <= int(
            process_corners.get("max_open_edges", 0))
        max_band = process_corners.get("max_edge_band_nm")
        if max_band is not None:
            ok = ok and pv["edge_band_max_nm"] <= float(max_band)
    out["pass_"] = bool(ok)
    return out


def dose_correction_map(fem_result: dict, *,
                        target_cd_nm: float | None = None,
                        max_correction: float = 0.15) -> dict:
    """Per-region dose corrections that flatten CD uniformity: the FEM's
    CD-vs-dose slope at mid focus (least squares over the dose axis) and
    the CDU map's per-region CD error give ``1 - (CD_region - target) /
    sensitivity``, clipped to ``+-max_correction``; regions with no
    printed feature get dose 1.0. Host numpy, as in the JAX package.

    Returns ``{"dose_map", "sensitivity_nm_per_dose", "target_cd_nm",
    "predicted_residual_nm"}``; apply it with :func:`apply_dose_map`."""
    cds = np.asarray(fem_result["cd_nm"], np.float64)
    doses = np.asarray(fem_result["doses"], np.float64)
    if cds.shape[1] < 2:
        raise ValueError("dose_correction_map needs >= 2 dose columns")
    cdu = fem_result.get("cdu")
    if not cdu or cdu.get("cd_map_nm") is None:
        raise ValueError("fem_result carries no CDU map")
    i_mid = cds.shape[0] // 2
    # least-squares slope over the whole dose axis: pixel-quantized CDs can
    # alias a narrow central difference to zero
    live = cds[i_mid] > 0
    if live.sum() < 2:
        raise ValueError("CD is dose-insensitive at the nominal point")
    sens = float(np.polyfit(doses[live], cds[i_mid, live], 1)[0])
    if abs(sens) < 1e-9:
        raise ValueError("CD is dose-insensitive at the nominal point")
    if target_cd_nm is None:
        target_cd_nm = float(fem_result.get("target_cd_nm")
                             or cdu["mean_cd_nm"])
    cd_map = np.asarray(cdu["cd_map_nm"], np.float64)
    with np.errstate(invalid="ignore"):
        corr = -(cd_map - target_cd_nm) / sens
    corr = np.clip(np.nan_to_num(corr, nan=0.0), -max_correction,
                   max_correction)
    residual = np.nan_to_num(cd_map - target_cd_nm + corr * sens, nan=0.0)
    return {
        "dose_map": (1.0 + corr).astype(np.float32),
        "sensitivity_nm_per_dose": float(sens),
        "target_cd_nm": float(target_cd_nm),
        "predicted_residual_nm": float(np.abs(residual).max()),
    }


def apply_dose_map(image, dose_map, *, device=None) -> torch.Tensor:
    """Scale an aerial image by a coarse per-region dose map (nearest
    upsampling to the image grid), on the image's device: the exposure-side
    application of :func:`dose_correction_map`. The product is taken in
    float64 and rounded to the image's dtype, as the JAX package's numpy."""
    img = to_tensor(image, device=device)
    dm = torch.as_tensor(np.asarray(dose_map, np.float64), device=img.device)
    reps_y = -(-img.shape[0] // dm.shape[0])
    reps_x = -(-img.shape[1] // dm.shape[1])
    up = dm.repeat_interleave(reps_y, 0).repeat_interleave(reps_x, 1)
    return (img.double() * up[:img.shape[0], :img.shape[1]]).to(img.dtype)


def _tile_imager(socs, tile_config, *, halo, engine, tiles_per_dispatch,
                 mask3d=None):
    def image_fn(geometry):
        return tiled_socs_image(
            np.asarray(geometry, np.float32), socs, tile_config, halo=halo,
            engine=engine, tiles_per_dispatch=tiles_per_dispatch,
            mask3d=mask3d)

    return image_fn


def tiled_meef(
    mask_big,
    tile_config: OpticsConfig,
    source_map,
    *,
    resist: ResistModel | None = None,
    bias_px: int = 1,
    rank: int = 128,
    halo: int | None = None,
    engine: str = "auto",
    tiles_per_dispatch: int = 8,
    socs=None,
    polarization=None,
    apodize: bool = True,
    chromatic=None,
    mask3d=None,
    device=None,
) -> float:
    """Full-chip MEEF: d(printed CD)/d(mask CD) with the biased mask imaged
    through the tiled path (kernels built once, on ``device``, or ``socs``
    given, reused for both biases; ``polarization`` and ``chromatic`` build
    them with the vector and finite-bandwidth physics)."""
    resist = resist or ResistModel()
    if socs is None:
        socs = _builder(tile_config, rank, source_map,
                        _device(mask_big, device), polarization=polarization,
                        apodize=apodize, chromatic=chromatic)(
            np.zeros((5,), np.float32))
    return meef(mask_big, _tile_imager(
        socs, tile_config, halo=halo, engine=engine,
        tiles_per_dispatch=tiles_per_dispatch, mask3d=mask3d),
        tile_config, resist, bias_px=bias_px)


def tiled_meef_map(
    mask_big,
    tile_config: OpticsConfig,
    source_map,
    *,
    resist: ResistModel | None = None,
    bias_px: int = 1,
    rank: int = 128,
    halo: int | None = None,
    engine: str = "auto",
    tiles_per_dispatch: int = 8,
    map_blocks: int | None = 16,
    polarization=None,
    apodize: bool = True,
    chromatic=None,
    mask3d=None,
    device=None,
) -> dict:
    """Per-feature full-chip MEEF and per-region map
    (:func:`.models.resist.meef_table` through the tiled imager, kernels
    built once, on ``device``, and reused for both biased prints): where
    mask errors amplify most, instead of one number like
    :func:`tiled_meef`."""
    from .models.resist import meef_table

    resist = resist or ResistModel()
    socs = _builder(tile_config, rank, source_map, _device(mask_big, device),
                    polarization=polarization, apodize=apodize,
                    chromatic=chromatic)(np.zeros((5,), np.float32))
    return meef_table(mask_big, _tile_imager(
        socs, tile_config, halo=halo, engine=engine,
        tiles_per_dispatch=tiles_per_dispatch, mask3d=mask3d),
        tile_config, resist, bias_px=bias_px, map_blocks=map_blocks)


def defect_printability(
    mask_big,
    defective_big,
    tile_config: OpticsConfig,
    source_map,
    *,
    resist: ResistModel | None = None,
    rank: int = 64,
    halo: int | None = None,
    engine: str = "auto",
    tiles_per_dispatch: int = 8,
    defocus_nm=(0.0,),
    cd_spec_nm: float | None = None,
    axis: int = 1,
    polarization=None,
    apodize: bool = True,
    chromatic=None,
    device=None,
) -> dict:
    """Mask-defect printability: does a reticle defect print, and at what
    CD cost? Images the nominal and defective masks through the tiled path
    with one shared kernel set per focal plane (built on ``device``), then
    aligns the defective print's
    subpixel edges to the nominal print's feature table on the continuous
    post-diffusion field (host float64 blur, as the JAX package's). Per
    focal plane: the peak aerial disturbance and its location, the
    per-feature CD deltas, and features that vanish or appear. ``prints``
    is the worst case over focus: any |CD delta| beyond ``cd_spec_nm``
    (default 5% of the nominal median CD) or any missing/new feature."""
    from .models.calibrate import _blur_np

    resist = resist or ResistModel()
    device = _device(mask_big, device)
    mask_big = chip_tensor(mask_big, device)
    defective_big = chip_tensor(defective_big, device)
    if mask_big.shape != defective_big.shape:
        raise ValueError(f"mask {tuple(mask_big.shape)} vs defective "
                         f"{tuple(defective_big.shape)} shapes differ")
    build = _builder(tile_config, rank, source_map, device,
                     polarization=polarization, apodize=apodize,
                     chromatic=chromatic)
    px = tile_config.pixel_size
    per_focus = []
    worst_delta = 0.0
    missing_total = 0
    new_total = 0
    median_cd = 0.0
    for d in defocus_nm:
        ab = np.zeros(5, np.float32)
        ab[4] = float(d)
        socs = build(ab)

        def image(m, _socs=socs):
            return tiled_socs_image(
                m, _socs, tile_config, halo=halo, engine=engine,
                tiles_per_dispatch=tiles_per_dispatch).cpu().numpy()

        nominal = image(mask_big)
        defective = image(defective_big)
        del socs
        scale = max(float(nominal.max()), 1e-30)
        nominal = nominal / scale
        defective = defective / scale
        delta = defective - nominal
        iy, ix = np.unravel_index(int(np.argmax(np.abs(delta))), delta.shape)
        p_nom = _blur_np(nominal, float(resist.diffusion_nm), px)
        p_def = _blur_np(defective, float(resist.diffusion_nm), px)
        row_step = max(1, p_nom.shape[0] // 256)
        ttab = feature_table(p_nom, tile_config, axis=axis,
                             threshold=resist.threshold, row_step=row_step)
        dtab = feature_table(p_def, tile_config, axis=axis,
                             threshold=resist.threshold, row_step=row_step)
        rise, fall = aligned_edge_positions(p_def, ttab, tile_config,
                                            threshold=resist.threshold,
                                            axis=axis, row_step=row_step)
        matched = ~np.isnan(rise) & ~np.isnan(fall)
        cd_delta = (fall - rise)[matched] - ttab["width_nm"][matched]
        missing = int((~matched).sum())
        new = max(0, int(dtab["row"].size) - int(matched.sum()))
        if ttab["width_nm"].size:
            median_cd = max(median_cd, float(np.median(ttab["width_nm"])))
        worst_here = float(np.max(np.abs(cd_delta))) if cd_delta.size else 0.0
        worst_delta = max(worst_delta, worst_here)
        missing_total += missing
        new_total += new
        # worst-CD-delta location (cut-line frame -> image frame, nm)
        if cd_delta.size:
            k = int(np.argmax(np.abs(cd_delta)))
            rows = ttab["row"][matched]
            centers = ttab["center_nm"][matched]
            along, across = float(centers[k]), float(rows[k]) * px
            cd_loc = ((across, along) if axis == 1 else (along, across))
        else:
            cd_loc = None
        per_focus.append({
            "defocus_nm": float(d),
            "max_delta_intensity": float(np.abs(delta).max()),
            "delta_location_nm": (float(iy) * px, float(ix) * px),
            "max_abs_cd_delta_nm": worst_here,
            "cd_delta_location_nm": cd_loc,
            "missing_features": missing,
            "new_features": new,
        })
    if cd_spec_nm is None:
        cd_spec_nm = 0.05 * median_cd if median_cd else 1.0
    prints = (worst_delta > cd_spec_nm or missing_total > 0
              or new_total > 0)
    return {
        "prints": bool(prints),
        "cd_spec_nm": float(cd_spec_nm),
        "max_abs_cd_delta_nm": worst_delta,
        "missing_features": missing_total,
        "new_features": new_total,
        "per_focus": per_focus,
    }
