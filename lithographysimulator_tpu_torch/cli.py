"""Command-line interface of the port: the ``simulate``, ``demo``,
``socs``, ``m3dcal``, ``focus``, ``resist3d``, ``stochastic``,
``calibrate``, ``fem``, ``smo``, ``opc``, ``fitaberr`` and ``lele``
subcommands. The HTTP worker and router start from
``python -m lithographysimulator_tpu_torch.serve``.

Same flags and JSON report keys as ``python -m lithographysimulator_tpu``'s
subcommands of those names, plus ``--device`` (default ``cuda``) and, for
``simulate``, ``--socs-rank``. ``--mask-file`` takes a GDSII layout
(``.gds``/``.gdsii``, an OASIS file under those suffixes too) with
``--gds-layer``, or a ``.npy`` array; ``fem --stream`` reads the tile
windows from the layout and ``lele --gds`` writes the masks' contours:

    python -m lithographysimulator_tpu_torch simulate --device cuda \
        --pixel-number 512 --source quasar --sigma-in 0.4 --sigma-out 0.8 \
        --aberrations 0 0 0.01 0 100 --out aerial.npy
    python -m lithographysimulator_tpu_torch simulate --device cuda \
        --pixel-number 1024 --na 1.35 --immersion-index 1.437 \
        --polarization x --bandwidth-pm 0.3 --msd-x 5
    python -m lithographysimulator_tpu_torch socs --device cuda \
        --pixel-number 1024 --rank 256 --power-iters 1 \
        --polarization unpolarized --out kernels.npz
    python -m lithographysimulator_tpu_torch m3dcal --device cuda \
        --steps 150 --out m3d.json
    python -m lithographysimulator_tpu_torch simulate --device cuda \
        --pixel-number 1024 --m3d m3d.json
    python -m lithographysimulator_tpu_torch resist3d --device cuda \
        --pixel-number 256 --mask lines --film --barc 37 --trials 8
    python -m lithographysimulator_tpu_torch stochastic --device cuda \
        --pixel-number 256 --mask lines --trials 64 --psd
    python -m lithographysimulator_tpu_torch fem --device cuda \
        --pixel-number 1024 --big-n 8192 --mask lines --rank 128
    python -m lithographysimulator_tpu_torch resist3d --device cuda \
        --pixel-number 1024 --big-n 4096 --mask lines --film --barc 37
    python -m lithographysimulator_tpu_torch smo --device cuda \
        --pixel-number 256 --forward socs --steps 50 --out smo.npy
    python -m lithographysimulator_tpu_torch opc --device cuda \
        --pixel-number 1024 --big-n 2048 --mask contacts --steps 20 \
        --mrc-min-width 50 --mrc-repair --out opc.npy
    python -m lithographysimulator_tpu_torch fitaberr --device cuda \
        --pixel-number 256 --images m0.npy m1.npy m2.npy \
        --defocus -60 0 60 --steps 100
    python -m lithographysimulator_tpu_torch lele --device cuda \
        --pixel-number 512 --mask lines --source classical --sigma-out 0.3 \
        --min-pitch 200 --rank 48 --gds lele.gds
    python -m lithographysimulator_tpu_torch fem --device cuda \
        --pixel-number 1024 --big-n 8192 --mask-file chip.gds --gds-layer 1 \
        --stream
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np


def _build_config(args):
    from .config import OpticsConfig

    return OpticsConfig(
        pixel_number=args.pixel_number,
        pixel_size=args.pixel_size,
        wavelength=args.wavelength,
        na=args.na,
        immersion_index=args.immersion_index,
        channel_tol=args.channel_tol,
        obscuration=args.obscuration,
    )


def _build_source(args, config):
    from .models.source import LightSource

    ls = LightSource(config, sigma_in=args.sigma_in, sigma_out=args.sigma_out,
                     shift_x=args.shift_x, shift_y=args.shift_y)
    if args.source == "annular":
        return ls.annular()
    if args.source == "classical":
        return ls.classical()
    if args.source == "quasar":
        return ls.quasar(args.poles, args.rotation)
    if args.source == "dipole":
        return ls.dipole(args.rotation)
    return ls.monopole()


def _build_mask(args, config):
    from .models import mask as mask_mod

    device = args.device
    if args.mask_file:
        if str(args.mask_file).lower().endswith((".gds", ".gdsii")):
            from .io.layout import mask_from_gds

            return mask_from_gds(args.mask_file, config, layer=args.gds_layer,
                                 device=device)
        return mask_mod.from_array(np.load(args.mask_file), config,
                                   device=device)
    n = config.n
    if args.mask == "demo":
        return mask_mod.demo_bars(config, device=device)
    if args.mask == "lines":
        return mask_mod.lines_and_spaces(
            config, line_width_px=max(1, n // 16), pitch_px=max(2, n // 8),
            device=device)
    return mask_mod.contact_holes(config, hole_px=max(1, n // 16),
                                  pitch_px=max(2, n // 8), device=device)


def _aberrations(args):
    if args.aberrations and args.zernike_indexing != "osa":
        from .ops.zernike import to_osa_coefficients

        return [float(c) for c in to_osa_coefficients(
            args.aberrations, scheme=args.zernike_indexing)]
    return args.aberrations


def _build_perturb(args):
    """ImagePerturbation from the flags, or None when all are off."""
    vals = (args.msd_x, args.msd_y, args.flare_tis, args.flare_kernel)
    if not any(vals):
        return None
    from .ops.perturb import ImagePerturbation

    return ImagePerturbation(msd_x_nm=vals[0], msd_y_nm=vals[1],
                             flare_tis=vals[2], flare_kernel_nm=vals[3])


def _build_chromatic(args):
    """LaserSpectrum from the flags, or None when monochromatic."""
    if args.bandwidth_pm == 0.0:
        return None
    from .config import LaserSpectrum

    return LaserSpectrum(bandwidth_pm=args.bandwidth_pm,
                         focus_nm_per_pm=args.chromatic_focus,
                         samples=args.chromatic_samples,
                         shape=args.chromatic_shape)


def _build_mask3d(args):
    """M3D model from the flags, or None when the model is off: a
    calibrated model file (--m3d, from m3dcal) wins over the scalar
    BoundaryLayer flags."""
    if args.m3d:
        from .ops.mask3d import model_from_json

        return model_from_json(args.m3d)
    width, bh, bv = args.mask3d_width, args.mask3d_beta_h, args.mask3d_beta_v
    if width == 0.0 or (bh == 0 and bv == 0):
        return None
    from .ops.mask3d import BoundaryLayer

    return BoundaryLayer(width_nm=width, beta_h=bh, beta_v=bv)


def _polarization(args):
    return None if args.polarization == "scalar" else args.polarization


def cmd_simulate(args) -> int:
    from .simulate import simulate

    config = _build_config(args)
    mask = _build_mask(args, config)
    source = _build_source(args, config)
    rank = args.socs_rank if args.socs_rank == "auto" else int(args.socs_rank)
    result = simulate(mask, source, _aberrations(args), device=args.device,
                      solver=args.solver, chunk=args.chunk,
                      normalize=args.normalize, socs_rank=rank,
                      polarization=_polarization(args),
                      chromatic=_build_chromatic(args),
                      perturb=_build_perturb(args),
                      mask3d=_build_mask3d(args))
    print(json.dumps(result.report, default=repr))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(out, result.image.cpu().numpy())
        Path(str(out.with_suffix("")) + ".report.json").write_text(
            json.dumps(result.report, indent=2, default=repr))
        print(f"wrote {args.out}")
    if args.plot:
        _plot_pipeline(result, mask, args.plot)
        print(f"wrote {args.plot}")
    return 0


def _plot_pipeline(result, mask, out_path: str) -> None:
    """The six-panel figure of a run: image, spectrum, mask, source and the
    pupil's real and imaginary parts (needs matplotlib)."""
    plt = _pyplot()
    fig, axes = plt.subplots(3, 2, dpi=200, figsize=(8, 10))
    panels = [
        (result.image.cpu().numpy(), "Simulated Aerial Image"),
        (result.spectrum.abs().cpu().numpy(), "Diffraction Pattern (Mag)"),
        (mask.geometry.abs().cpu().numpy(), "Mask"),
        (result.source_map, "Light Source"),
        (result.pupil.real.cpu().numpy(), "Pupil Function (Re)"),
        (result.pupil.imag.cpu().numpy(), "Pupil Function (Im)"),
    ]
    for ax, (img, title) in zip(axes.ravel(), panels):
        ax.imshow(img)
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def cmd_demo(args) -> int:
    """The reference's end-to-end demo on --device: the demo mask, a
    quadrupole 0.4/0.8, 10 OSA terms with 100 nm defocus, and the
    six-panel figure (which needs matplotlib)."""
    from .models.mask import demo_bars
    from .models.source import LightSource
    from .simulate import simulate
    from .utils.profiling import device_info

    config = _build_config(args)
    aberr = (_aberrations(args)
             or [0, 0, 0.01, 0, 100, 0.01, 0, 0.01, 0.01, 0.01])
    mask = demo_bars(config, device=args.device)
    source = LightSource(config, sigma_in=args.sigma_in,
                         sigma_out=args.sigma_out).quasar(args.poles,
                                                          args.rotation)
    info = device_info(args.device)
    print(f"Using {info['platform']} {info['device']} "
          f"({info['device_count']} device(s))")
    print("Beginning simulation")
    result = simulate(mask, source, aberr, device=args.device,
                      solver=args.solver)
    print(f"Aerial image computed in {result.report['wall_clock_s']:.3f} s "
          f"({result.report['source_points']} source points, "
          f"solver={result.report['solver']})")
    out = args.out or "demo.png"
    _plot_pipeline(result, mask, out)
    print(f"wrote {out}")
    return 0


def cmd_socs(args) -> int:
    """Build a SOCS kernel set (scalar, vector with --polarization,
    polychromatic with --bandwidth-pm), print the JAX CLI's JSON keys and
    optionally save it (``.npz``, loadable by either package)."""
    import torch

    from .models.pupil import pupil_function
    from .simulate import _channel_rotation_cached, _pupil_power, _socs_build
    from .utils.artifacts import save_socs

    config = _build_config(args)
    source = _build_source(args, config)
    device = torch.device(args.device)
    aberr = np.asarray(_aberrations(args) or [0.0], np.float32)
    polarization = _polarization(args)
    chromatic = _build_chromatic(args)
    lean = {"auto": "auto", "on": True, "off": False}[args.lean]
    # the aberration-independent channel rotation the simulate cache uses
    rot = _channel_rotation_cached(config, polarization, True, chromatic,
                                   str(device))
    t0 = time.perf_counter()
    pupil = pupil_function(aberr, config, device=device)
    socs = _socs_build(config, args.rank, aberr, source, pupil,
                       polarization=polarization, apodize=True,
                       chromatic=chromatic, rot=rot,
                       power_iters=args.power_iters, lean=lean)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    trace = (float(np.sum(source, dtype=np.float64))
             * _pupil_power(pupil, config, polarization, True))
    ev = socs.eigenvalues.cpu().numpy()
    print(json.dumps({
        "rank": int(socs.rank), "build_s": round(elapsed, 3),
        "eig_max": float(ev[0]), "eig_min_kept": float(ev[-1]),
        "energy_captured": (round(float(ev.sum(dtype=np.float64)) / trace, 6)
                            if trace > 0 else 1.0),
        "channels": None if rot is None else int(rot.shape[2]),
    }))
    if args.out:
        save_socs(args.out, socs)
        print(f"wrote {args.out}")
    return 0


def cmd_m3dcal(args) -> int:
    """First-principles thick-mask (M3D) calibration: the in-repo RCWA
    solver on a line/space topography of the absorber stack, and the
    boundary-layer (or, with --taps, edge-kernel) fit against its imaged
    near field on --device. Prints the JAX CLI's JSON line (the model plus
    the thin and corrected image residuals); --out also writes it, for the
    imaging commands' --m3d."""
    from .ops.mask3d import boundary_layer_from_rcwa, model_to_json

    config = _build_config(args)
    if config.n % args.pitch:
        raise SystemExit(f"--pitch {args.pitch} must divide "
                         f"--pixel-number {config.n}")
    duty = args.duty if args.duty is not None else (
        # default: ~half-pitch absorber rounded to an odd pixel count
        # (exact rasterization; see ops.mask3d.grating_geometry)
        (2 * (args.pitch // 4) + 1) / args.pitch)
    t0 = time.perf_counter()
    try:
        bl, report = boundary_layer_from_rcwa(
            config, device=args.device, stack=args.stack,
            pitch_px=args.pitch, duty=duty, illumination_pol=args.pol,
            width_nm=args.width_nm, n_harmonics=args.harmonics,
            sigma_out=args.sigma_out, steps=args.steps,
            learning_rate=args.lr, incidence_deg=args.incidence,
            azimuth_deg=args.azimuth, taps=args.taps,
            defocus_nm=tuple(args.defocus or ()))
    except ValueError as exc:
        # e.g. the stack/wavelength mismatch guard (ops.rcwa.resolve_stack)
        raise SystemExit(f"m3dcal: {exc}") from None
    out = model_to_json(bl)
    out.update({
        "stack": args.stack,
        "illumination_pol": args.pol,
        "incidence_deg": args.incidence,
        "azimuth_deg": args.azimuth,
        "defocus_nm": report["defocus_nm"],
        "pitch_px": args.pitch,
        "duty": round(duty, 6),
        "thin_nrms": {k: round(v, 8) for k, v in report["thin_nrms"].items()},
        "fit_nrms": {k: round(v, 8) for k, v in report["fit_nrms"].items()},
        "wall_clock_s": round(time.perf_counter() - t0, 3),
    })
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _padded_source(source, chunk: int):
    """(shifts, weights, max |shift|) of the live source points, padded
    with zero weights to a multiple of ``chunk``."""
    from .ops.abbe import _pad_points, source_points

    pts = source_points(np.asarray(source))
    shifts, weights = _pad_points(pts.shifts, pts.weights, chunk)
    return shifts, weights, int(np.abs(shifts).max()) if shifts.size else 0


def cmd_focus(args) -> int:
    """Through-focus stack + focus-exposure matrix (CD vs defocus), on
    --device."""
    from .models.resist import ResistModel, critical_dimension
    from .ops.focus import compiled_focus_stack, focus_stack_aberrations

    config = _build_config(args)
    mask = _build_mask(args, config)
    source = _build_source(args, config)
    shifts, weights, max_shift = _padded_source(source, args.chunk)
    defocus = np.linspace(args.focus_min, args.focus_max, args.focus_steps)
    base = np.asarray(_aberrations(args) or [0.0] * 5, np.float32)
    stack_ab = focus_stack_aberrations(base, defocus.astype(np.float32))
    run = compiled_focus_stack(config, chunk=args.chunk, normalize=True,
                               max_abs_shift=max_shift,
                               mask3d=_build_mask3d(args))
    t0 = time.perf_counter()
    stack = run(mask.geometry, stack_ab, shifts, weights)
    _sync(args.device)
    elapsed = time.perf_counter() - t0

    model = ResistModel(threshold=args.threshold)
    cds = [critical_dimension(model.develop_binary(im, config), config)
           for im in stack]
    print(json.dumps({
        "defocus_nm": [float(d) for d in defocus],
        "cd_nm": cds,
        "wall_clock_s": round(elapsed, 3),
    }))
    if args.out:
        np.save(args.out, stack.cpu().numpy())
        print(f"wrote {args.out}")
    return 0


def cmd_resist3d(args) -> int:
    """3-D resist development on --device: through-film exposure -> latent
    image -> eikonal front propagation (lateral etch, undercut) -> 3-D
    profile and summary. The exposure is the separable model (focal stack
    x analytic absorption and standing waves) or, with --film, the
    rigorous image in the resist over the --substrate/--barc stack;
    --trials adds the volumetric stochastic ensemble."""
    import sys

    from .models.resist import DepthResist, MackResist

    config = _build_config(args)
    mask = _build_mask(args, config)
    source = _build_source(args, config)
    if args.film and args.reflectivity:
        print("error: --reflectivity is the separable model's knob; with "
              "--film the actual substrate/BARC stack sets the reflected "
              "wave (use --substrate/--barc)", file=sys.stderr)
        return 2
    dr = DepthResist(
        mack=MackResist(thickness_nm=args.thickness, develop_s=args.develop_s),
        nz=args.nz,
        absorbance_per_um=args.absorbance,
        substrate_reflectivity=args.reflectivity,
        peb_diffusion_nm=args.peb,
        n_resist=args.n_resist,
        wavelength_nm=config.wavelength,
        surface_rate_factor=args.surface_rate_factor,
        inhibition_depth_nm=args.inhibition_depth,
        lateral_rate_factor=args.lateral_rate_factor,
        lateral_surface_factor=args.lateral_surface_factor,
    )
    base = np.asarray(_aberrations(args) or [0.0] * 5, np.float32)
    t0 = time.perf_counter()
    if args.film:
        from .ops.filmstack import MATERIALS_193, WaferStack
        from .simulate import film_stack_images

        under = (((float(args.barc), complex(*args.barc_n)),)
                 if args.barc > 0 else ())
        wafer = WaferStack.from_resist(
            dr, under_layers=under, n_substrate=MATERIALS_193[args.substrate])
        if args.big_n and args.big_n > config.n:
            # full chip: per-slab film-SOCS kernels once, then the tiles
            # through the fixed-size optics
            from .ops.tiled import tiled_film_stack
            from .simulate import film_socs_kernels

            big_cfg = dataclasses.replace(config, pixel_number=args.big_n)
            kernels = film_socs_kernels(
                source, base, device=args.device, config=config,
                wafer_stack=wafer, resist=dr,
                polarization=_polarization(args), rank=args.rank)
            stack = tiled_film_stack(
                _build_mask(args, big_cfg).geometry.abs(), kernels, config,
                source_total=float(np.asarray(source).sum()),
                halo=args.halo, chunk=args.chunk, mask3d=_build_mask3d(args))
            del kernels
        else:
            stack = film_stack_images(
                mask, source, base, device=args.device, config=config,
                wafer_stack=wafer, resist=dr,
                polarization=_polarization(args), chunk=args.chunk,
                normalize=True, mask3d=_build_mask3d(args))
        dr = dr.rigorous()  # exposure stack already carries absorption
    else:
        from .ops.focus import compiled_focus_stack, focus_stack_aberrations

        shifts, weights, max_shift = _padded_source(source, args.chunk)
        # Entry 4 of --aberrations is the user's focus setting (nm); the
        # film's per-slab defocus offsets ride on top of it
        # (focus_stack_aberrations replaces entry 4).
        best_focus = float(base[4]) if base.shape[0] > 4 else 0.0
        film_defocus = dr.film_defocus_nm(best_focus_nm=best_focus)
        stack_ab = focus_stack_aberrations(base, film_defocus.astype(np.float32))
        run = compiled_focus_stack(config, chunk=args.chunk, normalize=True,
                                   max_abs_shift=max_shift,
                                   mask3d=_build_mask3d(args))
        stack = run(mask.geometry, stack_ab, shifts, weights)
    profile = dr.develop_profile_binary(
        stack, args.dose, pixel_size_nm=config.pixel_size).cpu().numpy()
    stochastic = None
    if args.trials:
        # volumetric stochastic resist on the (nz, n, n) exposure: per-slab
        # counting statistics -> z-resolved LER/CD + defect rates
        from .models.stochastic import (StochasticResist,
                                        stochastic_volume_ensemble)

        model = StochasticResist(dose_photons_per_nm2=args.dose_photons,
                                 diffusion_nm=args.peb,
                                 threshold=args.sto_threshold)
        vol = stochastic_volume_ensemble(
            stack, config, model, dz_nm=dr.mack.thickness_nm / dr.nz,
            trials=args.trials, seed=args.seed)
        stochastic = {
            "trials": vol["trials"],
            "ler_top_nm": round(vol["ler_top_nm"], 4),
            "ler_bottom_nm": round(vol["ler_bottom_nm"], 4),
            "slabs": [{k: (round(v, 5) if isinstance(v, float) else v)
                       for k, v in sl.items()} for sl in vol["slabs"]],
        }
    elapsed = time.perf_counter() - t0

    # Undercut voxels: removed, with intact resist somewhere strictly above
    # them in the same column (min over the slabs above == 0).
    above_min = np.concatenate(
        [np.ones_like(profile[:1]),
         np.minimum.accumulate(profile, axis=0)[:-1]])
    undercut = int(np.logical_and(profile > 0.5, above_min < 0.5).sum())
    report = {
        "nz": dr.nz,
        "thickness_nm": dr.mack.thickness_nm,
        "exposure": "film" if args.film else "separable",
        "cleared_fraction": float(profile.mean()),
        "through_print_fraction": float(profile.min(axis=0).mean()),
        "undercut_voxels": undercut,
        "wall_clock_s": round(elapsed, 3),
    }
    if stochastic is not None:
        report["stochastic"] = stochastic
    print(json.dumps(report))
    if args.out:
        np.savez_compressed(args.out, profile=profile, depths_nm=dr.depths_nm)
        print(f"wrote {args.out}")
    if args.plot:
        plt = _pyplot()
        row = config.n // 2
        fig, axes = plt.subplots(2, 1, figsize=(8, 5), layout="constrained")
        axes[0].imshow(stack[dr.nz // 2].cpu().numpy(), cmap="inferno")
        axes[0].set_title("aerial image (mid-film plane)")
        axes[1].imshow(1.0 - profile[:, row, :], cmap="copper",
                       aspect="auto", interpolation="nearest")
        axes[1].set_title(f"resist x-z cross-section (row {row}; "
                          "dark = cleared)")
        axes[1].set_ylabel("depth slab")
        fig.savefig(args.plot, dpi=130)
        print(f"wrote {args.plot}")
    return 0


def _pyplot():
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("the figure needs matplotlib, which is not "
                         "installed") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def cmd_stochastic(args) -> int:
    """Monte-Carlo stochastic printing on --device: aerial image ->
    photon/acid counting trials -> LER/LWR/LCDU + bridge/break defect
    rates + print-probability band (+ the edge PSD with --psd)."""
    from .models.stochastic import StochasticResist, stochastic_ensemble
    from .simulate import simulate

    config = _build_config(args)
    mask = _build_mask(args, config)
    source = _build_source(args, config)
    result = simulate(mask, source, _aberrations(args), device=args.device,
                      solver=args.solver, normalize=True,
                      polarization=_polarization(args),
                      chromatic=_build_chromatic(args))
    model = StochasticResist(
        dose_photons_per_nm2=args.dose_photons,
        quantum_efficiency=args.quantum_efficiency,
        pag_per_nm2=args.pag, diffusion_nm=args.diffusion,
        threshold=args.threshold, noise=args.noise)
    t0 = time.perf_counter()
    want_psd = args.psd or bool(args.psd_out)  # --psd-out implies --psd
    out = stochastic_ensemble(result.image, config, model, trials=args.trials,
                              seed=args.seed, psd=want_psd)
    # the PSD accumulates from the same streamed trials as the summary
    psd = out.pop("psd", None)
    if psd is not None:
        for k in ("ler_3s_nm", "acf_corr_length_nm", "corr_length_nm",
                  "alpha", "psd0_nm3", "n_edges"):
            if k in psd:
                out[f"psd_{k}"] = psd[k]
        if args.psd_out:
            np.savez(args.psd_out, freq_per_nm=psd["freq_per_nm"],
                     psd_nm3=psd["psd_nm3"])
    elapsed = time.perf_counter() - t0
    band = out.pop("print_probability")
    out["wall_s"] = round(elapsed, 3)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in out.items()}))
    if args.out:
        np.save(args.out, band)
        print(f"wrote {args.out}")
    if args.plot:
        plt = _pyplot()
        n_panels = 3 if psd is not None and psd["n_edges"] else 2
        fig, axes = plt.subplots(1, n_panels, figsize=(4.5 * n_panels, 4.2))
        axes[0].imshow(result.image.cpu().numpy(), cmap="inferno")
        axes[0].set_title("aerial image")
        im = axes[1].imshow(band, cmap="RdBu_r", vmin=0, vmax=1)
        axes[1].set_title(
            f"print probability ({args.trials} trials)\n"
            f"LER {out['ler_nm']:.2f} nm  LWR {out['lwr_nm']:.2f} nm")
        fig.colorbar(im, ax=axes[1], fraction=0.046)
        for ax in axes[:2]:
            ax.set_xticks([]), ax.set_yticks([])
        if n_panels == 3:
            f_ax, p_ax = psd["freq_per_nm"], psd["psd_nm3"]
            axes[2].loglog(f_ax, p_ax, lw=1.2, label="measured")
            model_psd = psd["psd0_nm3"] / (
                1.0 + (2 * np.pi * f_ax * psd["corr_length_nm"]) ** 2
            ) ** (psd["alpha"] + 0.5)
            axes[2].loglog(f_ax, model_psd, "--", lw=1.0,
                           label=(f"Palasantzas fit\n"
                                  f"$\\xi$={psd['corr_length_nm']:.1f} nm  "
                                  f"$\\alpha$={psd['alpha']:.2f}"))
            axes[2].set_xlabel("frequency (1/nm)")
            axes[2].set_ylabel("PSD (nm$^3$)")
            axes[2].set_title(
                f"LER PSD ({psd['n_edges']} edges)\n"
                f"ACF corr. length {psd['acf_corr_length_nm']:.1f} nm")
            axes[2].legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(args.plot, dpi=130)
        print(f"wrote {args.plot}")
    return 0


def cmd_calibrate(args) -> int:
    """Resist model calibration: fit model parameters to measured gauge
    CDs (aerial images from .npy files + CD-SEM numbers). The fit is numpy
    on the host, as in the JAX package; --device is not used by it."""
    from .models.calibrate import calibrate_resist
    from .models.resist import MackResist, ResistModel

    config = _build_config(args)
    images = [np.load(p) for p in args.images]
    if len(args.cds) != len(images):
        raise SystemExit(f"{len(images)} --images vs {len(args.cds)} --cds")
    model = MackResist() if args.model == "mack" else ResistModel(
        threshold=args.threshold, diffusion_nm=args.diffusion)
    t0 = time.perf_counter()
    out = calibrate_resist(images, args.cds, config, model=model,
                           fit=tuple(args.fit), iters=args.iters)
    print(json.dumps({
        "params": out["params"],
        "rms_nm": round(out["rms_nm"], 4),
        "cd_nm": [round(float(c), 3) for c in out["cd_nm"]],
        "residual_nm": [round(float(r), 3) for r in out["residual_nm"]],
        "evals": out["evals"],
        "wall_clock_s": round(time.perf_counter() - t0, 3),
    }))
    return 0


def cmd_fem(args) -> int:
    """Full-chip focus-exposure matrix and process window on the tiled SOCS
    path, on --device: the mask at --big-n (e.g. 8192) through
    --pixel-number tiles, over a focus x dose grid; reports DoF and
    exposure latitude."""
    from .metrology import tiled_fem
    from .models.resist import ResistModel

    tile_config = _build_config(args)  # optics of each tile
    big_n = args.big_n or tile_config.n
    window_fn = mask_big = None
    if args.stream:
        if not args.mask_file:
            raise SystemExit("--stream requires --mask-file (GDSII/OASIS)")
        from .io.layout import layout_window_provider

        window_fn = layout_window_provider(args.mask_file, tile_config,
                                           big_n, layer=args.gds_layer)
    else:
        big_cfg = dataclasses.replace(tile_config, pixel_number=big_n)
        mask_big = _build_mask(args, big_cfg).geometry.abs()
    source = _build_source(args, tile_config)
    defocus = np.linspace(args.focus_min, args.focus_max, args.focus_steps)
    t0 = time.perf_counter()
    result = tiled_fem(
        mask_big, tile_config, source,
        defocus_nm=defocus, doses=args.doses,
        target_cd_nm=args.target_cd,
        resist=ResistModel(threshold=args.threshold),
        tolerance=args.cd_tolerance,
        base_aberrations=_aberrations(args),
        rank=args.rank, halo=args.halo,
        tiles_per_dispatch=args.tiles_per_dispatch,
        window_fn=window_fn, big_n=big_n if window_fn is not None else None,
        polarization=_polarization(args), chromatic=_build_chromatic(args),
        warm_start=not args.no_warm_start,
        hotspot_nils=args.hotspot_nils,
        pv_bands=args.pv_bands is not None,
        mask3d=_build_mask3d(args), device=args.device,
    )
    elapsed = time.perf_counter() - t0
    report = {
        "big_n": big_n,
        "tile_n": tile_config.n,
        "defocus_nm": [float(d) for d in result["defocus_nm"]],
        "doses": [float(d) for d in result["doses"]],
        "cd_nm": np.asarray(result["cd_nm"]).tolist(),
        "target_cd_nm": result["target_cd_nm"],
        "depth_of_focus_nm": result["depth_of_focus_nm"],
        "exposure_latitude": result["exposure_latitude"],
        "in_spec_fraction": result["in_spec_fraction"],
        "wall_clock_s": round(elapsed, 3),
    }
    cdu = result["cdu"]
    if cdu is not None:
        report["cdu"] = {k: v for k, v in cdu.items() if k != "cd_map_nm"}
    if result["epe"] is not None:
        report["epe"] = {k: v for k, v in result["epe"].items()
                         if not k.startswith("epe_")}
    if result["nils"] is not None:
        report["nils"] = result["nils"]
    if result["hotspots"] is not None:
        spots = dict(result["hotspots"])
        spots["locations"] = spots["locations"][:10]  # top-10 in the JSON
        report["hotspots"] = spots
    pv = result["pv"]
    if pv is not None:
        report["pv"] = {k: v for k, v in pv.items()
                        if k not in ("outer", "inner", "band")}
    print(json.dumps(report))
    if args.pv_bands and pv is not None:
        np.savez(args.pv_bands, outer=pv["outer"], inner=pv["inner"],
                 band=pv["band"])
        print(f"wrote {args.pv_bands}")
    if args.cdu_map and cdu is not None:
        cd_map = np.asarray(cdu["cd_map_nm"])
        if args.cdu_map.endswith(".npy"):
            np.save(args.cdu_map, cd_map)
        else:
            plt = _pyplot()
            fig, ax = plt.subplots(dpi=200)
            im = ax.imshow(cd_map, cmap="viridis")
            ax.set_title(
                f"CD uniformity map (mean {cdu['mean_cd_nm']:.1f} nm, "
                f"3$\\sigma$ {cdu['cdu_3sigma_nm']:.2f} nm)")
            fig.colorbar(im, ax=ax, label="mean CD (nm)")
            fig.savefig(args.cdu_map)
            plt.close(fig)
        print(f"wrote {args.cdu_map}")
    return 0


def cmd_smo(args) -> int:
    """Inverse lithography on --device: optimize the mask so its aerial
    image matches the target mask's image (the exact Abbe forward, or the
    SOCS kernels with --forward socs); reports the loss and the print's
    fidelity to the target layout."""
    import torch

    from .models.resist import ResistModel, pattern_fidelity
    from .optimize import (SMOProblem, forward, init_params, mask_from_latent,
                           optimize, optimize_socs)

    config = _build_config(args)
    target_mask = _build_mask(args, config)
    source = _build_source(args, config)
    shifts, weights, _ = _padded_source(source, args.chunk * 8)
    problem = SMOProblem(config=config, chunk=args.chunk,
                         mask_steepness=args.steepness,
                         mask3d=_build_mask3d(args))
    ab = np.asarray(_aberrations(args) or [0.0], np.float32)
    # With an M3D model the TARGET image is the thin-mask (design-intent)
    # print; the optimizer pre-compensates the topography by running its
    # own forward THROUGH the model (M3D-aware ILT).
    thin_problem = dataclasses.replace(problem, mask3d=None)
    with torch.no_grad():
        target = forward(init_params(problem, target_mask.geometry), ab,
                         shifts, weights, thin_problem)
    start = np.full((config.n, config.n), 0.4, np.float32)
    t0 = time.perf_counter()
    if args.forward == "socs":
        params, history = optimize_socs(
            problem, target, start, ab, shifts, weights, steps=args.steps,
            learning_rate=args.lr, rank=args.rank)
    else:
        params, history = optimize(problem, target, start, ab, shifts,
                                   weights, steps=args.steps,
                                   learning_rate=args.lr)
    elapsed = time.perf_counter() - t0  # the history's read-back waited

    optimized = mask_from_latent(params["mask_latent"], problem.mask_steepness)
    with torch.no_grad():
        final_img = forward(params, ab, shifts, weights, problem)
    model = ResistModel(threshold=args.threshold)
    fid = pattern_fidelity(model.develop_binary(final_img, config),
                           target_mask.geometry.abs(), config)
    print(json.dumps({
        "steps": args.steps,
        "loss_start": history[0], "loss_end": history[-1],
        "print_fidelity_vs_target_layout": fid,
        "wall_clock_s": round(elapsed, 3),
    }))
    if args.out:
        np.save(args.out, optimized.cpu().numpy())
        print(f"wrote {args.out}")
    return 0


def cmd_opc(args) -> int:
    """Full-chip resist-aware OPC on the tiled SOCS path, on --device;
    reports the printed pattern's fidelity (IoU, XOR area, EPE) before and
    after, and with the --mrc-* flags the mask rule check (and repair)."""
    from .metrology import tiled_focus_images
    from .models.resist import (ResistModel, edge_placement_errors,
                                pattern_fidelity)
    from .optimize import opc_correct_tiled

    tile_config = _build_config(args)
    big_n = args.big_n or tile_config.n
    big_cfg = dataclasses.replace(tile_config, pixel_number=big_n)
    target = _build_mask(args, big_cfg).geometry.abs()
    source = _build_source(args, tile_config)
    resist = ResistModel(threshold=args.threshold, steepness=30.0)
    polarization = _polarization(args)
    mask3d = _build_mask3d(args)

    def fidelity(mask_big):
        img = tiled_focus_images(mask_big, tile_config, source, [0.0],
                                 rank=args.rank, halo=args.halo,
                                 polarization=polarization, mask3d=mask3d,
                                 device=args.device)[0]
        profile = ((img / img.max()) > resist.threshold).float()
        out = pattern_fidelity(profile, target, tile_config)
        epe = edge_placement_errors(profile, target, tile_config)
        out.update({k: epe[k] for k in ("mean_abs_epe_nm", "max_abs_epe_nm",
                                        "matched", "missing")})
        return out

    t0 = time.perf_counter()
    corrected = opc_correct_tiled(
        target, tile_config, source, resist=resist, halo=args.halo,
        steps=args.steps, learning_rate=args.lr, rank=args.rank,
        sweeps=args.sweeps, polarization=polarization,
        chromatic=_build_chromatic(args), mask3d=mask3d)
    elapsed = time.perf_counter() - t0
    report = {
        "big_n": big_n, "tile_n": tile_config.n, "steps": args.steps,
        "sweeps": args.sweeps,
        "fidelity_before": fidelity(target),
        "fidelity_after": fidelity(corrected),
        "wall_clock_s": round(elapsed, 3),
    }
    if args.mrc_min_width or args.mrc_min_space or args.mrc_min_area:
        from .models.mrc import MaskRules, mrc_check, mrc_clean

        rules = MaskRules(min_width_nm=args.mrc_min_width,
                          min_space_nm=args.mrc_min_space,
                          min_area_nm2=args.mrc_min_area)
        check = mrc_check(corrected, tile_config, rules)
        report["mrc"] = {k: v for k, v in check.items()
                         if not isinstance(v, np.ndarray)}
        if args.mrc_repair and not check["clean"]:
            corrected = mrc_clean(corrected, tile_config, rules)
            recheck = mrc_check(corrected, tile_config, rules)
            report["mrc_after_repair"] = {
                k: v for k, v in recheck.items()
                if not isinstance(v, np.ndarray)}
            report["fidelity_after_repair"] = fidelity(corrected)
    print(json.dumps(report))
    if args.out:
        np.save(args.out, corrected)
        print(f"wrote {args.out}")
    return 0


def cmd_fitaberr(args) -> int:
    """Scanner aberration retrieval on --device: fit OSA Zernike
    coefficients to measured (through-focus) aerial images of a known test
    structure. The mask spectrum is formed and kept on the device."""
    from .ops.fraunhofer import mask_spectrum
    from .optimize import fit_aberrations

    config = _build_config(args)
    mask = _build_mask(args, config)
    source = _build_source(args, config)
    shifts, weights, _ = _padded_source(source, args.chunk * 8)
    images = np.stack([np.load(p).astype(np.float32) for p in args.images])
    if args.defocus is not None and len(args.defocus) != len(images):
        raise SystemExit(f"{len(images)} --images vs "
                         f"{len(args.defocus)} --defocus planes")
    spectrum = mask_spectrum(mask.geometry, config)
    target = images if args.defocus is not None else images[0]
    t0 = time.perf_counter()
    coeffs, history = fit_aberrations(
        target, spectrum, shifts, weights, config,
        n_coeffs=args.n_coeffs, steps=args.steps, learning_rate=args.lr,
        chunk=args.chunk, defocus_nm=args.defocus)
    print(json.dumps({
        "coefficients": [round(float(c), 6) for c in coeffs.cpu().numpy()],
        "loss_initial": history[0],
        "loss_final": history[-1],
        "planes": len(images),
        "wall_clock_s": round(time.perf_counter() - t0, 3),
    }))
    return 0


def cmd_lele(args) -> int:
    """Multiple patterning on --device: decompose the layout into --masks
    masks (2 = LELE, 3 = LELELE, ...), print each and the single exposure
    through the tiled SOCS path, report feature recovery; --gds writes
    the masks' contours as one GDSII cell, mask i on layer i."""
    from .models.multipatterning import multipatterning_print
    from .models.resist import ResistModel, feature_table

    config = _build_config(args)
    mask = _build_mask(args, config).geometry.abs()
    source = _build_source(args, config)
    overlay = None
    if args.overlay:
        if len(args.overlay) != 2 * args.masks:
            raise SystemExit(f"--overlay needs dy dx per mask "
                             f"({2 * args.masks} numbers for "
                             f"--masks {args.masks})")
        overlay = [(args.overlay[2 * i], args.overlay[2 * i + 1])
                   for i in range(args.masks)]
    t0 = time.perf_counter()
    out = multipatterning_print(
        mask, config, source, min_pitch_nm=args.min_pitch,
        masks=args.masks, overlay_nm=overlay,
        resist=ResistModel(threshold=args.threshold), rank=args.rank,
        halo=args.halo, polarization=_polarization(args),
        chromatic=_build_chromatic(args))
    elapsed = time.perf_counter() - t0

    def feats(m):
        return int(feature_table(m, config, axis=1)["row"].size)

    print(json.dumps({
        "masks": args.masks,
        "features": out["features"],
        "conflict_edges": out["conflict_edges"],
        "violations": out["violations"],
        "cuts_target": feats(mask),
        "cuts_lele": feats(out["profile"]),
        "cuts_single": feats(out["profile_single"]),
        "wall_clock_s": round(elapsed, 3),
    }))
    if args.out:
        np.savez(args.out, profile=out["profile"],
                 profile_single=out["profile_single"],
                 **{f"mask_{chr(ord('a') + i)}": m
                    for i, m in enumerate(out["masks"])})
        print(f"wrote {args.out}")
    if args.gds:
        from .io.contours import trace_contours
        from .io.gdsii import write_gds

        px = config.pixel_size
        cells = {"LELE": [
            (layer, xy)
            for layer, m in enumerate(out["masks"], start=1)
            for xy in trace_contours(m, pixel_size=px)
        ]}
        write_gds(args.gds, cells, unit_nm=1.0)
        print(f"wrote {args.gds} (mask i on layer i, {args.masks} masks)")
    return 0


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cuda', 'cuda:1', 'cpu')")


def _add_optics(p) -> None:
    p.add_argument("--pixel-number", type=int, default=64)
    p.add_argument("--pixel-size", type=float, default=25.0)
    p.add_argument("--wavelength", type=float, default=193.0)
    p.add_argument("--na", type=float, default=0.7)
    p.add_argument("--immersion-index", type=float, default=1.0,
                   help="image-side medium index (1.437 = water at 193 nm; "
                        "enables hyper-NA vector imaging)")
    p.add_argument("--obscuration", type=float, default=0.0,
                   help="central pupil obscuration as a fraction of NA")
    p.add_argument("--channel-tol", type=float, default=1e-6,
                   help="principal-channel compression trace tolerance for "
                        "polarized/chromatic kernel builds")


def _add_scene(p) -> None:
    """The device, the optics, the mask, the source, the aberrations and
    the thick-mask model."""
    _add_device(p)
    _add_optics(p)
    p.add_argument("--mask", default="demo", choices=["demo", "lines", "contacts"])
    p.add_argument("--mask-file", default=None,
                   help=".npy array or .gds layout for the mask (overrides "
                        "--mask)")
    p.add_argument("--gds-layer", type=int, default=None,
                   help="layer to keep when --mask-file is GDSII")
    p.add_argument("--source", default="quasar",
                   choices=["annular", "classical", "quasar", "dipole", "monopole"])
    p.add_argument("--sigma-in", type=float, default=0.4)
    p.add_argument("--sigma-out", type=float, default=0.8)
    p.add_argument("--shift-x", type=float, default=0.0)
    p.add_argument("--shift-y", type=float, default=0.0)
    p.add_argument("--poles", type=int, default=4)
    p.add_argument("--rotation", type=float, default=-np.pi / 8)
    p.add_argument("--aberrations", type=float, nargs="*", default=None,
                   help="Zernike coefficients in --zernike-indexing order "
                        "(OSA entry 4 / Noll term 4 is defocus in nm)")
    p.add_argument("--zernike-indexing", default="osa",
                   choices=["osa", "noll", "fringe"])
    p.add_argument("--mask3d-width", type=float, default=0.0,
                   help="thick-mask boundary-layer strip width in nm "
                        "(0 = thin/Kirchhoff mask)")
    p.add_argument("--mask3d-beta-h", type=complex, default=0j,
                   help="complex strip transmission on horizontal edges, "
                        "e.g. '-0.2+0.1j'")
    p.add_argument("--mask3d-beta-v", type=complex, default=0j,
                   help="complex strip transmission on vertical edges")
    p.add_argument("--m3d", metavar="FILE", default=None,
                   help="calibrated M3D model JSON from 'm3dcal --out' "
                        "(boundary layer incl. asymmetry, or multi-tap edge "
                        "kernel); overrides the scalar --mask3d-* flags")


def _add_polarization(p, help_text: str) -> None:
    p.add_argument("--polarization", default="scalar",
                   choices=["scalar", "x", "y", "unpolarized"], help=help_text)


def _add_chromatic(p) -> None:
    p.add_argument("--bandwidth-pm", type=float, default=0.0,
                   help="E95 laser bandwidth in pm (0 = monochromatic)")
    p.add_argument("--chromatic-focus", type=float, default=-250.0,
                   help="longitudinal chromatic aberration, nm defocus "
                        "per pm of wavelength")
    p.add_argument("--chromatic-samples", type=int, default=7)
    p.add_argument("--chromatic-shape", default="gaussian",
                   choices=["gaussian", "lorentzian", "tophat"])


def _add_common(p) -> None:
    """The scene, the polarization and the laser bandwidth."""
    _add_scene(p)
    _add_polarization(p, "vector (Jones-pupil) imaging for hyper-NA; "
                         "'scalar' = the reference's scalar path")
    _add_chromatic(p)


def _add_m3dcal(sub) -> None:
    p = sub.add_parser(
        "m3dcal", help="first-principles thick-mask (boundary-layer) "
                       "calibration against the in-repo rigorous RCWA solver")
    _add_device(p)
    _add_optics(p)
    p.add_argument("--stack", default="binary_cr",
                   choices=["binary_cr", "att_psm_mosi", "euv_ta"],
                   help="absorber stack to solve rigorously (euv_ta is "
                        "reflective: TaBN on a 40x Mo/Si mirror)")
    p.add_argument("--incidence", type=float, default=0.0,
                   help="illumination tilt in degrees (EUV chief ray ~6); "
                        "non-zero turns on the shadowing-asymmetry fit and, "
                        "with --taps, the direct conical-mount "
                        "horizontal-edge calibration")
    p.add_argument("--azimuth", type=float, default=0.0,
                   help="tilt direction in the layout plane, degrees from "
                        "+x (0 = across vertical lines)")
    p.add_argument("--taps", type=int, default=0,
                   help="fit the multi-tap EdgeKernelM3D with offsets "
                        "-taps..+taps instead of the 1-px boundary layer "
                        "(use >=1 for EUV stacks)")
    p.add_argument("--pol", default="unpolarized",
                   choices=["x", "y", "unpolarized"],
                   help="illumination polarization (x/y give an H-V split; "
                        "unpolarized is isotropic by symmetry)")
    p.add_argument("--pitch", type=int, default=16,
                   help="line/space pitch in pixels (must divide "
                        "--pixel-number)")
    p.add_argument("--duty", type=float, default=None,
                   help="absorber cover fraction (default: ~half pitch "
                        "rounded to an odd pixel count)")
    p.add_argument("--width-nm", type=float, default=8.0,
                   help="boundary-layer strip width held fixed in the fit")
    p.add_argument("--harmonics", type=int, default=31,
                   help="RCWA retained order count (odd)")
    p.add_argument("--sigma-out", type=float, default=0.5,
                   help="classical calibration source radius")
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--defocus", type=float, nargs="*", default=None,
                   metavar="NM",
                   help="through-focus calibration planes in nm (e.g. -80 0 "
                        "80); pins the sign of Im(beta) that an in-focus-only "
                        "target leaves weakly determined")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="also write the result JSON to FILE, for the "
                        "imaging commands' --m3d flag")
    p.set_defaults(func=cmd_m3dcal)


def _add_focus(sub) -> None:
    p = sub.add_parser("focus", help="through-focus stack + FEM CDs")
    _add_scene(p)
    p.add_argument("--focus-min", type=float, default=-100.0)
    p.add_argument("--focus-max", type=float, default=100.0)
    p.add_argument("--focus-steps", type=int, default=5)
    p.add_argument("--threshold", type=float, default=0.4)
    p.add_argument("--chunk", type=int, default=4)
    p.add_argument("--out", default=None, help="output .npy stack path")
    p.set_defaults(func=cmd_focus)


def _add_resist3d(sub) -> None:
    p = sub.add_parser("resist3d",
                       help="3-D resist develop (eikonal lateral etch)")
    _add_scene(p)
    p.add_argument("--nz", type=int, default=8)
    p.add_argument("--trials", type=int, default=0,
                   help="volumetric stochastic trials on the (nz, n, n) "
                        "exposure (0 = off): per-slab photon/acid counting "
                        "-> z-resolved LER/CD + defect rates in the report's "
                        "'stochastic' field")
    p.add_argument("--dose-photons", type=float, default=20.0,
                   help="absorbed photons/nm^2 at relative intensity 1 for "
                        "--trials (split across the nz slabs)")
    p.add_argument("--sto-threshold", type=float, default=0.3,
                   help="develop threshold of the stochastic model (--trials)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--thickness", type=float, default=100.0,
                   help="resist film thickness (nm)")
    p.add_argument("--develop-s", type=float, default=30.0)
    p.add_argument("--dose", type=float, default=1.0)
    p.add_argument("--absorbance", type=float, default=0.5,
                   help="lumped Dill absorbance (1/um)")
    p.add_argument("--reflectivity", type=float, default=0.0,
                   help="substrate intensity reflectance (standing waves)")
    p.add_argument("--lateral-rate-factor", type=float, default=1.0,
                   help="anisotropic develop: lateral etch rate as a "
                        "fraction of the vertical rate (1 = isotropic)")
    p.add_argument("--lateral-surface-factor", type=float, default=1.0,
                   help="extra lateral-rate suppression at the resist top, "
                        "relaxing over --inhibition-depth")
    p.add_argument("--inhibition-depth", type=float, default=0.0,
                   help="depth constant (nm) of the surface inhibition terms")
    p.add_argument("--surface-rate-factor", type=float, default=1.0,
                   help="isotropic surface inhibition: develop rate at the "
                        "resist top as a fraction of bulk")
    p.add_argument("--peb", type=float, default=0.0,
                   help="post-exposure-bake diffusion length (nm)")
    p.add_argument("--film", action="store_true",
                   help="rigorous electromagnetic image IN the resist over "
                        "the --substrate/--barc stack (replaces the "
                        "separable absorption x standing-wave model and the "
                        "--reflectivity knob)")
    p.add_argument("--n-resist", type=float, default=1.71,
                   help="resist refractive index (real part)")
    p.add_argument("--substrate", default="si", choices=["si", "sio2", "air"],
                   help="substrate material under the film stack "
                        "(--film only)")
    p.add_argument("--barc", type=float, default=0.0,
                   help="bottom antireflective coating thickness in nm "
                        "(0 = none; --film only)")
    p.add_argument("--barc-n", type=float, nargs=2, default=(1.82, 0.39),
                   metavar=("RE", "IM"), help="BARC complex refractive index")
    _add_polarization(p, "illumination polarization for the --film imager "
                         "(scalar = TE-Airy image in resist)")
    p.add_argument("--chunk", type=int, default=4)
    p.add_argument("--big-n", type=int, default=None,
                   help="full-chip size in px for --film: tiled film-SOCS "
                        "imaging through --pixel-number tiles (unused "
                        "without --film, as in the JAX package)")
    p.add_argument("--rank", type=int, default=64,
                   help="film-SOCS rank for the tiled --big-n path")
    p.add_argument("--halo", type=int, default=None,
                   help="tile guard band (px) for the --big-n path")
    p.add_argument("--out", default=None, help="3-D profile .npz path")
    p.add_argument("--plot", default=None,
                   help="cross-section .png path (needs matplotlib)")
    p.set_defaults(func=cmd_resist3d)


def _add_stochastic(sub) -> None:
    p = sub.add_parser("stochastic",
                       help="Monte-Carlo stochastic printing (LER/defects)")
    _add_common(p)
    p.add_argument("--solver", default="gau23",
                   choices=["gau23", "direct", "socs"])
    p.add_argument("--trials", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dose-photons", type=float, default=20.0,
                   help="absorbed photons per nm^2 at relative intensity 1 "
                        "(~20 = 30 mJ/cm^2 EUV)")
    p.add_argument("--quantum-efficiency", type=float, default=1.0)
    p.add_argument("--pag", type=float, default=0.0,
                   help="photo-acid generators per nm^2 (depletion "
                        "saturation; 0 = linear)")
    p.add_argument("--diffusion", type=float, default=5.0,
                   help="acid diffusion length (nm, 1-sigma)")
    p.add_argument("--threshold", type=float, default=0.3)
    p.add_argument("--noise", default="poisson", choices=["poisson", "gaussian"])
    p.add_argument("--out", default=None, help="print-probability map .npy path")
    p.add_argument("--psd", action="store_true",
                   help="add LER power-spectral-density analysis (averaged "
                        "edge PSD, Palasantzas fit, ACF correlation length)")
    p.add_argument("--psd-out", default=None,
                   help=".npz path for the PSD spectrum (implies --psd)")
    p.add_argument("--plot", default=None,
                   help="figure .png path (needs matplotlib)")
    p.set_defaults(func=cmd_stochastic)


def _add_calibrate(sub) -> None:
    p = sub.add_parser(
        "calibrate", help="fit resist model parameters to measured gauge CDs")
    _add_scene(p)
    p.add_argument("--images", nargs="+", required=True,
                   help="gauge aerial images (.npy), one per measurement")
    p.add_argument("--cds", type=float, nargs="+", required=True,
                   help="measured CDs (nm), one per gauge image")
    p.add_argument("--model", choices=["lumped", "mack"], default="lumped")
    p.add_argument("--fit", nargs="+", default=["threshold", "diffusion_nm"],
                   help="model fields to fit (others stay frozen)")
    p.add_argument("--threshold", type=float, default=0.3,
                   help="initial threshold (lumped model)")
    p.add_argument("--diffusion", type=float, default=0.0,
                   help="initial diffusion length nm (lumped model)")
    p.add_argument("--iters", type=int, default=150)
    p.set_defaults(func=cmd_calibrate)


def _add_fem(sub) -> None:
    p = sub.add_parser(
        "fem", help="full-chip focus-exposure matrix (tiled SOCS path)")
    _add_common(p)
    p.add_argument("--big-n", type=int, default=None,
                   help="full-chip mask size in px (default: one tile; "
                        "--pixel-number sets the tile size)")
    p.add_argument("--focus-min", type=float, default=-100.0)
    p.add_argument("--focus-max", type=float, default=100.0)
    p.add_argument("--focus-steps", type=int, default=5)
    p.add_argument("--doses", type=float, nargs="+",
                   default=[0.8, 0.9, 1.0, 1.1, 1.2])
    p.add_argument("--target-cd", type=float, default=None,
                   help="target CD in nm (default: self-calibrate to the "
                        "center-of-window CD)")
    p.add_argument("--cd-tolerance", type=float, default=0.10)
    p.add_argument("--threshold", type=float, default=0.4)
    p.add_argument("--rank", type=int, default=128)
    p.add_argument("--halo", type=int, default=None,
                   help="tile halo px (default: optics-derived)")
    p.add_argument("--tiles-per-dispatch", type=int, default=8)
    p.add_argument("--no-warm-start", action="store_true",
                   help="build every plane's kernels cold (no warm start "
                        "from the previous plane's basis)")
    p.add_argument("--hotspot-nils", type=float, default=None,
                   help="report feature locations with NILS below this "
                        "printability floor (e.g. 1.5)")
    p.add_argument("--pv-bands", default=None,
                   help="accumulate process-variability bands over the "
                        "focus x dose corners and write outer/inner/band "
                        "contour maps to this .npz (per-edge band stats "
                        "land in the JSON report)")
    p.add_argument("--cdu-map", default=None,
                   help="write the nominal-condition CD-uniformity map "
                        "(.npy, or an image extension, which needs "
                        "matplotlib)")
    p.add_argument("--stream", action="store_true",
                   help="stream tile windows straight from --mask-file "
                        "(no full-chip raster; any layout size)")
    p.set_defaults(func=cmd_fem)


def _add_smo(sub) -> None:
    p = sub.add_parser("smo", help="inverse lithography (mask optimization)")
    _add_scene(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.2)
    p.add_argument("--steepness", type=float, default=4.0)
    p.add_argument("--threshold", type=float, default=0.4)
    p.add_argument("--chunk", type=int, default=4)
    p.add_argument("--forward", choices=("abbe", "socs"), default="abbe",
                   help="mask-step forward model: exact per-point Abbe, "
                        "or SOCS kernels (O(rank) work per step)")
    p.add_argument("--rank", type=int, default=64,
                   help="SOCS kernel rank for --forward socs")
    p.add_argument("--out", default=None, help="optimized mask .npy path")
    p.set_defaults(func=cmd_smo)


def _add_opc(sub) -> None:
    p = sub.add_parser(
        "opc", help="full-chip resist-aware OPC (tiled SOCS path)")
    _add_common(p)
    p.add_argument("--big-n", type=int, default=None,
                   help="full-chip layout size in px (default: one tile)")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--sweeps", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.15)
    p.add_argument("--threshold", type=float, default=0.35)
    p.add_argument("--rank", type=int, default=64)
    p.add_argument("--halo", type=int, default=None)
    p.add_argument("--mrc-min-width", type=float, default=0.0,
                   help="mask-rule check: min feature width (nm)")
    p.add_argument("--mrc-min-space", type=float, default=0.0,
                   help="mask-rule check: min space/gap (nm)")
    p.add_argument("--mrc-min-area", type=float, default=0.0,
                   help="mask-rule check: min feature area (nm^2)")
    p.add_argument("--mrc-repair", action="store_true",
                   help="morphologically repair MRC violations and "
                        "re-report fidelity")
    p.add_argument("--out", default=None, help="corrected mask .npy path")
    p.set_defaults(func=cmd_opc)


def _add_fitaberr(sub) -> None:
    p = sub.add_parser(
        "fitaberr", help="scanner aberration retrieval from measured "
                         "through-focus aerial images")
    _add_scene(p)
    p.add_argument("--images", nargs="+", required=True,
                   help="measured aerial images (.npy), one per plane")
    p.add_argument("--defocus", type=float, nargs="+", default=None,
                   help="stage defocus (nm) of each image; omit for a "
                        "single-image fit (even-aberration signs then "
                        "unresolvable)")
    p.add_argument("--n-coeffs", type=int, default=10)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--chunk", type=int, default=4)
    p.set_defaults(func=cmd_fitaberr)


def _add_lele(sub) -> None:
    p = sub.add_parser(
        "lele", help="double patterning: decompose + composite print")
    _add_common(p)
    p.add_argument("--masks", type=int, default=2,
                   help="number of patterning masks (2=LELE, 3=LELELE)")
    p.add_argument("--overlay", type=float, nargs="+", default=None,
                   help="scanner overlay error: dy dx nm per mask "
                        "(2*masks numbers)")
    p.add_argument("--min-pitch", type=float, default=200.0,
                   help="minimum same-mask pitch (nm) for decomposition")
    p.add_argument("--threshold", type=float, default=0.35)
    p.add_argument("--rank", type=int, default=48)
    p.add_argument("--halo", type=int, default=None)
    p.add_argument("--out", default=None,
                   help=".npz path for masks + profiles")
    p.add_argument("--gds", default=None,
                   help="write the decomposed masks' contours as a GDS "
                        "cell (mask i on layer i)")
    p.set_defaults(func=cmd_lele)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="lithographysimulator_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("simulate", help="compute an aerial image")
    _add_common(p)
    p.add_argument("--solver", default="gau23",
                   choices=["gau23", "direct", "socs"])
    p.add_argument("--socs-rank", default="auto",
                   help="SOCS rank: an int, or 'auto' (99.9%% captured energy)")
    p.add_argument("--chunk", type=int, default=4)
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--msd-x", type=float, default=0.0,
                   help="scanner stage-blur MSD along x (nm, 1-sigma)")
    p.add_argument("--msd-y", type=float, default=0.0,
                   help="scanner stage-blur MSD along y (nm, 1-sigma)")
    p.add_argument("--flare-tis", type=float, default=0.0,
                   help="flare: total integrated scatter in [0, 1)")
    p.add_argument("--flare-kernel", type=float, default=0.0,
                   help="flare spread sigma in nm (0 = uniform background)")
    p.add_argument("--out", default=None, help="output .npy path")
    p.add_argument("--plot", default=None,
                   help="output .png figure path (needs matplotlib)")
    p.set_defaults(func=cmd_simulate)

    p = sub.add_parser("demo", help="reference demo pipeline + figure")
    _add_common(p)
    p.add_argument("--solver", default="gau23", choices=["gau23", "direct"])
    p.add_argument("--out", default=None,
                   help="figure path (default demo.png; needs matplotlib)")
    p.set_defaults(func=cmd_demo)

    p = sub.add_parser("socs", help="build (and save) SOCS kernels")
    _add_common(p)
    p.add_argument("--rank", type=int, default=64)
    p.add_argument("--power-iters", type=int, default=2)
    p.add_argument("--lean", default="auto", choices=["auto", "on", "off"],
                   help="single-buffer in-place build (a lower memory "
                        "peak than the standard build)")
    p.add_argument("--out", default=None, help="output .npz path")
    p.set_defaults(func=cmd_socs)
    _add_m3dcal(sub)
    _add_focus(sub)
    _add_resist3d(sub)
    _add_stochastic(sub)
    _add_calibrate(sub)
    _add_fem(sub)
    _add_smo(sub)
    _add_opc(sub)
    _add_fitaberr(sub)
    _add_lele(sub)
    return parser


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    return args.func(args)
