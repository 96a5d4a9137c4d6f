"""Command-line interface of the port: the ``simulate``, ``socs`` and
``m3dcal`` subcommands.

Same flags as ``python -m lithographysimulator_tpu simulate`` / ``socs`` /
``m3dcal`` for the masks, sources, solvers and imaging options this port
has (vector, chromatic, thick mask and, on ``simulate``, the scanner
perturbations), plus ``--device`` and, for ``simulate``, ``--socs-rank``:

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
"""

from __future__ import annotations

import argparse
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
        if not str(args.mask_file).lower().endswith(".npy"):
            raise SystemExit("--mask-file takes a .npy array (GDSII import is "
                             "ROADMAP.md Queue 1 item 6)")
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


def _add_common(p) -> None:
    _add_device(p)
    _add_optics(p)
    p.add_argument("--mask", default="demo", choices=["demo", "lines", "contacts"])
    p.add_argument("--mask-file", default=None,
                   help=".npy array for the mask (overrides --mask)")
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
    p.add_argument("--polarization", default="scalar",
                   choices=["scalar", "x", "y", "unpolarized"],
                   help="vector (Jones-pupil) imaging for hyper-NA; "
                        "'scalar' = the reference's scalar path")
    p.add_argument("--bandwidth-pm", type=float, default=0.0,
                   help="E95 laser bandwidth in pm (0 = monochromatic)")
    p.add_argument("--chromatic-focus", type=float, default=-250.0,
                   help="longitudinal chromatic aberration, nm defocus "
                        "per pm of wavelength")
    p.add_argument("--chromatic-samples", type=int, default=7)
    p.add_argument("--chromatic-shape", default="gaussian",
                   choices=["gaussian", "lorentzian", "tophat"])
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


def main(argv=None) -> int:
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
    p.set_defaults(func=cmd_simulate)

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
    args = parser.parse_args(argv)
    return args.func(args)
