"""Command-line interface of the port: the ``simulate`` and ``socs``
subcommands.

Same flags as ``python -m lithographysimulator_tpu simulate`` / ``socs`` for
the masks, sources, solvers and imaging options this port has (vector,
chromatic and, on ``simulate``, the scanner perturbations), plus
``--device`` and, for ``simulate``, ``--socs-rank``:

    python -m lithographysimulator_tpu_torch simulate --device cuda \
        --pixel-number 512 --source quasar --sigma-in 0.4 --sigma-out 0.8 \
        --aberrations 0 0 0.01 0 100 --out aerial.npy
    python -m lithographysimulator_tpu_torch simulate --device cuda \
        --pixel-number 1024 --na 1.35 --immersion-index 1.437 \
        --polarization x --bandwidth-pm 0.3 --msd-x 5
    python -m lithographysimulator_tpu_torch socs --device cuda \
        --pixel-number 1024 --rank 256 --power-iters 1 \
        --polarization unpolarized --out kernels.npz
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
                             "ROADMAP.md Queue 1 item 14)")
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
                      perturb=_build_perturb(args))
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


def _add_common(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cuda', 'cuda:1', 'cpu')")
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
    args = parser.parse_args(argv)
    return args.func(args)
