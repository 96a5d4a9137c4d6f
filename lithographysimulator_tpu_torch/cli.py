"""Command-line interface of the port: the ``simulate`` subcommand.

Same flags as ``python -m lithographysimulator_tpu simulate`` for the masks,
sources and solvers this port has, plus ``--device``:

    python -m lithographysimulator_tpu_torch simulate --device cuda \
        --pixel-number 512 --source quasar --sigma-in 0.4 --sigma-out 0.8 \
        --aberrations 0 0 0.01 0 100 --out aerial.npy
"""

from __future__ import annotations

import argparse
import json
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


def cmd_simulate(args) -> int:
    from .simulate import simulate

    config = _build_config(args)
    mask = _build_mask(args, config)
    source = _build_source(args, config)
    result = simulate(mask, source, _aberrations(args), device=args.device,
                      solver=args.solver, chunk=args.chunk,
                      normalize=args.normalize)
    print(json.dumps(result.report, default=repr))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(out, result.image.cpu().numpy())
        Path(str(out.with_suffix("")) + ".report.json").write_text(
            json.dumps(result.report, indent=2, default=repr))
        print(f"wrote {args.out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="lithographysimulator_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("simulate", help="compute an aerial image")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cuda', 'cuda:1', 'cpu')")
    p.add_argument("--pixel-number", type=int, default=64)
    p.add_argument("--pixel-size", type=float, default=25.0)
    p.add_argument("--wavelength", type=float, default=193.0)
    p.add_argument("--na", type=float, default=0.7)
    p.add_argument("--immersion-index", type=float, default=1.0)
    p.add_argument("--obscuration", type=float, default=0.0,
                   help="central pupil obscuration as a fraction of NA")
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
    p.add_argument("--solver", default="gau23", choices=["gau23", "direct"])
    p.add_argument("--chunk", type=int, default=4)
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--out", default=None, help="output .npy path")
    p.set_defaults(func=cmd_simulate)
    args = parser.parse_args(argv)
    return args.func(args)
