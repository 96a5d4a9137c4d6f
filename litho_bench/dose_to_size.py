#!/usr/bin/env python3
"""Dose to size of a stochastic-resist configuration: the develop
threshold at which the deterministic contour of a grating at the
configuration's ``dose_to_size`` pitch prints its target CD.

    python3 litho_bench/dose_to_size.py [--config euv1024] [--device cuda]

from the root of a checkout. The image is the cell's own (``simulate``
through SOCS at the configuration's rank, with its perturbation) of
gratings at the pitch with the layout's line fraction, over ``--phases``
phases; the CD is the mean width of the runs of the deterministic field
(:func:`litho_bench.reference.stochastic.deterministic`) on every
``row_step``-th cut line, as the ensemble reports ``deterministic_cd_nm``.
The threshold is found by bisection and printed, with the CD it gives at
every pitch of the layout.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def mean_cd(field, threshold: float, pixel_nm: float, row_step: int) -> float:
    from litho_bench.reference import stochastic as rst

    r = rst.runs(field[::row_step], threshold)
    return float(((r["fall"] - r["rise"]) * pixel_nm).mean()) if r["line"].size else 0.0


def fields(cfg: dict, pitch_nm: float, phases: int, device: str) -> list:
    """The deterministic fields of ``phases`` gratings at ``pitch_nm``."""
    from litho_bench import lines, program
    from litho_bench.drivers import stochastic_stream as drv
    from litho_bench.reference import stochastic as rst
    from litho_bench.reference import vector as rv

    lt = program.lt()
    oc = drv.optics(cfg)
    n, px = cfg["pixel_number"], cfg["pixel_nm"]
    pitch = lines.whole_px(pitch_nm, px)
    cd = int(round(pitch * cfg["grating"]["cd_of_pitch"]))
    out = []
    for k in range(phases):
        g = lines.grating(n, pitch, cd, (k * pitch) // phases, device=device)
        image = lt.simulate(lt.Mask(geometry=g, config=oc), rv.dipole_source(cfg),
                            program.aberrations(cfg), solver="socs",
                            socs_rank=cfg["socs_rank"],
                            perturb=drv.perturbation(cfg), device=device).image
        out.append(rst.deterministic(image, cfg["resist"], px))
    return out


def threshold_for(dets: list, target_nm: float, pixel_nm: float,
                  row_step: int) -> float:
    """The threshold whose mean CD over ``dets`` is ``target_nm`` (the CD
    falls as the threshold rises)."""
    lo, hi = 0.0, 1.0
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        cd = sum(mean_cd(f, mid, pixel_nm, row_step) for f in dets) / len(dets)
        lo, hi = (mid, hi) if cd > target_nm else (lo, mid)
    return 0.5 * (lo + hi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="euv1024")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--phases", type=int, default=4)
    args = ap.parse_args(argv)
    cfg = json.loads((ROOT / "litho_bench" / "configs" / f"{args.config}.json")
                     .read_text())
    target = cfg["dose_to_size"]
    px = cfg["pixel_nm"]
    row_step = max(1, cfg["pixel_number"] // 512)
    dets = fields(cfg, target["pitch_nm"], args.phases, args.device)
    thr = threshold_for(dets, target["target_cd_nm"], px, row_step)
    print(json.dumps({"threshold": thr, "pitch_nm": target["pitch_nm"],
                      "cd_nm": target["target_cd_nm"]}))
    for pitch in cfg["grating"]["pitches_nm"]:
        cds = [mean_cd(f, thr, px, row_step)
               for f in fields(cfg, pitch, args.phases, args.device)]
        print(json.dumps({"pitch_nm": pitch, "cd_nm_by_phase": cds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
