"""End-to-end production flow on a small chip, on the PyTorch/CUDA port.

Design -> OPC -> mask rule check/repair -> ORC sign-off -> focus-exposure
matrix (process window + NILS + CDU) -> dose-map correction -> stochastic
printability -> printed-contour GDS export, through
``lithographysimulator_tpu_torch``: the same steps, parameters, printed
lines and files as ``examples/production_flow.py`` (the JAX package's
tour). Every step is the same API the full-chip paths use; the defaults
keep the flow small enough for the CPU (``--device cpu``, about 10 s);
on a card, scale ``--big-n`` and ``--tile-n`` up (4096 and 1024: 25 tiles).

The layout and the source are uploaded once. OPC returns the corrected
mask to the host, where the MRC repair runs; it is uploaded once and stays
on ``device`` through ORC, the FEM, the stochastic ensemble and the focus
image. The developed profile is read back once, by the GDS writer.
``--device cuda`` without a card is an error: nothing falls back to the
CPU.

Run: python examples/production_flow_torch.py [--big-n 128] [--tile-n 64]
     [--out-dir .] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import lithographysimulator_tpu_torch as lt  # noqa: E402


def design(big_n: int, tile_n: int, device) -> tuple:
    """The flow's inputs: the optics of one ``tile_n`` tile, the
    ``big_n``-square contact layout (12 x 20 px contacts on a 40 px pitch)
    and the annular source on ``device``, the resist and the mask rules."""
    cfg = lt.OpticsConfig(pixel_number=tile_n)
    layout = np.zeros((big_n, big_n), np.float32)
    for y in range(16, big_n - 16, 40):
        for x in range(16, big_n - 16, 40):
            layout[y:y + 12, x:x + 20] = 1.0
    source = lt.LightSource(cfg, sigma_out=0.6).annular()
    resist = lt.ResistModel(threshold=0.3, steepness=30.0)
    rules = lt.MaskRules(min_width_nm=2 * cfg.pixel_size,
                         min_area_nm2=6 * cfg.pixel_size ** 2)
    return (cfg, torch.as_tensor(layout, device=device),
            torch.as_tensor(source, device=device), resist, rules)


def run_flow(big_n: int, tile_n: int, out_dir, device) -> dict:
    """Run the flow on ``device``, print its summary lines, write
    ``printed_contours.gds`` and ``corrected_mask.npy`` into ``out_dir``
    and return each stage's result: ``corrected`` (the MRC-clean mask, host
    float32), ``mrc``, ``orc`` (the deck), ``fem``, ``dose_map`` (None when
    the CDU is flat), ``stochastic``, ``profile`` (the developed in-focus
    print, on ``device``), ``gds`` (its path) and ``stage_s`` (each stage's
    wall seconds, the device synchronized at its end)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but "
                           "torch.cuda.is_available() is False")
    out_dir = Path(out_dir)
    stage_s: dict = {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        stage_s[name] = now - clock[0]
        clock[0] = now

    # -- 1. design + optics --------------------------------------------------
    cfg, layout, source, resist, rules = design(big_n, tile_n, device)
    lap("design")

    # -- 2. OPC + MRC repair -------------------------------------------------
    from lithographysimulator_tpu_torch.optimize import opc_correct_tiled

    corrected = opc_correct_tiled(layout, cfg, source, resist=resist,
                                  halo=16, steps=12, rank=48,
                                  learning_rate=0.2, device=device)
    lap("opc")
    corrected = lt.mrc_clean(corrected, cfg, rules)
    mrc = lt.mrc_check(corrected, cfg, rules)
    print("MRC:", json.dumps({k: v for k, v in mrc.items()
                              if not isinstance(v, np.ndarray)}))
    mask = torch.as_tensor(corrected, device=device)
    lap("mrc")

    # -- 3. ORC sign-off -----------------------------------------------------
    deck = lt.orc_check(mask, layout, cfg, source, resist=resist,
                        rank=48, halo=16, mrc_rules=rules, epe_spec_nm=90.0,
                        device=device)
    print("ORC:", json.dumps({"pass": deck["pass_"],
                              "iou": round(deck["fidelity"]["iou"], 3),
                              "mean_nils": round(deck["nils"]["mean_nils"], 2),
                              "epe_max": deck["epe"]["max_abs_epe_nm"]}))
    lap("orc")

    # -- 4. process window + dose correction ---------------------------------
    fem = lt.tiled_fem(mask, cfg, source,
                       defocus_nm=[-80.0, 0.0, 80.0],
                       doses=[0.85, 1.0, 1.15], resist=resist,
                       rank=48, halo=16, cd_stat="mean", device=device)
    print("FEM:", json.dumps({
        "dof_nm": fem["depth_of_focus_nm"],
        "exposure_latitude": round(fem["exposure_latitude"], 3),
        "cdu_3sigma_nm": round(fem["cdu"]["cdu_3sigma_nm"], 2)}))
    lap("fem")
    try:
        dc = lt.dose_correction_map(fem)
        print("dose map: sensitivity "
              f"{dc['sensitivity_nm_per_dose']:.1f} nm/dose, "
              f"max residual {dc['predicted_residual_nm']:.2f} nm")
    except ValueError as exc:  # flat CDU: nothing to correct
        dc = None
        print("dose map: skipped:", exc)
    lap("dose_map")

    # -- 5. stochastic printability ------------------------------------------
    sto = lt.tiled_stochastic(
        mask, cfg, source,
        model=lt.StochasticResist(dose_photons_per_nm2=20.0,
                                  diffusion_nm=8.0, threshold=0.3),
        trials=8, rank=48, halo=16, device=device)
    print("stochastic:", json.dumps({
        "ler_nm": round(sto["ler_nm"], 2),
        "break_rate": sto["break_rate"],
        "bridge_rate": sto["bridge_rate"]}))
    lap("stochastic")

    # -- 6. printed contours back to layout land ------------------------------
    image = lt.tiled_focus_images(mask, cfg, source, [0.0],
                                  rank=48, halo=16, device=device)[0]
    profile = resist.develop_binary(image / image.max(), cfg,
                                    normalize=False)
    gds = out_dir / "printed_contours.gds"
    from lithographysimulator_tpu_torch.io.contours import contours_to_gds

    contours_to_gds(gds, profile, cfg, layer=1)
    np.save(out_dir / "corrected_mask.npy", corrected)
    print(f"wrote {gds} and corrected_mask.npy")
    lap("contours")
    return {"corrected": corrected, "mrc": mrc, "orc": deck, "fem": fem,
            "dose_map": dc, "stochastic": sto, "profile": profile,
            "gds": gds, "stage_s": stage_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--big-n", type=int, default=128)
    ap.add_argument("--tile-n", type=int, default=64)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    run_flow(args.big_n, args.tile_n, args.out_dir, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
