"""The seven collective patterns of :mod:`.` on one mesh, as a dry run.

The port's counterpart of the JAX package's ``dryrun_multichip``: at 64^2
on a (2, n/2) ('focus', 'source') mesh (and a 1-D mesh over the same
entries) it runs one SMO training step through
:func:`.abbe_sharded.through_focus_sharded` on the windowed ``matmul``
engine, the FEM cell pass, the sharded Rayleigh-Ritz and Nystrom builds
against the local ones, the rank-sharded int8 apply, the tiled chip with
a boundary layer and an 8 px halo, the stochastic band, the film stack and
the volumetric band, with the JAX package's checks and thresholds, and
prints one ``dryrun_multichip OK: ...`` line a pattern. Any miss raises.

    python -m lithographysimulator_tpu_torch.parallel.dryrun --devices 4
    python -m lithographysimulator_tpu_torch.parallel.dryrun --devices 4 --device cpu

``--device cuda`` (the default) spreads the entries over the visible
cards, repeating them where there are fewer cards than entries (one H100
runs a 4-entry mesh of ``cuda:0``); ``--device cpu`` repeats the host.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .mesh import FOCUS_AXIS, SOURCE_AXIS, Mesh


def _mesh_devices(n_devices: int, device) -> list:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("dryrun_multichip: no CUDA device is visible "
                               "(pass device='cpu' for a host mesh)")
        return [torch.device("cuda", i % count) for i in range(n_devices)]
    return [device] * n_devices


def _nrms(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.double(), ref.double().to(a.device)
    return float(torch.sqrt(torch.mean((a - ref) ** 2))
                 / torch.clamp(ref.abs().max(), min=1e-30))


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


def dryrun_multichip(n_devices: int, *, device="cuda") -> None:
    """Run the seven patterns on a mesh of ``n_devices`` entries of
    ``device`` (see the module docstring); raises on the first miss."""
    from .. import (BoundaryLayer, LightSource, OpticsConfig, ResistModel,
                    StochasticResist, WaferStack, demo_bars, film_stack_images,
                    mask_spectrum, pupil_function, randomized_socs, socs_image)
    from ..ops.focus import focus_stack_aberrations
    from ..optimize import latent_from_mask, mask_from_latent
    from . import (fem_cd_matrix_sharded, film_stack_sharded,
                   padded_source_arrays, print_probability_sharded,
                   print_probability_volume_sharded, randomized_socs_sharded,
                   socs_image_sharded, through_focus_sharded,
                   tiled_socs_image_sharded)

    devices = _mesh_devices(n_devices, device)
    first = devices[0]
    # 64^2, so the windowed zoom-DFT, the int8 contraction, the halo
    # stitching and the FEM pass all run (no pattern is fft-only)
    cfg = OpticsConfig(pixel_number=64)
    chunk = 4
    if n_devices % 2 == 0 and n_devices >= 4:
        grid = (2, n_devices // 2)
    elif n_devices % 2 == 0:
        grid = (2, 1)
    else:
        grid = (1, n_devices)
    mesh = Mesh(np.asarray(devices[:grid[0] * grid[1]], dtype=object).reshape(grid),
                (FOCUS_AXIS, SOURCE_AXIS))
    n_src = mesh.shape[SOURCE_AXIS]

    src = LightSource(cfg, sigma_out=0.5).classical()
    shifts, weights, _ = padded_source_arrays(src, n_src * chunk)
    max_shift = int(np.abs(shifts).max())
    ab_stack = focus_stack_aberrations(np.zeros(5, np.float32),
                                       np.array([0.0, 50.0], np.float32))
    bars = demo_bars(cfg, device=first).geometry

    # (1) one SMO step through the source psum and the focus split
    target = torch.zeros((2, cfg.n, cfg.n), dtype=torch.float32, device=first)
    latent = latent_from_mask(bars, 4.0).detach().requires_grad_()
    optimizer = torch.optim.Adam([latent], lr=0.05)
    spectrum = mask_spectrum(mask_from_latent(latent, 4.0), cfg, solver="gau23")
    stack = through_focus_sharded(
        spectrum, ab_stack, shifts, weights, cfg, mesh, chunk=chunk,
        normalize=True, engine="matmul", max_abs_shift=max_shift)
    loss = torch.mean((stack - target) ** 2)
    optimizer.zero_grad()
    loss.backward()
    optimizer.step()
    loss = loss.detach().item()
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite training loss: {loss}")
    if not _finite(latent.detach()):
        raise AssertionError("non-finite latent after the step")
    print(f"dryrun_multichip OK: mesh {mesh.shape} ({n_devices} devices), one "
          f"SMO training step at 64^2 (windowed matmul engine), loss={loss:.6g}")

    # (focus x dose) FEM cell pass on the same 2-D mesh
    spec0 = mask_spectrum(bars, cfg, solver="gau23")
    cds = fem_cd_matrix_sharded(
        spec0, np.zeros(5, np.float32), np.array([0.0, 50.0], np.float32),
        np.array([0.9, 1.0, 1.1], np.float32), shifts, weights, cfg, mesh,
        resist=ResistModel(threshold=0.3, diffusion_nm=10.0), chunk=chunk,
        engine="matmul", max_abs_shift=max_shift)
    if tuple(cds.shape) != (2, 3) or not _finite(cds):
        raise AssertionError(f"bad FEM matrix {cds}")
    if not bool((torch.diff(cds, dim=1) > 0).all()):
        raise AssertionError(f"FEM CD not monotone in dose: {cds}")
    print("dryrun_multichip OK: fem_cd_matrix_sharded (focus shards x dose "
          "loop + source psum) on the 2-D mesh")

    mesh1d = Mesh(devices, (SOURCE_AXIS,))
    pupil = pupil_function(np.zeros(1, np.float32), cfg, device=first)
    socs = randomized_socs(pupil, src, cfg, rank=8, oversample=8,
                           power_iters=1, lean=False)

    # (2) the sharded kernel build: FFT row shards + Gram partial sums
    socs_dist = randomized_socs_sharded(pupil, src, cfg, mesh1d, rank=8,
                                        oversample=8, power_iters=1)
    img_local = socs_image(spec0, socs, cfg, chunk=1)
    img_dist = socs_image(spec0, socs_dist, cfg, chunk=1)
    err = _nrms(img_dist, img_local)
    if not (_finite(img_dist) and err < 1e-5):
        raise AssertionError(f"sharded RR build image nRMS {err}")
    print(f"dryrun_multichip OK: randomized_socs_sharded (sharded kernel "
          f"build: FFT row shards + gram psums), image nRMS vs local build "
          f"{err:.2e}")

    # (2b) the Nystrom core against the local Nystrom build at equal seed
    img_ny_local = socs_image(spec0, randomized_socs(
        pupil, src, cfg, rank=8, oversample=8, power_iters=1, lean=False,
        method="nystrom"), cfg, chunk=1)
    img_ny = socs_image(spec0, randomized_socs_sharded(
        pupil, src, cfg, mesh1d, rank=8, oversample=8, power_iters=1,
        method="nystrom"), cfg, chunk=1)
    err = _nrms(img_ny, img_ny_local)
    if not (_finite(img_ny) and err < 1e-5):
        raise AssertionError(f"sharded Nystrom build image nRMS {err}")
    print(f"dryrun_multichip OK: randomized_socs_sharded method='nystrom' "
          f"(2 sharded matvecs), image nRMS vs local Nystrom build {err:.2e}")

    # (3) the rank-sharded int8 apply: kernel shards + one intensity sum
    img_sharded = socs_image_sharded(spec0, socs, cfg, mesh1d, chunk=1,
                                     engine="int8")
    dev_max = float((img_sharded - img_local).abs().max()
                    / torch.clamp(img_local.abs().max(), min=1e-30))
    if not (_finite(img_sharded) and dev_max < 1e-4):
        raise AssertionError(f"rank-sharded int8 apply max dev {dev_max}")
    print(f"dryrun_multichip OK: socs_image_sharded (rank shards + psum, "
          f"int8 engine), max dev {dev_max:.2e}")

    # (4) the tile-sharded chip with halo stitching and a boundary layer
    big = np.zeros((3 * cfg.n, 3 * cfg.n), np.float32)
    big[10:14, 10:38] = 1.0
    big[30:44, 22:26] = 1.0
    img_tiled = tiled_socs_image_sharded(
        torch.as_tensor(big, device=first), socs, cfg, mesh1d, halo=8,
        chunk=1, mask3d=BoundaryLayer(width_nm=8.0, beta_h=-0.2,
                                      beta_v=-0.2 + 0.05j))
    if (tuple(img_tiled.shape) != big.shape or not _finite(img_tiled)
            or not float(img_tiled.max()) > 0):
        raise AssertionError("bad tiled image")
    print("dryrun_multichip OK: tiled_socs_image_sharded (replicated kernels "
          "+ tile all-gather, halo=8)")

    # (5) the trial-sharded stochastic band
    model = StochasticResist(dose_photons_per_nm2=5.0, diffusion_nm=4.0,
                             threshold=0.4, noise="gaussian")
    band = print_probability_sharded(img_tiled[:cfg.n, :cfg.n] + 1e-6, cfg,
                                     model, mesh1d, trials_per_device=2, seed=0)
    if (tuple(band.shape) != (cfg.n, cfg.n) or not float(band.min()) >= 0.0
            or not float(band.max()) <= 1.0):
        raise AssertionError("bad print-probability band")
    print("dryrun_multichip OK: print_probability_sharded (sharded trials + "
          "band psum)")

    # (6) the film stack's source psum against the local exact stack
    wafer = WaferStack(n_resist=1.71 + 0.01j, thickness_nm=120.0,
                       under_layers=((37.0, 1.82 + 0.39j),))
    depths = [20.0, 100.0]
    mask = demo_bars(cfg, device=first)
    film_local = film_stack_images(mask, src, device=first, config=cfg,
                                   wafer_stack=wafer, depths_nm=depths,
                                   engine="matmul", normalize=True)
    film_dist = film_stack_sharded(mask, src, config=cfg, wafer_stack=wafer,
                                   mesh=mesh1d, depths_nm=depths,
                                   engine="matmul", normalize=True)
    err = _nrms(film_dist, film_local)
    if (tuple(film_dist.shape) != (2, cfg.n, cfg.n) or not _finite(film_dist)
            or not err < 1e-5):
        raise AssertionError(f"sharded film stack nRMS {err}")
    print(f"dryrun_multichip OK: film_stack_sharded (source psum over the "
          f"per-slab film component loop), nRMS vs local exact {err:.2e}")

    # (7) the volumetric band on the film stack
    vol_band = print_probability_volume_sharded(
        film_local, cfg, model, mesh1d, dz_nm=80.0, trials_per_device=2,
        seed=0)
    if (vol_band.shape != film_local.shape or not float(vol_band.min()) >= 0.0
            or not float(vol_band.max()) <= 1.0):
        raise AssertionError("bad volumetric band")
    print("dryrun_multichip OK: print_probability_volume_sharded (sharded "
          "trials + volumetric band psum on the film stack)")

    print(f"dryrun_multichip OK: all 7 collective patterns on {n_devices} "
          f"devices ({sorted({str(d) for d in devices})}): source psum / "
          "sharded kernel build / rank psum / tile all-gather / trial psum / "
          "film-stack source psum / volumetric trial psum")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m lithographysimulator_tpu_torch.parallel.dryrun",
        description="The seven multi-device patterns at 64^2 on one mesh.")
    parser.add_argument("--devices", type=int, default=4,
                        help="mesh entries (default 4)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the visible cards, repeated as needed), "
                             "'cuda:1', or 'cpu'")
    args = parser.parse_args(argv)
    dryrun_multichip(args.devices, device=args.device)


if __name__ == "__main__":
    main()
