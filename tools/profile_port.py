#!/usr/bin/env python3
"""Kernel-time breakdown of the PyTorch/CUDA port (lithographysimulator_tpu_torch)
on one CUDA card, from torch.profiler. Run from the repository root:

    PYTHONPATH=. python3 tools/profile_port.py [--chunks 512] [--rank 256] [--exact-only] [--vector]
    PYTHONPATH=. python3 tools/profile_port.py --stochastic
    PYTHONPATH=. python3 tools/profile_port.py --tiled
    PYTHONPATH=. python3 tools/profile_port.py --optimize
    PYTHONPATH=. python3 tools/profile_port.py --parallel

1. 1024^2 exact Abbe (lines/spaces 64/128 px, quasar sigma 0.4/0.8, as in
   chip_smoke.py phase 4): the first ``chunks`` chunks of 4 source points
   through abbe_image_points on the int8 and the f32 matmul engines;
2. 1024^2 SOCS, the same mask and source: one rank-``rank``
   randomized_socs build (Rayleigh-Ritz, power_iters=2, as simulate uses)
   and one socs_image apply on each of the int8, matmul and fft engines
   (skipped with --exact-only);
3. with --vector, the paths of vector and chromatic imaging: the same
   ``chunks`` chunks through vector_abbe_image (unpolarized, six component
   passes, int8), the rank-``rank`` randomized_socs_vector build
   (unpolarized) and randomized_socs_chromatic build (0.3 pm E95, 5
   samples), both as bench.py runs them (power_iters=1, the setup's
   channel rotation).

With --stochastic it traces the resist paths instead of 1-3, on the
rank-``rank`` SOCS image of the same mask and source (chip_smoke.py phases
23 and 24): stochastic_ensemble (64 trials, psd=True, bench.py's model:
dose 20 photons/nm^2, diffusion 8 nm, PAG 5/nm^2, threshold 0.3), whose
busy share says whether the host's edge statistics or the device set its
pace; exposure_trials (16 trials, trial_chunk 8, bench.py's device form);
and the eikonal arrival_times at (8, 1024, 1024), 56 sweeps.

With --tiled it traces one 8192^2 tiled_socs_image instead (chip_smoke.py
phase 27's chip: the same lines and spaces over the whole chip, with 40 px
contacts on the tile seams; 1024^2 tiles, the default 96 px halo, 100
tiles, rank-``rank`` kernels, int8), with the device time split into the
int8 kernels, the spectrum (cuFFT and the resize GEMMs of cuBLAS) and the
rest (crop, stitch, pad and elementwise), and the host gap per tile (wall
minus device time, over the tiles). It also times a rank-``rank`` 1024^2
apply in turns with its per-call set-up (the chirp's planes and limbs and
the resize matrices) formed afresh, as before they were cached, and
cached.

With --optimize it traces two optimizer steps instead (chip_smoke.py
phases 31 and 34): one optimize_socs mask step at 1024^2 (uniform 0.4
start, the exact image of the same mask and source as target, rank-64
kernels of all 49,400 points, int8) and one opc_correct_tiled tile step
(an interior 1024^2 tile of phase 34's 2048^2 chip, 96 px halo, rank 64).
Each is one Adam step as the optimizers take it: the loss closure
(optimize._socs_loss, optimize._tile_loss), its backward and the update.
It splits the device time into the int8 forward kernels, cuBLAS (the
float32 backward's 3M recompute and its VJP, and the spectrum's resize
GEMMs), cuFFT and the rest (elementwise, reductions, Adam; a SOCS window
is the whole kernel, so these steps gather nothing), and reports the host
gap a step (untraced wall minus device time); and it times the pupil
an exact step forms with the Zernike basis uploaded afresh, as before it
was cached per device, and cached (in turns).

With --parallel it traces chip_smoke.py phase 42's run instead: the
1024^2 exact image of all 49,400 points through abbe_image_sharded on a
4-entry mesh of cuda:0 (int8), and then runs it once more shard by shard:
for each shard the host time inside its call, its device time (CUDA events
around it on the stream) and the device's idle time before it (the previous
shard's end event to this one's start event), and the host syncs inside
the shards (torch.cuda.set_sync_debug_mode('warn'): each synchronizing
call by file and line, with its count). A shard whose host time is about
the device time of the shard before it waited for the device: on distinct
cards that wait would serialize the shards.

Each run is traced after one untraced warm-up run and one untraced timed
run. For each it prints the untraced and the traced wall clock (host clock
around a synchronized run), the kernel time (the sum
of the CUDA device events), the busy share (kernel time over wall), the
kernel time and the count of device events (kernel launches, copies and
memsets) by group and by name, and for the int8 runs the device events a
chunk; the last line holds the same as JSON. It exits with an error where
there is no CUDA device. With PYTHONPATH set to another checkout (say the
parent commit's, unpacked with git archive), it profiles that checkout's
package: run two checkouts in turns to compare them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

GROUPS = (
    ("window_product_limbs", ("window_product_limbs_kernel",)),
    ("column_intensity", ("column_intensity_kernel",)),
    ("row_limb_gemm", ("row_limb_gemm_kernel",)),
    ("row_requantize", ("row_requantize_kernel",)),
    ("cuBLAS GEMM", ("gemm", "Gemm", "xmma", "cutlass")),
    ("cuFFT", ("fft", "FFT")),
    ("random (Poisson, normal)", ("poisson", "Poisson", "normal", "philox")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other (elementwise, reductions, copies)"


def trace(torch, fn) -> dict:
    """Wall, kernel time, busy share and kernel time by group and name (ms)
    of one traced call of ``fn`` after one untraced warm-up call, and the
    wall of one untraced call between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    untraced = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = defaultdict(float)
    count = defaultdict(int)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_name[e.key] += us / 1e3
        count[e.key] += e.count
    by_group = defaultdict(float)
    count_group = defaultdict(int)
    for name, ms in by_name.items():
        by_group[group_of(name)] += ms
        count_group[group_of(name)] += count[name]
    kernel = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"untraced_wall_ms": untraced, "wall_ms": wall, "kernel_ms": kernel,
            "busy": kernel / wall,
            "events": sum(count.values()),
            "by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
            "events_by_group": dict(count_group),
            "top_kernels": [[name[:90], ms, count[name]] for name, ms in top]}


INT8 = ("window_product_limbs", "row_limb_gemm", "row_requantize",
        "column_intensity")


def show(title: str, r: dict, chunks: int | None = None) -> None:
    print(f"{title}: untraced wall {r['untraced_wall_ms']:.2f} ms; traced: wall "
          f"{r['wall_ms']:.2f} ms, kernels {r['kernel_ms']:.2f} ms, busy "
          f"{100 * r['busy']:.1f}%, {r['events']} device events", flush=True)
    for group, ms in r["by_group"].items():
        print(f"  {group}: {ms:.2f} ms ({100 * ms / r['wall_ms']:.1f}% of wall), "
              f"{r['events_by_group'][group]} events")
    for name, ms, count in r["top_kernels"]:
        print(f"    {ms:9.3f} ms  {count:6d}x  {name}")
    if chunks:
        per = {g: r["events_by_group"].get(g, 0) / chunks for g in INT8}
        rest = r["events"] - sum(r["events_by_group"].get(g, 0) for g in INT8)
        r["int8_events_per_chunk"] = per
        r["other_events"] = rest
        print(f"  per chunk of {chunks}: {per}; other device events in the "
              f"whole call: {rest}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=512)
    ap.add_argument("--rank", type=int, default=256)
    ap.add_argument("--exact-only", action="store_true")
    ap.add_argument("--vector", action="store_true",
                    help="also trace the vector and chromatic paths")
    ap.add_argument("--stochastic", action="store_true",
                    help="trace the resist paths instead of the imaging ones")
    ap.add_argument("--tiled", action="store_true",
                    help="trace an 8192^2 tiled image instead of the imaging "
                         "paths")
    ap.add_argument("--optimize", action="store_true",
                    help="trace an SMO mask step and a full-chip OPC tile "
                         "step instead of the imaging paths")
    ap.add_argument("--parallel", action="store_true",
                    help="trace the sharded exact image over a 4-entry "
                         "cuda:0 mesh and time it shard by shard")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_port.py: needs a CUDA device")
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.ops.abbe import _pad_points, source_points

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    n = 1024
    cfg = lt.OpticsConfig(pixel_number=n)
    mask = lt.lines_and_spaces(cfg, line_width_px=n // 16, pitch_px=n // 8,
                               device="cuda")
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    spectrum = lt.mask_spectrum(mask.geometry, cfg)
    pupil = lt.pupil_function(np.zeros(1, np.float32), cfg, device="cuda")
    pts = source_points(src)
    shifts, weights = _pad_points(pts.shifts[:4 * args.chunks],
                                  pts.weights[:4 * args.chunks], 4)
    results = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    if args.stochastic:
        resist_paths(torch, lt, args, cfg, spectrum, pupil, src, results)
        print(json.dumps(results))
        return 0
    if args.tiled:
        tiled_path(torch, lt, args, cfg, spectrum, pupil, src, results)
        print(json.dumps(results))
        return 0
    if args.optimize:
        optimize_paths(torch, lt, cfg, mask, pupil, src, results)
        print(json.dumps(results))
        return 0
    if args.parallel:
        parallel_path(torch, lt, cfg, spectrum, pupil, src, results)
        print(json.dumps(results))
        return 0
    for engine in ("int8", "matmul"):
        r = trace(torch, lambda: lt.abbe_image_points(
            spectrum, pupil, shifts, weights, cfg, device="cuda", engine=engine))
        show(f"1024^2 exact Abbe, {args.chunks} chunks of 4, engine {engine}", r,
             args.chunks if engine == "int8" else None)
        print(f"  untraced: {4 * args.chunks / r['untraced_wall_ms'] * 1e3:.1f} "
              f"points/s", flush=True)
        results[f"exact_{engine}"] = r
    if args.exact_only:
        print(json.dumps(results))
        return 0
    socs_holder = {}

    def build():
        socs_holder["socs"] = lt.randomized_socs(pupil, src, cfg, rank=args.rank)

    r = trace(torch, build)
    show(f"1024^2 SOCS build, rank {args.rank}, Rayleigh-Ritz, power_iters=2", r)
    results["socs_build"] = r
    for engine in ("int8", "matmul", "fft"):
        r = trace(torch, lambda: lt.socs_image(spectrum, socs_holder["socs"], cfg,
                                               engine=engine))
        show(f"1024^2 SOCS apply, rank {args.rank}, engine {engine}", r,
             -(-args.rank // 4) if engine == "int8" else None)
        results[f"socs_apply_{engine}"] = r
    del socs_holder["socs"]
    if args.vector:
        vector_paths(torch, lt, args, cfg, spectrum, pupil, src, shifts, weights,
                     results)
    print(json.dumps(results))
    return 0


def vector_paths(torch, lt, args, cfg, spectrum, pupil, src, shifts, weights,
                 results) -> None:
    """Part 3: the vector exact chunks and the vector and chromatic builds."""
    from lithographysimulator_tpu_torch.simulate import _channel_rotation_cached

    r = trace(torch, lambda: lt.vector_abbe_image(
        spectrum, pupil, shifts, weights, cfg, device="cuda",
        polarization="unpolarized"))
    show(f"1024^2 vector exact, unpolarized, {args.chunks} chunks of 4 x 6 "
         "component passes, int8", r, 6 * args.chunks)
    print(f"  untraced: {4 * args.chunks / r['untraced_wall_ms'] * 1e3:.1f} "
          f"source points/s", flush=True)
    results["vector_exact_int8"] = r
    rot = _channel_rotation_cached(cfg, "unpolarized", True, None, "cuda")
    r = trace(torch, lambda: lt.randomized_socs_vector(
        pupil, src, cfg, rank=args.rank, polarization="unpolarized",
        power_iters=1, channel_rotation=rot))
    show(f"1024^2 vector SOCS build, rank {args.rank}, power_iters=1, "
         f"{'no' if rot is None else rot.shape[2]} channel rotation", r)
    results["vector_socs_build"] = r
    spec = lt.LaserSpectrum(bandwidth_pm=0.3, samples=5)
    rot = _channel_rotation_cached(cfg, None, True, spec, "cuda")
    r = trace(torch, lambda: lt.randomized_socs_chromatic(
        np.zeros(1, np.float32), src, cfg, spectrum=spec, rank=args.rank,
        power_iters=1, channel_rotation=rot, device="cuda"))
    show(f"1024^2 chromatic SOCS build, rank {args.rank}, power_iters=1, "
         f"{'no' if rot is None else rot.shape[2]} channel rotation", r)
    results["chromatic_socs_build"] = r


def resist_paths(torch, lt, args, cfg, spectrum, pupil, src, results) -> None:
    """The --stochastic traces: the ensemble, the trials and the eikonal."""
    from lithographysimulator_tpu_torch.ops import eikonal

    socs = lt.randomized_socs(pupil, src, cfg, rank=args.rank)
    image = lt.socs_image(spectrum, socs, cfg)
    image = image / image.max()
    del socs
    model = lt.StochasticResist(dose_photons_per_nm2=20.0, diffusion_nm=8.0,
                                threshold=0.3, pag_per_nm2=5.0)
    r = trace(torch, lambda: lt.stochastic_ensemble(image, cfg, model,
                                                    trials=64, psd=True))
    show("1024^2 stochastic_ensemble, 64 trials, psd=True", r)
    results["stochastic_ensemble"] = r
    r = trace(torch, lambda: lt.exposure_trials(image, cfg, model, trials=16,
                                                trial_chunk=8).mean(dim=(1, 2)).cpu())
    show("1024^2 exposure_trials, 16 trials, trial_chunk 8", r)
    results["exposure_trials"] = r
    dr = lt.DepthResist(nz=8)
    slow = 1.0 / dr._rate(dr.latent(image))
    spacing = (dr.mack.thickness_nm / dr.nz, cfg.pixel_size, cfg.pixel_size)
    r = trace(torch, lambda: eikonal.arrival_times(slow, spacing,
                                                   iterations=dr.nz + 48))
    show(f"eikonal arrival_times at {tuple(slow.shape)}, {dr.nz + 48} sweeps", r)
    results["eikonal"] = r


def tiled_path(torch, lt, args, cfg, spectrum, pupil, src, results) -> None:
    """The --tiled trace: one 8192^2 chip, and the set-up a tile pays."""
    from lithographysimulator_tpu_torch.ops import abbe, resize
    from lithographysimulator_tpu_torch.ops.tiled import tile_layout

    big_n, n = 8192, cfg.n
    halo = lt.default_halo(cfg)
    tiles, step = tile_layout(big_n, n, halo)
    chip = lt.lines_and_spaces(lt.OpticsConfig(pixel_number=big_n),
                               line_width_px=n // 16, pitch_px=n // 8,
                               device="cuda").geometry.clone()
    for r in range(step, big_n, step):
        for c in range(step, big_n, step):
            chip[r - 20:r + 20, c - 20:c + 20] = 1.0
    socs = lt.randomized_socs(pupil, src, cfg, rank=args.rank)
    r = trace(torch, lambda: lt.tiled_socs_image(chip, socs, cfg))
    show(f"{big_n}^2 tiled_socs_image, {tiles * tiles} tiles of {n}^2 (halo "
         f"{halo}), rank {args.rank}, int8", r, tiles * tiles * -(-args.rank // 4))
    int8 = sum(r["by_group"].get(g, 0.0) for g in INT8)
    spectrum_ms = (r["by_group"].get("cuFFT", 0.0)
                   + r["by_group"].get("cuBLAS GEMM", 0.0))
    rest = r["kernel_ms"] - int8 - spectrum_ms
    gap = (r["wall_ms"] - r["kernel_ms"]) / tiles ** 2
    untraced_gap = (r["untraced_wall_ms"] - r["kernel_ms"]) / tiles ** 2
    r["tiles"] = tiles * tiles
    r["split_ms"] = {"int8 kernels": int8, "spectrum (cuFFT, resize GEMMs)":
                     spectrum_ms, "crop, stitch, pad, elementwise": rest}
    r["host_gap_per_tile_ms"] = gap
    r["untraced_host_gap_per_tile_ms"] = untraced_gap
    print(f"  device time a tile: {r['kernel_ms'] / tiles ** 2:.3f} ms (int8 "
          f"kernels {int8 / tiles ** 2:.3f}, spectrum {spectrum_ms / tiles ** 2:.3f}, "
          f"crop/stitch/pad/elementwise {rest / tiles ** 2:.3f}); host gap a "
          f"tile {gap:.3f} ms traced, {untraced_gap:.3f} ms untraced (untraced "
          f"wall minus traced device time); "
          f"{tiles * tiles / r['untraced_wall_ms'] * 1e3:.2f} tiles/s untraced",
          flush=True)
    results["tiled_8192"] = r

    def apply():
        lt.socs_image(spectrum, socs, cfg)

    def apply_fresh():  # the set-up every apply paid before it was cached
        abbe.t0_operands.cache_clear()
        resize._interp_matrix_on.cache_clear()
        apply()

    times = {"fresh set-up": [], "cached set-up": []}
    apply()
    for rep in range(4):  # in turns: fresh, cached, cached, fresh
        for tag in (("fresh set-up", "cached set-up") if rep % 2 == 0
                    else ("cached set-up", "fresh set-up")):
            fn = apply_fresh if tag.startswith("fresh") else apply
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            times[tag].append(1e3 * (time.perf_counter() - t0) / 10)
    apply()  # leave the caches filled
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"  {n}^2 rank-{args.rank} apply, wall a call (median of 4 runs of "
          f"10, in turns): {med}; samples {times}", flush=True)
    results["apply_setup_ms"] = {"median": med, "samples": times}


def _step_split(r: dict, steps_tag: str) -> None:
    """Print and record the device time of one step split by layer, and
    the host gap (untraced wall minus device time)."""
    int8 = sum(r["by_group"].get(g, 0.0) for g in INT8)
    parts = {"int8 forward kernels": int8,
             "cuBLAS (backward 3M recompute and VJP, spectrum resize)":
                 r["by_group"].get("cuBLAS GEMM", 0.0),
             "cuFFT": r["by_group"].get("cuFFT", 0.0)}
    parts["other (elementwise, reductions, Adam)"] = r["kernel_ms"] - sum(
        parts.values())
    r["split_ms"] = parts
    r["host_gap_ms"] = r["untraced_wall_ms"] - r["kernel_ms"]
    print(f"  {steps_tag}: device {r['kernel_ms']:.3f} ms = "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; host gap {r['host_gap_ms']:.3f} ms untraced, "
          f"{r['wall_ms'] - r['kernel_ms']:.3f} ms traced", flush=True)


def optimize_paths(torch, lt, cfg, mask, pupil, src, results) -> None:
    """The --optimize traces: an optimize_socs mask step and an
    opc_correct_tiled tile step, each as one Adam step."""
    from lithographysimulator_tpu_torch import optimize as opt
    from lithographysimulator_tpu_torch.ops.abbe import _pad_points, source_points
    from lithographysimulator_tpu_torch.ops.tiled import tile_layout

    rank, n = 64, cfg.n
    pts = source_points(src)
    shifts, weights = _pad_points(pts.shifts, pts.weights, 4)
    problem = opt.SMOProblem(config=cfg)
    w = torch.as_tensor(weights, device="cuda")
    with torch.no_grad():
        target = opt.forward(opt.init_params(problem, mask.geometry),
                             np.zeros(1, np.float32), shifts, weights, problem)
    socs = lt.randomized_socs(pupil, opt._source_map_from_points(shifts, w, n),
                              cfg, rank=rank)
    latent = opt.latent_from_mask(torch.full((n, n), 0.4, device="cuda"),
                                  problem.mask_steepness).requires_grad_()
    adam = torch.optim.Adam([latent], lr=0.2)
    w_sum = w.sum()
    r = trace(torch, lambda: opt._optimizer_steps(adam, lambda: opt._socs_loss(
        latent, problem, socs, w_sum, target), 1))
    show(f"{n}^2 optimize_socs mask step, rank {rank}, int8", r, rank // 4)
    _step_split(r, "a mask step")
    results["optimize_socs_mask_step"] = r

    big_n = 2 * n
    halo = lt.default_halo(cfg)
    tiles, step = tile_layout(big_n, n, halo)
    chip = lt.lines_and_spaces(lt.OpticsConfig(pixel_number=big_n),
                               line_width_px=n // 16, pitch_px=n // 8,
                               device="cuda").geometry.clone()
    for y in range(step, big_n, step):
        for x in range(step, big_n, step):
            chip[y - 20:y + 20, x - 20:x + 20] = 1.0
    padded = torch.nn.functional.pad(chip, (halo, n, halo, n))
    y0 = x0 = step  # tile (1, 1): the interior one
    window = padded[y0:y0 + n, x0:x0 + n]
    core = torch.zeros((n, n), dtype=torch.bool, device="cuda")
    core[halo:n - halo, halo:n - halo] = True
    resist = lt.ResistModel(threshold=0.35, steepness=30.0)
    latent = opt.latent_from_mask(window, 4.0).requires_grad_()
    adam = torch.optim.Adam([latent], lr=0.15)
    r = trace(torch, lambda: opt._optimizer_steps(adam, lambda: opt._tile_loss(
        latent, window, core, window[halo:n - halo, halo:n - halo], socs, cfg,
        halo, 4.0, resist, None), 1))
    show(f"opc_correct_tiled tile step, {n}^2 tile of a {big_n}^2 chip (halo "
         f"{halo}, {tiles * tiles} tiles), rank {rank}, int8", r, rank // 4)
    _step_split(r, "a tile step")
    results["opc_tiled_tile_step"] = r

    # the pupil every exact step forms (fit_aberrations: one a plane): the
    # Zernike basis uploaded afresh, as before it was cached, and cached
    from lithographysimulator_tpu_torch.ops import zernike

    coeffs = torch.zeros(10, device="cuda")

    def pupil_fresh():
        zernike._basis_on.cache_clear()
        lt.pupil_function(coeffs, cfg)

    times = {"fresh basis": [], "cached basis": []}
    lt.pupil_function(coeffs, cfg)
    for rep in range(4):  # in turns: fresh, cached, cached, fresh
        for tag in (("fresh basis", "cached basis") if rep % 2 == 0
                    else ("cached basis", "fresh basis")):
            fn = (pupil_fresh if tag.startswith("fresh")
                  else lambda: lt.pupil_function(coeffs, cfg))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            times[tag].append(1e3 * (time.perf_counter() - t0) / 10)
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"  {n}^2 pupil of 10 coefficients, wall a call (median of 4 runs "
          f"of 10, in turns): {med}; samples {times}", flush=True)
    results["pupil_basis_ms"] = {"median": med, "samples": times}



def parallel_path(torch, lt, cfg, spectrum, pupil, src, results) -> None:
    """The --parallel trace: phase 42's sharded exact image, then shard by
    shard (see the module docstring)."""
    import warnings

    from lithographysimulator_tpu_torch import parallel
    from lithographysimulator_tpu_torch.parallel import abbe_sharded

    entries = 4
    mesh = parallel.source_mesh(devices=["cuda:0"] * entries)
    shifts, weights, live = parallel.padded_source_arrays(src, entries * 4)

    def run():
        return parallel.abbe_image_sharded(spectrum, pupil, shifts, weights,
                                           cfg, mesh)

    r = trace(torch, run)
    show(f"1024^2 exact, abbe_image_sharded over cuda:0 x {entries}, {live} "
         f"points ({len(shifts)} padded)", r, len(shifts) // 4)
    print(f"  untraced: {live / r['untraced_wall_ms'] * 1e3:.1f} points/s",
          flush=True)
    shards = []
    inner = abbe_sharded.accumulate_intensity

    def timed_shard(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = inner(*a, **kw)
        end.record()
        shards.append((1e3 * (time.perf_counter() - t0), start, end))
        return out

    abbe_sharded.accumulate_intensity = timed_shard
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        abbe_sharded.accumulate_intensity = inner
    rows = []
    for i, (host, start, end) in enumerate(shards):
        idle = shards[i - 1][2].elapsed_time(start) if i else 0.0
        rows.append({"host_ms": host, "device_ms": start.elapsed_time(end),
                     "device_idle_before_ms": idle})
    syncs = defaultdict(int)
    for w in caught:
        syncs[f"{w.filename.split('/lithographysimulator_tpu_torch/')[-1]}:"
              f"{w.lineno}: {str(w.message)[:80]}"] += 1
    print(f"  shard by shard (sync debug mode on, wall {wall:.2f} ms):",
          flush=True)
    for i, row in enumerate(rows):
        print(f"    shard {i}: host {row['host_ms']:.2f} ms, device "
              f"{row['device_ms']:.2f} ms, device idle before it "
              f"{row['device_idle_before_ms']:.3f} ms")
    print(f"  host syncs in the sharded call ({sum(syncs.values())}):")
    for where, count in sorted(syncs.items(), key=lambda kv: -kv[1]):
        print(f"    {count:6d}x  {where}")
    r["shards"] = rows
    r["shard_wall_ms"] = wall
    r["host_syncs"] = dict(syncs)
    results["parallel_exact"] = r


if __name__ == "__main__":
    sys.exit(main())
