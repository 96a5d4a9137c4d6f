#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lithographysimulator_tpu_torch) on
one CUDA GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

It exits 0 only if every phase passes; each fails hard on a miss:

0. device: name, capability, torch/CUDA versions, nvidia-smi name and
   power limit;
1. build the int8 kernels from csrc/ with nvcc for sm_90a;
2. each kernel against its plain PyTorch version on the card, at the
   main-path shapes (B=4, n=1024, w=520), (4, 2048, 1032) and a ragged
   (3, 96, 40), 3-limb and 2-limb: normalized RMS <= 1e-6 on dequantized Y
   and on the image; median kernel and plain times (CUDA events);
3. the 64^2 demo through simulate(device='cuda'): <= 2e-3 normalized RMS
   against tests/golden/demo_aerial_image_fft.npy and <= 1e-5 against the
   port's own fft engine on the card;
4. the 1024^2 headline (lines/spaces 64/128 px, quasar sigma 0.4/0.8)
   through simulate(device='cuda') against the f32 matmul engine (cuBLAS,
   TF32 off): <= 1e-6; wall clock and points/s of both. If the int8 kernels
   would need more than ~2 minutes for every point, every k-th point is used
   and the count is printed;
5. 2048^2, the 8-point sparse source, int8 engine against the complex128
   NumPy oracle (tests/numpy_oracle.py): <= 1e-6;
6. every kernel's launch count from phases 3-5 is > 0.

The last stdout line is {"ok": true, "device": {...}}; the line before it
lists each kernel with its launches, error and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CU_SOURCE = "lithographysimulator_tpu_torch/csrc/intensity_int8.cu"
TPU_KERNELS = "lithographysimulator_tpu/ops/kernels/intensity_int8.py"
KERNELS = {
    "row_limb_gemm": f"{TPU_KERNELS}:297 (row_transform_int8), "
                     f"{TPU_KERNELS}:431 (row_transform_int8_splitk)",
    "row_requantize": f"{TPU_KERNELS}:203 (_quant_rows_in_kernel, in the "
                      "row kernels at :297 and :431)",
    "column_intensity": f"{TPU_KERNELS}:161 (column_intensity_int8)",
}
KERNEL_SHAPES = ((4, 1024, 520), (4, 2048, 1032), (3, 96, 40))
TOL_KERNEL = 1e-6
TOL_GOLDEN = 2e-3
TOL_FFT = 1e-5
TOL_MATMUL = 1e-6
TOL_ORACLE = 1e-6
INT8_BUDGET_S = 120.0


def log(msg: str) -> None:
    print(msg, flush=True)


def nrms(a, b) -> float:
    a = np.asarray(a, np.complex128 if np.iscomplexobj(a) else np.float64)
    b = np.asarray(b, np.complex128 if np.iscomplexobj(b) else np.float64)
    return float(np.sqrt(np.mean(np.abs(a - b) ** 2)) / np.abs(b).max())


def check(name: str, value: float, tol: float) -> None:
    ok = np.isfinite(value) and value <= tol
    log(f"  {name}: {value:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} = {value:.3e} exceeds {tol:.0e}")


def check_image(img, n: int) -> np.ndarray:
    img = img.detach().cpu().numpy()
    if img.shape != (n, n) or not np.isfinite(img).all() or img.max() <= 0:
        raise AssertionError(f"bad image: shape {img.shape}, "
                             f"finite {np.isfinite(img).all()}, max {img.max()}")
    return img


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(torch, fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def dequant(limbs, scales) -> np.ndarray:
    """(3, 3, B, n, kp) limbs + (3, B, n) scales -> (3, B, n, kp) f64."""
    l = limbs.double()
    v = (l[:, 0] + l[:, 1] / 256.0 + l[:, 2] / 65536.0) * scales.double()[..., None]
    return v.cpu().numpy()


def phase_kernels(torch, ik) -> dict:
    """Phase 2: each kernel against its plain version; returns the JSON
    fields measured at the first (main-path) shape, 3-limb mode."""
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    stats = {}
    for batch, n, w in KERNEL_SHAPES:
        x_np = (rng.normal(size=(batch, w, w))
                + 1j * rng.normal(size=(batch, w, w))).astype(np.complex64)
        t0 = np.exp(1j * rng.normal(size=(n, w))).astype(np.complex64)
        x = torch.as_tensor(x_np, device=dev)
        t_limbs, t_scales = ik.prepare_t0_limbs(
            torch.as_tensor(t0.real, device=dev), torch.as_tensor(t0.imag, device=dev))
        weights = torch.as_tensor(rng.random(batch).astype(np.float32), device=dev)
        kp = t_limbs.shape[-1]
        x_limbs, x_scales = ik.quantize_x(x)
        for fast in (False, True):
            tag = f"B={batch} n={n} w={w} {'2-limb' if fast else '3-limb'}"
            log(f"[phase 2] {tag}")
            # row_limb_gemm
            args = (x_limbs, x_scales, t_limbs, t_scales)
            yr_k, yi_k = ik.row_limb_gemm(*args, fast=fast)
            yr_p, yi_p = ik.row_limb_gemm_plain(*args, fast=fast)
            torch.cuda.synchronize()
            y_k = torch.complex(yr_k, yi_k).cpu().numpy()
            y_p = torch.complex(yr_p, yi_p).cpu().numpy()
            check("row_limb_gemm Y vs plain", nrms(y_k, y_p), TOL_KERNEL)
            err = {"row_limb_gemm": float(np.abs(y_k - y_p).max())}
            # row_requantize, on the plain Y so both see the same input
            yl_k, ys_k = ik.row_requantize(yr_p, yi_p, kp)
            yl_p, ys_p = ik.row_requantize_plain(yr_p, yi_p, kp)
            dq_k, dq_p = dequant(yl_k, ys_k), dequant(yl_p, ys_p)
            diff = int((yl_k != yl_p).sum())
            log(f"  row_requantize limbs differing from plain: {diff}")
            check("row_requantize dequantized Y vs plain", nrms(dq_k, dq_p),
                  TOL_KERNEL)
            err["row_requantize"] = float(np.abs(dq_k - dq_p).max())
            # column_intensity, on the plain limbs
            cargs = (yl_p, ys_p, t_limbs, t_scales, weights)
            img_k = ik.column_intensity_int8(*cargs, fast=fast).cpu().numpy()
            img_p = ik.column_intensity_int8_plain(*cargs, fast=fast).cpu().numpy()
            check("column_intensity image vs plain", nrms(img_k, img_p), TOL_KERNEL)
            err["column_intensity"] = float(np.abs(img_k - img_p).max())
            ms = {
                "row_limb_gemm": (
                    time_ms(torch, lambda: ik.row_limb_gemm(*args, fast=fast)),
                    time_ms(torch, lambda: ik.row_limb_gemm_plain(*args, fast=fast))),
                "row_requantize": (
                    time_ms(torch, lambda: ik.row_requantize(yr_p, yi_p, kp)),
                    time_ms(torch, lambda: ik.row_requantize_plain(yr_p, yi_p, kp))),
                "column_intensity": (
                    time_ms(torch, lambda: ik.column_intensity_int8(*cargs, fast=fast)),
                    time_ms(torch, lambda: ik.column_intensity_int8_plain(*cargs, fast=fast))),
            }
            for name, (k_ms, p_ms) in ms.items():
                log(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
            if not stats:
                stats = {name: {"max_abs_err": err[name], "ms": ms[name][0],
                                "plain_ms": ms[name][1]} for name in ms}
    return stats


def phase_demo(torch, lt) -> None:
    """Phase 3: the 64^2 demo through simulate() on the card."""
    from lithographysimulator_tpu_torch.ops.abbe import abbe_image

    cfg = lt.DEMO_CONFIG
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    aberr = np.array([0, 0, 0.01, 0, 100, 0.01, 0, 0.01, 0.01, 0.01], np.float32)
    res = lt.simulate(lt.demo_bars(cfg, device="cuda"), src, aberr, device="cuda")
    img = check_image(res.image, cfg.n)
    log(f"[phase 3] demo 64^2: {res.report['source_points']} points, "
        f"{res.report['wall_clock_s']:.3f} s, image max {img.max():.6e}")
    golden = np.load(REPO / "tests" / "golden" / "demo_aerial_image_fft.npy")
    check("demo int8 vs golden", nrms(img, golden), TOL_GOLDEN)
    fft = abbe_image(res.spectrum, res.pupil, src, cfg, device="cuda",
                     engine="fft")
    check("demo int8 vs fft engine (card)", nrms(img, check_image(fft, cfg.n)),
          TOL_FFT)


def phase_headline(torch, lt) -> None:
    """Phase 4: 1024^2 exact Abbe, int8 (simulate) against f32 matmul."""
    from lithographysimulator_tpu_torch.ops.abbe import (abbe_image_points,
                                                         source_points)

    n = 1024
    cfg = lt.OpticsConfig(pixel_number=n)
    mask = lt.lines_and_spaces(cfg, line_width_px=n // 16, pitch_px=n // 8,
                               device="cuda")
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    pts = source_points(src)
    # probe the int8 rate on 256 points to size the run
    probe = lt.simulate(mask, _subset(src, pts, 193), device="cuda")
    rate = probe.report["source_points"] / probe.report["wall_clock_s"]
    k = max(1, int(np.ceil(pts.live_count / rate / INT8_BUDGET_S)))
    sub = _subset(src, pts, k)
    res = lt.simulate(mask, sub, device="cuda")
    img = check_image(res.image, n)
    used = res.report["source_points"]
    t_int8 = res.report["wall_clock_s"]
    log(f"[phase 4] 1024^2: {pts.live_count} live points, every {k}-th used: "
        f"{used} points")
    log(f"  int8 (simulate): {t_int8:.3f} s, {used / t_int8:.1f} points/s")
    sp = source_points(sub)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = abbe_image_points(res.spectrum, res.pupil, *_padded(sp, 4), cfg,
                            device="cuda", engine="matmul")
    torch.cuda.synchronize()
    t_mm = time.perf_counter() - t0
    log(f"  matmul f32 (abbe_image_points): {t_mm:.3f} s, "
        f"{used / t_mm:.1f} points/s")
    check("1024^2 int8 vs f32 matmul", nrms(img, check_image(ref, n)), TOL_MATMUL)


def _subset(src: np.ndarray, pts, k: int) -> np.ndarray:
    """Source map keeping every k-th live point (row-major order)."""
    n = src.shape[0]
    keep = pts.shifts[::k] + n // 2
    out = np.zeros_like(src)
    out[keep[:, 0], keep[:, 1]] = src[keep[:, 0], keep[:, 1]]
    return out


def _padded(sp, chunk: int):
    from lithographysimulator_tpu_torch.ops.abbe import _pad_points

    return _pad_points(sp.shifts, sp.weights, chunk)


def phase_oracle(torch, lt) -> None:
    """Phase 5: 2048^2 sparse source, int8 engine vs complex128 oracle."""
    from lithographysimulator_tpu_torch.ops.abbe import (abbe_image_points,
                                                         source_points)

    sys.path.insert(0, str(REPO))
    from tests import numpy_oracle as oracle

    n = 2048
    cfg = lt.OpticsConfig(pixel_number=n)
    mask = lt.lines_and_spaces(cfg, line_width_px=n // 16, pitch_px=n // 8,
                               device="cuda")
    src = np.zeros((n, n), np.float32)
    bnd = n // 4 - 2
    for dy, dx in [(0, 0), (bnd, 0), (0, -bnd), (-(bnd // 2), bnd // 2),
                   (bnd // 3, bnd // 3), (-bnd, -(bnd // 4)), (7, -29),
                   (-53, 11)]:
        src[n // 2 + dy, n // 2 + dx] = 1.0
    spectrum = lt.mask_spectrum(mask.geometry, cfg)
    pupil = lt.pupil_function(np.zeros(1, np.float32), cfg, device="cuda")
    sp = source_points(src)
    t0 = time.perf_counter()
    img = abbe_image_points(spectrum, pupil, *_padded(sp, 4), cfg,
                            device="cuda", engine="int8")
    img = check_image(img, n)
    log(f"[phase 5] 2048^2 int8, 8 points: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    ref = oracle.abbe64(mask.geometry.cpu().numpy(), src, np.zeros(1, np.float32),
                        pixel_size=cfg.pixel_size, wavelength=cfg.wavelength,
                        na=cfg.na)
    log(f"  complex128 oracle on the host: {time.perf_counter() - t0:.1f} s")
    check("2048^2 int8 vs float64 oracle", nrms(img, ref), TOL_ORACLE)


def main() -> int:
    if not (REPO / "lithographysimulator_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py: the lithographysimulator_tpu_torch "
                         "package is not beside this script")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    sys.path.insert(0, str(REPO))
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.ops.kernels import build
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[phase 0] {name}, capability {torch.cuda.get_device_capability(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[phase 0] nvidia-smi: {smi}")

    t0 = time.perf_counter()
    lib, nvcc_log = build.build()
    log(f"[phase 1] built {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    build.load_library()

    stats = phase_kernels(torch, ik)

    ik.reset_launch_counts()  # count only the main path's launches below
    phase_demo(torch, lt)
    phase_headline(torch, lt)
    phase_oracle(torch, lt)
    launches = dict(ik.LAUNCHES)
    log(f"[phase 6] launches in phases 3-5: {launches}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": CU_SOURCE, "replaces": KERNELS[k],
         "launches": launches[k], **stats[k]} for k in KERNELS]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
