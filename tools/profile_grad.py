"""Where a gradient step's time goes on the card: the int8 engine's
backward (the float32 recompute) against the f32 matmul engine's autograd,
and the per-step split of an M3D fit.

    PYTHONPATH=. python3 tools/profile_grad.py

at 1024² on every 41st point of the 49,400-point quadrupole (1,205 points),
as `chip_smoke.py` phases 19 and 20. It prints:

1. one gradient step of sum(image * M) for the spectrum and the pupil on
   the int8 and matmul engines in turns (int8, matmul, int8, matmul):
   forward and backward wall, synchronized;
2. a torch.profiler trace of one warm int8 and one matmul step on every
   401st point: device time by kernel, in total and a chunk;
3. fit_boundary_layer (asymmetric, 50 nm defocus, 10 steps): forward,
   backward and Adam wall per step for the first int8 fit of the process,
   a second int8 fit and a matmul fit, and the top of a cProfile of the
   first fit (one-time imports show there).

Needs a CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import cProfile
import pstats
import sys
import time

import numpy as np
import torch


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _device_us(event) -> float:
    """An event's device time in us (the attribute's name depends on the
    torch version)."""
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_grad.py needs a CUDA device")
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.ops import mask3d as pm
    from lithographysimulator_tpu_torch.ops.abbe import (_pad_points,
                                                         abbe_image_points,
                                                         source_points)

    n = 1024
    cfg = lt.OpticsConfig(pixel_number=n)
    mask = lt.lines_and_spaces(cfg, line_width_px=n // 16, pitch_px=n // 8,
                               device="cuda")
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    pts = source_points(src)
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}",
          flush=True)

    def points(k, chunk):
        return _pad_points(pts.shifts[::k], pts.weights[::k], chunk)

    spectrum = lt.mask_spectrum(mask.geometry, cfg)
    pupil = lt.pupil_function(np.array([0, 0, 0.05, 0.03, 30], np.float32),
                              cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(19)
    m = 0.5 + torch.rand((n, n), generator=gen, device="cuda")

    def step(engine, shifts, weights):
        s = spectrum.detach().clone().requires_grad_()
        p = pupil.detach().clone().requires_grad_()
        loss, t_fwd = _sync_time(lambda: (abbe_image_points(
            s, p, shifts, weights, cfg, device="cuda", engine=engine) * m).sum())
        _, t_bwd = _sync_time(loss.backward)
        return t_fwd, t_bwd

    shifts, weights = points(41, 4)
    print(f"[1] gradient step, {len(weights) // 4} chunks of 4", flush=True)
    for turn in range(2):
        for engine in ("int8", "matmul"):
            t_fwd, t_bwd = step(engine, shifts, weights)
            print(f"  step {turn + 1}, {engine}: forward {t_fwd:.4f} s, "
                  f"backward {t_bwd:.4f} s", flush=True)

    from torch.profiler import ProfilerActivity, profile

    shifts, weights = points(401, 4)
    chunks = len(weights) // 4
    for engine in ("int8", "matmul"):
        step(engine, shifts, weights)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(engine, shifts, weights)
        events = [(_device_us(e), e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(us for us, _, _ in events) / 1e3
        print(f"[2] traced {engine} step, {chunks} chunks: device "
              f"{total:.3f} ms ({total / chunks:.4f} ms a chunk)", flush=True)
        for us, count, key in sorted(events, reverse=True)[:8]:
            print(f"  {us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}", flush=True)

    def adam_timed(params, loss_fn, steps, learning_rate):
        opt = torch.optim.Adam(params, lr=learning_rate)
        history, split = [], []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss, t_fwd = _sync_time(loss_fn)
            _, t_bwd = _sync_time(loss.backward)
            _, t_adam = _sync_time(opt.step)
            history.append(float(loss.detach()))
            split.append(f"{t_fwd:.3f}/{t_bwd:.3f}/{t_adam:.4f}")
        print(f"  per step forward/backward/adam s: {' '.join(split)}",
              flush=True)
        return history

    pm._adam_fit = adam_timed
    shifts, weights = points(41, 8)
    ab = np.array([0, 0, 0, 0, 50.0], np.float32)
    bl = lt.BoundaryLayer(width_nm=8.0, beta_h=-0.2 + 0.1j, beta_v=-0.3,
                          beta_h_asym=0.03j, beta_v_asym=0.05 - 0.02j)
    keep = pts.shifts[::41] + n // 2
    sub = np.zeros_like(src)
    sub[keep[:, 0], keep[:, 1]] = src[keep[:, 0], keep[:, 1]]
    target = lt.simulate(mask, sub, ab, normalize=True, mask3d=bl,
                         device="cuda").image
    kw = dict(target_image=target, geometry=mask.geometry, shifts=shifts,
              weights=weights, config=cfg, device="cuda", steps=10,
              aberrations=ab, fit_asym=True)
    prof = cProfile.Profile()
    for tag, extra in (("int8, first of the process", {}),
                       ("int8, second", {}), ("matmul", {"engine": "matmul"})):
        print(f"[3] fit_boundary_layer, 10 steps, {tag}", flush=True)
        if tag.startswith("int8, first"):
            prof.enable()
        _, t = _sync_time(lambda: pm.fit_boundary_layer(**kw, **extra))
        prof.disable()
        print(f"  total {t:.3f} s", flush=True)
    pstats.Stats(prof, stream=sys.stdout).sort_stats("cumulative").print_stats(12)
    return 0


if __name__ == "__main__":
    sys.exit(main())
