"""The comparison that decides ``correct`` has to fail its controls.

The control is the program with one of its own lower precisions switched
on, each judged as a run is: the worst ``image_nrms`` and
``broadband_nrms`` over the sample of 8 images that the clip cell draws
from one seed's pool of 64 masks, against the reference's own float64
kernel set. The program's images (through ``simulate``) stay under both
limits.

* The apply's control: the two-limb int8 engine (``int8_fast``) on the
  program's kernel set. ``broadband_nrms`` has to exceed its limit.
* The kernel build's control: the program's build with TF32 on (its
  matmuls in the precision below the float32 it states), on the card (a
  CPU has no TF32). ``image_nrms`` has to exceed its limit, and so it has
  under a build cut from rank 256 to 192.
* Faults planted under a whole run (the rest of the run as it is, on the
  CPU at small sizes): an image altered where the program produces it,
  half of each chunk's kernels left out with the others' weights doubled,
  half of a served batch answered with the mean, a kernel set of other
  optics. Each has to make ``correct`` false.

The card tests run the controls at the cells' own sizes, on three seeds:
``python -m pytest litho_bench/tests -m cuda -s`` from a checkout's root on
a machine with the card.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from conftest import ROOT, load, write

SEEDS = (2**31 + 3, 911, 2**33 + 17)
POOL, SAMPLE = 64, 8


def _worst(cfg: dict, seed: int, device: str, image_of,
           reference) -> tuple[float, float]:
    """Worst (``image_nrms``, ``broadband_nrms``) over the cell's sample of
    one seed's pool, each image made by ``image_of(geometry)``."""
    from litho_bench import judge, masks

    pool = masks.layouts(seed, 0, POOL, cfg["pixel_number"], cfg["layout"],
                         device=device)
    picks = judge.sample(masks.rng_for(seed, 1), POOL, SAMPLE)
    return judge.worst_errors(cfg, [(pool[i], image_of(pool[i]), None)
                                    for i in picks], *reference)


def _limits(cfg: dict) -> tuple[float, float]:
    return cfg["limits"]["image_nrms"], cfg["limits"]["broadband_nrms"]


def _holds(cfg: dict, reading: tuple[float, float]) -> None:
    assert all(v <= lim for v, lim in zip(reading, _limits(cfg)))


def _simulated(cfg: dict, device: str):
    from litho_bench import program

    lt = program.lt()
    oc = program.optics(cfg)
    return lambda g: lt.simulate(
        lt.Mask(geometry=g, config=oc), program.source_map(cfg),
        program.aberrations(cfg), solver="socs", socs_rank=cfg["socs_rank"],
        device=device).image


def _applied(cfg: dict, socs, engine: str = "auto"):
    from litho_bench import program

    lt = program.lt()
    oc = program.optics(cfg)
    return lambda g: lt.socs_image(lt.mask_spectrum(g, oc), socs, oc,
                                   engine=engine)


def _apply_readings(cfg: dict, seed: int, device: str, reference):
    from litho_bench import program

    socs = program.kernel_set(cfg, device)
    return (_worst(cfg, seed, device, _simulated(cfg, device), reference),
            _worst(cfg, seed, device, _applied(cfg, socs, "int8_fast"),
                   reference))


def test_apply_control_fails_on_cpu(tiny_bench):
    from litho_bench import judge

    root, _, bench = tiny_bench
    cfg = load(root / bench["configs"][0]["file"])
    reference = judge.reference_kernels(cfg, "cpu")
    program_reading, control_reading = _apply_readings(cfg, SEEDS[0], "cpu",
                                                       reference)
    _holds(cfg, program_reading)
    assert control_reading[1] > cfg["limits"]["broadband_nrms"]


@pytest.mark.cuda
def test_apply_control_fails_on_the_card(card):
    from litho_bench import judge

    cfg = load(ROOT / "litho_bench" / "configs" / "clip1024.json")
    reference = judge.reference_kernels(cfg, card)
    for seed in SEEDS:
        t0 = time.perf_counter()
        program_reading, control_reading = _apply_readings(cfg, seed, card,
                                                           reference)
        print(f"apply, seed {seed}: program {program_reading!r}, int8_fast "
              f"control {control_reading!r}, limits {_limits(cfg)!r} "
              f"({time.perf_counter() - t0:.1f} s)")
        _holds(cfg, program_reading)
        assert control_reading[1] > cfg["limits"]["broadband_nrms"]


@pytest.mark.cuda
def test_kernel_set_control_fails_on_the_card(card):
    from litho_bench import judge, program

    cfg = load(ROOT / "litho_bench" / "configs" / "clip1024.json")
    limit = cfg["limits"]["image_nrms"]
    reference = judge.reference_kernels(cfg, card)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = program.kernel_set(cfg, card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    builds = {"program": program.kernel_set(cfg, card), "TF32 build": tf32,
              "rank 224": program.kernel_set(cfg, card, rank=224),
              "rank 192": program.kernel_set(cfg, card, rank=192)}
    for seed in SEEDS:
        readings = {name: _worst(cfg, seed, card, _applied(cfg, s), reference)
                    for name, s in builds.items()}
        print(f"kernel set, seed {seed}: " + ", ".join(
            f"{name} {v!r}" for name, v in readings.items()) + f", limits {_limits(cfg)!r}")
        _holds(cfg, readings["program"])
        assert limit < readings["TF32 build"][0] and limit < readings["rank 192"][0]


# --------------------------------------------------------------------------
# Faults under a whole run
# --------------------------------------------------------------------------

def _altered(image: torch.Tensor) -> torch.Tensor:
    out = image.clone()
    out[:2, :2] += 0.1 * float(image.max())
    return out


def _half_kernels(socs_image):
    """socs_image with every other kernel left out and the rest's weights
    doubled: half of each chunk dropped, the mean taken over the rest."""
    from lithographysimulator_tpu_torch.ops.hopkins import SOCSKernels

    def broken(spectrum, socs, config, **kw):
        half = SOCSKernels(kernels=socs.kernels[::2],
                           eigenvalues=2.0 * socs.eigenvalues[::2],
                           total_rank=socs.total_rank)
        return socs_image(spectrum, half, config, **kw)
    return broken


def _run(tiny_bench, cell: str) -> dict:
    from litho_bench import harness

    root, bench_dir, bench = tiny_bench
    return harness.run(bench, root, cell, SEEDS[1], 0.5, False, device="cpu",
                       t_start=time.perf_counter(), bench_dir=bench_dir)


CELLS = ("clip1024.socs_stream", "chip8192.tiled_image",
         "clip1024.serve_closed8")


def test_sound_runs_are_correct(tiny_bench):
    for cell in CELLS:
        assert _run(tiny_bench, cell)["correct"] is True


def test_an_image_altered_where_produced_is_caught(tiny_bench, monkeypatch):
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch import serve

    simulate, tiled = lt.simulate, lt.tiled_socs_image
    run_batch = serve.LithoService._run_batch

    def bad_batch(self, signature, masks):
        images = run_batch(self, signature, masks).copy()
        images[:, :2, :2] += 0.1 * images.max()
        return images

    def bad_simulate(*a, **kw):
        r = simulate(*a, **kw)
        return type(r)(image=_altered(r.image), spectrum=r.spectrum,
                       pupil=r.pupil, source_map=r.source_map, report=r.report)

    monkeypatch.setattr(lt, "simulate", bad_simulate)
    monkeypatch.setattr(lt, "tiled_socs_image",
                        lambda *a, **kw: _altered(tiled(*a, **kw)))
    monkeypatch.setattr(serve.LithoService, "_run_batch", bad_batch)
    for cell in CELLS:
        out = _run(tiny_bench, cell)
        assert out["correct"] is False
        assert out["checks"]["image_nrms"]["value"] > out["checks"]["image_nrms"]["limit"]


def test_half_of_each_chunk_left_out_is_caught(tiny_bench, monkeypatch):
    import importlib

    for module in ("lithographysimulator_tpu_torch.simulate",
                   "lithographysimulator_tpu_torch.ops.tiled"):
        mod = importlib.import_module(module)
        monkeypatch.setattr(mod, "socs_image", _half_kernels(mod.socs_image))
    for cell in CELLS:
        assert _run(tiny_bench, cell)["correct"] is False


def test_half_of_a_served_batch_left_out_is_caught(tiny_bench, monkeypatch):
    """The worker images half of each batch and answers the rest with the
    mean of those images."""
    from lithographysimulator_tpu_torch import serve

    run_batch = serve.LithoService._run_batch

    def half(self, signature, masks):
        k = max(1, len(masks) // 2)
        images = run_batch(self, signature, masks[:k])
        rest = [images.mean(axis=0)] * (len(masks) - k)
        return np.concatenate([images, np.stack(rest)]) if rest else images

    monkeypatch.setattr(serve.LithoService, "_run_batch", half)
    path = tiny_bench[1] / "traffic" / "serve_closed8.json"
    write(path, {**load(path), "pool": 4, "sample": 4, "clients": 4,
                 "max_batch": 4, "batch_window_s": 0.2})
    assert _run(tiny_bench, "clip1024.serve_closed8")["correct"] is False


def test_kernel_set_of_other_optics_is_caught(tiny_bench):
    """The image check holds the build to the configuration's optics: a
    set built with the aberrations' signs flipped fails it."""
    from litho_bench import judge, program

    root, _, bench = tiny_bench
    cfg = load(root / bench["configs"][0]["file"])
    reference = judge.reference_kernels(cfg, "cpu")
    flipped = dict(cfg, aberrations_osa=list(-np.asarray(cfg["aberrations_osa"])))
    readings = [_worst(cfg, SEEDS[2], "cpu", _applied(cfg, socs), reference)
                for socs in (program.kernel_set(cfg, "cpu"),
                             program.kernel_set(flipped, "cpu"))]
    _holds(cfg, readings[0])
    assert readings[1][0] > cfg["limits"]["image_nrms"]
