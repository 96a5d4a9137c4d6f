"""Port parity: the exact-Abbe engine and simulate() of the torch port
(device='cpu') against the JAX package and the reference goldens.

Tolerances: <= 1e-6 normalized RMS against JAX for every engine (both
float32; the int8 engines emulate fp32 with limbs); goldens at the bounds
the JAX tests assert (demo 2e-3, perfect-pupil images 1e-5, direct 5e-3:
the reference's fp16 grids); chunk invariance at test_abbe.py's 1e-5."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.ops import abbe as ja
from lithographysimulator_tpu_torch.interop import config_from_jax
from lithographysimulator_tpu_torch.ops import abbe as pa

from .conftest import normalized_rms

TOL = 1e-6
REPO = Path(__file__).resolve().parent.parent
DEMO_ABERR = np.array([0, 0, 0.01, 0, 100, 0.01, 0, 0.01, 0.01, 0.01], np.float32)


def _np(x):
    return x.detach().cpu().numpy()


def _boundary_shifts(n):
    """8 shifts: the windowed path's exactness edge |shift| = n/4 - 2 on
    both axes and signs, plus interior points."""
    b = n // 4 - 2
    return np.array([[0, 0], [b, 0], [0, -b], [-b, b], [b, -b], [1, -2],
                     [-(b // 2), b // 3], [2, 1]], np.int32)


def _inputs(n, seed=0):
    cfg = jt.OpticsConfig(pixel_number=n)
    rng = np.random.default_rng(seed)
    geom = (rng.random((n, n)) > 0.7).astype(np.float32)
    spec = np.asarray(jt.spectrum_fft(geom, cfg))
    pup = np.asarray(jt.pupil_function(np.array([0, 0, 0.02, 0, 30], np.float32), cfg))
    weights = rng.uniform(0.5, 1.0, 8).astype(np.float32)
    return cfg, spec, pup, _boundary_shifts(n), weights


@pytest.mark.parametrize("engine", ["fft", "matmul", "int8"])
@pytest.mark.parametrize("n", [32, 64, 128])
def test_abbe_image_points_matches_jax(n, engine):
    cfg, spec, pup, shifts, weights = _inputs(n)
    ms = int(np.abs(shifts).max())
    ref = np.asarray(ja.abbe_image_points(spec, pup, shifts, weights, cfg,
                                          engine=engine, max_abs_shift=ms))
    ours = _np(pa.abbe_image_points(spec, pup, shifts, weights, config_from_jax(cfg),
                                    device="cpu", engine=engine, max_abs_shift=ms))
    assert normalized_rms(ours, ref) < TOL


def test_windowed_and_rolled_products_match_jax():
    """Window origins at the clip edge (abbe.py:224-229) and the roll sign."""
    n = 64
    cfg, spec, pup, shifts, _ = _inputs(n, 1)
    w, lo = pa._window_size(n), n // 4 - 1
    ref = np.asarray(ja._windowed_products(ja._tiled(pup), spec, shifts, w, lo))
    tiled = pa._tiled(torch.as_tensor(pup))
    ours = _np(pa._windowed_products(tiled, torch.as_tensor(spec), shifts, w, lo))
    # same windows; the complex products may differ by an ulp (FMA)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    rolled = _np(pa._rolled_products(tiled, torch.as_tensor(spec), shifts))
    for b, (dy, dx) in enumerate(shifts):
        expected = np.roll(pup, (dy, dx), (0, 1)) * spec
        np.testing.assert_allclose(rolled[b], expected, rtol=1e-6,
                                   atol=1e-6 * np.abs(expected).max())
    np.testing.assert_array_equal(pa._zoom_dft_window(n, 128), ja._zoom_dft_window(n, 128))


def test_direct_solver_matches_jax():
    cfg, _, pup, shifts, weights = _inputs(32, 2)
    geom = (np.random.default_rng(2).random((32, 32)) > 0.7).astype(np.float32)
    spec = np.asarray(jt.spectrum_direct(geom, cfg))
    shifts = shifts[:4]
    ref = np.asarray(ja.abbe_image_points(spec, pup, shifts, weights[:4], cfg,
                                          solver="direct"))
    ours = _np(pa.abbe_image_points(spec, pup, shifts, weights[:4],
                                    config_from_jax(cfg), device="cpu",
                                    solver="direct"))
    assert normalized_rms(ours, ref) < TOL


def test_simulate_demo_matches_jax_and_golden(golden):
    cfg = jt.DEMO_CONFIG
    src = np.asarray(jt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8))
    ref = jt.simulate(jt.demo_bars(cfg), src, DEMO_ABERR)
    res = pt.simulate(pt.demo_bars(config_from_jax(cfg), device="cpu"), src,
                      DEMO_ABERR, device="cpu")
    assert normalized_rms(_np(res.image), np.asarray(ref.image)) < TOL
    assert normalized_rms(_np(res.image), golden("demo_aerial_image_fft")) < 2e-3
    assert normalized_rms(_np(res.spectrum), np.asarray(ref.spectrum)) < TOL
    assert normalized_rms(_np(res.pupil), np.asarray(ref.pupil)) < TOL
    assert set(res.report) == set(ref.report)
    for k in ("source_points", "fft_size", "beta", "epsilon", "polarization",
              "chromatic", "mask3d", "solver"):
        assert res.report[k] == ref.report[k]
    # the int8 engine (plain limb math on the CPU) on the same inputs
    int8 = pa.abbe_image(res.spectrum, res.pupil, src, pt.DEMO_CONFIG, device="cpu",
                         engine="int8")
    assert normalized_rms(_np(int8), np.asarray(ref.image)) < TOL


@pytest.mark.parametrize("name,kw,kind,args", [
    ("demo_aerial_image_fft_perfect", dict(sigma_in=0.4, sigma_out=0.8), "quasar",
     (4, -np.pi / 8)),
    ("demo_aerial_image_fft_annular_perfect", dict(sigma_in=0.4, sigma_out=0.8),
     "annular", ()),
    ("demo_aerial_image_fft_shifted_perfect",
     dict(sigma_in=0.2, sigma_out=0.6, shift_x=0.3, shift_y=-0.2), "annular", ()),
    ("demo_aerial_image_fft_dipole_perfect", dict(sigma_in=0.5, sigma_out=0.8),
     "quasar", (2, 0.0)),
])
def test_perfect_pupil_goldens(golden, name, kw, kind, args):
    cfg = pt.DEMO_CONFIG
    spec = pt.spectrum_fft(pt.demo_bars(cfg, device="cpu").geometry, cfg)
    pup = pt.pupil_function(np.zeros(1), cfg, device="cpu")
    src = getattr(pt.LightSource(cfg, **kw), kind)(*args)
    img = pt.abbe_image(spec, pup, src, cfg, device="cpu")
    assert normalized_rms(_np(img), golden(name)) < 1e-5


def test_small_goldens_fft_and_direct(golden):
    cfg = pt.OpticsConfig(pixel_number=32)
    mask = pt.from_array(golden("small_mask_geometry"), cfg, device="cpu")
    src = pt.LightSource(cfg, sigma_out=0.3).classical()
    ab = np.array([0, 0, 0, 0, 50], np.float32)
    img = _np(pt.simulate(mask, src, ab, device="cpu").image)
    ref = golden("small_aerial_image_fft")
    p = (32 - ref.shape[0]) // 2
    assert normalized_rms(img[p : p + ref.shape[0], p : p + ref.shape[0]], ref) < 2e-3
    assert img[0].max() == 0 and img[-1].max() == 0
    direct = pt.simulate(mask, src, ab, device="cpu", solver="direct")
    assert normalized_rms(_np(direct.image), golden("small_aerial_image_direct")) < 5e-3
    jref = jt.simulate(jt.from_array(golden("small_mask_geometry"),
                                     jt.OpticsConfig(pixel_number=32)),
                       src, ab, solver="direct")
    assert normalized_rms(_np(direct.image), np.asarray(jref.image)) < TOL


@pytest.mark.parametrize("engine,chunks", [("fft", (8, 32)), ("int8", (4, 12))])
def test_chunk_size_invariance(engine, chunks):
    cfg = pt.OpticsConfig(pixel_number=32)
    spec = pt.spectrum_fft(pt.demo_bars(cfg, device="cpu").geometry, cfg)
    pup = pt.pupil_function(np.zeros(1), cfg, device="cpu")
    src = pt.LightSource(cfg, sigma_out=0.4).classical()
    a, b = (_np(pt.abbe_image(spec, pup, src, cfg, device="cpu", chunk=c,
                              engine=engine)) for c in chunks)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * a.max())


def test_normalize_and_dark_source():
    cfg = pt.OpticsConfig(pixel_number=32)
    mask = pt.demo_bars(cfg, device="cpu")
    src = pt.LightSource(cfg, sigma_out=0.4).classical()
    raw = pt.simulate(mask, src, device="cpu")
    norm = pt.simulate(mask, src, device="cpu", normalize=True)
    np.testing.assert_allclose(_np(norm.image) * src.sum(), _np(raw.image), rtol=1e-5,
                               atol=1e-6 * _np(raw.image).max())
    dark = pt.simulate(mask, np.zeros_like(src), device="cpu", normalize=True)
    assert not dark.image.any()


def test_engine_policy_and_slice_limits():
    assert pa.resolve_engine("auto", device="cpu") == "fft"
    assert pa.resolve_engine("auto", device=torch.device("cuda")) == "int8"
    assert pa.resolve_engine("int8_fast", device="cpu") == "int8_fast"
    with pytest.raises(ValueError):
        pa.resolve_engine("warp9", device="cpu")
    mask = pt.demo_bars(pt.OpticsConfig(pixel_number=32), device="cpu")
    src = pt.LightSource(mask.config).classical()
    for kw in (dict(solver="socs"), dict(polarization="x"), dict(chromatic=1),
               dict(mask3d=1), dict(perturb=1)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            pt.simulate(mask, src, device="cpu", **kw)
    with pytest.raises(TypeError):
        pt.simulate(mask, src)  # no default device


def test_int8_engine_is_forward_only():
    cfg, spec, pup, shifts, weights = _inputs(32, 3)
    w = torch.as_tensor(weights, dtype=torch.float32).requires_grad_()
    with pytest.raises(NotImplementedError, match="forward-only"):
        pa.abbe_image_points(spec, pup, shifts, w, config_from_jax(cfg),
                             device="cpu", engine="int8")


def test_cli_simulate_writes_npy(tmp_path):
    from lithographysimulator_tpu_torch import cli

    out = tmp_path / "aerial.npy"
    assert cli.main(["simulate", "--device", "cpu", "--pixel-number", "32",
                     "--source", "annular", "--aberrations", "0", "0", "0.01",
                     "--out", str(out)]) == 0
    cfg = pt.OpticsConfig(pixel_number=32)
    ref = pt.simulate(pt.demo_bars(cfg, device="cpu"),
                      pt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).annular(),
                      [0, 0, 0.01], device="cpu")
    np.testing.assert_array_equal(np.load(out), _np(ref.image))
    report = json.loads((tmp_path / "aerial.report.json").read_text())
    assert report["source_points"] == ref.report["source_points"]


def test_profiling_on_cpu():
    from lithographysimulator_tpu_torch.utils.profiling import StageTimer, device_info

    timer = StageTimer("cpu")
    with timer.stage("spectrum"):
        pt.spectrum_fft(torch.zeros(32, 32), pt.OpticsConfig(pixel_number=32))
    assert set(timer.report()) == {"spectrum"} and timer.report()["spectrum"] >= 0
    assert device_info("cpu")["platform"] == "cpu"


def test_import_leaves_jax_out():
    """Importing the port (and its CLI, kernels and interop) loads no jax."""
    code = ("import sys, lithographysimulator_tpu_torch, "
            "lithographysimulator_tpu_torch.cli, "
            "lithographysimulator_tpu_torch.interop, "
            "lithographysimulator_tpu_torch.ops.kernels.build; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lithographysimulator_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"
