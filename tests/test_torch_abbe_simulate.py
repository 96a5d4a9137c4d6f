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


def _dense_inputs():
    """tests/test_abbe.py's dense-path setup (demo bars, perfect pupil)
    and ROADMAP F7's (annular 0.2/0.6, M in [0.5, 1.5) from seed 0)."""
    cfg = jt.OpticsConfig(pixel_number=32)
    spec = np.array(jt.spectrum_fft(jt.demo_bars(cfg).geometry, cfg))
    pup = np.array(jt.pupil_function(np.zeros(1), cfg))
    return cfg, spec, pup


def test_dense_source_path_matches_point_list_and_jax():
    """F7: a source map that requires grad takes the dense path over all
    n^2 grid points; its image equals the point list's and JAX's traced
    (jitted) dense path at tests/test_abbe.py's rtol 1e-4, with JAX's grid
    offsets."""
    import jax

    cfg, spec, pup = _dense_inputs()
    pcfg = config_from_jax(cfg)
    src = np.asarray(jt.LightSource(cfg, sigma_out=0.4).classical())
    np.testing.assert_array_equal(pa.dense_source_points(32),
                                  ja.dense_source_points(32))
    sparse = _np(pa.abbe_image(spec, pup, src, pcfg, device="cpu"))
    dense = pa.abbe_image(spec, pup, torch.tensor(src).requires_grad_(),
                          pcfg, device="cpu", chunk=64)
    assert dense.requires_grad
    np.testing.assert_allclose(_np(dense), sparse, rtol=1e-4,
                               atol=1e-4 * sparse.max())
    ref = np.asarray(jax.jit(lambda s: ja.abbe_image(spec, pup, s, cfg,
                                                     chunk=64))(src))
    np.testing.assert_allclose(_np(dense), ref, rtol=1e-4, atol=1e-4 * ref.max())


@pytest.mark.parametrize("normalize", [False, True])
def test_dense_source_path_gradient_matches_float64(normalize):
    """F7: d sum(image * M) / d map reaches every one of the 1,024 pixels
    of an annular map (chunk 8) and equals a float64 evaluation of the same
    dense sum (the spectrum and pupil upcast, every point on the fft
    engine in complex128) within 1e-6 * max|g|; with normalize=True the
    map's sum is in the graph (as F5's)."""
    cfg, spec, pup = _dense_inputs()
    pcfg = config_from_jax(cfg)
    src = np.asarray(jt.LightSource(cfg, sigma_in=0.2, sigma_out=0.6).annular())
    m = np.random.default_rng(0).uniform(0.5, 1.5, (32, 32)).astype(np.float32)
    leaf = torch.as_tensor(src).requires_grad_()
    image = pa.abbe_image(spec, pup, leaf, pcfg, device="cpu", chunk=8,
                          normalize=normalize)
    (image * torch.as_tensor(m)).sum().backward()
    g = leaf.grad.numpy()
    assert (g != 0).all()

    w64 = torch.as_tensor(src, dtype=torch.float64).reshape(-1).requires_grad_()
    raw = pa.accumulate_intensity(
        torch.as_tensor(pup, dtype=torch.complex128),
        torch.as_tensor(spec, dtype=torch.complex128),
        pa.dense_source_points(32), w64, pcfg, chunk=8, engine="fft")
    img64 = pa.postprocess_gau23(raw, pcfg)
    if normalize:
        img64 = img64 / w64.sum()
    (img64 * torch.as_tensor(m, dtype=torch.float64)).sum().backward()
    ref = w64.grad.numpy().reshape(32, 32)
    np.testing.assert_allclose(g, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_engine_policy_and_slice_limits():
    assert pa.resolve_engine("auto", device="cpu") == "fft"
    assert pa.resolve_engine("auto", device=torch.device("cuda")) == "int8"
    assert pa.resolve_engine("int8_fast", device="cpu") == "int8_fast"
    assert pa.resolve_engine("pallas", device="cpu") == "int8"
    with pytest.raises(ValueError):
        pa.resolve_engine("warp9", device="cpu")
    mask = pt.demo_bars(pt.OpticsConfig(pixel_number=32), device="cpu")
    src = pt.LightSource(mask.config).classical()
    # every option of the JAX package is ported: mask3d takes a model with
    # an .apply (anything else is refused), on every solver and the batch
    bl = pt.BoundaryLayer(width_nm=8.0, beta_h=-0.2, beta_v=0.1j)
    for kw in (dict(), dict(solver="socs", socs_rank=8)):
        res = pt.simulate(mask, src, device="cpu", mask3d=bl, **kw)
        assert res.report["mask3d"].startswith("BL(w=8.0nm")
        with pytest.raises(AttributeError):
            pt.simulate(mask, src, device="cpu", mask3d=1, **kw)
    assert pt.simulate_batch(mask.geometry[None], mask.config, src,
                             device="cpu", mask3d=bl).shape == (1, 32, 32)
    with pytest.raises(ValueError, match="unknown polarization"):
        pt.simulate(mask, src, device="cpu", polarization="z")
    with pytest.raises(ValueError, match="unknown solver"):
        pt.simulate(mask, src, device="cpu", solver="hopkins")
    with pytest.raises(TypeError):
        pt.simulate(mask, src)  # no default device


def test_int8_engine_is_forward_only():
    """Only the int8 engine's forward runs on the limb kernels: its
    gradient is the float32 recompute's (tests/test_torch_int8_grad.py),
    so it equals the matmul engine's autograd."""
    cfg, spec, pup, shifts, weights = _inputs(32, 3)
    grads = []
    for engine in ("int8", "matmul"):
        w = torch.as_tensor(weights, dtype=torch.float32).requires_grad_()
        img = pa.abbe_image_points(spec, pup, shifts, w, config_from_jax(cfg),
                                   device="cpu", engine=engine)
        img.sum().backward()
        grads.append(w.grad.numpy())
    assert np.abs(grads[1]).max() > 0
    np.testing.assert_allclose(grads[0], grads[1], rtol=0,
                               atol=1e-6 * np.abs(grads[1]).max())


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
    """Importing the port (and its CLI, kernels, interop, io, server,
    utils and parallel modules, and ops.abbe's dense-path names) loads no
    jax."""
    code = ("import sys, lithographysimulator_tpu_torch, "
            "lithographysimulator_tpu_torch.cli, "
            "lithographysimulator_tpu_torch.interop, "
            "lithographysimulator_tpu_torch.ops.hopkins, "
            "lithographysimulator_tpu_torch.ops.vector, "
            "lithographysimulator_tpu_torch.ops.focus, "
            "lithographysimulator_tpu_torch.ops.perturb, "
            "lithographysimulator_tpu_torch.ops.mask3d, "
            "lithographysimulator_tpu_torch.ops.rcwa, "
            "lithographysimulator_tpu_torch.ops.rcwa2d, "
            "lithographysimulator_tpu_torch.ops.filmstack, "
            "lithographysimulator_tpu_torch.ops.compensated, "
            "lithographysimulator_tpu_torch.simulate, "
            "lithographysimulator_tpu_torch.ops.tiled, "
            "lithographysimulator_tpu_torch.metrology, "
            "lithographysimulator_tpu_torch.models.mrc, "
            "lithographysimulator_tpu_torch.optimize, "
            "lithographysimulator_tpu_torch.models.sraf, "
            "lithographysimulator_tpu_torch.models.multipatterning, "
            "lithographysimulator_tpu_torch.utils.artifacts, "
            "lithographysimulator_tpu_torch.ops.kernels.build, "
            "lithographysimulator_tpu_torch.io, "
            "lithographysimulator_tpu_torch.io.native, "
            "lithographysimulator_tpu_torch.io.gdsii, "
            "lithographysimulator_tpu_torch.io.oasis, "
            "lithographysimulator_tpu_torch.io.layout, "
            "lithographysimulator_tpu_torch.io.contours, "
            "lithographysimulator_tpu_torch.serve, "
            "lithographysimulator_tpu_torch.utils, "
            "lithographysimulator_tpu_torch.parallel, "
            "lithographysimulator_tpu_torch.parallel.mesh, "
            "lithographysimulator_tpu_torch.parallel.distributed, "
            "lithographysimulator_tpu_torch.parallel.abbe_sharded, "
            "lithographysimulator_tpu_torch.parallel.socs_sharded, "
            "lithographysimulator_tpu_torch.parallel.tiled_sharded, "
            "lithographysimulator_tpu_torch.parallel.stochastic_sharded, "
            "lithographysimulator_tpu_torch.parallel.film_sharded, "
            "lithographysimulator_tpu_torch.parallel.fem_sharded, "
            "lithographysimulator_tpu_torch.parallel.socs_build_sharded, "
            "lithographysimulator_tpu_torch.parallel.dryrun; "
            "from lithographysimulator_tpu_torch.ops.abbe import "
            "dense_source_points, resolve_engine; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lithographysimulator_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"
