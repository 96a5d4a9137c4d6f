"""Port parity: chromatic (finite laser bandwidth) and through-focus
imaging of the torch port (device='cpu') against the JAX package
(ops/focus.py, the chromatic paths of simulate and the polychromatic SOCS
build).

Exact images: <= 1e-6 normalized RMS against JAX. SOCS images: held to
JAX's exact images at the classes of the JAX tests (test_chromatic.py:141-173:
5e-4 at full rank, 1e-3 vector and chromatic)."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.ops import focus as jf
from lithographysimulator_tpu.ops import hopkins as jh
from lithographysimulator_tpu.parallel import padded_source_arrays
from lithographysimulator_tpu_torch.interop import config_from_jax, spectrum_from_jax
from lithographysimulator_tpu_torch.ops import focus as pf
from lithographysimulator_tpu_torch.ops import hopkins as ph

from .conftest import normalized_rms

TOL = 1e-6
CFG = jt.OpticsConfig(pixel_number=32)
PCFG = config_from_jax(CFG)
# asymmetric aberrations and an off-axis source, as test_chromatic.py
ABERR = np.array([0, 0, 0.05, 0.03, 30, 0.02, 0, 0.04], np.float32)
SPEC3 = jt.LaserSpectrum(bandwidth_pm=0.8, focus_nm_per_pm=-250.0, samples=3)
PSPEC3 = spectrum_from_jax(SPEC3)
SRC = np.asarray(jt.LightSource(CFG, sigma_in=0.2, sigma_out=0.6, shift_x=0.1).annular())
PLANES = [-60.0, 0.0, 60.0]


def _np(x):
    return x.detach().cpu().numpy()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def masks():
    return jt.demo_bars(CFG), pt.demo_bars(PCFG, device="cpu")


def test_aberration_stacks_equal_jax():
    for base in (ABERR, np.array([0.01, 0.02], np.float32), [0.0]):
        ref_s, ref_w = jf.chromatic_aberrations(base, SPEC3)
        ours_s, ours_w = pf.chromatic_aberrations(base, PSPEC3)
        np.testing.assert_array_equal(ours_s, np.asarray(ref_s))
        np.testing.assert_array_equal(ours_w, np.asarray(ref_w))
        np.testing.assert_array_equal(pf.focus_stack_aberrations(base, PLANES),
                                      np.asarray(jf.focus_stack_aberrations(base, PLANES)))
    assert ours_s.dtype == ours_w.dtype == np.float32


def test_chromatic_component_stack_matches_jax():
    for pol in (None, "unpolarized"):
        jc, jw = jh.chromatic_component_stack(ABERR, CFG, spectrum=SPEC3,
                                              polarization=pol)
        pc, pw = ph.chromatic_component_stack(ABERR, PCFG, spectrum=PSPEC3,
                                              polarization=pol, device="cpu")
        factors = 1 if pol is None else len(ph.dedup_polarization_factors(PCFG, pol))
        assert pc.shape == jc.shape == (3 * factors, 32, 32)
        assert normalized_rms(_np(pc), np.asarray(jc)) < TOL
        np.testing.assert_allclose(_np(pw), np.asarray(jw), rtol=1e-7)


@pytest.mark.parametrize("pol", [None, "unpolarized"])
@pytest.mark.parametrize("solver", ["gau23", "direct"])
def test_exact_chromatic_matches_jax(masks, solver, pol):
    jmask, pmask = masks
    ref = jt.simulate(jmask, SRC, ABERR, solver=solver, chromatic=SPEC3,
                      polarization=pol)
    ours = pt.simulate(pmask, SRC, ABERR, device="cpu", solver=solver,
                       chromatic=PSPEC3, polarization=pol)
    assert normalized_rms(_np(ours.image), np.asarray(ref.image)) < TOL
    assert ours.report["chromatic"] == ref.report["chromatic"] == (
        "gaussian E95=0.8pm x3 @ -250.0nm/pm")
    assert set(ours.report) == set(ref.report)


def test_zero_bandwidth_is_monochromatic(masks):
    _, pmask = masks
    mono = pt.simulate(pmask, SRC, ABERR, device="cpu")
    chrom = pt.simulate(pmask, SRC, ABERR, device="cpu",
                        chromatic=pt.LaserSpectrum(bandwidth_pm=0.0, samples=5))
    assert normalized_rms(_np(chrom.image), _np(mono.image)) < TOL


def test_chromatic_socs_matches_jax_exact_blend(masks):
    """One polychromatic kernel set at full rank (3 planes x 60 points)
    against JAX's exact blend; the batch path gives simulate()'s image."""
    jmask, pmask = masks
    exact = np.asarray(jt.simulate(jmask, SRC, ABERR, chromatic=SPEC3).image)
    live = int((SRC > 0).sum())
    res = pt.simulate(pmask, SRC, ABERR, device="cpu", solver="socs",
                      chromatic=PSPEC3, socs_rank=min(3 * live, 256))
    assert normalized_rms(_np(res.image), exact) < 5e-4
    assert res.report["socs_energy_captured"] > 0.999
    ref = jt.simulate(jmask, SRC, ABERR, solver="socs", chromatic=SPEC3,
                      socs_rank=min(3 * live, 256))
    assert set(res.report) == set(ref.report)
    g = np.asarray(jmask.geometry)
    batch = _np(pt.simulate_batch(np.stack([g, g]), PCFG, SRC, ABERR, device="cpu",
                                  solver="socs", chromatic=PSPEC3,
                                  socs_rank=min(3 * live, 256)))
    np.testing.assert_array_equal(batch[0], _np(res.image))


def test_vector_chromatic_socs_matches_jax_exact(masks):
    """Polarized and polychromatic: the outer-product component build
    (test_chromatic.py:162-173)."""
    jmask, _ = masks
    exact = np.asarray(jt.simulate(jmask, SRC, ABERR, chromatic=SPEC3,
                                   polarization="unpolarized").image)
    spec = pt.spectrum_fft(torch.as_tensor(np.array(jmask.geometry)), PCFG)
    socs = ph.randomized_socs_chromatic(ABERR, SRC, PCFG, spectrum=PSPEC3,
                                        polarization="unpolarized", rank=320,
                                        power_iters=3, device="cpu")
    assert normalized_rms(_np(ph.socs_image(spec, socs, PCFG)), exact) < 1e-3


def test_chromatic_rotation_matches_jax():
    js = importlib.import_module("lithographysimulator_tpu.simulate")
    ps = importlib.import_module("lithographysimulator_tpu_torch.simulate")
    spec = jt.LaserSpectrum(bandwidth_pm=0.3, samples=5)
    for cfg in (CFG, jt.OpticsConfig(pixel_number=64)):
        ref = js._channel_rotation_cached(cfg, None, True, spec)
        ours = ps._channel_rotation_cached(config_from_jax(cfg), None, True,
                                           spectrum_from_jax(spec), "cpu")
        assert (ours is None) == (ref is None)
        if ref is not None:
            assert ours.shape == ref.shape


@pytest.fixture(scope="module")
def focus_inputs():
    spec = np.array(jt.spectrum_fft(jt.demo_bars(CFG).geometry, CFG))
    shifts, weights, _ = padded_source_arrays(SRC, 4)
    shifts, weights = np.asarray(shifts), np.asarray(weights)
    ms = int(np.abs(shifts).max())
    stack = np.asarray(jf.focus_stack_aberrations(ABERR, PLANES))
    exact = np.asarray(jf.through_focus_images(spec, stack, shifts, weights, CFG,
                                               max_abs_shift=ms))
    return spec, shifts, weights, ms, stack, exact


def test_through_focus_images_match_jax(focus_inputs, masks):
    spec, shifts, weights, ms, stack, exact = focus_inputs
    ours = _np(pf.through_focus_images(torch.as_tensor(spec), stack, shifts, weights,
                                       PCFG, device="cpu", max_abs_shift=ms))
    assert ours.shape == (3, 32, 32)
    for f in range(3):
        assert normalized_rms(ours[f], exact[f]) < TOL
    run = pf.compiled_focus_stack(PCFG, max_abs_shift=ms)
    assert run is pf.compiled_focus_stack(PCFG, max_abs_shift=ms)
    again = _np(run(masks[1].geometry, stack, shifts, weights))
    for f in range(3):
        assert normalized_rms(again[f], exact[f]) < TOL
    # the thick mask applies before the spectrum, as in the JAX package
    bl = jt.BoundaryLayer(width_nm=8.0, beta_h=-0.2 + 0.1j, beta_v=-0.3)
    ref = np.asarray(jf.compiled_focus_stack(CFG, max_abs_shift=ms, mask3d=bl)(
        masks[0].geometry, stack, shifts, weights))
    thick = _np(pf.compiled_focus_stack(
        PCFG, max_abs_shift=ms, mask3d=pt.BoundaryLayer(
            width_nm=8.0, beta_h=-0.2 + 0.1j, beta_v=-0.3))(
        masks[1].geometry, stack, shifts, weights))
    for f in range(3):
        assert normalized_rms(thick[f], ref[f]) < TOL


def test_through_focus_socs_matches_jax_exact(focus_inputs):
    """Rank 96 >= the 60 live points, so each plane's build is complete:
    its residual against the exact plane is float rounding (2.8e-6 for
    both packages' builds)."""
    spec, *_, exact = focus_inputs
    ours = _np(pf.through_focus_socs(torch.as_tensor(spec), ABERR, PLANES, SRC, PCFG))
    for f in range(3):
        assert normalized_rms(ours[f], exact[f]) < 1e-4
