"""Port parity: thick-mask (M3D) imaging of the torch port (device='cpu')
against the JAX package (ops/mask3d.py and simulate(mask3d=...)).

Tolerances: the edge fields and the effective masks of both models within
1e-6 of JAX's; exact images (gau23, direct) <= 1e-6 normalized RMS against
JAX's; the SOCS image within its own reported bound of JAX's exact image
(as tests/test_torch_socs_simulate.py holds the thin mask); 5-step fits:
loss histories within rtol 1e-4 and the fitted parameters within 1e-4 of
JAX's (both packages' CPU 'auto' engine is the FFT one).

The fits run on a layout without mirror symmetry, imaged with defocus and
coma. A parameter whose gradient vanishes by symmetry (Im beta in focus,
as the JAX package's fit_boundary_layer docstring says, or a mirrored tap
pair of the edge kernel on a symmetric layout) takes Adam steps of float
rounding noise, which land anywhere in either package; the fit then
compares noise. Their targets are strong enough that the loss, a
residual, keeps well above the images' own 1e-7 agreement over the five
steps."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.ops import mask3d as jm
from lithographysimulator_tpu.ops.abbe import source_points
from lithographysimulator_tpu_torch.interop import config_from_jax, mask3d_from_jax
from lithographysimulator_tpu_torch.ops import mask3d as pm

from .conftest import normalized_rms

TOL = 1e-6
FIT_TOL = 1e-4
CFG = jt.OpticsConfig(pixel_number=32)
PCFG = config_from_jax(CFG)
SRC = np.asarray(jt.LightSource(CFG, sigma_out=0.5).classical())
BL = jm.BoundaryLayer(width_nm=8.0, beta_h=-0.2 + 0.1j, beta_v=-0.3)
BL_ASYM = jm.BoundaryLayer(width_nm=6.0, beta_h=-0.25 + 0.15j,
                           beta_v=0.1 - 0.2j, beta_h_asym=0.03j,
                           beta_v_asym=0.05 - 0.02j)
EK = jm.EdgeKernelM3D(width_nm=8.0,
                      taps_h_rise=(0.05j, -0.2 + 0.1j, 0.1),
                      taps_h_fall=(0.1, -0.2 - 0.05j, 0.05j),
                      taps_v_rise=(0.02, -0.3, 0.15),
                      taps_v_fall=(0.15, -0.25, 0.02))
MODELS = {"bl": BL, "bl_asym": BL_ASYM, "edge_kernel": EK}


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


def _geometries():
    """Binary, continuous, complex and real-signed PSM layouts (writable
    host arrays, so torch can wrap them)."""
    rng = np.random.default_rng(6)
    psm = np.ones((32, 32), np.complex64)
    psm[:, 8:20] = -1.0
    psm[20:26, :] = 0.245 * np.exp(1j * np.pi / 3)
    return {
        "binary": np.array(jt.demo_bars(CFG).geometry),
        "continuous": rng.random((32, 32)).astype(np.float32),
        "complex": psm,
        "real_psm": np.where(np.arange(32) < 16, 1.0, -1.0).astype(
            np.float32)[None].repeat(32, 0),
    }


GEOMETRIES = _geometries()


def _close(ours, ref) -> None:
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=TOL * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_edge_fields_equal_jax(name):
    g = GEOMETRIES[name]
    for ours, ref in zip(pm.edge_fields(torch.as_tensor(g)),
                         jm.edge_fields(g)):
        _close(_np(ours), ref)
    for ours, ref in zip(pm.edge_fields_signed(torch.as_tensor(g)),
                         jm.edge_fields_signed(g)):
        _close(_np(ours), ref)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_effective_mask_equal_jax(model, name):
    """apply_boundary_layers (symmetric and asymmetric) and
    apply_edge_kernel through the models' ``.apply``."""
    g = GEOMETRIES[name]
    ref = MODELS[model].apply(g, CFG)
    ours = mask3d_from_jax(MODELS[model]).apply(torch.as_tensor(g), PCFG)
    _close(_np(ours), ref)


def test_static_zero_betas_leave_the_thin_mask():
    """width 0 or beta 0 adds exactly nothing (the thin-mask limit)."""
    g = torch.as_tensor(GEOMETRIES["binary"])
    for model in (pm.BoundaryLayer(width_nm=0.0, beta_h=0.3, beta_v=0.3),
                  pm.BoundaryLayer(width_nm=8.0)):
        eff = model.apply(g, PCFG)
        np.testing.assert_array_equal(_np(eff), _np(g).astype(np.complex64))


@pytest.fixture(scope="module")
def masks():
    return jt.demo_bars(CFG), pt.demo_bars(PCFG, device="cpu")


@pytest.mark.parametrize("model", ["bl", "edge_kernel"])
@pytest.mark.parametrize("solver", ["gau23", "direct"])
def test_simulate_exact_mask3d_matches_jax(masks, solver, model):
    jmask, pmask = masks
    ref = jt.simulate(jmask, SRC, solver=solver, normalize=True,
                      mask3d=MODELS[model])
    ours = pt.simulate(pmask, SRC, device="cpu", solver=solver, normalize=True,
                       mask3d=mask3d_from_jax(MODELS[model]))
    assert ours.report["mask3d"] == ref.report["mask3d"]
    assert normalized_rms(_np(ours.image), np.asarray(ref.image)) < TOL
    assert normalized_rms(_np(ours.spectrum), np.asarray(ref.spectrum)) < TOL


@pytest.mark.parametrize("model", ["bl", "edge_kernel"])
def test_simulate_socs_mask3d_within_bound_of_jax_exact(masks, model):
    """SOCS sees the same effective mask: its image lies within its own
    reported bound of JAX's exact thick-mask image, and simulate_batch
    gives the same image."""
    jmask, pmask = masks
    m3d = mask3d_from_jax(MODELS[model])
    exact = np.asarray(jt.simulate(jmask, SRC, normalize=True,
                                   mask3d=MODELS[model]).image)
    ours = pt.simulate(pmask, SRC, device="cpu", solver="socs", socs_rank=32,
                       normalize=True, mask3d=m3d)
    bound = ours.report["socs_image_nrms_bound"]
    assert 0 < bound and normalized_rms(_np(ours.image), exact) <= bound
    batch = pt.simulate_batch(pmask.geometry[None], PCFG, SRC, device="cpu",
                              solver="socs", socs_rank=32, normalize=True,
                              mask3d=m3d)
    assert normalized_rms(_np(batch[0]), _np(ours.image)) < TOL


def test_simulate_batch_exact_mask3d_matches_jax(masks):
    jmask, pmask = masks
    geoms = np.stack([np.asarray(jmask.geometry),
                      np.asarray(jmask.geometry)[::-1].copy()])
    ref = np.asarray(jt.simulate_batch(geoms, CFG, SRC, mask3d=BL_ASYM))
    ours = _np(pt.simulate_batch(geoms, PCFG, SRC, device="cpu",
                                 mask3d=mask3d_from_jax(BL_ASYM)))
    for b in range(2):
        assert normalized_rms(ours[b], ref[b]) < TOL


def _padded_points(chunk=8):
    pts = source_points(SRC)
    pad = (-pts.live_count) % chunk
    shifts = np.concatenate([pts.shifts, np.zeros((pad, 2), np.int32)])
    weights = np.concatenate([pts.weights, np.zeros((pad,), np.float32)])
    return shifts, weights


def _assert_fit_matches(ours, ref, hist, ref_hist) -> None:
    np.testing.assert_allclose(hist, ref_hist, rtol=FIT_TOL)
    for key, value in vars(ref).items():
        got = getattr(ours, key)
        if isinstance(value, tuple):
            np.testing.assert_allclose(np.asarray(got), np.asarray(value),
                                       rtol=0, atol=FIT_TOL)
        else:
            assert abs(complex(got) - complex(value)) <= FIT_TOL, key


FIT_ABERR = np.array([0, 0, 0, 0, 50.0, 0, 0, 0.05, 0.04], np.float32)
FOCUS_PLANES = (-60.0, 0.0, 60.0)
EK_FIT = jm.EdgeKernelM3D(width_nm=8.0, **{
    k: tuple(3.0 * c for c in getattr(EK, k))
    for k in ("taps_h_rise", "taps_h_fall", "taps_v_rise", "taps_v_fall")})


@pytest.fixture(scope="module")
def fit_masks():
    """demo_bars with two extra blocks: no mirror symmetry."""
    g = np.array(jt.demo_bars(CFG).geometry)
    g[3:7, 2:13] = 1.0
    g[24:27, 20:30] = 1.0
    return jt.from_array(g, CFG), pt.from_array(g, PCFG, device="cpu")


@pytest.mark.parametrize("fit_asym", [False, True])
def test_fit_boundary_layer_matches_jax(fit_masks, fit_asym):
    """The symmetric fit through focus (an (F, A) stack and an (F, n, n)
    target), the asymmetric one on one plane."""
    jmask, pmask = fit_masks
    if fit_asym:
        ab = FIT_ABERR
        target = np.asarray(jt.simulate(jmask, SRC, ab, normalize=True,
                                        mask3d=BL_ASYM).image)
    else:
        ab = np.asarray(jt.focus_stack_aberrations(FIT_ABERR, FOCUS_PLANES))
        target = np.stack([np.asarray(jt.simulate(
            jmask, SRC, a, normalize=True, mask3d=BL_ASYM).image) for a in ab])
    shifts, weights = _padded_points()
    kw = dict(width_nm=6.0, steps=5, learning_rate=0.02, fit_asym=fit_asym,
              aberrations=ab)
    ref, ref_hist = jm.fit_boundary_layer(target, jmask.geometry, shifts,
                                          weights, CFG, **kw)
    ours, hist = pm.fit_boundary_layer(target, pmask.geometry, shifts,
                                       weights, PCFG, device="cpu", **kw)
    assert len(hist) == 5 and hist[-1] < hist[0]
    _assert_fit_matches(ours, ref, hist, ref_hist)


def test_fit_edge_kernel_matches_jax(fit_masks):
    jmask, pmask = fit_masks
    target = np.asarray(jt.simulate(jmask, SRC, FIT_ABERR, normalize=True,
                                    mask3d=EK_FIT).image)
    shifts, weights = _padded_points()
    kw = dict(k=1, width_nm=8.0, steps=5, learning_rate=0.01,
              aberrations=FIT_ABERR)
    ref, ref_hist = jm.fit_edge_kernel(target, jmask.geometry, shifts,
                                       weights, CFG, **kw)
    ours, hist = pm.fit_edge_kernel(target, pmask.geometry, shifts, weights,
                                    PCFG, device="cpu", **kw)
    assert ours.k == 1 and hist[-1] < hist[0]
    _assert_fit_matches(ours, ref, hist, ref_hist)


def test_boundary_layer_from_rcwa_matches_jax():
    """m3dcal's calibration at the CLI's 64^2 default, through focus
    (``--defocus -80 0 80``), with few steps: beta and fit_nrms within
    1e-4 of JAX's."""
    cfg = jt.OpticsConfig(pixel_number=64)
    kw = dict(pitch_px=16, duty=9 / 16, steps=4, defocus_nm=(-80, 0, 80))
    ref, ref_report = jm.boundary_layer_from_rcwa(cfg, **kw)
    ours, report = pm.boundary_layer_from_rcwa(config_from_jax(cfg),
                                               device="cpu", **kw)
    assert abs(ours.beta_h - ref.beta_h) <= FIT_TOL
    assert abs(ours.beta_v - ref.beta_v) <= FIT_TOL
    assert set(report["fit_nrms"]) == set(ref_report["fit_nrms"]) == {"avg"}
    for key in ("fit_nrms", "thin_nrms"):
        for tag, value in ref_report[key].items():
            assert abs(report[key][tag] - value) <= FIT_TOL
    np.testing.assert_allclose(report["history"]["avg"],
                               ref_report["history"]["avg"], rtol=FIT_TOL)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_json_from_jax_gives_the_same_image(masks, model):
    """JAX's model_to_json read by the port's model_from_json (dict, JSON
    string and file) is the model mask3d_from_jax carries over, and it
    images as JAX's model does."""
    jmask, pmask = masks
    line = json.dumps(dict(jm.model_to_json(MODELS[model]), stack="binary_cr"))
    ours = pm.model_from_json(line)
    assert ours == mask3d_from_jax(MODELS[model])
    assert pm.model_to_json(ours) == jm.model_to_json(MODELS[model])
    assert jm.model_from_json(json.dumps(pm.model_to_json(ours))) == MODELS[model]
    ref = jt.simulate(jmask, SRC, normalize=True, mask3d=MODELS[model]).image
    img = pt.simulate(pmask, SRC, device="cpu", normalize=True,
                      mask3d=ours).image
    assert normalized_rms(_np(img), np.asarray(ref)) < TOL
