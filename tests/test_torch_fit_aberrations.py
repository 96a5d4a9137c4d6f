"""Port parity: aberration retrieval (optimize.fit_aberrations) against the
JAX package on the CPU, at tests/test_optimize.py's 32^2 grid, chunk 8
and classical sigma-0.4 source.

Both packages image on the fft engine here. The targets come from JAX's
forward at known coefficients (astigmatism, coma and defocus: no
gradient vanishes by symmetry); the fit starts from a nonzero init so
that every fitted coefficient moves in the first step. Over 6 Adam steps
the port's histories agree with JAX's within 2e-4 relative and its
coefficients within 1e-5 of the largest (measured 5.8e-5 and 4.5e-7 at
most: each loss is a mean of squared differences of two near-equal
normalized images, so it carries their float32 rounding relatively
magnified).
The through-focus mode images its planes one after another where JAX
vmaps them, and averages the same per-plane losses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
from lithographysimulator_tpu import optimize as jo
from lithographysimulator_tpu.parallel import padded_source_arrays
from lithographysimulator_tpu_torch import optimize as po
from lithographysimulator_tpu_torch.interop import config_from_jax

CFG = jt.OpticsConfig(pixel_number=32)
PCFG = config_from_jax(CFG)
CHUNK = 8
TRUE_AB = np.array([0, 0, 0.02, 0.05, 25.0, 0, 0, 0.04], np.float32)
INIT = np.array([0.3, 0.01, 0.0, 0.01, 5.0, 0.0, 0.01, 0.0], np.float32)
OFFSETS = np.array([-80.0, 0.0, 80.0], np.float32)
TOL_HISTORY = 2e-4
TOL_COEFFS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    src = np.asarray(jt.LightSource(CFG, sigma_out=0.4).classical())
    shifts, weights, _ = padded_source_arrays(src, 8 * CHUNK)
    spectrum = np.asarray(jt.mask_spectrum(jt.demo_bars(CFG).geometry, CFG))

    def image_at(off):
        ab = TRUE_AB.copy()
        ab[4] += off
        return np.asarray(jt.abbe_image_points(
            spectrum, jt.pupil_function(ab, CFG), shifts, weights, CFG,
            chunk=CHUNK, normalize=True))

    stack = np.stack([image_at(o) for o in OFFSETS])
    return np.asarray(shifts), np.asarray(weights), spectrum, stack


def _compare(ours, ref) -> None:
    (c, h), (c_ref, h_ref) = ours, ref
    assert isinstance(c, torch.Tensor) and c.device.type == "cpu"
    assert h[-1] < h[0]
    np.testing.assert_allclose(h, h_ref, rtol=TOL_HISTORY)
    c_ref = np.asarray(c_ref)
    assert c.shape == c_ref.shape
    np.testing.assert_allclose(c.numpy(), c_ref, rtol=0,
                               atol=TOL_COEFFS * np.abs(c_ref).max())


@pytest.mark.parametrize("mode", ["single", "through_focus"])
def test_fit_matches_jax(setup, mode):
    shifts, weights, spectrum, stack = setup
    kw = dict(n_coeffs=8, steps=6, learning_rate=0.05, chunk=CHUNK, init=INIT)
    if mode == "single":
        target, kw_mode = stack[1], {}
    else:
        target, kw_mode = stack, {"defocus_nm": OFFSETS}
    ref = jo.fit_aberrations(target, spectrum, shifts, weights, CFG, **kw,
                             **kw_mode)
    ours = po.fit_aberrations(target, spectrum, shifts, weights,
                              PCFG, device="cpu", **kw, **kw_mode)
    _compare(ours, ref)
    # a device tensor spectrum sets the device
    again = po.fit_aberrations(target, torch.as_tensor(spectrum), shifts,
                               weights, PCFG, **kw, **kw_mode)
    np.testing.assert_array_equal(again[0].numpy(), ours[0].numpy())


def test_piston_is_pinned_and_defocus_entry_kept(setup):
    """Piston stays zero whatever the init; a focal stack fit keeps entry 4
    (n_coeffs raised to 5) for the offsets."""
    shifts, weights, spectrum, stack = setup
    coeffs, hist = po.fit_aberrations(
        stack, spectrum, shifts, weights, PCFG, n_coeffs=3,
        steps=2, init=np.array([0.7, 0.0, 0.0, 0.0, 0.0], np.float32),
        chunk=CHUNK, defocus_nm=OFFSETS, device="cpu")
    ref, _ = jo.fit_aberrations(
        stack, spectrum, shifts, weights, CFG, n_coeffs=3, steps=2,
        init=np.array([0.7, 0.0, 0.0, 0.0, 0.0], np.float32), chunk=CHUNK,
        defocus_nm=OFFSETS)
    assert coeffs.shape == (5,) and np.asarray(ref).shape == (5,)
    assert float(coeffs[0]) == 0.0 and len(hist) == 2


def test_shape_errors_match_jax(setup):
    shifts, weights, spectrum, stack = setup
    for target, kw, match in ((stack[0], {"defocus_nm": OFFSETS}, "matching"),
                              (stack[:2], {"defocus_nm": OFFSETS}, "matching"),
                              (stack, {}, "single-image")):
        with pytest.raises(ValueError, match=match) as ref:
            jo.fit_aberrations(target, spectrum, shifts, weights, CFG, **kw)
        with pytest.raises(ValueError, match=match) as ours:
            po.fit_aberrations(target, spectrum, shifts, weights,
                               PCFG, device="cpu", **kw)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="device="):
        po.fit_aberrations(stack[1], spectrum, shifts, weights, PCFG)
