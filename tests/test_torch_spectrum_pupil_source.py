"""Port parity: mask spectra, Zernike pupils and source maps of the torch
port (device='cpu') against the JAX package on the same numpy inputs, and
against the reference goldens at the tolerances the JAX tests assert.

Tolerances: modules <= 1e-6 normalized RMS against JAX (both float32; the
residual is summation order); source maps and host-built geometry exactly
equal (the same numpy code); goldens as in test_mask.py / test_zernike.py /
test_source.py (the reference's fp16 grids set those floors)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.ops import zernike as jz
from lithographysimulator_tpu_torch.interop import config_from_jax, mask_from_numpy
from lithographysimulator_tpu_torch.ops import fourier as pf
from lithographysimulator_tpu_torch.ops import zernike as pz
from lithographysimulator_tpu_torch.ops.resize import bilinear_resize

from .conftest import normalized_rms

TOL = 1e-6
DEMO_ABERR = np.array([0, 0, 0.01, 0, 100, 0.01, 0, 0.01, 0.01, 0.01], np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_mask(n, seed, complex_=False):
    rng = np.random.default_rng(seed)
    geom = (rng.random((n, n)) > 0.6).astype(np.float32)
    if complex_:
        return (geom + (1 - geom) * 0.245 * np.exp(1j * np.pi)).astype(np.complex64)
    return geom


@pytest.mark.parametrize("n,pixel_size", [(32, 25.0), (64, 25.0), (64, 60.0)])
def test_spectrum_fft_matches_jax(n, pixel_size):
    """Gau'23 spectrum; pixel_size 60 puts epsilon < 1 (pad becomes crop)."""
    cfg = jt.OpticsConfig(pixel_number=n, pixel_size=pixel_size)
    geom = _random_mask(n, n)
    ref = np.asarray(jt.spectrum_fft(geom, cfg))
    ours = _np(pt.spectrum_fft(torch.as_tensor(geom), config_from_jax(cfg)))
    assert normalized_rms(ours, ref) < TOL


def test_spectrum_fft_complex_psm_matches_jax():
    cfg = jt.OpticsConfig(pixel_number=32)
    geom = _random_mask(32, 5, complex_=True)
    ref = np.asarray(jt.spectrum_fft(geom, cfg))
    ours = _np(pt.spectrum_fft(torch.as_tensor(geom), config_from_jax(cfg)))
    assert normalized_rms(ours, ref) < TOL


@pytest.mark.parametrize("n", [32, 64])
def test_spectrum_direct_matches_jax(n):
    cfg = jt.OpticsConfig(pixel_number=n)
    geom = _random_mask(n, 100 + n)
    ref = np.asarray(jt.mask_spectrum(geom, cfg, solver="direct"))
    ours = _np(pt.mask_spectrum(torch.as_tensor(geom), config_from_jax(cfg),
                                solver="direct"))
    assert normalized_rms(ours, ref) < TOL


def test_pad_crop_and_resize_match_jax():
    from lithographysimulator_tpu.ops import fourier as jf
    from lithographysimulator_tpu.ops.resize import bilinear_resize as jresize

    rng = np.random.default_rng(3)
    a = rng.normal(size=(2, 10, 10)).astype(np.float32)
    for target in (16, 7, 10):
        np.testing.assert_array_equal(_np(pf.pad_center(torch.as_tensor(a), target)),
                                      np.asarray(jf.pad_center(a, target)))
        np.testing.assert_array_equal(_np(pf.crop_center(torch.as_tensor(a), target)),
                                      np.asarray(jf.crop_center(a, target)))
    for scale in (1.0362694300518136, 1 / 1.0362694300518136, 0.5, 1.7):
        ref = np.asarray(jresize(a, scale))
        np.testing.assert_allclose(_np(bilinear_resize(torch.as_tensor(a), scale)),
                                   ref, rtol=1e-6, atol=1e-6)


def test_centered_ffts_match_jax():
    from lithographysimulator_tpu.ops import fourier as jf

    rng = np.random.default_rng(4)
    a = (rng.normal(size=(3, 16, 16)) + 1j * rng.normal(size=(3, 16, 16))
         ).astype(np.complex64)
    for jfn, pfn in ((jf.centered_fft2, pf.centered_fft2),
                     (jf.centered_ifft2, pf.centered_ifft2)):
        assert normalized_rms(_np(pfn(torch.as_tensor(a))),
                              np.asarray(jfn(a))) < TOL


def test_mask_factories_match_jax():
    cfg = jt.OpticsConfig(pixel_number=64)
    pcfg = config_from_jax(cfg)
    pairs = [
        (jt.demo_bars(cfg), pt.demo_bars(pcfg, device="cpu")),
        (jt.lines_and_spaces(cfg, line_width_px=4, pitch_px=8, margin_px=3),
         pt.lines_and_spaces(pcfg, line_width_px=4, pitch_px=8, margin_px=3,
                             device="cpu")),
        (jt.lines_and_spaces(cfg, line_width_px=5, pitch_px=11, vertical=False),
         pt.lines_and_spaces(pcfg, line_width_px=5, pitch_px=11, vertical=False,
                             device="cpu")),
        (jt.contact_holes(cfg, hole_px=3, pitch_px=9),
         pt.contact_holes(pcfg, hole_px=3, pitch_px=9, device="cpu")),
    ]
    from lithographysimulator_tpu.models.mask import alternating_psm, attenuated_psm
    pairs += [
        (alternating_psm(cfg, line_width_px=4, pitch_px=8),
         pt.alternating_psm(pcfg, line_width_px=4, pitch_px=8, device="cpu")),
        (attenuated_psm(jt.demo_bars(cfg)),
         pt.attenuated_psm(pt.demo_bars(pcfg, device="cpu"))),
    ]
    for jm, pm in pairs:
        assert pm.config == pcfg
        np.testing.assert_allclose(_np(pm.geometry), np.asarray(jm.geometry),
                                   rtol=1e-7, atol=1e-7)
    m = mask_from_numpy(np.zeros((32, 32)), cfg, device="cpu")
    assert m.config.n == 32 and m.geometry.dtype == torch.float32
    with pytest.raises(ValueError):
        pt.from_array(np.zeros((4, 5)), pcfg, device="cpu")


def test_mask_goldens(golden):
    cfg = pt.DEMO_CONFIG
    np.testing.assert_array_equal(_np(pt.demo_bars(cfg, device="cpu").geometry),
                                  golden("demo_mask_geometry"))
    ours = _np(pt.spectrum_fft(pt.demo_bars(cfg, device="cpu").geometry, cfg))
    assert normalized_rms(ours, golden("demo_mask_spectrum_fft")) < 1e-5
    small = pt.from_array(golden("small_mask_geometry"),
                          pt.OpticsConfig(pixel_number=32), device="cpu")
    assert normalized_rms(_np(pt.spectrum_fft(small.geometry, small.config)),
                          golden("small_mask_spectrum_fft")) < 1e-5
    assert normalized_rms(_np(pt.spectrum_direct(small.geometry, small.config)),
                          golden("small_mask_spectrum_direct")) < 5e-3


@pytest.mark.parametrize("kw", [dict(), dict(obscuration=0.2), dict(na=0.33)])
def test_pupil_and_wavefront_match_jax(kw):
    cfg = jt.OpticsConfig(pixel_number=64, **kw)
    pcfg = config_from_jax(cfg)
    ab = DEMO_ABERR
    ref_we = np.asarray(jz.wavefront_error(ab, cfg))
    ours_we = _np(pz.wavefront_error(ab, pcfg, device="cpu"))
    assert normalized_rms(ours_we, ref_we) < TOL
    ref = np.asarray(jt.pupil_function(ab, cfg))
    ours = _np(pt.pupil_function(ab, pcfg, device="cpu"))
    assert normalized_rms(ours, ref) < TOL
    np.testing.assert_array_equal(np.abs(ours) > 0, np.abs(ref) > 0)


def test_pupil_host_input_needs_device():
    with pytest.raises(ValueError):
        pt.pupil_function(np.zeros(1), pt.DEMO_CONFIG)
    ab = torch.tensor([0.0, 0.0, 0.0, 0.0, 100.0])
    pt.pupil_function(ab, pt.DEMO_CONFIG)  # a tensor keeps its own device
    assert ab[4] == 100.0  # defocus conversion does not mutate the input


def test_zernike_index_maps_and_basis_match_jax():
    for j in range(28):
        assert pz.osa_index_to_mn(j) == jz.osa_index_to_mn(j)
    for j in range(1, 29):
        assert pz.noll_index_to_mn(j) == jz.noll_index_to_mn(j)
        assert pz.fringe_index_to_mn(j) == jz.fringe_index_to_mn(j)
    coeffs = np.arange(1, 12, dtype=np.float64)
    for scheme in ("noll", "fringe", "osa"):
        np.testing.assert_array_equal(pz.to_osa_coefficients(coeffs, scheme),
                                      jz.to_osa_coefficients(coeffs, scheme))
    cfg = jt.OpticsConfig(pixel_number=32)
    np.testing.assert_array_equal(pz.zernike_basis(config_from_jax(cfg), 15),
                                  jz.zernike_basis(cfg, 15))


@pytest.mark.parametrize("j", range(15))
def test_zernike_term_goldens(golden, j):
    m, n = pz.osa_index_to_mn(j)
    ours = pz.zernike_term(m, n, pt.Grid(pt.DEMO_CONFIG))
    assert normalized_rms(ours, golden(f"zernike_term_{j}")) < 2e-3


def test_wavefront_golden(golden):
    ref = golden("pupildemo_wavefront_error")
    cfg = pt.OpticsConfig(na=0.6)
    ab = np.array([0, 0, 0, 1, 3, 0, 0, 1, 0, 0], np.float32)
    ours = _np(pz.wavefront_error(ab, cfg, device="cpu"))
    assert normalized_rms(ours, ref.real) < 2e-3


SOURCES = [
    (dict(sigma_in=0.4, sigma_out=0.8), "quasar", (4, -np.pi / 8), "demo_source_quasar"),
    (dict(sigma_in=0.4, sigma_out=0.8), "annular", (), "demo_source_annular"),
    (dict(sigma_out=0.6), "classical", (), "demo_source_classical"),
    (dict(sigma_in=0.2, sigma_out=0.7, shift_x=0.25, shift_y=-0.5), "annular", (),
     "demo_source_shifted"),
    (dict(sigma_in=0.2, sigma_out=0.6, shift_x=0.3, shift_y=-0.2), "annular", (),
     "demo_source_shifted_small"),
    (dict(sigma_in=0.5, sigma_out=0.8), "quasar", (2, 0.0), "demo_source_dipole"),
    (dict(sigma_out=0.5), "monopole", (), None),
    (dict(sigma_in=0.3, sigma_out=0.9), "dipole", (0.3,), None),
]


@pytest.mark.parametrize("kw,kind,args,golden_name", SOURCES)
def test_source_maps_equal_jax_and_goldens(golden, kw, kind, args, golden_name):
    ref = np.asarray(getattr(jt.LightSource(jt.DEMO_CONFIG, **kw), kind)(*args))
    ours = getattr(pt.LightSource(pt.DEMO_CONFIG, **kw), kind)(*args)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    if golden_name is not None:
        np.testing.assert_array_equal(ours, golden(golden_name))
