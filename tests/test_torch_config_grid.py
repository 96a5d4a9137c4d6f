"""Port parity: OpticsConfig / wavelength scaling / grid of the torch port
against the JAX package (both framework-free copies: equality is exact)."""

import numpy as np
import pytest

pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu import grid as jgrid
from lithographysimulator_tpu_torch import grid as pgrid
from lithographysimulator_tpu_torch.interop import config_from_jax

SWEEP = [dict(pixel_number=n, pixel_size=ps, wavelength=wl, na=na)
         for n in (16, 32, 64, 128, 1024, 2048)
         for ps in (2.5, 25.0, 40.0)
         for wl in (13.5, 193.0, 248.0)
         for na in (0.33, 0.7, 1.35)]


@pytest.mark.parametrize("case", range(0, len(SWEEP), 9))
def test_wavelength_scaling_matches_jax(case):
    """beta, N and epsilon equal field by field (exact: same float math)."""
    for kw in SWEEP[case : case + 9]:
        a = jt.OpticsConfig(**kw).wavelength_scaling()
        b = pt.OpticsConfig(**kw).wavelength_scaling()
        assert (a.beta, a.fft_size, a.epsilon) == (b.beta, b.fft_size, b.epsilon)


def test_config_derived_fields_and_hash():
    kw = dict(pixel_number=96, pixel_size=30.0, wavelength=193.0, na=1.2,
              immersion_index=1.437, obscuration=0.2)
    a, b = jt.OpticsConfig(**kw), pt.OpticsConfig(**kw)
    for f in ("n", "delta_k", "k_bound", "delta_sigma", "pixel_bound", "field_nm"):
        assert getattr(a, f) == getattr(b, f)
    assert a.defocus_nm_to_waves(50.0) == b.defocus_nm_to_waves(50.0)
    assert config_from_jax(a) == b
    assert hash(config_from_jax(a)) == hash(b)  # keys the host caches
    with pytest.raises(ValueError):
        pt.OpticsConfig(pixel_number=63)


def test_laser_spectrum_matches_jax():
    for shape in ("gaussian", "lorentzian", "tophat"):
        a = jt.LaserSpectrum(bandwidth_pm=0.4, samples=5, shape=shape)
        b = pt.LaserSpectrum(bandwidth_pm=0.4, samples=5, shape=shape)
        np.testing.assert_array_equal(a.defocus_offsets_nm(), b.defocus_offsets_nm())
        np.testing.assert_array_equal(a.weights(), b.weights())


@pytest.mark.parametrize("n", [32, 64])
def test_grid_axes_and_disk_match_jax(n):
    ja, pa = jt.OpticsConfig(pixel_number=n), pt.OpticsConfig(pixel_number=n)
    jg, pg = jgrid.Grid(ja), pgrid.Grid(pa)
    for f in ("sigma", "k", "x"):
        np.testing.assert_array_equal(getattr(jg, f), getattr(pg, f))
    np.testing.assert_array_equal(jg.radius(0.25, -0.5), pg.radius(0.25, -0.5))
    np.testing.assert_array_equal(jg.theta(0.1, 0.2), pg.theta(0.1, 0.2))
    np.testing.assert_array_equal(jgrid.unit_disk_mask(jg), pgrid.unit_disk_mask(pg))


def test_tf32_off_at_import():
    import torch

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
