"""Port parity: the port's own copy of the wafer film stack
(ops/filmstack.py) against the JAX package's module: the Airy
coefficients, the depth factors, the per-slab component multipliers
(scalar and vector), the open-frame profile, the substrate reflectance and
the BARC sweep, all within 1e-12 (both sides are host complex128 on the
same inputs; the stack crosses with interop.wafer_stack_from_jax)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
from lithographysimulator_tpu.ops import filmstack as jfs
from lithographysimulator_tpu_torch.interop import (config_from_jax,
                                                    wafer_stack_from_jax)
from lithographysimulator_tpu_torch.ops import filmstack as pfs

TOL = 1e-12
SI = jfs.MATERIALS_193["si"]
BARC = jfs.MATERIALS_193["barc"]
STACK = jfs.WaferStack(n_resist=1.71 + 0.02j, thickness_nm=150.0,
                       under_layers=((37.0, BARC),), n_substrate=SI)
PSTACK = wafer_stack_from_jax(STACK)
CFG = jt.OpticsConfig(pixel_number=16, na=0.85)
IMMERSION = jt.OpticsConfig(pixel_number=16, na=1.35, immersion_index=1.437)


def _close(a, b) -> None:
    for x, y in zip(np.atleast_1d(a) if not isinstance(a, tuple) else a,
                    np.atleast_1d(b) if not isinstance(b, tuple) else b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0,
                                   atol=TOL * max(1.0, np.abs(y).max()))


def test_wafer_stack_round_trip():
    assert dataclasses.asdict(PSTACK) == dataclasses.asdict(STACK)
    assert pfs.MATERIALS_193 == jfs.MATERIALS_193


@pytest.mark.parametrize("pol", ["te", "tm"])
def test_film_coefficients_equal_jax(pol):
    kx = np.linspace(0.0, 1.3, 27)
    kw = dict(pol=pol, n_top=1.437)
    _close(pfs.film_coefficients(PSTACK, kx, 193.0, **kw),
           jfs.film_coefficients(STACK, kx, 193.0, **kw))


@pytest.mark.parametrize("cfg", [CFG, IMMERSION], ids=["dry", "immersion"])
@pytest.mark.parametrize("depth", [0.0, 75.0, 150.0])
def test_film_depth_factors_equal_jax(cfg, depth):
    _close(pfs.film_depth_factors(PSTACK, config_from_jax(cfg), depth),
           jfs.film_depth_factors(STACK, cfg, depth))


@pytest.mark.parametrize("polarization", [None, "unpolarized", "x",
                                          (1.0, 1j)])
def test_film_component_multipliers_equal_jax(polarization):
    depths = [10.0, 75.0, 140.0]
    ref = jfs.film_component_multipliers(CFG, STACK, depths,
                                         polarization=polarization)
    got = pfs.film_component_multipliers(config_from_jax(CFG), PSTACK, depths,
                                         polarization=polarization)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    _close(got, ref)


@pytest.mark.parametrize("normalize", [True, False])
def test_open_frame_profile_equal_jax(normalize):
    z = np.linspace(0.0, 150.0, 31)
    _close(pfs.open_frame_profile(PSTACK, config_from_jax(IMMERSION), z,
                                  normalize=normalize),
           jfs.open_frame_profile(STACK, IMMERSION, z, normalize=normalize))


@pytest.mark.parametrize("kx,pol", [(0.0, "te"), (0.85, "tm")])
def test_substrate_reflectance_equal_jax(kx, pol):
    _close(pfs.substrate_reflectance(PSTACK, config_from_jax(CFG), kx=kx,
                                     pol=pol),
           jfs.substrate_reflectance(STACK, CFG, kx=kx, pol=pol))


def test_underlayer_sweep_equal_jax():
    t = np.linspace(10.0, 120.0, 45)
    _close(pfs.underlayer_sweep(PSTACK, config_from_jax(CFG), t, kx=0.3),
           jfs.underlayer_sweep(STACK, CFG, t, kx=0.3))
