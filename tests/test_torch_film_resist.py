"""Port parity: the resist side of the film stack — the four
resist-coupled tests of tests/test_filmstack.py, run on the torch port's
DepthResist, WaferStack.from_resist, film_stack_images and swing_curve
(device='cpu') and held against the JAX package's.

Tolerances: the depth profiles and the stack built from a resist are host
float64 in both packages and equal exactly. The rigorous develop's binary
profile equals JAX's except voxels whose arrival time lies within 1e-5 of
the develop time (tests/test_torch_resist.py's field class). The swing
curve's doses to clear are bisections to 64 / 2^24 on float32 cleared
depths: within two steps (64 / 2^23) of JAX's; the swing ratio, a ratio
of their detrended spread to their mean, within 1e-3 relative.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.models import resist as jr
from lithographysimulator_tpu.ops import filmstack as jfs
from lithographysimulator_tpu_torch.interop import (config_from_jax,
                                                    resist_from_jax,
                                                    wafer_stack_from_jax)
from lithographysimulator_tpu_torch.ops import filmstack as pfs

TOL = 1e-5
SI = jfs.MATERIALS_193["si"]
BARC = jfs.MATERIALS_193["barc"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_mack_depth_profile_agrees_at_weak_reflection():
    """The port's analytic D(z) is the weak-top-reflection limit of its
    rigorous profile (test_filmstack.py:116), and both equal JAX's."""
    n_r = 1.70 + 0.01j
    n_sub = 1.45  # |r_bot|^2 ~ 0.6%, positive-real reflection
    stack = jfs.WaferStack(n_resist=n_r, thickness_nm=150.0, n_substrate=n_sub)
    cfg = jt.OpticsConfig(pixel_number=16)
    r_bot = abs((n_r - n_sub) / (n_r + n_sub)) ** 2
    jd = jr.DepthResist(
        mack=jr.MackResist(thickness_nm=150.0), nz=30,
        absorbance_per_um=4.0 * np.pi * n_r.imag / 193.0 * 1e3,
        substrate_reflectivity=r_bot, n_resist=n_r.real, wavelength_nm=193.0)
    pd = resist_from_jax(jd)
    rig = pfs.open_frame_profile(wafer_stack_from_jax(stack),
                                 config_from_jax(cfg), pd.depths_nm)
    approx = pd.depth_profile()
    assert np.abs(rig - approx).max() < 0.05
    np.testing.assert_array_equal(approx, jd.depth_profile())
    np.testing.assert_array_equal(
        rig, jfs.open_frame_profile(stack, cfg, jd.depths_nm))


def test_from_resist_and_rigorous_handoff():
    """WaferStack.from_resist takes the port's DepthResist (the Dill
    absorbance becomes Im(n)); rigorous() disables the analytic D(z)
    (test_filmstack.py:242). Equal to JAX's."""
    jd = jr.DepthResist(mack=jr.MackResist(thickness_nm=180.0), nz=6,
                        absorbance_per_um=0.9, substrate_reflectivity=0.3,
                        n_resist=1.68, wavelength_nm=193.0)
    pd = resist_from_jax(jd)
    stack = pt.WaferStack.from_resist(pd, under_layers=((37.0, BARC),))
    assert dataclasses.asdict(stack) == dataclasses.asdict(
        jfs.WaferStack.from_resist(jd, under_layers=((37.0, BARC),)))
    assert stack.thickness_nm == 180.0
    assert abs(stack.n_resist.real - 1.68) < 1e-12
    assert abs(stack.n_resist.imag - 0.9e-3 * 193.0 / (4.0 * np.pi)) < 1e-15
    rig = pd.rigorous()
    assert isinstance(rig, pt.DepthResist)
    assert np.abs(rig.depth_profile() - 1.0).max() < 1e-12
    assert rig.nz == pd.nz and rig.n_resist == pd.n_resist
    assert dataclasses.asdict(rig) == dataclasses.asdict(jd.rigorous())


def test_develop_through_rigorous_stack():
    """Rigorous in-film exposure -> eikonal develop on the port clears the
    bright spaces and keeps the dark lines (test_filmstack.py:259), and its
    profile equals JAX's."""
    cfg = jt.OpticsConfig(pixel_number=32, na=0.8)
    pcfg = config_from_jax(cfg)
    src = np.asarray(jt.LightSource(cfg, sigma_out=0.5).classical())
    jd = jr.DepthResist(mack=jr.MackResist(thickness_nm=120.0, develop_s=60.0),
                        nz=6, absorbance_per_um=0.5, n_resist=1.71)
    pd = resist_from_jax(jd)
    jstack = jfs.WaferStack.from_resist(jd, under_layers=((37.0, BARC),))
    pstack = pt.WaferStack.from_resist(pd, under_layers=((37.0, BARC),))
    jmask = jt.demo_bars(cfg)
    film = pt.film_stack_images(pt.demo_bars(pcfg, device="cpu"), src,
                                device="cpu", wafer_stack=pstack, resist=pd,
                                normalize=True)
    assert film.shape == (6, 32, 32)
    profile = pd.rigorous().develop_profile_binary(
        film, 1.0, pixel_size_nm=cfg.pixel_size).numpy()
    cleared = profile[-1]  # bottom slab: 1 = resist removed
    geometry = np.asarray(jmask.geometry)  # 1 = transmitting bar -> bright
    assert cleared[geometry > 0.5].mean() > 0.9
    assert cleared[geometry < 0.5].mean() < 0.45
    assert cleared[:, :4].mean() < 0.05

    jfilm = jt.film_stack_images(jmask, src, config=cfg, wafer_stack=jstack,
                                 resist=jd, normalize=True)
    t_ref = np.asarray(jd.rigorous().arrival_times(
        jfilm, 1.0, pixel_size_nm=cfg.pixel_size))
    ref = (t_ref <= jd.mack.develop_s).astype(np.float32)
    differ = profile != ref
    assert not (differ & (np.abs(t_ref - jd.mack.develop_s)
                          > TOL * jd.mack.develop_s)).any()


def test_rigorous_swing_curve():
    """swing_curve(wafer_stack=...) on the port: over silicon the swing
    oscillates at lambda / (2 n_resist), an index-matched substrate kills
    it (test_filmstack.py:281); the doses to clear equal JAX's."""
    n_r = 1.70 + 0.012j
    jd = jr.DepthResist(mack=jr.MackResist(thickness_nm=300.0, develop_s=30.0),
                        nz=24, n_resist=n_r.real, wavelength_nm=193.0)
    pd = resist_from_jax(jd)
    on_si = jfs.WaferStack(n_resist=n_r, thickness_nm=300.0, n_substrate=SI)
    thicknesses = np.arange(260.0, 420.0, 4.0)
    sw = pt.swing_curve(thicknesses, pd, device="cpu",
                        wafer_stack=wafer_stack_from_jax(on_si))
    assert np.isfinite(sw["dose_to_clear"]).all()
    assert sw["swing_ratio"] > 0.05
    d = sw["dose_to_clear"]
    resid = d - np.polyval(np.polyfit(thicknesses, d, 1), thicknesses)
    spec = np.abs(np.fft.rfft(resid))
    freqs = np.fft.rfftfreq(len(resid), d=4.0)
    peak = freqs[1 + np.argmax(spec[1:])]
    assert 1.0 / peak == pytest.approx(193.0 / (2.0 * n_r.real), rel=0.2)

    matched = dataclasses.replace(on_si, n_substrate=n_r)
    sw0 = pt.swing_curve(thicknesses, pd, device="cpu",
                         wafer_stack=wafer_stack_from_jax(matched))
    assert sw0["swing_ratio"] < 0.2 * sw["swing_ratio"]

    ref = jr.swing_curve(thicknesses, jd, wafer_stack=on_si)
    np.testing.assert_allclose(d, ref["dose_to_clear"], rtol=0,
                               atol=64.0 / 2**23)
    assert sw["swing_ratio"] == pytest.approx(ref["swing_ratio"], rel=1e-3)
