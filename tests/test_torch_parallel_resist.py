"""Port parity: the trial-sharded stochastic bands, the source-sharded film
stack and the sharded FEM cell pass with its gradient (parallel/*) on the
CPU, at tests/test_sharding.py's 32^2 configurations and tolerances, on
meshes of 2-8 'cpu' entries.

The stochastic bands equal the port's single-device bands bit for bit:
trial i draws from its own generator seeded from (seed, i) wherever it
runs, and the print counts are integers, exact in float32 in any order
(ROADMAP D2). Against JAX (jax.random keys) they agree in distribution:
the pixel-mean print probability and the band's correlation, with bounds
set from measured values with a margin. The film stack and the FEM matrix
are held to JAX's sharded functions on a JAX mesh of the same shape.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
from lithographysimulator_tpu import parallel as jp
from lithographysimulator_tpu.models import stochastic as js
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu_torch import parallel as pp
from lithographysimulator_tpu_torch.interop import (config_from_jax,
                                                    resist_from_jax,
                                                    stochastic_from_jax,
                                                    wafer_stack_from_jax)
from lithographysimulator_tpu_torch.models import stochastic as ps
from lithographysimulator_tpu_torch.ops import focus as pfocus

CFG = jt.OpticsConfig(pixel_number=32)
PCFG = config_from_jax(CFG)
SCFG = jt.OpticsConfig(pixel_number=32, pixel_size=5.0)
PSCFG = config_from_jax(SCFG)
MODEL = js.StochasticResist(dose_photons_per_nm2=8.0, diffusion_nm=6.0,
                            threshold=0.4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(k: int):
    return pp.source_mesh(devices=["cpu"] * k)


def _jax_mesh(k: int, shape=None, axes=("source",)):
    return JaxMesh(np.asarray(jax.devices()[:k]).reshape(shape or (k,)), axes)


def _smooth_image(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    image = np.abs(np.fft.ifft2(np.fft.fft2(rng.random((32, 32)))
                                * np.exp(-0.05 * np.arange(32)[:, None])))
    return (image / image.max()).astype(np.float32)


def _same_distribution(ours: np.ndarray, ref: np.ndarray) -> None:
    """Two bands of independent draws of one model: the pixel-mean print
    probability within 0.01 and the bands correlated above 0.98 (measured
    here: 4.6e-4 and 0.996 for the 2-D lines, 1.1e-3 and 0.994 for the
    volume)."""
    assert abs(float(ours.mean()) - float(ref.mean())) < 0.01
    assert np.corrcoef(ours.ravel(), ref.ravel())[0, 1] > 0.98


def test_stochastic_band_sharded_matches_host():
    """JAX's slow test_stochastic_band_sharded_matches_host: 8 entries x 4
    trials, seed 5, bit for bit the port's 32-trial single-device band;
    JAX's 32-trial band in distribution."""
    image = _smooth_image(0)
    model = stochastic_from_jax(MODEL)
    band = pp.print_probability_sharded(image, PSCFG, model, _mesh(8),
                                        trials_per_device=4, seed=5).numpy()
    host = ps.exposure_trials(image, PSCFG, model, trials=32, seed=5,
                              trial_chunk=32, device="cpu").sum(0).numpy()
    np.testing.assert_array_equal(band, host / np.float32(32))
    assert 0.0 <= band.min() and band.max() <= 1.0
    # that image prints everywhere; in distribution on lines whose edges
    # the threshold crosses, at a dose that leaves 41% of the pixels
    # neither always nor never printed
    lines = (0.5 + 0.45 * np.cos(2 * np.pi * np.arange(32) / 8))[None, :]
    lines = np.repeat(lines, 32, axis=0).astype(np.float32)
    low = js.StochasticResist(dose_photons_per_nm2=0.2, diffusion_nm=6.0,
                              threshold=0.4)
    band = pp.print_probability_sharded(lines, PSCFG, stochastic_from_jax(low),
                                        _mesh(8), trials_per_device=4,
                                        seed=5).numpy()
    assert ((band > 0) & (band < 1)).mean() > 0.3
    ref = np.asarray(js.exposure_trials(lines, SCFG, low, trials=32, seed=5,
                                        trial_chunk=32)).mean(axis=0)
    _same_distribution(band, ref)


def test_stochastic_volume_band_sharded_matches_host():
    """JAX's test_stochastic_volume_band_sharded_matches_host: 8 entries x
    2 trials of the (3, 32, 32) stack bit for bit the port's
    stochastic_volume_ensemble print probability; JAX's sharded band on 8
    devices in distribution; the band's shape and range."""
    base = _smooth_image(1)
    stack = np.stack([base, 0.7 * base, 0.5 * base]).astype(np.float32)
    stack = stack / stack.max()
    model = stochastic_from_jax(MODEL)
    band = pp.print_probability_volume_sharded(
        stack, PSCFG, model, _mesh(8), dz_nm=40.0, trials_per_device=2,
        seed=5).numpy()
    host = ps.stochastic_volume_ensemble(stack, PSCFG, model, dz_nm=40.0,
                                         trials=16, seed=5, device="cpu")
    np.testing.assert_array_equal(band, host["print_probability"])
    assert band.shape == stack.shape
    assert 0.0 <= band.min() and band.max() <= 1.0
    ref = np.asarray(jp.print_probability_volume_sharded(
        stack, SCFG, MODEL, _jax_mesh(8), dz_nm=40.0, trials_per_device=2,
        seed=5))
    _same_distribution(band, ref)
    # another split of the same 16 trials: the same band, bit for bit
    np.testing.assert_array_equal(band, pp.print_probability_volume_sharded(
        stack, PSCFG, model, _mesh(4), dz_nm=40.0, trials_per_device=4,
        seed=5).numpy())


@pytest.mark.parametrize("case", ["scalar", "unpolarized", "boundary_layer"])
def test_film_stack_sharded_matches_local(case):
    """JAX's test_film_stack_sharded_matches_local, case by case: the
    port's sharded stack on 4 entries against JAX's on 4 devices and the
    port's film_stack_images, rtol 1e-5."""
    cfg = jt.OpticsConfig(pixel_number=32, na=0.85)
    pcfg = config_from_jax(cfg)
    src = np.asarray(jt.LightSource(cfg, sigma_out=0.6).classical())
    wafer = jt.WaferStack(n_resist=1.71 + 0.01j, thickness_nm=120.0,
                          under_layers=((37.0, 1.82 + 0.39j),))
    pwafer = wafer_stack_from_jax(wafer)
    pol = "unpolarized" if case == "unpolarized" else None
    m3d = pm3d = None
    if case == "boundary_layer":
        kw = dict(width_nm=8.0, beta_h=-0.2, beta_v=-0.2 + 0.05j)
        m3d, pm3d = jt.BoundaryLayer(**kw), pt.BoundaryLayer(**kw)
    depths = [20.0, 60.0, 100.0]
    geometry = np.array(jt.demo_bars(cfg).geometry)
    ref = np.asarray(jp.film_stack_sharded(
        jt.demo_bars(cfg), src, config=cfg, wafer_stack=wafer,
        mesh=_jax_mesh(4), depths_nm=depths, polarization=pol, mask3d=m3d,
        normalize=True))
    ours = pp.film_stack_sharded(
        torch.as_tensor(geometry), src, config=pcfg, wafer_stack=pwafer,
        mesh=_mesh(4), depths_nm=depths, polarization=pol, mask3d=pm3d,
        normalize=True)
    assert ours.shape == (3, 32, 32)
    ours = ours.numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * ref.max())
    local = pt.film_stack_images(torch.as_tensor(geometry), src, device="cpu",
                                 config=pcfg, wafer_stack=pwafer,
                                 depths_nm=depths, polarization=pol,
                                 mask3d=pm3d, normalize=True).numpy()
    np.testing.assert_allclose(ours, local, rtol=1e-5, atol=1e-5 * local.max())


@pytest.fixture(scope="module")
def fem_setup():
    spec = np.array(jt.spectrum_fft(jt.demo_bars(CFG).geometry, CFG))
    src = np.asarray(jt.LightSource(CFG, sigma_in=0.2, sigma_out=0.6).annular())
    shifts, weights, _ = pp.padded_source_arrays(src, 4 * 4)
    return spec, shifts, weights


def test_fem_cd_matrix_sharded_matches_jax_and_host(fem_setup):
    """JAX's test_fem_cd_matrix_sharded_matches_host: the (2, 3) matrix
    on a (2, 4) mesh against JAX's on a (2, 4) JAX mesh and against the
    same math on the port's host focal stack (rtol 1e-4, atol 1e-3 nm);
    CD grows with dose at every focus."""
    spec, shifts, weights = fem_setup
    base = np.zeros(5, np.float32)
    defocus = np.array([0.0, 80.0], np.float32)
    doses = np.array([0.8, 1.0, 1.2], np.float32)
    resist = jt.ResistModel(threshold=0.3, steepness=60.0, diffusion_nm=10.0)
    presist = resist_from_jax(resist)
    cds = pp.fem_cd_matrix_sharded(
        torch.as_tensor(spec), base, defocus, doses, shifts, weights, PCFG,
        pp.focus_source_mesh(2, 4, devices=["cpu"] * 8), resist=presist,
        chunk=4).numpy()
    assert cds.shape == (2, 3)
    ref = np.asarray(jp.fem_cd_matrix_sharded(
        spec, base, defocus, doses, shifts, weights, CFG,
        _jax_mesh(8, (2, 4), ("focus", "source")), resist=resist, chunk=4))
    np.testing.assert_allclose(cds, ref, rtol=1e-4, atol=1e-3)
    stack = pfocus.through_focus_images(
        torch.as_tensor(spec), pfocus.focus_stack_aberrations(base, defocus),
        shifts, weights, PCFG, device="cpu", chunk=4).numpy()
    blurred = presist.blur(stack / stack.max(), PCFG, device="cpu").numpy()
    cut = blurred[:, CFG.n // 2].astype(np.float64)
    expect = np.stack([
        (1.0 / (1.0 + np.exp(-presist.steepness * (cut * d - presist.threshold)))
         ).sum(axis=-1) * CFG.pixel_size for d in doses], axis=1)
    np.testing.assert_allclose(cds, expect, rtol=1e-4, atol=1e-3)
    assert (np.diff(cds, axis=1) > 0).all()


def test_fem_cd_matrix_sharded_grad(fem_setup):
    """JAX's slow test_fem_cd_matrix_sharded_grad: the matrix's variance
    is differentiable in the base aberrations through the (2, 4) mesh
    (finite, nonzero), and the gradient equals the one through a (2, 1)
    mesh of two entries and a (1, 1) mesh of one, to 1e-5 * max|g|."""
    spec, shifts, weights = fem_setup

    def grad(mesh):
        # coma and astigmatism: an asymmetric image with one maximum (the
        # shared normalization's max has a tie-dependent subgradient)
        base = torch.tensor([0, 0, 0, 0.02, 0, 0, 0, 0.03],
                            requires_grad=True)
        cds = pp.fem_cd_matrix_sharded(
            torch.as_tensor(spec), base, np.array([0.0, 60.0], np.float32),
            np.array([1.0], np.float32), shifts, weights, PCFG, mesh, chunk=4)
        torch.var(cds, unbiased=False).backward()
        return base.grad.numpy()

    g = grad(pp.focus_source_mesh(2, 4, devices=["cpu"] * 8))
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    for mesh in (pp.focus_source_mesh(2, 1, devices=["cpu"] * 2),
                 pp.focus_source_mesh(1, 1, devices=["cpu"])):
        np.testing.assert_allclose(grad(mesh), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())
