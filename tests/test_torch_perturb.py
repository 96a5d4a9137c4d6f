"""Port parity: the scanner perturbations (ops/perturb.py) and the perturb
option of simulate and simulate_batch of the torch port (device='cpu')
against the JAX package: <= 1e-6 normalized RMS, report strings equal.

One divergence, on purpose (ROADMAP.md Queue 3, R7): the uniform-flare
background of a batch is each image's own mean, where the JAX package
averages over the whole batch; for a batch of equal masks both agree."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.ops import perturb as jp
from lithographysimulator_tpu_torch.interop import config_from_jax, perturbation_from_jax
from lithographysimulator_tpu_torch.ops import perturb as pp

from .conftest import normalized_rms

TOL = 1e-6
CFG = jt.OpticsConfig(pixel_number=64)
PCFG = config_from_jax(CFG)
CASES = {
    "blur": jt.ImagePerturbation(msd_x_nm=20.0, msd_y_nm=7.0),
    "uniform_flare": jt.ImagePerturbation(flare_tis=0.2),
    "kernel_flare": jt.ImagePerturbation(flare_tis=0.1, flare_kernel_nm=40.0),
    "all": jt.ImagePerturbation(msd_x_nm=5.0, msd_y_nm=2.0, flare_tis=0.02,
                                flare_kernel_nm=30.0),
}


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


def _feature(n=128):
    rng = np.random.default_rng(0)
    img = np.zeros((n, n), np.float32)
    img[60:68, 60:68] = 1.0
    return img + 0.1 * rng.random((n, n), np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_apply_perturbation_matches_jax(case):
    img = _feature()
    perturb = CASES[case]
    ref = np.asarray(jp.apply_perturbation(jnp.asarray(img), perturb, 4.0))
    ours = pp.apply_perturbation(torch.as_tensor(img), perturbation_from_jax(perturb), 4.0)
    assert ours.dtype == torch.float32
    assert normalized_rms(_np(ours), ref) < TOL
    # energy conserved: unit-DC transfers, flare redistributes
    assert float(ours.sum(dtype=torch.float64)) == pytest.approx(float(img.sum()), rel=1e-5)
    np.testing.assert_array_equal(pp._gauss_transfer(16, 2.0, 3.0, 1.0),
                                  jp._gauss_transfer(16, 2.0, 3.0, 1.0))


def test_stage_blur_is_the_gaussian_mtf():
    """A sinusoid's modulation drops by exp(-2 pi^2 sigma^2 f^2)
    (test_perturb.py:33-50); a y-blur leaves an x-sinusoid alone."""
    x = (np.arange(256) - 128) * 2.0
    img = torch.as_tensor(np.tile(0.5 * (1 + np.cos(2 * np.pi * x / 128.0)),
                                  (256, 1)).astype(np.float32))
    out = pp.apply_perturbation(img, pt.ImagePerturbation(msd_x_nm=20.0), 2.0)
    expected = np.exp(-2 * np.pi ** 2 * 20.0 ** 2 / 128.0 ** 2)
    assert float(out.max() - out.min()) / float(img.max() - img.min()) == pytest.approx(
        expected, rel=1e-3)
    out_y = pp.apply_perturbation(img, pt.ImagePerturbation(msd_y_nm=20.0), 2.0)
    np.testing.assert_allclose(_np(out_y), _np(img), atol=1e-5)


def test_validation_and_active():
    for kw in (dict(flare_tis=1.0), dict(flare_tis=-0.1), dict(msd_x_nm=-1.0),
               dict(flare_kernel_nm=-2.0)):
        with pytest.raises(ValueError):
            pt.ImagePerturbation(**kw)
    assert not pt.ImagePerturbation().active
    assert not pt.ImagePerturbation(flare_kernel_nm=3.0).active
    assert pt.ImagePerturbation(msd_y_nm=1.0).active
    with pytest.raises(TypeError, match="tensor"):
        pp.apply_perturbation(np.zeros((4, 4)), pt.ImagePerturbation(msd_x_nm=1.0), 1.0)
    assert pp.apply_perturbation(torch.ones(8, 8), pt.ImagePerturbation(flare_tis=0.5),
                                 PCFG).tolist() == torch.ones(8, 8).tolist()


@pytest.fixture(scope="module")
def setup():
    src = np.asarray(jt.LightSource(CFG, sigma_out=0.5).classical())
    return src, jt.demo_bars(CFG), pt.demo_bars(PCFG, device="cpu")


@pytest.mark.parametrize("solver,kw", [("gau23", {}), ("direct", {}),
                                       ("socs", dict(socs_rank=32)),
                                       ("gau23", dict(polarization="x"))])
def test_simulate_perturb_matches_jax(setup, solver, kw):
    src, jmask, pmask = setup
    perturb = CASES["all"]
    ref = jt.simulate(jmask, src, solver=solver, normalize=True, perturb=perturb, **kw)
    ours = pt.simulate(pmask, src, device="cpu", solver=solver, normalize=True,
                       perturb=perturbation_from_jax(perturb), **kw)
    assert ours.report["perturbation"] == ref.report["perturbation"] == (
        "MSD=(5.0,2.0)nm TIS=0.02")
    assert set(ours.report) == set(ref.report)
    if solver == "socs":
        # the SOCS builds differ (other probes): hold the perturbation step
        # itself, on the port's own unperturbed image
        clean = pt.simulate(pmask, src, device="cpu", solver=solver,
                            normalize=True, **kw)
        expect = np.asarray(jp.apply_perturbation(jnp.asarray(_np(clean.image)),
                                                  perturb, CFG))
        assert normalized_rms(_np(ours.image), expect) < TOL
        assert normalized_rms(_np(ours.image), np.asarray(ref.image)) < 1e-3
    else:
        assert normalized_rms(_np(ours.image), np.asarray(ref.image)) < TOL
    off = pt.simulate(pmask, src, device="cpu", solver=solver, normalize=True,
                      perturb=pt.ImagePerturbation(), **kw)
    assert "perturbation" not in off.report


def test_simulate_batch_perturb(setup):
    """Equal masks: JAX's batch to 1e-6. Different masks: each image is
    simulate()'s on its own mask (per-image flare background, R7)."""
    src, jmask, _ = setup
    perturb = jt.ImagePerturbation(msd_x_nm=30.0, flare_tis=0.05)
    g = np.abs(np.asarray(jmask.geometry))
    same = np.stack([g, g])
    ref = np.asarray(jt.simulate_batch(same, CFG, src, perturb=perturb))
    ours = _np(pt.simulate_batch(same, PCFG, src, device="cpu",
                                 perturb=perturbation_from_jax(perturb)))
    for b in range(2):
        assert normalized_rms(ours[b], ref[b]) < TOL
    mixed = np.stack([g, 0.3 * g.T])
    batch = _np(pt.simulate_batch(mixed, PCFG, src, device="cpu",
                                  perturb=perturbation_from_jax(perturb)))
    for b in range(2):
        single = pt.simulate(pt.from_array(mixed[b], PCFG, device="cpu"), src,
                             device="cpu", perturb=perturbation_from_jax(perturb))
        assert normalized_rms(batch[b], _np(single.image)) < TOL
