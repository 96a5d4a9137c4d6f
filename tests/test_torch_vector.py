"""Port parity: the Jones-pupil vector engine (ops/vector.py) and
simulate(polarization=...) of the torch port (device='cpu') against the JAX
package.

The host float64 factors must be bit-equal to JAX's: the SOCS component
dedup compares them by exact equality (hopkins.py:850-861), so any
difference would change the component count of every vector build.
Images: <= 1e-6 normalized RMS against JAX (both float32)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.ops import hopkins as jh
from lithographysimulator_tpu.ops import vector as jv
from lithographysimulator_tpu.parallel import padded_source_arrays
from lithographysimulator_tpu_torch.interop import config_from_jax
from lithographysimulator_tpu_torch.ops import hopkins as ph
from lithographysimulator_tpu_torch.ops import vector as pv

from .conftest import normalized_rms

TOL = 1e-6
ABERR = np.asarray([0, 0, 0.02, 0, 30.0, 0.01], np.float32)
OPTICS = {"na0.9": dict(na=0.9), "dry1.35": dict(na=1.35),
          "water1.35": dict(na=1.35, immersion_index=1.437)}
POLS = ["x", "y", "unpolarized", (1, 1j)]


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


@pytest.mark.parametrize("apodize", [True, False])
@pytest.mark.parametrize("optics", list(OPTICS))
def test_factors_bit_equal_to_jax(optics, apodize):
    cfg = jt.OpticsConfig(pixel_number=32, **OPTICS[optics])
    pc = config_from_jax(cfg)
    for a, b in zip(jv._vector_basis(cfg), pv._vector_basis(pc)):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jv._vector_factors(cfg, apodize), pv._vector_factors(pc, apodize)):
        np.testing.assert_array_equal(b, a)
    for pol in ("x", "y", (1, 1j), (0.3, -0.7 + 0.2j)):
        for _, jones in jv.polarization_states(pol):
            ref = jv.component_factors(cfg, jones, apodize=apodize)
            ours = pv.component_factors(pc, jones, apodize=apodize)
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)


def test_evanescent_cut_and_on_axis_identity():
    """Dry NA 1.35 cuts the pupil positions with NA rho >= 1; water at
    1.437 keeps them all. The on-axis factor is the identity."""
    dry = pv._vector_basis(pt.OpticsConfig(pixel_number=32, na=1.35))[-1]
    wet = pv._vector_basis(pt.OpticsConfig(pixel_number=32, na=1.35,
                                           immersion_index=1.437))[-1]
    assert wet.sum() > dry.sum() and (dry <= wet).all()
    v, _ = pv._vector_factors(pt.OpticsConfig(pixel_number=32, na=0.9), True)
    np.testing.assert_array_equal(v[:, :, 16, 16], [[1, 0], [0, 1], [0, 0]])


def test_polarization_states_and_errors():
    for pol in ("x", "y", "unpolarized", None, (1, 1j), [0.6, 0.8j]):
        assert pv.polarization_states(pol) == jv.polarization_states(pol)
    ((w, (jx, jy)),) = pv.polarization_states((3, 4j))
    assert w == 1.0 and abs(jx) ** 2 + abs(jy) ** 2 == pytest.approx(1.0)
    with pytest.raises(ValueError, match="zero Jones"):
        pv.polarization_states((0, 0))
    for bad in ("z", (1, 0, 0), 3):
        with pytest.raises(ValueError, match="unknown polarization"):
            pv.polarization_states(bad)


@pytest.mark.parametrize("pol,count", [("unpolarized", 5), ("x", 3), ((1, 1j), 3)])
def test_dedup_matches_jax(pol, count):
    cfg = jt.OpticsConfig(pixel_number=32, na=0.9)
    ref = jh.dedup_polarization_factors(cfg, pol)
    ours = ph.dedup_polarization_factors(config_from_jax(cfg), pol)
    assert len(ours) == len(ref) == count
    for (wo, fo), (wr, fr) in zip(ours, ref):
        assert wo == wr
        np.testing.assert_array_equal(fo, fr)


@pytest.fixture(scope="module")
def points():
    cfg = jt.OpticsConfig(pixel_number=32, na=0.9)
    spec = np.asarray(jt.spectrum_fft(jt.demo_bars(cfg).geometry, cfg))
    pup = np.asarray(jt.pupil_function(ABERR, cfg))
    src = np.asarray(jt.LightSource(cfg, sigma_out=0.5).classical())
    shifts, weights, _ = padded_source_arrays(src, 4)
    shifts, weights = np.asarray(shifts), np.asarray(weights)
    return cfg, spec, pup, shifts, weights, int(np.abs(shifts).max())


def test_vector_pupils_match_jax(points):
    cfg, _, pup, *_ = points
    for _, jones in jv.polarization_states("unpolarized"):
        ref = np.asarray(jv.vector_pupils(pup, cfg, jones))
        ours = _np(pv.vector_pupils(pup, config_from_jax(cfg), jones, device="cpu"))
        assert ours.dtype == np.complex64
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("pol,engine,jax_engine", [
    ("unpolarized", "fft", "fft"), ("unpolarized", "int8", "matmul"),
    ((1, 1j), "int8", "matmul")])
def test_vector_abbe_image_matches_jax(points, pol, engine, jax_engine):
    """The int8 engine (its plain limb math on the CPU) is the CUDA path;
    it is held to the JAX package's f32 windowed engine, the plain
    reference of the same contraction (JAX's own int8 engine runs its
    Pallas kernels in interpret mode on the CPU, ~50x slower)."""
    cfg, spec, pup, shifts, weights, ms = points
    ref = np.asarray(jv.vector_abbe_image(spec, pup, shifts, weights, cfg,
                                          polarization=pol, engine=jax_engine,
                                          max_abs_shift=ms))
    ours = _np(pv.vector_abbe_image(spec, pup, shifts, weights, config_from_jax(cfg),
                                    device="cpu", polarization=pol, engine=engine,
                                    max_abs_shift=ms))
    assert normalized_rms(ours, ref) < TOL


@pytest.fixture(scope="module")
def masks():
    cfg = jt.OpticsConfig(pixel_number=32, na=0.9)
    src = np.asarray(jt.LightSource(cfg, sigma_out=0.5).classical())
    return cfg, src, jt.demo_bars(cfg), pt.demo_bars(config_from_jax(cfg), device="cpu")


@pytest.mark.parametrize("pol", POLS)
@pytest.mark.parametrize("solver", ["gau23", "direct"])
def test_simulate_polarization_matches_jax(masks, solver, pol):
    cfg, src, jmask, pmask = masks
    ref = jt.simulate(jmask, src, ABERR, solver=solver, polarization=pol)
    ours = pt.simulate(pmask, src, ABERR, device="cpu", solver=solver,
                       polarization=pol)
    assert normalized_rms(_np(ours.image), np.asarray(ref.image)) < TOL
    assert normalized_rms(_np(ours.pupil), np.asarray(ref.pupil)) < TOL
    assert set(ours.report) == set(ref.report)
    for key in ("polarization", "chromatic", "mask3d", "source_points", "solver"):
        assert ours.report[key] == ref.report[key]


def test_jones_list_normalized_and_batch_matches_jax(masks):
    """A list Jones vector prints as JAX's tuple of complex; the batch path
    images each mask as simulate() does."""
    cfg, src, jmask, pmask = masks
    ours = pt.simulate(pmask, src, ABERR, device="cpu", polarization=[1, 1j])
    ref = jt.simulate(jmask, src, ABERR, polarization=[1, 1j])
    assert ours.report["polarization"] == ref.report["polarization"] == "((1+0j), 1j)"
    g = np.asarray(jmask.geometry)
    geoms = np.stack([g, g.T])
    jb = np.asarray(jt.simulate_batch(geoms, cfg, src, ABERR, polarization="y",
                                      normalize=True))
    pb = _np(pt.simulate_batch(geoms, config_from_jax(cfg), src, ABERR, device="cpu",
                               polarization="y", normalize=True))
    for b in range(2):
        assert normalized_rms(pb[b], jb[b]) < TOL
