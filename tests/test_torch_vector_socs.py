"""Port parity: the summed-TCC (component) SOCS builds of the torch port
(device='cpu') against the JAX package: the channel algebra, the vector
trace, the randomized vector build and simulate(solver='socs',
polarization=...).

The builds draw torch.Generator probes, so they are held as the JAX tests
hold theirs: eigenvalues against the dense oracle (2e-3 relative,
test_vector_socs.py:103-115), images against JAX's exact vector image
(1e-3 at rank 96, :87-100), the full channel rotation against the
uncompressed build (2e-4, test_channels.py:77-94). The channel algebra is
held to 1e-5 relative of JAX."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.ops import hopkins as jh
from lithographysimulator_tpu.parallel import padded_source_arrays
from lithographysimulator_tpu_torch.interop import config_from_jax
from lithographysimulator_tpu_torch.ops import hopkins as ph
from lithographysimulator_tpu_torch.ops import vector as pv

from .conftest import normalized_rms

ABERR = np.asarray([0, 0, 0.02, 0, 30.0, 0.01], np.float32)
BUILD = dict(rank=96, oversample=32, power_iters=3)


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


def _setup(na=0.9):
    cfg = jt.OpticsConfig(pixel_number=32, na=na)
    spec = np.array(jt.spectrum_fft(jt.demo_bars(cfg).geometry, cfg))
    pup = np.array(jt.pupil_function(ABERR, cfg))
    src = np.asarray(jt.LightSource(cfg, sigma_out=0.5).classical())
    return cfg, config_from_jax(cfg), torch.as_tensor(spec), torch.as_tensor(pup), src


def _stacks(na=0.9, pol="unpolarized"):
    cfg, pc, _, pup, _ = _setup(na)
    jc, jq = jh.vector_component_stack(jnp.asarray(pup.numpy()), cfg, polarization=pol)
    pcomp, pq = ph.vector_component_stack(pup, pc, polarization=pol)
    return (jc, jq), (pcomp, pq)


@pytest.fixture(scope="module")
def exact():
    """JAX's exact vector images at 32^2, NA 0.9 (one per polarization)."""
    cfg, _, spec, pup, src = _setup()
    shifts, weights, _ = padded_source_arrays(src, 4)
    ms = int(np.abs(np.asarray(shifts)).max())
    return {str(pol): np.asarray(jt.vector_abbe_image(
        spec.numpy(), pup.numpy(), shifts, weights, cfg, polarization=pol,
        max_abs_shift=ms)) for pol in ("unpolarized", "x", (1.0, 1.0j))}


def test_component_stack_gram_and_rotation_match_jax():
    (jc, jq), (pc, pq) = _stacks()
    np.testing.assert_array_equal(_np(pc), np.asarray(jc))
    np.testing.assert_array_equal(_np(pq), np.asarray(jq))
    ref = np.asarray(jh.channel_gram(jc, jq), np.float64)
    ours = ph.channel_gram(pc, pq)
    scale = np.abs(ref).max()
    assert np.abs(ours - ref).max() <= 1e-5 * scale
    # trace(S) is the component energy (test_channels.py:65-74)
    energy = float(np.sum(_np(pq)[:, None, None] * np.abs(_np(pc)) ** 2))
    assert np.trace(ours[0]) == pytest.approx(energy, rel=1e-6)
    rot, captured = ph.rotation_from_gram(ours, channels=3)
    jrot, jcap = jh.rotation_from_gram(ref, channels=3)
    assert rot.shape == jrot.shape == (2, 5, 3) and captured == pytest.approx(jcap, rel=1e-6)
    y, ones = ph.apply_channel_rotation(pc, pq, rot)
    jy, _ = jh.apply_channel_rotation(jc, jq, rot)
    assert _np(ones).tolist() == [1.0] * 3
    assert np.abs(_np(y) - np.asarray(jy)).max() <= 1e-5 * np.abs(np.asarray(jy)).max()


@pytest.mark.parametrize("na,tol", [(0.9, 1e-6), (0.6, 1e-6), (0.6, 3e-3)])
def test_rotation_channel_count_matches_jax(na, tol):
    """NA 0.9 keeps all 5 channels, NA 0.6 drops its exactly redundant one
    at the tight tolerance and more at 3e-3 (test_channels.py:97-122)."""
    (jc, jq), (pc, pq) = _stacks(na)
    jrot, jcap = jh.principal_channel_rotation(jc, jq, tol=tol)
    rot, cap = ph.principal_channel_rotation(pc, pq, tol=tol)
    assert rot.shape == jrot.shape
    assert cap == pytest.approx(jcap, rel=1e-5)


def test_vector_pupil_power_and_trace_match_jax():
    cfg, pc, _, pup, src = _setup()
    for pol in ("unpolarized", "x", (1, 1j)):
        for apodize in (True, False):
            ref = float(jh.vector_pupil_power(jnp.asarray(pup.numpy()), cfg,
                                              polarization=pol, apodize=apodize))
            ours = ph.vector_pupil_power(pup, pc, polarization=pol, apodize=apodize)
            assert ours == pytest.approx(ref, rel=1e-5)
    ref = float(jh.vector_tcc_trace(jnp.asarray(pup.numpy()), src, cfg))
    assert ph.vector_tcc_trace(pup, src, pc) == pytest.approx(ref, rel=1e-5)
    assert ph.tcc_total_trace(pup, src, polarization="unpolarized",
                              config=pc) == pytest.approx(ref, rel=1e-5)
    with pytest.raises(ValueError, match="config"):
        ph.tcc_total_trace(pup, src, polarization="unpolarized")


def test_randomized_vector_eigenvalues_match_dense():
    """The randomized summed-TCC build against the port's dense oracle over
    the stacked components (test_vector_socs.py:103-115)."""
    _, pc, _, pup, src = _setup()
    comps, cws = [], []
    for wgt, jones in pv.polarization_states("unpolarized"):
        vp = pv.vector_pupils(pup, pc, jones)
        comps += list(vp)
        cws += [wgt] * 3
    dense = ph.tcc_eigensystem(torch.stack(comps), src, pc, rank=24,
                               component_weights=np.asarray(cws))
    rand = ph.randomized_socs_vector(pup, src, pc, polarization="unpolarized",
                                     rank=24, oversample=32, power_iters=3)
    np.testing.assert_allclose(_np(rand.eigenvalues), _np(dense.eigenvalues),
                               rtol=2e-3)
    assert rand.total_rank == int((src > 0).sum())


@pytest.mark.parametrize("pol", ["unpolarized", "x", (1.0, 1.0j)])
def test_randomized_vector_image_matches_jax_exact(exact, pol):
    """One kernel set reproduces JAX's exact vector image at rank 96; a
    missed source roll or kernel conjugation fails this (eigenvalues
    alone cannot see either)."""
    _, pc, spec, pup, src = _setup()
    socs = ph.randomized_socs_vector(pup, src, pc, polarization=pol, **BUILD)
    img = _np(ph.socs_image(spec, socs, pc))
    assert socs.rank == 96 and float(socs.eigenvalues[0]) > 0
    assert normalized_rms(img, exact[str(pol)]) < 1e-3
    frac = ph.socs_energy_captured(socs, pup, src, polarization=pol, config=pc)
    assert 0.95 < frac <= 1.0 + 1e-6


def test_full_rotation_and_compression(exact):
    """All channels kept is a pure unitary mixing (test_channels.py:77-94);
    the fixed-count compression keeps the trace and the image's class."""
    _, pc, spec, pup, src = _setup()
    comps, q = ph.vector_component_stack(pup, pc)
    plain = ph.randomized_socs_vector(pup, src, pc, **BUILD)
    rot, captured = ph.principal_channel_rotation(comps, torch.full((5,), 0.2),
                                                  channels=5)
    assert captured == pytest.approx(1.0, abs=1e-12)
    full = ph.randomized_socs_vector(pup, src, pc, channel_rotation=rot, **BUILD)
    img_plain = _np(ph.socs_image(spec, plain, pc))
    assert normalized_rms(_np(ph.socs_image(spec, full, pc)), img_plain) < 2e-4
    np.testing.assert_allclose(_np(full.eigenvalues), _np(plain.eigenvalues),
                               rtol=1e-3, atol=1e-5)
    # compress_components to 4 channels keeps the rotation's captured trace
    y, ones = ph.compress_components(comps, q, 4)
    assert _np(ones).tolist() == [1.0] * 4
    kept = float((y.abs() ** 2).sum(dtype=torch.float64))
    total = float((q[:, None, None] * comps.abs() ** 2).sum(dtype=torch.float64))
    _, cap4 = ph.principal_channel_rotation(comps, q, channels=4)
    assert kept / total == pytest.approx(cap4, rel=1e-5)
    auto = ph.randomized_socs_components(comps, q, src, pc, channels="auto", **BUILD)
    assert normalized_rms(_np(ph.socs_image(spec, auto, pc)),
                          exact["unpolarized"]) < 1e-3
    with pytest.raises(ValueError, match="channels"):
        ph.compress_components(comps, q, 0)


def test_component_kernels_are_conjugated_in_memory():
    """The kernels are conj(u) in memory: the CUDA wrappers read raw
    memory, and refuse a lazy conjugate view rather than read u."""
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    _, pc, _, pup, src = _setup()
    socs = ph.randomized_socs_vector(pup, src, pc, rank=8)
    assert not socs.kernels.is_conj()
    lazy = torch.zeros((2, 4), dtype=torch.complex64).conj()
    with pytest.raises(ValueError, match="lazy conjugate"):
        ik._check(lazy, "a", torch.complex64, (2, 4))


def test_dark_source_gives_zero_kernels():
    _, pc, _, pup, src = _setup()
    socs, basis = ph.randomized_socs_vector(pup, np.zeros_like(src), pc, rank=8,
                                            return_basis=True)
    assert socs.total_rank == 0 and not socs.kernels.any() and basis.shape == (8, 32, 32)


@pytest.fixture(scope="module")
def sim_setup(exact):
    cfg, pc, _, _, src = _setup()
    return cfg, src, jt.demo_bars(cfg), pt.demo_bars(pc, device="cpu")


@pytest.mark.parametrize("kw", [dict(socs_rank=64), dict(), dict(socs_tolerance=2e-2)],
                         ids=["pinned", "auto", "tolerance"])
def test_simulate_vector_socs_matches_jax(sim_setup, kw):
    """JAX's report keys and rank, and the (sup) bound above the error
    against JAX's exact vector image (R5: the same class as JAX)."""
    cfg, src, jmask, pmask = sim_setup
    ref = jt.simulate(jmask, src, ABERR, solver="socs", polarization="unpolarized", **kw)
    ours = pt.simulate(pmask, src, ABERR, device="cpu", solver="socs",
                       polarization="unpolarized", **kw)
    exact_img = np.asarray(jt.simulate(jmask, src, ABERR,
                                       polarization="unpolarized").image)
    assert set(ours.report) == set(ref.report)
    assert ours.report["socs_rank"] == ref.report["socs_rank"]
    assert ours.report["polarization"] == ref.report["polarization"]
    assert ours.report["socs_energy_captured"] == pytest.approx(
        ref.report["socs_energy_captured"], rel=1e-3)
    bound = ours.report["socs_image_nrms_bound"]
    assert normalized_rms(_np(ours.image), exact_img) <= bound
    assert bound == pytest.approx(ref.report["socs_image_nrms_bound"], rel=0.1)
    if "socs_tolerance" in kw:
        assert bound <= kw["socs_tolerance"]


def test_channel_rotation_cached_matches_jax():
    """simulate's per-setup rotation: JAX's channel count (None where the
    stack does not compress)."""
    js = importlib.import_module("lithographysimulator_tpu.simulate")
    ps = importlib.import_module("lithographysimulator_tpu_torch.simulate")

    for na, pol in ((0.9, "unpolarized"), (0.6, "unpolarized"), (0.6, "x")):
        cfg = jt.OpticsConfig(pixel_number=32, na=na)
        ref = js._channel_rotation_cached(cfg, pol, True, None)
        ours = ps._channel_rotation_cached(config_from_jax(cfg), pol, True, None, "cpu")
        assert (ours is None) == (ref is None)
        if ref is not None:
            assert ours.shape == ref.shape
