"""Port parity: the mesh-sharded randomized SOCS builds
(parallel/socs_build_sharded.py: Rayleigh-Ritz and Nystrom, warm starts,
the summed-TCC components build) on the CPU, at tests/test_sharding.py's
32^2 configurations and tolerances: eigenvalues to rtol 1e-4 (atol 1e-6
of the leading one), images to 1e-5 normalized RMS.

Two comparisons a case. The port's sharded build against the port's
local build at the same seed (the contract JAX pins for its own pair: the
same probes, only the summation order differs). And the port's sharded
build against JAX's build with the same probes: the two packages draw
different random numbers, so each gets one numpy-drawn probe block as
``init_basis`` (with as many rows as rank + oversample, the block is used
as it is); against JAX's sharded build on a JAX mesh where JAX's case runs
in tier-1 (the Nystrom case), against JAX's local build where JAX marks
its case slow. Builds compare eigenvalues and images, never kernels.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
from lithographysimulator_tpu import parallel as jp
from lithographysimulator_tpu.ops import hopkins as jh
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu_torch import parallel as pp
from lithographysimulator_tpu_torch.ops import hopkins as ph
from lithographysimulator_tpu_torch.interop import config_from_jax

from .conftest import normalized_rms

CFG = jt.OpticsConfig(pixel_number=32)
PCFG = config_from_jax(CFG)


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


def _probes(rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (rows, CFG.n, CFG.n)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def spec():
    return np.array(jt.spectrum_fft(jt.demo_bars(CFG).geometry, CFG))


def _image(spec, socs) -> np.ndarray:
    if isinstance(socs.kernels, torch.Tensor):
        return pt.socs_image(torch.as_tensor(spec), socs, PCFG, chunk=4).numpy()
    return np.asarray(jt.socs_image(spec, socs, CFG, chunk=4))


def _same_build(spec, ours, ref, *, tol_image=1e-5) -> None:
    """JAX's parity contract for a pair of builds."""
    ref_vals = np.asarray(ref.eigenvalues)
    vals = ours.eigenvalues.numpy()
    assert ours.kernels.shape == tuple(np.shape(ref.kernels))
    np.testing.assert_allclose(vals, ref_vals, rtol=1e-4,
                               atol=1e-6 * float(ref_vals[0]))
    nrms = normalized_rms(_image(spec, ours), _image(spec, ref))
    assert nrms < tol_image, nrms


def _annular():
    src = np.asarray(jt.LightSource(CFG, sigma_in=0.2, sigma_out=0.6).annular())
    pup = np.array(jt.pupil_function(np.array([0, 0, 0, 0, 30], np.float32), CFG))
    return src, pup


@pytest.mark.parametrize("method", ["rr", "nystrom"])
def test_socs_build_sharded_matches_local(spec, method):
    """JAX's test_socs_build_sharded_matches_local (rr, slow there) and
    test_socs_build_sharded_nystrom_matches_local (power_iters 1): the
    sharded build on 4 entries against the port's local build at seed 3;
    then, with one probe block in both packages, against JAX's sharded
    build on 4 devices (Nystrom) or JAX's local build (rr)."""
    src, pup = _annular()
    kw = dict(rank=24, oversample=16, power_iters=2 if method == "rr" else 1,
              method=method)
    tpup = torch.as_tensor(pup)
    ours = pp.randomized_socs_sharded(tpup, src, PCFG, _mesh(4), seed=3, **kw)
    assert ours.total_rank == int((src > 0).sum())
    _same_build(spec, ours, pt.randomized_socs(tpup, src, PCFG, lean=False,
                                               seed=3, **kw))
    omega = _probes(40, 11)
    ours = pp.randomized_socs_sharded(tpup, src, PCFG, _mesh(4),
                                      init_basis=omega, **kw)
    if method == "nystrom":
        ref = jp.randomized_socs_sharded(
            pup, src, CFG, JaxMesh(np.asarray(jax.devices()[:4]), ("source",)),
            init_basis=omega, **kw)
    else:
        ref = jt.randomized_socs(pup, src, CFG, lean=False, init_basis=omega,
                                 **kw)
    _same_build(spec, ours, ref)


def test_socs_build_sharded_device_count_invariance(spec):
    """JAX's slow test_socs_build_sharded_device_count_invariance: 2- and
    8-entry builds agree; with one probe block, the 8-entry build agrees
    with JAX's local build."""
    src = np.asarray(jt.LightSource(CFG, sigma_out=0.5).classical())
    pup = np.array(jt.pupil_function(np.zeros(1, np.float32), CFG))
    kw = dict(rank=16, oversample=8, power_iters=1)
    images = [_image(spec, pp.randomized_socs_sharded(
        torch.as_tensor(pup), src, PCFG, _mesh(k), seed=0, **kw)) for k in (2, 8)]
    np.testing.assert_allclose(images[0], images[1], rtol=1e-5,
                               atol=1e-5 * images[0].max())
    omega = _probes(24, 5)
    _same_build(spec, pp.randomized_socs_sharded(
        torch.as_tensor(pup), src, PCFG, _mesh(8), init_basis=omega, **kw),
        jt.randomized_socs(pup, src, CFG, lean=False, init_basis=omega, **kw))


def test_socs_build_sharded_warm_start_interchange(spec):
    """JAX's slow test_socs_build_sharded_warm_start_interchange: a local
    build's Ritz basis warm-starts the sharded build at power_iters 0 (and
    the sharded basis the local build), within 1e-4 of the cold
    power_iters-2 image; the warm sharded image also within 1e-4 of JAX's
    cold local image."""
    src = np.asarray(jt.LightSource(CFG, sigma_out=0.6).classical())
    pup = np.array(jt.pupil_function(np.array([0, 0, 0, 0, 20], np.float32), CFG))
    tpup = torch.as_tensor(pup)
    kw = dict(rank=20, oversample=12, seed=1)
    cold, basis = pt.randomized_socs(tpup, src, PCFG, lean=False, power_iters=2,
                                     return_basis=True, **kw)
    warm, sharded_basis = pp.randomized_socs_sharded(
        tpup, src, PCFG, _mesh(4), power_iters=0, init_basis=basis,
        return_basis=True, **kw)
    assert sharded_basis.shape == (20, 32, 32)
    img_cold, img_warm = _image(spec, cold), _image(spec, warm)
    assert normalized_rms(img_warm, img_cold) < 1e-4
    back = pt.randomized_socs(tpup, src, PCFG, lean=False, power_iters=0,
                              init_basis=sharded_basis, **kw)
    assert normalized_rms(_image(spec, back), img_cold) < 1e-4
    ref = jt.randomized_socs(pup, src, CFG, lean=False, power_iters=2, **kw)
    assert normalized_rms(img_warm, _image(spec, ref)) < 1e-4


def test_socs_components_build_sharded_matches_local(spec):
    """JAX's slow test_socs_components_build_sharded_matches_local: the
    vector (unpolarized, NA 0.9) summed-TCC build on 4 entries against
    the port's local components build at seed 2; with one probe block,
    against JAX's local build."""
    cfg = jt.OpticsConfig(pixel_number=32, na=0.9)
    pcfg = config_from_jax(cfg)
    spec = np.array(jt.spectrum_fft(jt.demo_bars(cfg).geometry, cfg))
    src = np.asarray(jt.LightSource(cfg, sigma_out=0.5).classical())
    pup = jt.pupil_function(np.array([0, 0, 0, 0, 15], np.float32), cfg)
    comps, q = jh.vector_component_stack(pup, cfg, polarization="unpolarized")
    comps, q = np.array(comps), np.array(q)
    kw = dict(rank=20, oversample=12, power_iters=2)

    def image(socs):
        if isinstance(socs.kernels, torch.Tensor):
            return pt.socs_image(torch.as_tensor(spec), socs, pcfg, chunk=4).numpy()
        return np.asarray(jt.socs_image(spec, socs, cfg, chunk=4))

    def same(ours, ref):
        vals = np.asarray(ref.eigenvalues)
        np.testing.assert_allclose(ours.eigenvalues.numpy(), vals, rtol=1e-4,
                                   atol=1e-6 * float(vals[0]))
        assert normalized_rms(image(ours), image(ref)) < 1e-5

    ours = pp.randomized_socs_components_sharded(
        torch.as_tensor(comps), q, src, pcfg, _mesh(4), seed=2, **kw)
    same(ours, ph.randomized_socs_components(torch.as_tensor(comps), q, src,
                                             pcfg, seed=2, **kw))
    omega = _probes(32, 7)
    same(pp.randomized_socs_components_sharded(
        torch.as_tensor(comps), q, src, pcfg, _mesh(4), init_basis=omega, **kw),
        jh.randomized_socs_components(comps, q, src, cfg, init_basis=omega, **kw))


def test_sharded_builds_edge_cases(spec):
    """A dark source gives zero kernels (as the local builds); channels=
    compresses as the local components build does; an axis the mesh lacks
    and an unknown method raise."""
    pup = torch.as_tensor(np.array(jt.pupil_function(np.zeros(1), CFG)))
    dark = pp.randomized_socs_sharded(pup, np.zeros((32, 32), np.float32), PCFG,
                                      _mesh(2), rank=4, oversample=4)
    assert dark.total_rank == 0 and float(dark.kernels.abs().max()) == 0
    src = np.asarray(jt.LightSource(CFG, sigma_out=0.5).classical())
    comps, q = ph.vector_component_stack(pup, PCFG, polarization="unpolarized")
    kw = dict(rank=8, oversample=8, power_iters=1, seed=4, channels=2)
    ours = pp.randomized_socs_components_sharded(comps, q, src, PCFG, _mesh(2), **kw)
    ref = ph.randomized_socs_components(comps, q, src, PCFG, **kw)
    np.testing.assert_allclose(ours.eigenvalues.numpy(), ref.eigenvalues.numpy(),
                               rtol=1e-4)
    with pytest.raises(ValueError, match="axis 'focus' not in mesh"):
        pp.randomized_socs_sharded(pup, src, PCFG, _mesh(2), axis="focus")
    with pytest.raises(ValueError, match="unknown randomized-eigh method"):
        pp.randomized_socs_sharded(pup, src, PCFG, _mesh(2), method="qr")
    two_d = pp.focus_source_mesh(2, 2, devices=["cpu"] * 4)
    a = pp.randomized_socs_sharded(pup, src, PCFG, two_d, rank=8, oversample=8,
                                   axis="focus")
    b = pp.randomized_socs_sharded(pup, src, PCFG, two_d, rank=8, oversample=8)
    np.testing.assert_allclose(a.eigenvalues.numpy(), b.eigenvalues.numpy(),
                               rtol=1e-5)
