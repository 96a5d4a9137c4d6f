"""Port parity: parallel/* (the mesh, the source-sharded Abbe image and
focal stack, the rank-sharded SOCS apply, the tiled chip, optimize(mesh=))
against the JAX package on the CPU, at tests/test_sharding.py's 32^2 grid
and tolerances, on meshes of 2-8 'cpu' entries (the counterpart of the 8
virtual host devices tests/conftest.py gives JAX).

Where JAX's own sharded case runs in tier-1, the port's sharded function
is held to JAX's sharded function on a JAX mesh of the same size
(jax.devices()[:k]); where JAX marks its case slow, to the JAX
single-device function that case holds JAX's sharded one to, and to the
port's own single-device function. Both packages take the same complex64
spectrum and pupil, so the comparisons see the engines alone; both run
the fft engine here (the port's 'auto' on a CPU tensor), the matmul
engine where a case names it.
"""

import functools

import jax
import numpy as np
import optax
import pytest
from jax.sharding import Mesh as JaxMesh

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
from lithographysimulator_tpu import optimize as jo
from lithographysimulator_tpu import parallel as jp
from lithographysimulator_tpu.ops.focus import (focus_stack_aberrations,
                                                through_focus_images)
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu_torch import optimize as po
from lithographysimulator_tpu_torch import parallel as pp
from lithographysimulator_tpu_torch.interop import (config_from_jax,
                                                    smo_problem_from_jax,
                                                    socs_from_numpy)
from lithographysimulator_tpu_torch.ops import focus as pfocus

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


def _cpu(k: int) -> list:
    return ["cpu"] * k


def _jax_mesh(k: int, shape=None, axes=("source",)):
    devices = np.asarray(jax.devices()[:k])
    return JaxMesh(devices.reshape(shape or (k,)), axes)


def _close(ours, ref, rtol=1e-5) -> None:
    ours = ours.detach().cpu().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def setup():
    """test_sharding.py's setup: demo bars, 30 nm defocus, annular
    sigma 0.2/0.6; the same spectrum and pupil for both packages."""
    spec = np.array(jt.spectrum_fft(jt.demo_bars(CFG).geometry, CFG))
    pup = np.array(jt.pupil_function(np.array([0, 0, 0, 0, 30], np.float32),
                                     CFG))
    src = np.asarray(jt.LightSource(CFG, sigma_in=0.2, sigma_out=0.6).annular())
    return spec, pup, src, torch.as_tensor(spec), torch.as_tensor(pup)


def test_mesh_shapes_entries_and_errors(monkeypatch):
    """test_eight_devices_visible's counterpart: an 8-entry host mesh, the
    2-D mesh's layout, JAX's error for too few entries, and no silent
    fallback to the CPU when no card is visible."""
    mesh = pp.source_mesh(devices=_cpu(8))
    assert mesh.shape == {"source": 8} and mesh.size == 8
    assert mesh.first == torch.device("cpu")
    two = pp.focus_source_mesh(4, 2, devices=[f"cuda:{i}" for i in range(8)])
    assert two.shape == {"focus": 4, "source": 2}
    assert two.axis_devices("source", 1) == [torch.device("cuda:2"),
                                              torch.device("cuda:3")]
    assert two.axis_devices("focus") == [torch.device(f"cuda:{i}")
                                         for i in (0, 2, 4, 6)]
    assert pp.focus_source_mesh(2, devices=_cpu(8)).shape == {"focus": 2,
                                                             "source": 4}
    assert pp.source_mesh(3, devices=_cpu(8)).shape == {"source": 3}
    with pytest.raises(ValueError, match="needs 12 devices, have 8"):
        pp.focus_source_mesh(4, 3, devices=_cpu(8))
    with pytest.raises(ValueError, match="needs 9 devices"):
        pp.source_mesh(9, devices=_cpu(8))
    with pytest.raises(ValueError, match="axis 'x'"):
        mesh.axis_devices("x")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for call in (pp.source_mesh, lambda: pp.focus_source_mesh(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_parallel_exports_the_jax_names():
    """The port's parallel package has every name of JAX's (its 13
    imports and initialize_distributed), plus Mesh and dryrun_multichip."""
    names = {n for n in dir(jp) if not n.startswith("_")
             and not hasattr(getattr(jp, n), "__path__")
             and getattr(getattr(jp, n), "__module__", "").startswith(
                 "lithographysimulator_tpu.parallel")
             or n in ("FOCUS_AXIS", "SOURCE_AXIS")}
    assert len(names) == 18
    missing = [n for n in sorted(names | {"Mesh", "dryrun_multichip"})
               if not hasattr(pp, n)]
    assert missing == []
    assert callable(pp.dryrun_multichip) and callable(pp.initialize_distributed)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_matches_single_device(setup, k):
    """JAX's test_sharded_matches_single_device and, with k = 2, its
    test_sharded_under_jit (JAX's sharded call jitted): the port's
    sharded image against JAX's sharded image on k devices, and against
    the port's own abbe_image."""
    spec, pup, src, tspec, tpup = setup
    chunk = 8
    shifts, weights, _ = pp.padded_source_arrays(src, k * chunk)
    ours = pp.abbe_image_sharded(tspec, tpup, shifts, weights, PCFG,
                                 pp.source_mesh(devices=_cpu(k)), chunk=chunk)
    jmesh = _jax_mesh(k)
    js, jw, _ = jp.padded_source_arrays(src, k * chunk)

    def run(s, p, a, b):
        return jp.abbe_image_sharded(s, p, a, b, CFG, jmesh, chunk=chunk)

    ref = (jax.jit(run) if k == 2 else run)(spec, pup, js, jw)
    assert ours.shape == (32, 32) and ours.dtype == torch.float32
    _close(ours, ref)
    _close(ours, pt.abbe_image(tspec, tpup, src, PCFG, device="cpu",
                               chunk=chunk))


def test_device_count_invariance(setup):
    """JAX's slow test_device_count_invariance: 2- and 8-entry meshes give
    the same image, which is JAX's single-device abbe_image."""
    spec, pup, src, tspec, tpup = setup
    images = []
    for k in (2, 8):
        shifts, weights, _ = pp.padded_source_arrays(src, k * 4)
        images.append(pp.abbe_image_sharded(
            tspec, tpup, shifts, weights, PCFG, pp.source_mesh(devices=_cpu(k)),
            chunk=4))
    _close(images[0], images[1].numpy())
    _close(images[1], jt.abbe_image(spec, pup, src, CFG, chunk=4))


def test_through_focus_sharded_matches_local(setup):
    """JAX's slow test_through_focus_sharded_matches_vmap: a (4, 2) mesh,
    four planes, against JAX's through_focus_images and the port's."""
    spec, _, src, tspec, _ = setup
    base = np.array([0, 0, 0.01, 0, 0], np.float32)
    defocus = np.array([-60.0, -20.0, 20.0, 60.0], np.float32)
    stack_ab = focus_stack_aberrations(base, defocus)
    mesh = pp.focus_source_mesh(4, 2, devices=_cpu(8))
    shifts, weights, _ = pp.padded_source_arrays(src, 2 * 8)
    ours = pp.through_focus_sharded(tspec, np.asarray(stack_ab), shifts,
                                    weights, PCFG, mesh, chunk=8)
    assert ours.shape == (4, 32, 32)
    _close(ours, through_focus_images(spec, stack_ab, shifts, weights, CFG,
                                      chunk=8))
    _close(ours, pfocus.through_focus_images(
        tspec, np.asarray(stack_ab), shifts, weights, PCFG, device="cpu",
        chunk=8))
    with pytest.raises(ValueError, match="focus count 4 must divide"):
        pp.through_focus_sharded(tspec, stack_ab, shifts, weights, PCFG,
                                 pp.focus_source_mesh(3, 2, devices=_cpu(6)),
                                 chunk=8)
    with pytest.raises(ValueError, match="must divide devices\\*chunk"):
        pp.through_focus_sharded(tspec, stack_ab, shifts[:-8], weights[:-8],
                                 PCFG, mesh, chunk=8)


def test_focus_stack_monotone_blur(setup):
    """JAX's test_focus_stack_monotone_blur on the sharded stack (a (2, 2)
    mesh, normalized), held to JAX's through_focus_sharded: more defocus,
    less contrast."""
    spec, _, src, tspec, _ = setup
    stack_ab = focus_stack_aberrations(np.zeros(5, np.float32),
                                       np.array([0.0, 120.0], np.float32))
    shifts, weights, _ = pp.padded_source_arrays(src, 2 * 8)
    ours = pp.through_focus_sharded(
        tspec, np.asarray(stack_ab), shifts, weights, PCFG,
        pp.focus_source_mesh(2, 2, devices=_cpu(4)), chunk=8,
        normalize=True).numpy()
    js, jw, _ = jp.padded_source_arrays(src, 2 * 8)
    ref = jp.through_focus_sharded(
        spec, stack_ab, js, jw, CFG, _jax_mesh(4, (2, 2), ("focus", "source")),
        chunk=8, normalize=True)
    _close(ours, ref)

    def contrast(im):
        c = im[8:24, 8:24]
        return (c.max() - c.min()) / (c.max() + c.min())

    assert contrast(ours[1]) < contrast(ours[0])


def test_through_focus_socs_matches_sharded_abbe(setup):
    """JAX's test_through_focus_socs_matches_abbe with the port's sharded
    Abbe stack as the exact side: the port's through_focus_socs at rank 96
    within 5e-4 of it."""
    _, _, src, tspec, _ = setup
    defocus = np.array([0.0, 60.0], np.float32)
    base = np.zeros(5, np.float32)
    shifts, weights, _ = pp.padded_source_arrays(src, 8)
    abbe = pp.through_focus_sharded(
        tspec, focus_stack_aberrations(base, defocus), shifts, weights, PCFG,
        pp.focus_source_mesh(2, 1, devices=_cpu(2)), chunk=8).numpy()
    socs = pfocus.through_focus_socs(tspec, base, defocus, src, PCFG,
                                     rank=96).numpy()
    assert socs.shape == abbe.shape
    assert normalized_rms(socs, abbe) < 5e-4


def test_sharded_windowed_matches_dense(setup):
    """JAX's test_sharded_windowed_matches_dense: the windowed 3M
    contraction against the dense matmul (a shift bound above n/4 - 2
    asks for it), and the windowed image against JAX's sharded one."""
    spec, pup, src, tspec, tpup = setup
    shifts, weights, _ = pp.padded_source_arrays(src, 8 * 4)
    ms = int(np.abs(shifts).max())
    mesh = pp.source_mesh(devices=_cpu(8))
    kw = dict(chunk=4, engine="matmul")
    dense = pp.abbe_image_sharded(tspec, tpup, shifts, weights, PCFG, mesh,
                                  max_abs_shift=PCFG.n, **kw).numpy()
    windowed = pp.abbe_image_sharded(tspec, tpup, shifts, weights, PCFG, mesh,
                                     max_abs_shift=ms, **kw).numpy()
    np.testing.assert_allclose(windowed, dense, rtol=2e-6,
                               atol=2e-6 * np.abs(dense).max())
    ref = jp.abbe_image_sharded(spec, pup, shifts, weights, CFG, _jax_mesh(8),
                                max_abs_shift=ms, **kw)
    _close(windowed, ref)


def test_socs_image_sharded_matches_local():
    """JAX's slow test_socs_image_sharded_matches_local: rank 27 over 8
    entries at chunk 2 (zero-kernel padding to 32), the same kernels in
    both packages, against JAX's socs_image and the port's."""
    cfg = CFG
    spec = np.array(jt.spectrum_fft(jt.demo_bars(cfg).geometry, cfg))
    src = np.asarray(jt.LightSource(cfg, sigma_out=0.5).classical())
    socs = jt.randomized_socs(jt.pupil_function(np.zeros(1), cfg), src, cfg,
                              rank=27, oversample=16, power_iters=2, lean=False)
    ours_socs = socs_from_numpy(np.asarray(socs.kernels),
                                np.asarray(socs.eigenvalues), device="cpu")
    padded = pp.pad_socs_rank(ours_socs, 16)
    assert padded.rank == 32 and float(padded.eigenvalues[27:].abs().max()) == 0
    assert pp.pad_socs_rank(padded, 16) is padded
    ours = pp.socs_image_sharded(torch.as_tensor(spec), ours_socs, PCFG,
                                 pp.source_mesh(devices=_cpu(8)), chunk=2)
    _close(ours, jt.socs_image(spec, socs, cfg, chunk=2))
    _close(ours, pt.socs_image(torch.as_tensor(spec), ours_socs, PCFG, chunk=2))


@pytest.mark.parametrize("engine", ["fft", "int8"])
def test_socs_image_sharded_engines_match_jax_sharded(engine):
    """The rank-sharded apply on the fft engine and on the int8 kernels'
    plain versions (the dry run's pattern 3) against JAX's sharded apply
    (its matmul engine: JAX's int8 engine interprets its Pallas kernels,
    ~50x slower here) on 4 devices, rank 12 at chunk 1."""
    spec = np.array(jt.spectrum_fft(jt.demo_bars(CFG).geometry, CFG))
    src = np.asarray(jt.LightSource(CFG, sigma_out=0.5).classical())
    socs = jt.tcc_eigensystem(jt.pupil_function(np.zeros(1), CFG), src, CFG,
                              rank=12)
    ref = jp.socs_image_sharded(spec, socs, CFG, _jax_mesh(4), chunk=1,
                                engine="matmul")
    ours = pp.socs_image_sharded(
        torch.as_tensor(spec), socs_from_numpy(np.asarray(socs.kernels),
                                               np.asarray(socs.eigenvalues),
                                               device="cpu"),
        PCFG, pp.source_mesh(devices=_cpu(4)), chunk=1, engine=engine)
    _close(ours, ref)


def test_tiled_socs_image_sharded_matches_jax_and_local():
    """The dry run's tiled pattern at 32^2 tiles: a 96 px chip, halo 8,
    a boundary layer, 9 tiles over 4 entries (3 dummy tiles), against
    JAX's tiled_socs_image_sharded on 4 devices and, bit for bit, the
    port's single-device tiled_socs_image (the same code a tile)."""
    src = np.asarray(jt.LightSource(CFG, sigma_out=0.5).classical())
    socs = jt.tcc_eigensystem(jt.pupil_function(np.zeros(1), CFG), src, CFG,
                              rank=8)
    ours_socs = socs_from_numpy(np.asarray(socs.kernels),
                                np.asarray(socs.eigenvalues), device="cpu")
    big = np.zeros((3 * CFG.n, 3 * CFG.n), np.float32)
    big[10:14, 10:38] = 1.0
    big[30:44, 22:26] = 1.0
    bl = jt.BoundaryLayer(width_nm=8.0, beta_h=-0.2, beta_v=-0.2 + 0.05j)
    pbl = pt.BoundaryLayer(width_nm=8.0, beta_h=-0.2, beta_v=-0.2 + 0.05j)
    ours = pp.tiled_socs_image_sharded(torch.as_tensor(big), ours_socs, PCFG,
                                       pp.source_mesh(devices=_cpu(4)),
                                       halo=8, chunk=1, mask3d=pbl)
    assert ours.shape == big.shape
    ref = jp.tiled_socs_image_sharded(big, socs, CFG, _jax_mesh(4), halo=8,
                                      chunk=1, mask3d=bl)
    _close(ours, ref)
    local = pt.tiled_socs_image(torch.as_tensor(big), ours_socs, PCFG, halo=8,
                                chunk=1, mask3d=pbl)
    np.testing.assert_array_equal(ours.numpy(), local.numpy())


def test_sharded_image_gradients_match_single_device(setup):
    """The sum on the first device keeps every shard's graph: the gradient
    of a loss of the sharded image in the spectrum, the pupil and the
    weights equals the single-device gradient (1e-6 * max|g|)."""
    _, _, src, tspec, tpup = setup
    shifts, weights, _ = pp.padded_source_arrays(src, 4 * 8)
    rng = np.random.default_rng(0)
    m = torch.as_tensor(rng.uniform(0.5, 1.5, (32, 32)).astype(np.float32))

    def grads(mesh):
        leaves = [t.clone().requires_grad_() for t in
                  (tspec, tpup, torch.as_tensor(weights))]
        if mesh is None:
            image = pt.abbe_image_points(*leaves[:2], shifts, leaves[2], PCFG,
                                         device="cpu", chunk=8, normalize=True)
        else:
            image = pp.abbe_image_sharded(*leaves[:2], shifts, leaves[2], PCFG,
                                          mesh, chunk=8, normalize=True)
        (image * m).sum().backward()
        return [t.grad for t in leaves]

    for ours, ref in zip(grads(pp.source_mesh(devices=_cpu(4))), grads(None)):
        scale = float(ref.abs().max())
        assert scale > 0
        assert float((ours - ref).abs().max()) <= 1e-6 * scale


def test_smo_sharded_step_matches_jax():
    """tests/test_optimize.py::test_smo_sharded_step_matches_local with
    both packages on a mesh: one SGD step of make_train_step(mesh=) on 4
    entries against JAX's on 4 devices, the loss to 1e-5 and the updated
    latent to 2e-4 of its scale (JAX's own tolerances)."""
    src = np.asarray(jt.LightSource(CFG, sigma_out=0.4).classical())
    shifts, weights, _ = jp.padded_source_arrays(src, 8 * 8)
    shifts, weights = np.asarray(shifts), np.asarray(weights)
    problem = jo.SMOProblem(config=CFG, chunk=8)
    ab = np.zeros(1, np.float32)
    target = np.asarray(jo.forward(jo.init_params(problem, jt.demo_bars(CFG).geometry),
                                   ab, shifts, weights, problem))
    geom0 = np.full((CFG.n, CFG.n), 0.4, np.float32)
    opt = optax.sgd(0.1)
    p0 = jo.init_params(problem, geom0)
    p1, _, loss1 = jo.make_train_step(problem, opt, mesh=_jax_mesh(4))(
        p0, opt.init(p0), target, ab, shifts, weights)
    pprob = smo_problem_from_jax(problem)
    step = po.make_train_step(pprob, functools.partial(torch.optim.SGD, lr=0.1),
                              mesh=pp.source_mesh(devices=_cpu(4)))
    ours, _, loss = step(po.init_params(pprob, geom0, device="cpu"), None,
                         target, ab, shifts, weights)
    np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-5)
    g1 = np.asarray(p1["mask_latent"])
    scale = np.abs(g1).max()
    np.testing.assert_allclose(ours["mask_latent"].detach().numpy() / scale,
                               g1 / scale, atol=2e-4)


def test_device_caches_keep_an_entry_a_device():
    """Step 0's per-device caches: T0's planes and limbs (4 a device), the Zernike
    basis (4), the resist blur transfer (2) and the bilinear resize's
    matrices (8, two a configuration's spectrum and image), each filled to
    its size
    on two distinct devices ('cpu' and 'meta': two keys a CPU-only torch
    can make; meta tensors carry shapes without data) and read three
    times round-robin, miss once a (key, device) and never again; one
    lru_cache of the old size over both devices missed every call."""
    from lithographysimulator_tpu_torch.models import resist
    from lithographysimulator_tpu_torch.ops import abbe, resize, zernike

    devices = [torch.device("cpu"), torch.device("meta")]
    cases = [(abbe.t0_operands, 4, lambda i, d: (32, 32 + 8 * i, 32, d)),
             (zernike._basis_on, 4, lambda i, d: (PCFG, 5 + i, torch.float32, d)),
             (resist._transfer, 2, lambda i, d: (32, 5.0, 1.0 + i, d)),
             (resize._interp_matrix_on, 8,
              lambda i, d: (32, 1.0 + 0.25 * i, 40, torch.float32, d))]
    for fn, size, args in cases:
        fn.cache_clear()
        for _ in range(3):
            for i in range(size):
                for d in devices:
                    fn(*args(i, d))
        info = fn.cache_info()
        assert (info.misses, info.hits) == (2 * size, 4 * size), fn.__name__
        assert info.currsize == 2 * size
        fn.cache_clear()
