"""Port parity: source-mask optimization (optimize.py: the latent maps,
forward, one step's gradients, optimize, optimize_socs, make_train_step)
against the JAX package on the CPU, at tests/test_optimize.py's 32^2 grid,
chunk 8 and classical sigma-0.4 source.

Both packages run the fft engine here (the JAX package's 'auto' on the
CPU, the port's plain versions). The latent maps agree within 1 ulp
(log) and 2 ulp (sigmoid), not bit for bit: XLA:CPU's float32 log and exp are polynomial approximations (its
log is off the correctly rounded value in 11% of uniform draws, torch's in
0.03%), so JAX's own maps are not the correctly rounded ones either. The
mask latent's and the aberrations' gradients are held to JAX's at
1e-5 * max|g|; the source logits' to a float64 evaluation of the same
loss at that class (ROADMAP.md Queue 3, F4 and F5: through the
normalization the logits' gradient is a difference of two near-equal
terms; the port's float32 value lies 5.7e-6 * max|g| from float64, JAX's
6.0e-5). Optimizer
histories run from an asymmetric start with coma, so no gradient
vanishes by symmetry; the tolerances are measured values with a margin.
At 37 live source points a rank-24 SOCS build's 40 probes span the
whole range in both packages, so their different random probes give the
same top-24 eigenpairs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
from lithographysimulator_tpu import optimize as jo
from lithographysimulator_tpu.parallel import padded_source_arrays
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu_torch import optimize as po
from lithographysimulator_tpu_torch.interop import smo_problem_from_jax
from lithographysimulator_tpu_torch.ops import abbe as pa

CFG = jt.OpticsConfig(pixel_number=32)
CHUNK = 8
ABERR = np.array([0, 0, 0.03, 0.02, 20.0, 0, 0, 0.04], np.float32)
TOL_HISTORY = 1e-4  # relative, 5 Adam steps (measured 2.6e-5)
TOL_GRAD = 1e-5  # * max|g|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """(shifts, weights, design, asymmetric start, target image) as host
    arrays; the target is JAX's forward of the design."""
    src = np.asarray(jt.LightSource(CFG, sigma_out=0.4).classical())
    shifts, weights, _ = padded_source_arrays(src, 8 * CHUNK)
    shifts, weights = np.asarray(shifts), np.asarray(weights)
    design = np.asarray(jt.demo_bars(CFG).geometry, np.float32)
    rng = np.random.default_rng(0)
    start = np.clip(design * 0.5 + 0.25 * rng.random(design.shape),
                    0, 1).astype(np.float32)
    problem = jo.SMOProblem(config=CFG, chunk=CHUNK)
    target = np.asarray(jo.forward(jo.init_params(problem, design), ABERR,
                                   shifts, weights, problem))
    return shifts, weights, design, start, target


def _problems(**kw):
    jp = jo.SMOProblem(config=CFG, chunk=CHUNK, **kw)
    return jp, smo_problem_from_jax(jp)


def _close_history(ours, ref, tol=TOL_HISTORY) -> None:
    assert len(ours) == len(ref)
    np.testing.assert_allclose(ours, ref, rtol=tol)


def test_latent_maps_and_init_params_match_jax(setup):
    *_, start, _ = setup
    jp, pp = _problems(optimize_source=True)
    w0 = np.linspace(0.0, 1.0, 64).astype(np.float32)
    ref = jo.init_params(jp, start, source_weights_init=w0)
    ours = po.init_params(pp, start, source_weights_init=w0, device="cpu")
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == torch.float32 and ours[k].device.type == "cpu"
        np.testing.assert_array_max_ulp(ours[k].numpy(), np.asarray(ref[k]), 1)
    latent = np.array(ref["mask_latent"])
    np.testing.assert_array_max_ulp(
        po.mask_from_latent(torch.as_tensor(latent), 4.0).numpy(),
        np.asarray(jo.mask_from_latent(latent, 4.0)), 2)
    with pytest.raises(ValueError, match="source_weights_init"):
        po.init_params(pp, start, device="cpu")
    with pytest.raises(ValueError, match="device="):
        po.init_params(pp, start, source_weights_init=w0)


def test_forward_matches_jax(setup):
    shifts, weights, design, start, _ = setup
    for jp, pp in (_problems(), _problems(optimize_source=True)):
        w0 = np.maximum(weights, 1e-3)
        ref = np.asarray(jo.forward(jo.init_params(jp, start, w0), ABERR,
                                    shifts, weights, jp))
        ours = po.forward(po.init_params(pp, start, w0, device="cpu"), ABERR,
                          shifts, weights, pp)
        assert ours.shape == (CFG.n, CFG.n) and ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


def _logit_grad_f64(pp, params, target, shifts, weights) -> np.ndarray:
    """d loss / d logits of the port's loss_fn, evaluated in float64: the
    float32 spectrum and pupil of ``params`` upcast, every point's field
    on the fft engine in complex128."""
    geom = po.mask_from_latent(params["mask_latent"].detach(),
                               pp.mask_steepness)
    spectrum = pt.mask_spectrum(geom, pp.config).to(torch.complex128)
    pupil = pt.pupil_function(ABERR, pp.config,
                              device="cpu").to(torch.complex128)
    logits = params["source_logits"].detach().to(torch.float64).requires_grad_()
    w = torch.as_tensor(weights, dtype=torch.float64)
    w = torch.exp(logits) * (w > 0).to(torch.float64)
    image = pa.accumulate_intensity(pupil, spectrum, shifts, w, pp.config,
                                    chunk=CHUNK, engine="fft")
    image = pa.postprocess_gau23(image, pp.config) / w.sum()
    loss = torch.mean((image - torch.as_tensor(target, dtype=torch.float64)) ** 2)
    (g,) = torch.autograd.grad(loss, logits)
    return g.numpy()


def test_one_step_gradients(setup):
    """The mask latent's and the aberrations' gradients against jax.grad
    of the JAX loss; the source logits' against float64 (F4, F5)."""
    shifts, weights, _, start, target = setup
    jp, pp = _problems(optimize_source=True)
    w0 = np.maximum(weights, 1e-3) * np.linspace(0.5, 1.5, len(weights),
                                                 dtype=np.float32)
    jparams = jo.init_params(jp, start, w0)
    (gp_ref, ga_ref) = jax.grad(jo.loss_fn, argnums=(0, 2))(
        jparams, target, jnp.asarray(ABERR), shifts, weights, jp)
    params = po._leaves(po.init_params(pp, start, w0, device="cpu"))
    ab = torch.as_tensor(ABERR).requires_grad_()
    po.loss_fn(params, target, ab, shifts, weights, pp).backward()
    for ours, ref in ((params["mask_latent"].grad, gp_ref["mask_latent"]),
                      (ab.grad, ga_ref)):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=TOL_GRAD * np.abs(ref).max())
    g64 = _logit_grad_f64(pp, params, target, shifts, weights)
    live = weights > 0
    assert np.abs(g64[live]).max() > 0 and not g64[~live].any()
    np.testing.assert_allclose(params["source_logits"].grad.numpy(), g64,
                               rtol=0, atol=TOL_GRAD * np.abs(g64).max())


def test_optimize_history_matches_jax(setup):
    shifts, weights, _, start, target = setup
    jp, pp = _problems()
    pj, hj = jo.optimize(jp, target, start, ABERR, shifts, weights, steps=5,
                         learning_rate=0.2)
    ours, hist = po.optimize(pp, target, start, ABERR, shifts, weights,
                             steps=5, learning_rate=0.2, device="cpu")
    assert list(ours) == ["mask_latent"] and hist[-1] < hist[0]
    _close_history(hist, hj)
    np.testing.assert_allclose(ours["mask_latent"].numpy(),
                               np.asarray(pj["mask_latent"]), rtol=0, atol=1e-4)
    # a tensor target sets the device; host data alone needs one
    _, again = po.optimize(pp, torch.as_tensor(target), start, ABERR, shifts,
                           weights, steps=1, learning_rate=0.2)
    assert again == pytest.approx(hist[:1], rel=0, abs=0)
    with pytest.raises(ValueError, match="device="):
        po.optimize(pp, target, start, ABERR, shifts, weights, steps=1)


def test_source_map_from_points_matches_jax(setup):
    shifts, weights, *_ = setup
    w = weights * np.linspace(1.0, 2.0, len(weights), dtype=np.float32)
    ref = np.asarray(jo._source_map_from_points(shifts, w, CFG.n))
    ours = po._source_map_from_points(shifts, torch.as_tensor(w), CFG.n)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert (weights == 0).any()  # the padding scattered its zeros too


def test_optimize_socs_mask_only_matches_jax(setup):
    """SOCS mask steps: the same losses (a complete build in both), and the
    result's Abbe-model loss as JAX's result's."""
    shifts, weights, _, start, target = setup
    jp, pp = _problems()
    pj, hj = jo.optimize_socs(jp, target, start, ABERR, shifts, weights,
                              steps=6, learning_rate=0.2, rank=24)
    ours, hist = po.optimize_socs(pp, target, start, ABERR, shifts, weights,
                                  steps=6, learning_rate=0.2, rank=24,
                                  device="cpu")
    assert list(ours) == ["mask_latent"] and hist[-1] < hist[0]
    _close_history(hist, hj)
    abbe = po.loss_fn(ours, target, ABERR, shifts, weights, pp)
    abbe_ref = jo.loss_fn(pj, target, ABERR, shifts, weights, jp)
    assert float(abbe) == pytest.approx(float(abbe_ref), rel=TOL_HISTORY)


def test_optimize_socs_alternating_matches_jax(setup):
    """Alternating mask / source SMO: warm rebuilds a source step, the
    source moves, the losses and the Abbe-model loss of the result as
    JAX's."""
    shifts, weights, design, start, _ = setup
    jp, pp = _problems(optimize_source=True)
    w0 = np.maximum(weights, 1e-3)
    target = np.asarray(jo.forward(jo.init_params(jp, design, w0), ABERR,
                                   shifts, weights, jp))
    kw = dict(steps=6, learning_rate=0.2, rank=24, mask_steps_per_build=3,
              source_weights_init=w0)
    pj, hj = jo.optimize_socs(jp, target, start, ABERR, shifts, weights, **kw)
    ours, hist = po.optimize_socs(pp, target, start, ABERR, shifts, weights,
                                  device="cpu", **kw)
    assert len(hist) == 6 + 2 and hist[-1] < hist[0]
    _close_history(hist, hj)
    moved = np.abs(ours["source_logits"].numpy() - np.log(w0)).max()
    assert moved > 1e-4
    np.testing.assert_allclose(ours["source_logits"].numpy(),
                               np.asarray(pj["source_logits"]), rtol=0,
                               atol=1e-3 * moved)
    abbe = po.loss_fn(ours, target, ABERR, shifts, weights, pp)
    abbe_ref = jo.loss_fn(pj, target, ABERR, shifts, weights, jp)
    assert float(abbe) == pytest.approx(float(abbe_ref), rel=TOL_HISTORY)
    with pytest.raises(ValueError, match="chromatic SMO"):
        po.optimize_socs(pp, target, start, ABERR, shifts, weights,
                         device="cpu", chromatic=object(), **kw)


def test_mesh_is_refused(setup):
    """mesh= is no longer refused: each of the four entry points that take
    it gives the mesh=None result on a 2-entry CPU mesh (the source points
    split over it, parallel/abbe_sharded.py), the loss within 1e-6
    relative, for the mask alone and with the source logits."""
    from lithographysimulator_tpu_torch.parallel import source_mesh

    shifts, weights, _, start, target = setup
    mesh = source_mesh(devices=["cpu"] * 2)
    for _, pp in (_problems(), _problems(optimize_source=True)):
        w0 = np.maximum(weights, 1e-3)
        params = po.init_params(pp, start, w0, device="cpu")
        pairs = [[po.forward(params, ABERR, shifts, weights, pp, m)
                  for m in (None, mesh)],
                 [po.loss_fn(params, target, ABERR, shifts, weights, pp, m)
                  for m in (None, mesh)],
                 [po.make_train_step(pp, functools.partial(
                     torch.optim.SGD, lr=0.1), m)(
                         params, None, target, ABERR, shifts, weights)[2]
                  for m in (None, mesh)],
                 [torch.as_tensor(po.optimize(
                     pp, target, start, ABERR, shifts, weights, steps=2,
                     source_weights_init=w0, mesh=m, device="cpu")[1])
                  for m in (None, mesh)]]
        image, sharded = pairs[0]
        np.testing.assert_allclose(sharded.detach().numpy(),
                                   image.detach().numpy(), rtol=0,
                                   atol=1e-6 * float(image.abs().max()))
        for ref, ours in pairs[1:]:
            np.testing.assert_allclose(ours.detach().numpy(),
                                       ref.detach().numpy(), rtol=1e-6)


def test_make_train_step_with_sgd_matches_jax(setup):
    """tests/test_optimize.py::test_smo_sharded_step_matches_local's local
    step, with optax.sgd(0.1) and torch.optim.SGD(lr=0.1): the same loss
    and the same update; a second step continues from the optimizer."""
    shifts, weights, design, _, _ = setup
    jp, pp = _problems()
    target = np.asarray(jo.forward(jo.init_params(jp, design), ABERR[:1],
                                   shifts, weights, jp))
    geom0 = np.full((CFG.n, CFG.n), 0.4, np.float32)
    opt = optax.sgd(0.1)
    p0 = jo.init_params(jp, geom0)
    p1, _, loss1 = jo.make_train_step(jp, opt)(
        p0, opt.init(p0), target, ABERR[:1], shifts, weights)
    step = po.make_train_step(pp, functools.partial(torch.optim.SGD, lr=0.1))
    ours0 = po.init_params(pp, geom0, device="cpu")
    ours1, state, loss = step(ours0, None, target, ABERR[:1], shifts, weights)
    assert isinstance(state, torch.optim.SGD)
    assert float(loss) == pytest.approx(float(loss1), rel=1e-5)
    upd = (ours1["mask_latent"] - ours0["mask_latent"]).detach().numpy()
    upd_ref = np.asarray(p1["mask_latent"]) - np.asarray(p0["mask_latent"])
    np.testing.assert_allclose(upd, upd_ref, rtol=0,
                               atol=TOL_GRAD * np.abs(upd_ref).max())
    before = float(po.loss_fn(ours1, target, ABERR[:1], shifts, weights, pp))
    ours2, state2, loss2 = step(ours1, state, target, ABERR[:1], shifts,
                                weights)
    assert state2 is state and ours2["mask_latent"] is ours1["mask_latent"]
    assert float(loss2) == before


def test_adam_steps_where_float32_squares_overflow(setup):
    """D10: SMO's raw-intensity gradient grows with the grid; at 1024^2
    most of its squares overflow float32 and a float32 Adam (optax's)
    leaves those pixels where they are. Here a target scaled by 2^36 gives
    the same overflow at 32^2 (83% of the squares): the port steps float64
    copies, so its first step moves every pixel by the learning rate
    against the gradient's sign, as Adam's first step does; JAX's moves
    only the pixels whose squares stay finite."""
    shifts, weights, _, start, target = setup
    jp, pp = _problems()
    big = target * np.float32(2.0 ** 36)
    p0 = jo.init_params(jp, start)
    g = np.asarray(jax.grad(jo.loss_fn)(p0, big, ABERR, shifts, weights,
                                        jp)["mask_latent"])
    with np.errstate(over="ignore"):
        finite = np.isfinite(g * g)
    assert 0.5 < (~finite).mean() < 1.0
    latent0 = np.asarray(p0["mask_latent"])
    ref, _ = jo.optimize(jp, big, start, ABERR, shifts, weights, steps=1,
                         learning_rate=0.2)
    moved_ref = np.asarray(ref["mask_latent"]) != latent0
    np.testing.assert_array_equal(moved_ref, finite & (g != 0))
    ours, _ = po.optimize(pp, big, start, ABERR, shifts, weights, steps=1,
                          learning_rate=0.2, device="cpu")
    assert ours["mask_latent"].dtype == torch.float32
    np.testing.assert_allclose(ours["mask_latent"].numpy(),
                               latent0 - 0.2 * np.sign(g), rtol=0, atol=1e-6)
