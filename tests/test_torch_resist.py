"""Port parity: the resist models and CD metrology (models/resist.py) of
the torch port (device='cpu') against the JAX package's, at 64^2 and
nz = 4, on one numpy aerial image (JAX's, of demo_bars under an annular
source) fed to both.

Tolerances:

* Continuous fields (blur, latent images, arrival times, lateral cleared
  depths): within 1e-5 of JAX's, relative to the field's largest value
  (float32 FFTs and reductions, one rounding an op in the port against
  XLA's fused multiply-adds; the eikonal's own class is in
  tests/test_torch_eikonal.py).
* Vertical cleared depths: within 3e-5 of the film thickness. The chain
  divides (develop_s - t_top) by a slab's etch time where t_top nears
  develop_s, so float32 leaves each package ~8e-6 of the thickness from a
  float64 evaluation of the same chain (measured 7.8e-6 for JAX, 6.4e-6
  for the port on the 'plain' case; 1.5e-5 between them with PEB).
* Sigmoid develops: the input's tolerance times the sigmoid's largest
  slope (steepness / 4).
* Binary develops: equal, except pixels whose continuous field lies
  within 1e-5 (the field tolerance) of the threshold.
* The numpy metrology functions are copies: on the same input they give
  JAX's output exactly. Chained after each package's own develop, binary
  CD tables match to 1e-6 nm (their edges fall at whole or half pixels).
* A develop-loss gradient (DepthResist.develop_profile through the
  eikonal, ResistModel and MackResist develops) against jax.grad: within
  1e-4 of the largest component (see tests/test_torch_eikonal.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
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
from lithographysimulator_tpu_torch.models import resist as pr

TOL = 1e-5
DEPTH_TOL = 3e-5
GRAD_TOL = 1e-4
CFG = jt.OpticsConfig(pixel_number=64)
PCFG = config_from_jax(CFG)
PX = CFG.pixel_size
DEPTH = {
    "plain": jr.DepthResist(nz=4),
    "standing_waves_peb": jr.DepthResist(
        nz=4, substrate_reflectivity=0.3, absorbance_per_um=1.2,
        peb_diffusion_nm=15.0),
    "inhibited_anisotropic": jr.DepthResist(
        nz=4, surface_rate_factor=0.3, inhibition_depth_nm=30.0,
        lateral_rate_factor=0.6, lateral_surface_factor=0.5),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def aerial():
    src = jt.LightSource(CFG, sigma_out=0.6).annular()
    return np.asarray(jt.simulate(jt.demo_bars(CFG), src).image)


@pytest.fixture(scope="module")
def stack(aerial):
    """A (4, n, n) stack whose planes differ (shifted and scaled copies)."""
    return np.stack([np.roll(aerial, k, axis=1) * (1.0 - 0.1 * k)
                     for k in range(4)]).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy()


def _close(ours, ref, tol=TOL):
    ours, ref = _np(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    assert np.abs(ours - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def _binary_equal(ours, ref, field, threshold):
    """Equal except where the continuous field is within TOL of the
    threshold."""
    ours, ref = _np(ours), np.asarray(ref)
    differ = ours != ref
    assert not (differ & (np.abs(np.asarray(field) - threshold) > TOL)).any()
    assert differ.mean() < 1e-2


def test_resist_from_jax_round_trip():
    for model in (jr.ResistModel(threshold=0.4, diffusion_nm=3.0),
                  jr.MackResist(dill_c=0.07), *DEPTH.values()):
        ours = resist_from_jax(model)
        assert type(ours).__name__ == type(model).__name__
        assert dataclasses.asdict(ours) == dataclasses.asdict(model)


@pytest.mark.parametrize("diffusion", [0.0, 20.0])
@pytest.mark.parametrize("normalize", [True, False])
def test_resist_model_matches_jax(aerial, diffusion, normalize):
    jm = jr.ResistModel(threshold=0.35, steepness=50.0, diffusion_nm=diffusion)
    pm = resist_from_jax(jm)
    img = aerial / aerial.max() * (1.0 if normalize else 0.9)
    blurred = np.asarray(jm.blur(img, CFG))
    _close(pm.blur(img, PCFG, device="cpu"), blurred)
    _close(pm.develop(img, PCFG, normalize=normalize, device="cpu"),
           jm.develop(img, CFG, normalize=normalize),
           tol=jm.steepness / 4 * TOL * np.abs(blurred).max())
    field = blurred / blurred.max() if normalize else blurred
    _binary_equal(pm.develop_binary(img, PCFG, normalize=normalize,
                                    device="cpu"),
                  jm.develop_binary(img, CFG, normalize=normalize), field, 0.35)


@pytest.mark.parametrize("dose", [0.7, 1.3])
def test_mack_resist_matches_jax(aerial, dose):
    jm = jr.MackResist(m_threshold=0.55, develop_s=40.0)
    pm = resist_from_jax(jm)
    _close(pm.latent_image(aerial, dose, device="cpu"),
           jm.latent_image(aerial, dose))
    m = torch.linspace(0.0, 1.0, 101)
    _close(pm.development_rate(m), jm.development_rate(jnp.asarray(m.numpy())))
    depth = np.asarray(jm.cleared_depth_nm(aerial, dose))
    _close(pm.cleared_depth_nm(aerial, dose, device="cpu"), depth)
    _close(pm.develop(aerial, dose, device="cpu"), jm.develop(aerial, dose))
    ours = pm.develop_binary(aerial, dose, device="cpu")
    differ = _np(ours) != np.asarray(jm.develop_binary(aerial, dose))
    assert not (differ & (np.abs(depth - jm.thickness_nm)
                          > TOL * depth.max())).any()


@pytest.mark.parametrize("name", DEPTH)
def test_depth_resist_vertical_chain_matches_jax(stack, name):
    jm = DEPTH[name]
    pm = resist_from_jax(jm)
    np.testing.assert_array_equal(pm.depths_nm, jm.depths_nm)
    np.testing.assert_array_equal(pm.depth_profile(), jm.depth_profile())
    np.testing.assert_array_equal(pm.film_defocus_nm(best_focus_nm=20.0),
                                  jm.film_defocus_nm(best_focus_nm=20.0))
    np.testing.assert_array_equal(pm.rate_depth_factor(), jm.rate_depth_factor())
    lf_j, lf_p = jm.lateral_factor_profile(), pm.lateral_factor_profile()
    assert (lf_j is None) == (lf_p is None)
    if lf_j is not None:
        np.testing.assert_array_equal(lf_p, lf_j)
    kw = dict(pixel_size_nm=PX)
    _close(pm.latent(stack, 1.2, device="cpu", **kw), jm.latent(stack, 1.2, **kw))
    thick = jm.mack.thickness_nm
    depth = np.asarray(jm.cleared_depth_nm(stack, 1.2, **kw))
    assert depth.max() == pytest.approx(thick)
    _close(pm.cleared_depth_nm(stack, 1.2, device="cpu", **kw), depth,
           tol=DEPTH_TOL)
    height = np.asarray(jm.height_map_nm(stack, 1.2, **kw))
    assert np.abs(_np(pm.height_map_nm(stack, 1.2, device="cpu", **kw))
                  - height).max() <= DEPTH_TOL * thick
    _close(pm.develop(stack, 1.2, device="cpu", **kw), jm.develop(stack, 1.2, **kw),
           tol=0.2 / 4 * DEPTH_TOL * thick)
    ours = pm.develop_binary(stack, 1.2, device="cpu", **kw)
    differ = _np(ours) != np.asarray(jm.develop_binary(stack, 1.2, **kw))
    assert not (differ & (np.abs(depth - thick) > DEPTH_TOL * thick)).any()


@pytest.mark.parametrize("name", DEPTH)
def test_depth_resist_eikonal_develop_matches_jax(aerial, name):
    jm = DEPTH[name]
    pm = resist_from_jax(jm)
    kw = dict(pixel_size_nm=PX)
    t_ref = np.asarray(jm.arrival_times(aerial, **kw))
    t = pm.arrival_times(aerial, device="cpu", **kw)
    _close(t, t_ref)
    _close(pm.cleared_depth_nm_lateral(aerial, device="cpu", **kw),
           jm.cleared_depth_nm_lateral(aerial, **kw))
    # near the develop time the arrival times are within TOL * develop_s
    _close(pm.develop_profile(aerial, device="cpu", **kw),
           jm.develop_profile(aerial, **kw),
           tol=5.0 / 4 * TOL * jm.mack.develop_s)
    ours = pm.develop_profile_binary(aerial, device="cpu", **kw)
    differ = _np(ours) != np.asarray(jm.develop_profile_binary(aerial, **kw))
    assert not (differ & (np.abs(t_ref - jm.mack.develop_s)
                          > TOL * t_ref.max())).any()


def test_peb_requires_pixel_size():
    with pytest.raises(ValueError, match="pixel_size_nm"):
        pr.DepthResist(peb_diffusion_nm=10.0).latent(
            np.ones((8, 8), np.float32), device="cpu")
    with pytest.raises(ValueError, match="planes"):
        pr.DepthResist(nz=4).latent(np.ones((3, 8, 8), np.float32),
                                    device="cpu")


@pytest.fixture(scope="module")
def profiles(aerial):
    """Each package's binary develop of the same image, and JAX's
    continuous field of it."""
    jm = jr.ResistModel(threshold=0.35, diffusion_nm=10.0)
    pm = resist_from_jax(jm)
    ref = np.asarray(jm.develop_binary(aerial, CFG))
    ours = _np(pm.develop_binary(aerial, PCFG, device="cpu"))
    blurred = np.asarray(jm.blur(aerial, CFG))
    return ours, ref, blurred / blurred.max()


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_metrology_copies_equal_jax_on_the_same_input(profiles):
    """Every numpy measurement function of the port, on JAX's own profile
    and field, returns JAX's result exactly (the copies are faithful)."""
    _, ref, field = profiles
    target = np.roll(ref, 1, axis=1)
    cases = [
        ("critical_dimension", (ref, CFG), {}),
        ("feature_table", (field, CFG), dict(threshold=0.35)),
        ("feature_table", (field, CFG), dict(threshold=0.35, axis=0,
                                             row_step=3)),
        ("cd_uniformity", (field, CFG), dict(threshold=0.35, map_blocks=4)),
        ("cd_uniformity", (field, CFG), dict(threshold=0.35, axis=0,
                                             min_width_nm=30.0)),
        ("nils_table", (field, CFG), dict(threshold=0.35)),
        ("hotspots", (field, CFG), dict(threshold=0.35, nils_limit=3.0)),
        ("edge_placement_errors", (ref, target, CFG), {}),
        ("pattern_fidelity", (ref, target, CFG), {}),
        ("process_window", (np.array([[90.0, 100, 110], [95, 102, 130]]),
                            [-50.0, 0.0], [0.9, 1.0, 1.1]),
         dict(target_cd_nm=100.0)),
    ]
    for name, args, kw in cases:
        pargs = tuple(PCFG if a is CFG else a for a in args)
        _assert_same(getattr(pr, name)(*pargs, **kw),
                     getattr(jr, name)(*args, **kw))
    table = jr.feature_table(target, CFG)
    _assert_same(pr.aligned_edge_positions(ref, table, PCFG),
                 jr.aligned_edge_positions(ref, table, CFG))


def test_cd_tables_after_each_develop_match(profiles):
    ours, ref, _ = profiles
    a = pr.feature_table(ours, PCFG)
    b = jr.feature_table(ref, CFG)
    np.testing.assert_array_equal(a["row"], b["row"])
    for key in ("width_nm", "center_nm"):
        np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-6)
    assert pr.critical_dimension(ours, PCFG) == jr.critical_dimension(ref, CFG)


def test_exposure_latitude_meef_and_process_window_match_jax(aerial):
    jm = jr.ResistModel(threshold=0.35, diffusion_nm=10.0)
    pm = resist_from_jax(jm)
    img = aerial / aerial.max()
    doses = [0.8, 1.0, 1.25]
    assert (pr.exposure_latitude(img, PCFG, pm, doses, device="cpu")
            == jr.exposure_latitude(img, CFG, jm, doses))
    with pytest.raises(ValueError, match="one"):
        pr.exposure_latitude(np.stack([img, img]), PCFG, pm, doses,
                             device="cpu")
    src = np.asarray(jt.LightSource(CFG, sigma_out=0.6).annular())
    geom = np.asarray(jt.lines_and_spaces(CFG, line_width_px=6,
                                          pitch_px=16).geometry)

    def jimage(g):
        return jt.simulate(jt.from_array(g, CFG), src).image

    def pimage(g):
        return pt.simulate(pt.from_array(g, PCFG, device="cpu"), src,
                           device="cpu").image

    assert pr.meef(geom, pimage, PCFG, pm) == jr.meef(geom, jimage, CFG, jm)
    _assert_same(pr.meef_table(geom, pimage, PCFG, pm, map_blocks=4),
                 jr.meef_table(geom, jimage, CFG, jm, map_blocks=4))


@pytest.mark.parametrize("rigorous", [False, True], ids=["analytic", "rigorous"])
def test_swing_curve_matches_jax(rigorous):
    jm = jr.DepthResist(mack=jr.MackResist(thickness_nm=300.0), nz=12,
                        substrate_reflectivity=0.25, absorbance_per_um=0.4)
    wafer = (jfs.WaferStack(n_resist=1.7 + 0.012j, thickness_nm=300.0,
                            n_substrate=jfs.MATERIALS_193["si"])
             if rigorous else None)
    thick = np.arange(260.0, 300.0, 8.0)
    ref = jr.swing_curve(thick, jm, wafer_stack=wafer)
    ours = pr.swing_curve(thick, resist_from_jax(jm), device="cpu",
                          wafer_stack=(None if wafer is None
                                       else wafer_stack_from_jax(wafer)))
    assert ours.keys() == ref.keys()
    np.testing.assert_array_equal(ours["thickness_nm"], ref["thickness_nm"])
    # bisection to 64 / 2^24 on float32 cleared depths: one step apart at most
    np.testing.assert_allclose(ours["dose_to_clear"], ref["dose_to_clear"],
                               rtol=0, atol=64.0 / 2**23)
    assert ours["period_nm_theory"] == ref["period_nm_theory"]


def test_develop_gradients_match_jax(aerial):
    img = (aerial / aerial.max()).astype(np.float32)
    rng = np.random.default_rng(5)
    weight = rng.uniform(0.5, 1.5, (4, 64, 64)).astype(np.float32)
    jd = jr.DepthResist(nz=4, lateral_rate_factor=0.7)
    pd = resist_from_jax(jd)

    def jloss(dose, im):
        return jnp.sum(jd.develop_profile(im, dose, pixel_size_nm=PX,
                                          iterations=12) * weight)

    g_dose, g_img = jax.grad(jloss, argnums=(0, 1))(1.0, jnp.asarray(img))
    dose = torch.tensor(1.0, requires_grad=True)
    im = torch.tensor(img, requires_grad=True)
    loss = torch.sum(pd.develop_profile(im, dose, pixel_size_nm=PX,
                                        iterations=12) * torch.tensor(weight))
    pg_dose, pg_img = torch.autograd.grad(loss, (dose, im))
    assert float(g_dose) != 0.0
    assert abs(float(pg_dose) - float(g_dose)) <= GRAD_TOL * abs(float(g_dose))
    _close(pg_img, g_img, tol=GRAD_TOL)

    for jm in (jr.ResistModel(threshold=0.35, steepness=20.0, diffusion_nm=10.0),
               jr.MackResist()):
        pm = resist_from_jax(jm)
        w2 = weight[0]
        if isinstance(jm, jr.ResistModel):
            ref = jax.grad(lambda x: jnp.sum(jm.develop(x, CFG) * w2))(
                jnp.asarray(img))
            x = torch.tensor(img, requires_grad=True)
            out = pm.develop(x, PCFG)
        else:
            ref = jax.grad(lambda x: jnp.sum(jm.develop(x) * w2))(
                jnp.asarray(img))
            x = torch.tensor(img, requires_grad=True)
            out = pm.develop(x)
        (g,) = torch.autograd.grad(torch.sum(out * torch.tensor(w2)), x)
        _close(g, ref, tol=GRAD_TOL)
