"""Port parity: full-chip metrology (metrology.py) of the torch port
(device='cpu') against the JAX package's, on tests/test_metrology.py's
chip (8 px lines on a 32 px pitch over 128^2, 64^2 tiles).

The kernel builds happen inside the functions. At 37 live source points
(classical sigma 0.2) and rank 24, the 40 probes of a randomized build
span the whole range, so both packages' builds are exact (warm or cold)
and their images agree to the SOCS pair class; one test also passes the
JAX kernels carried across (``socs_builder``). Tolerances: focus stacks
within 1e-5 of JAX's maximum (TOL_SOCS_PAIR); the CD matrices, process
windows, feature and edge counts and PV maps of binary develops equal
JAX's (pixel-quantized, the class of test_metrology.py:122's 1e-9);
subpixel and gradient values (NILS, EPE, CDU, MEEF, CD deltas) within
1e-4 relative; the stochastic ensemble in distribution only (per-trial
generators, ROADMAP D2): its deterministic CD within 1e-3 nm, the mean
CD within five sampling errors and LER/LWR within 10%.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu import metrology as jm
from lithographysimulator_tpu.simulate import _compiled_socs_build
from lithographysimulator_tpu_torch.interop import (config_from_jax,
                                                    mask_rules_from_jax,
                                                    perturbation_from_jax,
                                                    resist_from_jax,
                                                    socs_from_numpy,
                                                    stochastic_from_jax)

JCFG = jt.OpticsConfig(pixel_number=64)
PCFG = config_from_jax(JCFG)
BIG_N = 128
KW = dict(rank=24, halo=16)
TOL = 1e-5
JRES = jt.ResistModel(threshold=0.25)
PRES = resist_from_jax(JRES)
FOCUS = [-80.0, 0.0, 80.0]
DOSES = [0.8, 0.9, 1.0, 1.1, 1.2]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chip():
    x = np.arange(BIG_N)
    cols = ((x // 8) % 4 == 0).astype(np.float32)
    m = np.broadcast_to(cols, (BIG_N, BIG_N)).copy()
    m[:10] = 0.0  # line ends at the top
    return m


@pytest.fixture(scope="module")
def src():
    return np.asarray(jt.LightSource(JCFG, sigma_out=0.2).classical())


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _close(ours, ref, rel=1e-4) -> None:
    assert ours == pytest.approx(ref, rel=rel, abs=1e-9)


@pytest.fixture(scope="module")
def fem_pair(chip, src):
    kw = dict(defocus_nm=FOCUS, doses=DOSES, hotspot_nils=2.5,
              pv_bands=True, **KW)
    return (pt.tiled_fem(chip, PCFG, src, resist=PRES, device="cpu", **kw),
            jm.tiled_fem(chip, JCFG, src, resist=JRES, **kw))


def test_focus_images_match_jax(chip, src):
    ours = pt.tiled_focus_images(chip, PCFG, src, FOCUS, device="cpu", **KW)
    ref = jm.tiled_focus_images(chip, JCFG, src, FOCUS, **KW)
    assert isinstance(ours, torch.Tensor)
    assert ours.shape == (3, BIG_N, BIG_N) and ours.dtype == torch.float32
    assert _rel(ours.numpy(), ref) <= TOL
    cold = pt.tiled_focus_images(chip, PCFG, src, FOCUS, device="cpu",
                                 warm_start=False, **KW)
    assert _rel(cold.numpy(), ref) <= TOL
    streamed = pt.tiled_focus_images(
        None, PCFG, src, FOCUS, window_fn=pt.array_window_fn(chip, PCFG.n),
        big_n=BIG_N, device="cpu", **KW)
    np.testing.assert_allclose(streamed.numpy(), ours.numpy(), rtol=0,
                               atol=1e-6 * float(ours.max()))
    contrast = [float(im.max() - im.min()) for im in ours]
    assert contrast[1] >= max(contrast[0], contrast[2])


def test_focus_images_on_carried_kernels(chip, src):
    """``socs_builder`` with JAX's kernels carried across: the same
    planes (JAX's builder is called first, plane by plane)."""
    build = _compiled_socs_build(JCFG, 24)
    carried = []

    def jax_builder(ab):
        socs = build(np.asarray(ab, np.float32), src)[0]
        carried.append(socs_from_numpy(np.asarray(socs.kernels),
                                       np.asarray(socs.eigenvalues),
                                       socs.total_rank, device="cpu"))
        return socs

    ref = jm.tiled_focus_images(chip, JCFG, src, FOCUS,
                                socs_builder=jax_builder, **KW)
    planes = iter(carried)
    ours = pt.tiled_focus_images(chip, PCFG, src, FOCUS, device="cpu",
                                 socs_builder=lambda ab: next(planes), **KW)
    assert _rel(ours.numpy(), ref) <= TOL
    # tiled_fem on the same carried planes: JAX's own FEM, cell for cell
    planes = iter(carried)
    kw = dict(defocus_nm=FOCUS, doses=DOSES, **KW)
    fem = pt.tiled_fem(chip, PCFG, src, resist=PRES, device="cpu",
                       socs_builder=lambda ab: next(planes), **kw)
    fem_ref = jm.tiled_fem(chip, JCFG, src, resist=JRES, **kw)
    np.testing.assert_array_equal(fem["cd_nm"], fem_ref["cd_nm"])


def test_field_and_perturbed_focus_images_match_jax(chip, src):
    def slit(fx, fy):
        return np.array([0, 0, 0, 0.3 * fx, 110.0 * (fx**2 + fy**2)],
                        np.float32)

    kw = dict(field_aberrations=slit, field_points=3, field_blend="nearest",
              **KW)
    ours = pt.tiled_focus_images(chip, PCFG, src, [-80.0, 80.0],
                                 device="cpu", **kw)
    ref = jm.tiled_focus_images(chip, JCFG, src, [-80.0, 80.0], **kw)
    assert _rel(ours.numpy(), ref) <= TOL
    perturb = jt.ImagePerturbation(msd_x_nm=5.0, flare_tis=0.02)
    ours = pt.tiled_focus_images(chip, PCFG, src, [0.0], device="cpu",
                                 perturb=perturbation_from_jax(perturb), **KW)
    ref = jm.tiled_focus_images(chip, JCFG, src, [0.0], perturb=perturb, **KW)
    assert _rel(ours.numpy(), ref) <= TOL


def test_tiled_fem_matches_jax(fem_pair):
    ours, ref = fem_pair
    assert ours.keys() == ref.keys()
    np.testing.assert_array_equal(ours["cd_nm"], ref["cd_nm"])
    for key in ("target_cd_nm", "depth_of_focus_nm", "exposure_latitude",
                "in_spec_fraction"):
        assert ours[key] == ref[key], key
    assert ours["cd_nm"].shape == (3, 5) and ours["in_spec_fraction"] > 0
    assert ours["cdu"].keys() == ref["cdu"].keys()
    for key in ("count", "mean_cd_nm", "sigma_cd_nm", "range_cd_nm"):
        _close(ours["cdu"][key], ref["cdu"][key])
    np.testing.assert_allclose(ours["cdu"]["cd_map_nm"],
                               ref["cdu"]["cd_map_nm"], rtol=1e-4)
    assert ours["nils"]["count"] == ref["nils"]["count"] > 0
    for key in ("mean_nils", "min_nils", "mean_ils_per_nm"):
        _close(ours["nils"][key], ref["nils"][key])
    assert ours["epe"].keys() == ref["epe"].keys()
    for key in ("matched", "missing", "spurious"):
        assert ours["epe"][key] == ref["epe"][key]
    _close(ours["epe"]["mean_abs_epe_nm"], ref["epe"]["mean_abs_epe_nm"])
    spots, spots_ref = ours["hotspots"], ref["hotspots"]
    assert spots["count"] == spots_ref["count"] > 0
    # weakest first: equal lines tie in NILS, so compare them as a set
    by_place = lambda a: np.asarray(a)[np.lexsort(np.asarray(a)[:, 1::-1].T)]
    np.testing.assert_allclose(by_place(spots["locations"]),
                               by_place(spots_ref["locations"]),
                               rtol=1e-4, atol=0.011)


def test_pv_bands_match_jax_and_their_algebra(fem_pair):
    ours, ref = fem_pair
    pv, pv_ref = ours["pv"], ref["pv"]
    for key in ("outer", "inner", "band"):
        assert pv[key].dtype == np.uint8
        np.testing.assert_array_equal(pv[key], pv_ref[key])
    for key in ("band_area_frac", "edge_band_mean_nm", "edge_band_max_nm",
                "edge_band_sigma_nm"):
        _close(pv[key], pv_ref[key])
    for key in ("edges_measured", "edges_open", "conditions"):
        assert pv[key] == pv_ref[key]
    outer, inner = pv["outer"].astype(bool), pv["inner"].astype(bool)
    assert not (inner & ~outer).any()
    np.testing.assert_array_equal(pv["band"].astype(bool), outer & ~inner)
    assert 0.0 < pv["band_area_frac"] < 0.5 and pv["conditions"] == 15


def test_single_row_fem_and_progress(chip, src):
    seen = []
    kw = dict(defocus_nm=[0.0, 80.0], doses=[0.9, 1.1], row=40, **KW)
    ours = pt.tiled_fem(chip, PCFG, src, resist=PRES, device="cpu",
                        progress_cb=seen.append, **kw)
    ref = jm.tiled_fem(chip, JCFG, src, resist=JRES, **kw)
    np.testing.assert_array_equal(ours["cd_nm"], ref["cd_nm"])
    assert seen[-1] == pytest.approx(1.0)
    assert all(b >= a for a, b in zip(seen, seen[1:]))
    with pytest.raises(ValueError, match="cd_stat"):
        pt.tiled_fem(chip, PCFG, src, cd_stat="mode", device="cpu", **kw)


def test_dose_map_matches_jax(fem_pair):
    ours, ref = fem_pair
    dc = pt.dose_correction_map(ours)
    dc_ref = jm.dose_correction_map(ref)
    np.testing.assert_allclose(dc["dose_map"], dc_ref["dose_map"], rtol=1e-5)
    for key in ("sensitivity_nm_per_dose", "target_cd_nm",
                "predicted_residual_nm"):
        _close(dc[key], dc_ref[key])
    rng = np.random.default_rng(2)
    image = rng.random((BIG_N, BIG_N)).astype(np.float32)
    dose_map = (0.9 + 0.2 * rng.random((5, 5))).astype(np.float32)  # ragged
    scaled = pt.apply_dose_map(torch.as_tensor(image), dose_map)
    assert isinstance(scaled, torch.Tensor) and scaled.dtype == torch.float32
    np.testing.assert_array_equal(scaled.numpy(),
                                  jm.apply_dose_map(image, dose_map))
    with pytest.raises(ValueError, match="dose columns"):
        pt.dose_correction_map({"cd_nm": np.ones((1, 1)), "doses": [1.0],
                                "cdu": {"cd_map_nm": np.ones((2, 2))}})
    with pytest.raises(ValueError, match="device"):
        pt.apply_dose_map(image, dose_map)


def test_tiled_stochastic_matches_jax_in_distribution(chip, src):
    jmodel = jt.StochasticResist(dose_photons_per_nm2=0.05, diffusion_nm=25.0,
                                 threshold=0.35)
    kw = dict(trials=16, seed=0, trial_chunk=4, psd=True, **KW)
    seen = []
    ours = pt.tiled_stochastic(chip, PCFG, src,
                               model=stochastic_from_jax(jmodel),
                               device="cpu", progress_cb=seen.append, **kw)
    ref = jm.tiled_stochastic(chip, JCFG, src, model=jmodel, **kw)
    assert ours.keys() == ref.keys() and "psd" not in ours
    assert ours["big_n"] == ref["big_n"] == BIG_N and ours["trials"] == 16
    assert ours["print_probability"].shape == (BIG_N, BIG_N)
    assert ours["deterministic_cd_nm"] == pytest.approx(
        ref["deterministic_cd_nm"], abs=1e-3)
    sigma = np.hypot(ours["lcdu_nm"], ref["lcdu_nm"]) / 3.0 / np.sqrt(16)
    assert abs(ours["mean_cd_nm"] - ref["mean_cd_nm"]) <= 5.0 * sigma + 1e-3
    for key in ("ler_nm", "lwr_nm"):
        assert ours[key] == pytest.approx(ref[key], rel=0.1), key
    assert isinstance(ours["psd_nm3"], np.ndarray)
    assert seen[-1] == 1.0


def test_orc_check_matches_jax(chip, src):
    rules = jt.MaskRules(min_width_nm=100.0, min_space_nm=100.0,
                         min_area_nm2=5e4)
    corners = {"defocus_nm": [-60.0, 0.0, 60.0], "doses": [0.95, 1.0, 1.05],
               "max_edge_band_nm": 40.0}
    kw = dict(hotspot_nils=2.5, process_corners=corners, **KW)
    ours = pt.orc_check(chip, chip, PCFG, src, resist=PRES, device="cpu",
                        mrc_rules=mask_rules_from_jax(rules), **kw)
    ref = jm.orc_check(chip, chip, JCFG, src, resist=JRES, mrc_rules=rules,
                       **kw)
    assert ours.keys() == ref.keys()
    assert ours["pass_"] == ref["pass_"]
    assert ours["mrc"] == ref["mrc"] and ours["mrc"]["clean"]
    for key in ("iou", "xor_area_nm2", "mean_epe_nm"):
        _close(ours["fidelity"][key], ref["fidelity"][key])
    for key in ("matched", "missing", "spurious"):
        assert ours["epe"][key] == ref["epe"][key]
    _close(ours["epe"]["max_abs_epe_nm"], ref["epe"]["max_abs_epe_nm"])
    _close(ours["nils"]["mean_nils"], ref["nils"]["mean_nils"])
    assert ours["hotspots"]["count"] == ref["hotspots"]["count"]
    assert ours["pv"]["edges_open"] == ref["pv"]["edges_open"]
    _close(ours["pv"]["edge_band_max_nm"], ref["pv"]["edge_band_max_nm"])
    assert ours["process_window"] == ref["process_window"]


def test_meef_and_meef_map_match_jax(chip, src):
    js = _compiled_socs_build(JCFG, 24)(np.zeros(5, np.float32), src)[0]
    carried = socs_from_numpy(np.asarray(js.kernels),
                              np.asarray(js.eigenvalues), js.total_rank,
                              device="cpu")
    ours = pt.tiled_meef(chip, PCFG, src, resist=PRES, socs=carried, **KW)
    ref = jm.tiled_meef(chip, JCFG, src, resist=JRES, socs=js, **KW)
    assert ours == pytest.approx(ref, rel=1e-9) and 0.2 < ours < 5.0
    built = pt.tiled_meef(chip, PCFG, src, resist=PRES, device="cpu", **KW)
    assert built == pytest.approx(ref, rel=1e-9)
    table = pt.tiled_meef_map(chip, PCFG, src, resist=PRES, map_blocks=4,
                              device="cpu", **KW)
    table_ref = jm.tiled_meef_map(chip, JCFG, src, resist=JRES, map_blocks=4,
                                  **KW)
    assert table["count"] == table_ref["count"] > 50
    for key in ("mean_meef", "sigma_meef", "max_meef"):
        _close(table[key], table_ref[key])
    np.testing.assert_allclose(table["meef_map"], table_ref["meef_map"],
                               rtol=1e-4)


def _lines(n=96, w=4, pitch=16):
    m = np.zeros((n, n), np.float32)
    for x in range(8, n - 8, pitch):
        m[8:-8, x:x + w] = 1.0
    return m


def test_defect_printability_matches_jax():
    """tests/test_defect.py's notch, through focus, on 48^2 tiles."""
    jcfg = jt.OpticsConfig(pixel_number=48)
    src = np.asarray(jt.LightSource(jcfg, sigma_out=0.2).classical())
    m = _lines()
    bad = m.copy()
    bad[46:50, 40:42] = 0.0
    kw = dict(rank=16, halo=8, defocus_nm=(-80.0, 0.0))
    res = jt.ResistModel(threshold=0.4, diffusion_nm=10.0)
    ours = pt.defect_printability(m, bad, config_from_jax(jcfg), src,
                                  resist=resist_from_jax(res), device="cpu",
                                  **kw)
    ref = jm.defect_printability(m, bad, jcfg, src, resist=res, **kw)
    assert ours.keys() == ref.keys()
    assert ours["prints"] == ref["prints"]
    for key in ("missing_features", "new_features"):
        assert ours[key] == ref[key]
    _close(ours["max_abs_cd_delta_nm"], ref["max_abs_cd_delta_nm"], rel=1e-3)
    _close(ours["cd_spec_nm"], ref["cd_spec_nm"])
    for p, q in zip(ours["per_focus"], ref["per_focus"]):
        assert p["delta_location_nm"] == q["delta_location_nm"]
        assert p["cd_delta_location_nm"] == pytest.approx(
            q["cd_delta_location_nm"], rel=1e-6)
        _close(p["max_delta_intensity"], q["max_delta_intensity"], rel=1e-3)
    with pytest.raises(ValueError, match="shapes differ"):
        pt.defect_printability(m, _lines(64), config_from_jax(jcfg), src,
                               device="cpu", **kw)


def test_host_data_needs_a_device(chip, src):
    with pytest.raises(ValueError, match="device"):
        pt.tiled_focus_images(chip, PCFG, src, [0.0], **KW)
    with pytest.raises(ValueError, match="exactly one"):
        pt.tiled_focus_images(None, PCFG, src, [0.0], device="cpu", **KW)
    image = pt.tiled_focus_images(torch.as_tensor(chip), PCFG, src, [0.0],
                                  **KW)  # a tensor chip keeps its device
    assert image.device.type == "cpu"


def _field():
    """A smooth, asymmetric 96 x 80 field with features along both axes."""
    y, x = np.mgrid[0:96, 0:80].astype(np.float64)
    f = (0.5 + 0.3 * np.cos(2 * np.pi * x / 17.0) * np.cos(2 * np.pi * y / 23.0)
         + 0.15 * np.sin(2 * np.pi * (x + 2 * y) / 31.0))
    return f.astype(np.float32)


@pytest.mark.parametrize("name,kw", [
    ("feature_table", dict(threshold=0.5, axis=1, row_step=4)),
    ("feature_table", dict(threshold=0.5, axis=0, row_step=3)),
    ("cd_uniformity", dict(threshold=0.5, axis=0, row_step=2, map_blocks=4)),
    ("nils_table", dict(threshold=0.5, axis=0, row_step=3)),
    ("nils_table", dict(threshold=0.45, axis=1, normalize=False)),
    ("hotspots", dict(threshold=0.5, axis=0, nils_limit=4.0, row_step=5)),
    ("critical_dimension", dict(row=7)),
])
def test_cut_line_readback_equals_jax_and_the_host_copy(name, kw):
    """The metrology reads only a tensor's kept cut lines back; the result
    equals JAX's on the same field and the port's on its numpy copy, bit
    for bit, along either axis."""
    from lithographysimulator_tpu.models import resist as jr
    from lithographysimulator_tpu_torch.models import resist as pr

    field = _field()
    cfg = jt.OpticsConfig(pixel_number=96)
    ours = getattr(pr, name)(torch.as_tensor(field), config_from_jax(cfg), **kw)
    host = getattr(pr, name)(field, config_from_jax(cfg), **kw)
    ref = getattr(jr, name)(field, cfg, **kw)
    for got in (ours, host):
        if isinstance(ref, dict):
            assert got.keys() == ref.keys()
            for k, v in ref.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got == ref


def test_edge_tables_of_a_tensor_equal_jax():
    from lithographysimulator_tpu.models import resist as jr
    from lithographysimulator_tpu_torch.models import resist as pr

    cfg = jt.OpticsConfig(pixel_number=96)
    profile = (_field() > 0.5).astype(np.float32)
    target = np.roll(profile, 2, axis=0)
    for axis in (0, 1):
        table = jr.feature_table(target, cfg, axis=axis, row_step=2)
        ours = pr.aligned_edge_positions(torch.as_tensor(profile), table,
                                         config_from_jax(cfg), axis=axis,
                                         row_step=2)
        ref = jr.aligned_edge_positions(profile, table, cfg, axis=axis,
                                        row_step=2)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
        epe = pr.edge_placement_errors(torch.as_tensor(profile), target,
                                       config_from_jax(cfg), axis=axis,
                                       row_step=3)
        epe_ref = jr.edge_placement_errors(profile, target, cfg, axis=axis,
                                           row_step=3)
        for k, v in epe_ref.items():
            np.testing.assert_array_equal(epe[k], v, err_msg=k)


def test_fem_with_thick_mask_and_column_cuts_matches_jax(src):
    """tiled_fem with a boundary-layer mask (it must reach every tile) over
    horizontal lines measured along columns (cd_axis 0, cd_row_step 4)."""
    from lithographysimulator_tpu.ops.mask3d import BoundaryLayer

    from lithographysimulator_tpu_torch.interop import mask3d_from_jax

    y = np.arange(BIG_N)
    rows = ((y // 8) % 4 == 0).astype(np.float32)
    chip = np.broadcast_to(rows[:, None], (BIG_N, BIG_N)).copy()
    chip[:, :10] = 0.0
    bl = BoundaryLayer(width_nm=8.0, beta_h=-0.35, beta_v=-0.35 + 0.1j)
    kw = dict(defocus_nm=[-60.0, 0.0, 60.0], doses=[0.9, 1.0, 1.1],
              cd_axis=0, cd_row_step=4, cd_stat="mean", **KW)
    ours = pt.tiled_fem(chip, PCFG, src, resist=PRES, device="cpu",
                        mask3d=mask3d_from_jax(bl), **kw)
    ref = jm.tiled_fem(chip, JCFG, src, resist=JRES, mask3d=bl, **kw)
    np.testing.assert_allclose(ours["cd_nm"], ref["cd_nm"], rtol=1e-6)
    assert ours["depth_of_focus_nm"] == ref["depth_of_focus_nm"]
    assert ours["exposure_latitude"] == ref["exposure_latitude"]
    thin = pt.tiled_fem(chip, PCFG, src, resist=PRES, device="cpu", **kw)
    assert not np.array_equal(thin["cd_nm"], ours["cd_nm"])
    for key in ("matched", "missing", "spurious"):
        assert ours["epe"][key] == ref["epe"][key]
