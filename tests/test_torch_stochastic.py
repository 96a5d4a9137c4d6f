"""Port parity: the stochastic resist (models/stochastic.py) of the torch
port (device='cpu') against the JAX package's.

``jax.random`` and ``torch.Generator`` draw different numbers, so the two
packages' ensembles agree in their statistics, not their bits. What holds
exactly, within the port:

* the same seed gives the same fields, bit for bit;
* trial i's field depends on (seed, i) only: the same under any
  ``trial_chunk`` and any host chunking of the ensemble;
* ``deprotection_volume`` of a one-slab stack equals ``deprotection`` of
  the plane for the same generator state, bit for bit.

Against JAX:

* deterministic limits (fields and volumes): within 1e-6 of the largest
  value (float32 FFT blur); contours equal except pixels within that of
  the threshold;
* the copied numpy statistics (edge PSD, Palasantzas fit, ACF length) on
  the same fields: JAX's result exactly;
* ensemble statistics (32 trials each, 128^2 lines at 5 nm pixels): the
  mean field per pixel within 6 sigma of the pair's sampling error (6, not
  5: 16,384 pixels are tested at once), and the mean LER, LWR, CD,
  per-trial break and bridge rates, LCDU and the PSD's edge variance each
  within 5 sigma of the pair's sampling error, estimated from the trials'
  own spread. The bounds come from the sampling error, not the seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import lithographysimulator_tpu as jt
from lithographysimulator_tpu.models import resist as jr
from lithographysimulator_tpu.models import stochastic as js
from lithographysimulator_tpu_torch.interop import (config_from_jax,
                                                    stochastic_from_jax)
from lithographysimulator_tpu_torch.models import stochastic as ps

TOL = 1e-6
TRIALS = 32
CFG = jt.OpticsConfig(pixel_number=128, pixel_size=5.0)
PCFG = config_from_jax(CFG)
NOISY = js.StochasticResist(dose_photons_per_nm2=5.0, diffusion_nm=8.0,
                            threshold=0.4)
STARVED = js.StochasticResist(dose_photons_per_nm2=0.8, diffusion_nm=5.0,
                              threshold=0.4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _aerial():
    """Binary lines low-passed to finite contrast (tests/test_stochastic.py's
    image)."""
    geom = np.abs(np.asarray(
        jt.lines_and_spaces(CFG, line_width_px=16, pitch_px=32).geometry,
        np.float32))
    soft = jr.ResistModel(diffusion_nm=30.0).blur(jnp.asarray(geom), CFG)
    return np.asarray(soft / jnp.max(soft))


IMG = _aerial()


def _line_stack():
    """tests/test_stochastic_volume.py's standing-wave-like stack: the same
    lines, dimmer and lower in contrast toward the bottom."""
    def lines(lo, hi, n=32, period=16, width=7):
        x = np.arange(n)
        dist = np.minimum(x % period, period - (x % period))
        row = np.where(dist < width / 2, lo, hi)
        return np.broadcast_to(row[None, :], (n, n)).astype(np.float32)

    return np.stack([lines(0.05, 1.0), lines(0.10, 0.80) * 0.9,
                     lines(0.16, 0.62) * 0.8])


def _np(x):
    return x.detach().cpu().numpy()


def test_stochastic_from_jax_round_trip():
    ours = stochastic_from_jax(NOISY)
    assert isinstance(ours, ps.StochasticResist)
    assert ours == ps.StochasticResist(dose_photons_per_nm2=5.0,
                                       diffusion_nm=8.0, threshold=0.4)
    with pytest.raises(ValueError):
        ps.StochasticResist(noise="bernoulli")


@pytest.mark.parametrize("diffusion", [0.0, 8.0])
def test_deterministic_limits_match_jax(diffusion):
    jm = js.StochasticResist(diffusion_nm=diffusion, threshold=0.4)
    pm = stochastic_from_jax(jm)
    field = np.asarray(jm.deterministic_field(jnp.asarray(IMG), CFG))
    ours = _np(pm.deterministic_field(IMG, PCFG, device="cpu"))
    assert np.abs(ours - field).max() <= TOL * np.abs(field).max()
    differ = (_np(pm.deterministic_contour(IMG, PCFG, device="cpu"))
              != np.asarray(jm.deterministic_contour(jnp.asarray(IMG), CFG)))
    assert not (differ & (np.abs(field - 0.4) > TOL)).any()
    stack = _line_stack()
    cfg32 = jt.OpticsConfig(pixel_number=32)
    vol = np.asarray(jm.deterministic_volume(jnp.asarray(stack), cfg32,
                                             dz_nm=20.0))
    ours = _np(pm.deterministic_volume(stack, config_from_jax(cfg32),
                                       dz_nm=20.0, device="cpu"))
    assert np.abs(ours - vol).max() <= TOL * np.abs(vol).max()


def test_deterministic_limit_matches_resist_model():
    from lithographysimulator_tpu_torch.models.resist import ResistModel

    pm = ps.StochasticResist(diffusion_nm=8.0, threshold=0.4)
    np.testing.assert_array_equal(
        _np(pm.deterministic_contour(IMG, PCFG, device="cpu")),
        _np(ResistModel(threshold=0.4, diffusion_nm=8.0).develop_binary(
            IMG, PCFG, device="cpu")))


def test_high_dose_converges_to_deterministic():
    """tests/test_stochastic.py's criterion at 1e6 photons/nm^2."""
    pm = ps.StochasticResist(dose_photons_per_nm2=1e6, diffusion_nm=8.0,
                             threshold=0.4)
    trials = _np(ps.exposure_trials(IMG, PCFG, pm, trials=4, seed=1,
                                    device="cpu"))
    det = _np(pm.deterministic_contour(IMG, PCFG, device="cpu"))
    assert np.mean(np.abs(trials - det[None])) < 0.01


@pytest.mark.parametrize("noise", ["poisson", "gaussian"])
def test_seed_reproducibility(noise):
    pm = ps.StochasticResist(dose_photons_per_nm2=10.0, diffusion_nm=5.0,
                             threshold=0.4, noise=noise)
    kw = dict(trials=4, binary=False, device="cpu")
    a = _np(ps.exposure_trials(IMG, PCFG, pm, seed=7, **kw))
    b = _np(ps.exposure_trials(IMG, PCFG, pm, seed=7, **kw))
    c = _np(ps.exposure_trials(IMG, PCFG, pm, seed=8, **kw))
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    assert (a[0] != a[1]).any()  # independent draws, not copies


@pytest.mark.parametrize("noise", ["poisson", "gaussian"])
def test_trial_chunk_independence(noise):
    pm = ps.StochasticResist(dose_photons_per_nm2=10.0, diffusion_nm=5.0,
                             threshold=0.4, pag_per_nm2=5.0, noise=noise)
    kw = dict(trials=7, seed=3, binary=False, device="cpu")
    ref = _np(ps.exposure_trials(IMG, PCFG, pm, trial_chunk=7, **kw))
    for chunk in (1, 3, 16):
        np.testing.assert_array_equal(
            _np(ps.exposure_trials(IMG, PCFG, pm, trial_chunk=chunk, **kw)), ref)
    # trial i alone, from its own generator
    gen = ps.trial_generator(3, 5, "cpu")
    np.testing.assert_array_equal(_np(pm.deprotection(gen, IMG, PCFG,
                                                      device="cpu")), ref[5])
    rows, runs, band = ps.exposure_summary(IMG, PCFG, pm, trials=7, seed=3,
                                           trial_chunk=2, row_step=3,
                                           device="cpu")
    np.testing.assert_array_equal(_np(rows), ref[:, ::3, :])
    contour = ref > pm.threshold
    np.testing.assert_array_equal(_np(band), contour.sum(axis=0))
    pad = np.pad(contour, ((0, 0), (0, 0), (1, 1))).astype(np.int8)
    np.testing.assert_array_equal(_np(runs),
                                  (np.diff(pad, axis=2) == 1).sum(axis=2))


def _assert_same(a, b, rtol=0.0):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k], rtol)
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=0)


@pytest.mark.parametrize("axis", [1, 0])
def test_host_chunking_does_not_change_the_ensemble(axis, monkeypatch):
    """A tiny summary budget streams 3 trials a host chunk: every result
    and the print probability are the single pass's, bit for bit; the PSD,
    a float64 sum of per-chunk partials, within 1e-12 (summation order)."""
    pm = stochastic_from_jax(NOISY)
    img = IMG if axis == 1 else IMG.T.copy()
    kw = dict(trials=8, seed=11, axis=axis, row_step=2, psd=True, device="cpu")
    single = ps.stochastic_ensemble(img, PCFG, pm, **kw)
    monkeypatch.setattr(ps, "_SUMMARY_BYTES", 3 * (64 * 128 * 4 + 128 * 4))
    assert ps._host_chunk(128, 2, 8) == 3
    streamed = ps.stochastic_ensemble(img, PCFG, pm, **kw)
    _assert_same(streamed.pop("psd"), single.pop("psd"), rtol=1e-12)
    _assert_same(streamed, single)
    monkeypatch.undo()
    kw = dict(trials=8, seed=11, axis=axis, row_step=2, device="cpu")
    _assert_same(ps.stochastic_psd(img, PCFG, pm, trial_chunk=3, **kw),
                 ps.stochastic_psd(img, PCFG, pm, trial_chunk=8, **kw))


@pytest.mark.parametrize("noise", ["poisson", "gaussian"])
def test_one_slab_volume_is_the_plane(noise):
    pm = ps.StochasticResist(dose_photons_per_nm2=10.0, diffusion_nm=4.0,
                             pag_per_nm2=3.0, noise=noise)
    flat = pm.deprotection(ps.trial_generator(7, 0, "cpu"), IMG, PCFG,
                           device="cpu")
    vol = pm.deprotection_volume(ps.trial_generator(7, 0, "cpu"), IMG[None],
                                 PCFG, dz_nm=10.0, device="cpu")
    assert vol.shape == (1, 128, 128)
    torch.testing.assert_close(vol[0], flat, rtol=0, atol=0)


def test_psd_helpers_equal_jax_on_the_same_fields():
    rows, _, _ = js.exposure_summary(IMG, CFG, NOISY, trials=8, seed=2,
                                     row_step=1)
    rows = np.asarray(rows)
    det = np.asarray(NOISY.deterministic_field(jnp.asarray(IMG), CFG))
    centers = js._reference_centers(det, CFG, axis=1, threshold=0.4,
                                    row_step=1)
    np.testing.assert_array_equal(
        ps._reference_centers(det, PCFG, axis=1, threshold=0.4, row_step=1),
        centers)
    band = js._print_band(det, CFG, threshold=0.4, ref_centers=centers)
    assert ps._print_band(det, PCFG, threshold=0.4,
                          ref_centers=centers) == band
    kw = dict(threshold=0.4, ref_centers=centers, row_band=band)
    ref = js.edge_psd(rows, CFG, **kw)
    ours = ps.edge_psd(torch.tensor(rows), PCFG, **kw)
    _assert_same(ours, ref)
    assert ref["n_edges"] > 0 and np.isfinite(ref["alpha"])
    np.testing.assert_array_equal(
        ps.fit_psd_model(ref["freq_per_nm"], ref["psd_nm3"])["corr_length_nm"],
        js.fit_psd_model(ref["freq_per_nm"], ref["psd_nm3"])["corr_length_nm"])
    assert (ps.acf_correlation_length(ref["freq_per_nm"], ref["psd_nm3"], 5.0)
            == js.acf_correlation_length(ref["freq_per_nm"], ref["psd_nm3"],
                                         5.0))
    le_p = ps._edge_stats_trials(rows, PCFG, threshold=0.4, ref_centers=centers)
    le_j = js._edge_stats_trials(rows, CFG, threshold=0.4, ref_centers=centers)
    np.testing.assert_array_equal(np.asarray(le_p), np.asarray(le_j))


def _per_trial(rows, runs, config, model, module):
    """Per-trial (ler, lwr, mean_cd, break_rate, bridge_rate) of a summary
    with row_step 1, by the copied numpy statistics."""
    det = np.asarray(js.StochasticResist(
        diffusion_nm=model.diffusion_nm).deterministic_field(
            jnp.asarray(IMG), CFG))
    centers = js._reference_centers(det, CFG, axis=1,
                                    threshold=model.threshold, row_step=1)
    le, lw, mc = module._edge_stats_trials(rows, config,
                                           threshold=model.threshold,
                                           ref_centers=centers)
    pad = np.pad(det > model.threshold, ((0, 0), (1, 1))).astype(np.int8)
    ref_runs = (np.diff(pad, axis=1) == 1).sum(axis=1)
    live = ref_runs > 0
    brk = (runs[:, live] > ref_runs[None, live]).mean(axis=1)
    brg = (runs[:, live] < ref_runs[None, live]).mean(axis=1)
    return {"ler": np.asarray(le), "lwr": np.asarray(lw),
            "cd": np.asarray(mc), "break": brk, "bridge": brg}


def _within_sampling_error(a, b, z=5.0):
    a, b = a[np.isfinite(a)], b[np.isfinite(b)]
    err = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
    assert abs(a.mean() - b.mean()) <= z * err + 1e-12, (a.mean(), b.mean(), err)


@pytest.fixture(scope="module")
def ensembles():
    out = {}
    for name, jm in (("noisy", NOISY), ("starved", STARVED)):
        pm = stochastic_from_jax(jm)
        rj, nj, bj = (np.asarray(x) for x in js.exposure_summary(
            IMG, CFG, jm, trials=TRIALS, seed=0))
        rp, np_, bp = (_np(x) for x in ps.exposure_summary(
            IMG, PCFG, pm, trials=TRIALS, seed=0, device="cpu"))
        out[name] = dict(jax=(rj, nj, bj), port=(rp, np_, bp),
                         jm=jm, pm=pm)
    return out


def test_ensemble_mean_field_matches_jax_and_the_deterministic_field(ensembles):
    e = ensembles["noisy"]
    fj, fp = e["jax"][0], e["port"][0]
    err = np.sqrt(fj.var(axis=0, ddof=1) / TRIALS + fp.var(axis=0, ddof=1) / TRIALS)
    assert (np.abs(fj.mean(axis=0) - fp.mean(axis=0)) <= 6.0 * err).all()
    # the counting chain is unbiased: E[field] is the deterministic field
    det = _np(e["pm"].deterministic_field(IMG, PCFG, device="cpu"))
    err_p = np.sqrt(fp.var(axis=0, ddof=1) / TRIALS)
    assert (np.abs(fp.mean(axis=0) - det) <= 6.0 * err_p).all()


@pytest.mark.parametrize("name,keys", [
    ("noisy", ("ler", "lwr", "cd")),
    ("starved", ("break", "bridge")),
])
def test_ensemble_statistics_match_jax(ensembles, name, keys):
    e = ensembles[name]
    sj = _per_trial(e["jax"][0], e["jax"][1], CFG, e["jm"], js)
    sp = _per_trial(e["port"][0], e["port"][1], PCFG, e["pm"], ps)
    for key in keys:
        _within_sampling_error(sp[key], sj[key])
    if name == "starved":
        assert sp["break"].mean() + sp["bridge"].mean() > 0.01
    else:
        # LCDU = 3 std(mean CD): the sample std's error is sigma/sqrt(2(T-1))
        s_p, s_j = sp["cd"].std(), sj["cd"].std()
        err = np.sqrt((s_p**2 + s_j**2) / (2 * (TRIALS - 1)))
        assert abs(s_p - s_j) <= 5.0 * err


def test_stochastic_ensemble_is_its_trials(ensembles):
    """stochastic_ensemble's summary is the per-trial statistics of the
    same (seed, trial) streams exposure_summary draws, in both packages."""
    for pkg, module, cfg in (("port", ps, PCFG), ("jax", js, CFG)):
        e = ensembles["noisy"]
        model = e["pm"] if pkg == "port" else e["jm"]
        kw = dict(trials=TRIALS, seed=0, row_step=1)
        if pkg == "port":
            kw["device"] = "cpu"
        out = module.stochastic_ensemble(IMG, cfg, model, **kw)
        per = _per_trial(*e[pkg][:2], cfg, model, module)
        assert out["ler_nm"] == pytest.approx(np.nanmean(per["ler"]), rel=1e-12)
        assert out["lcdu_nm"] == pytest.approx(3 * np.nanstd(per["cd"]),
                                               rel=1e-12)
        np.testing.assert_allclose(out["print_probability"],
                                   e[pkg][2] / TRIALS, rtol=0, atol=1e-7)


def _edge_variances(rows, module, config):
    det = np.asarray(NOISY.deterministic_field(jnp.asarray(IMG), CFG))
    centers = js._reference_centers(det, CFG, axis=1, threshold=0.4,
                                    row_step=1)
    band = js._print_band(det, CFG, threshold=0.4, ref_centers=centers)
    out = []
    for contour in rows[:, band[0]:band[1] + 1]:
        out += [np.var(tr) for tr in module._complete_edge_traces(
            contour, config, threshold=0.4, ref_centers=centers)]
    return np.asarray(out)


def test_psd_edge_variance_matches_jax(ensembles):
    """The PSD's sigma^2 (Parseval) is the mean edge variance: compared
    within the sampling error of the per-edge variances."""
    e = ensembles["noisy"]
    vj = _edge_variances(e["jax"][0], js, CFG)
    vp = _edge_variances(e["port"][0], ps, PCFG)
    assert vj.size > 16 and vp.size > 16
    _within_sampling_error(vp, vj)
    spec = ps.stochastic_psd(IMG, PCFG, e["pm"], trials=TRIALS, seed=0,
                             device="cpu")
    assert spec["sigma_nm"] ** 2 == pytest.approx(vp.mean(), rel=1e-9)


def test_volume_ensemble_physics_and_axis_flip():
    """tests/test_stochastic_volume.py's depth-resolved LER and axis-flip
    checks, on the port; the axis flip is exact here."""
    cfg = config_from_jax(jt.OpticsConfig(pixel_number=32))
    stack = _line_stack()
    pm = ps.StochasticResist(dose_photons_per_nm2=6.0, diffusion_nm=3.0,
                             threshold=0.25)
    out = ps.stochastic_volume_ensemble(stack, cfg, pm, dz_nm=30.0, trials=24,
                                        seed=3, device="cpu")
    lers = [s["ler_nm"] for s in out["slabs"]]
    assert np.all(np.isfinite(lers)) and lers[0] < lers[1] < lers[2]
    assert [s["depth_nm"] for s in out["slabs"]] == [0.0, 30.0, 60.0]
    p = out["print_probability"]
    assert p.shape == stack.shape and 0.0 <= p.min() and p.max() <= 1.0
    flipped = ps.stochastic_volume_ensemble(
        stack.transpose(0, 2, 1).copy(), cfg, pm, dz_nm=30.0, trials=24,
        seed=3, axis=0, device="cpu")
    assert flipped["slabs"] == out["slabs"]
    np.testing.assert_array_equal(flipped["print_probability"],
                                  p.transpose(0, 2, 1))


def test_volume_ensemble_matches_jax_in_distribution():
    """Per-slab print probability: the voxel-mean over a slab within 5
    sigma of the pair's sampling error, and the same report keys as JAX's.
    The error of a slab mean is bounded by the mean of its voxels' binomial
    errors (the variance of an average is at most the average variance)."""
    cfg = jt.OpticsConfig(pixel_number=32)
    stack = _line_stack()
    jm = js.StochasticResist(dose_photons_per_nm2=6.0, diffusion_nm=3.0,
                             threshold=0.25)
    ref = js.stochastic_volume_ensemble(stack, cfg, jm, dz_nm=30.0, trials=16,
                                        seed=3)
    ours = ps.stochastic_volume_ensemble(stack, config_from_jax(cfg),
                                         stochastic_from_jax(jm), dz_nm=30.0,
                                         trials=16, seed=3, device="cpu")
    assert ours.keys() == ref.keys()
    assert [s.keys() for s in ours["slabs"]] == [s.keys() for s in ref["slabs"]]
    for s in range(3):
        a, b = ours["print_probability"][s], ref["print_probability"][s]
        # a voxel's probability is a mean of 16 Bernoulli draws
        err = np.sqrt((a * (1 - a) + b * (1 - b)).mean() / 16)
        assert abs(a.mean() - b.mean()) <= 5.0 * err + 1e-12
