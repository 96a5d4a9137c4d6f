"""The stochastic ensemble's device path against the host's numpy helpers,
on the CPU: the edge table of ``edge_runs_plain`` (the plain twin of the
``edge_runs`` CUDA kernel) against ``resist.feature_table`` bit for bit and
``stochastic._run_counts`` exactly, and the float64 statistics and PSD of
``models/edge_stats.py`` against ``_edge_stats_tables``, ``_table_traces``
and ``_tables_psd`` on seeded ensembles, and against the JAX package's
``_edge_stats_trials`` and ``edge_psd`` on the same cut lines.

Tolerances: edge positions, run counts, feature ids and traces exactly;
per-trial LER, LWR and mean CD and the PSD within rel 1e-12 (the device
sums in another order than numpy's pairwise sums, each float64).
"""

import numpy as np
import pytest
import torch

import lithographysimulator_tpu as jt
from lithographysimulator_tpu.models import stochastic as js
from lithographysimulator_tpu_torch.config import OpticsConfig
from lithographysimulator_tpu_torch.models import edge_stats as es
from lithographysimulator_tpu_torch.models import stochastic as ps
from lithographysimulator_tpu_torch.models.resist import feature_table
from lithographysimulator_tpu_torch.ops.kernels import stochastic_edges as se

CFG = OpticsConfig(pixel_number=128, pixel_size=5.0)
JCFG = jt.OpticsConfig(pixel_number=128, pixel_size=5.0)
REL = 1e-12

# a dark trial prints no tracked feature, and the host's LER is then a mean
# of NaNs
pytestmark = pytest.mark.filterwarnings("ignore:Mean of empty slice")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(kind: str, seed: int = 0):
    """(fields (T, L, n) float32, threshold) of one kind of cut lines."""
    rng = np.random.default_rng(seed)
    t, lines, n = 3, 24, 64
    x = np.arange(n)
    if kind == "grating":
        phase = rng.uniform(0, 2 * np.pi, (t, lines, 1))
        f = 0.5 + 0.4 * np.cos(2 * np.pi * x / 12 + phase)
        f = f + 0.05 * rng.normal(size=(t, lines, n))
        return f.astype(np.float32), 0.5
    if kind == "random":  # fragments, bridges and breaks
        f = rng.normal(size=(t, lines, n + 4))
        f = (f[..., :-4] + f[..., 1:-3] + f[..., 2:-2] + f[..., 3:-1]) / 4
        return f.astype(np.float32), 0.1
    if kind == "line ends":  # runs touching either end, empty and full lines
        f = rng.uniform(0.0, 1.0, (t, lines, n)).astype(np.float32)
        f[:, 0] = 0.2  # empty
        f[:, 1] = 0.9  # above throughout
        f[:, 2:8, :3] = 0.95
        f[:, 4:10, -2:] = 0.97
        f[:, 10, :] = np.where(x % 2 == 0, 0.9, 0.1)  # single-pixel runs
        return f, 0.5
    if kind == "at the threshold":
        # 0.1 rounds up in float32: a pixel at float32(0.1) is above in
        # float64 (the table) and not in float32 (the run counts)
        f = rng.choice(np.float32([0.0, 0.1, np.nextafter(np.float32(0.1), 1),
                                   np.nextafter(np.float32(0.1), 0), 1.0]),
                       size=(t, lines, 37))
        return f.astype(np.float32), 0.1
    raise ValueError(kind)


KINDS = ["grating", "random", "line ends", "at the threshold"]


def _table(rise, fall, counts, row_step):
    """The valid entries of a (R, K) table as feature_table's arrays."""
    valid = torch.arange(rise.shape[-1]) < counts[:, None]
    rows = valid.nonzero()[:, 0].numpy() * row_step
    return rows, rise[valid].numpy(), fall[valid].numpy()


@pytest.mark.parametrize("row_step", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_edge_table_is_feature_tables_bit_for_bit(kind, row_step):
    fields, thr = _fields(kind)
    fields = torch.from_numpy(fields)
    runs, counts = se.edge_runs(fields, thr, row_step)
    assert runs.dtype == counts.dtype == torch.int32
    assert torch.equal(runs, ps._run_counts(fields > thr))
    k = int(counts.max())
    rise, fall = se.edge_runs(fields, thr, row_step, k)
    assert rise.shape == (3, -(-fields.shape[1] // row_step), k)
    total = 0
    for t in range(fields.shape[0]):
        ref = feature_table(fields[t].numpy(), CFG, threshold=thr,
                            row_step=row_step)
        rows, r, f = _table(rise[t], fall[t], counts[t], row_step)
        np.testing.assert_array_equal(rows, ref["row"])
        np.testing.assert_array_equal(r.view(np.int64), ref["rise_px"].view(np.int64))
        np.testing.assert_array_equal(f.view(np.int64), ref["fall_px"].view(np.int64))
        valid = torch.arange(k) < counts[t][:, None]
        assert torch.isnan(rise[t][~valid]).all() and torch.isnan(fall[t][~valid]).all()
        total += len(ref["row"])
    assert total == int(counts.sum()) > 0
    if kind == "at the threshold":  # the two compares differ somewhere
        assert not torch.equal(runs[:, ::row_step], counts)


def test_a_narrow_table_keeps_each_lines_first_runs():
    fields, thr = _fields("random")
    fields = torch.from_numpy(fields)
    _, counts = se.edge_runs(fields, thr, 2)
    k = int(counts.max())
    rise, fall = se.edge_runs(fields, thr, 2, k)
    narrow = se.edge_runs(fields, thr, 2, k - 2)
    for got, full in zip(narrow, (rise, fall)):
        assert torch.allclose(got, full[..., :k - 2], rtol=0, atol=0,
                              equal_nan=True)


def test_the_table_pass_writes_into_a_trial_slice():
    """``out=``: the rows of a wider batch's tables, written as the fresh
    tables are, the other rows untouched; a wrong width is refused."""
    fields, thr = _fields("random")
    fields = torch.from_numpy(fields)
    _, counts = se.edge_runs(fields, thr, 2)
    k = int(counts.max())
    fresh = se.edge_runs(fields, thr, 2, k)
    big = [torch.full((5, 12, k), 7.0, dtype=torch.float64) for _ in range(2)]
    got = se.edge_runs(fields, thr, 2, k, out=(big[0][1:4], big[1][1:4]))
    for whole, want, mine in zip(big, fresh, got):
        assert mine.data_ptr() == whole[1:4].data_ptr()
        assert torch.allclose(whole[1:4], want, rtol=0, atol=0, equal_nan=True)
        assert (whole[0] == 7.0).all() and (whole[4] == 7.0).all()
    with pytest.raises(ValueError, match="out"):
        se.edge_runs(fields, thr, 2, k + 1, out=(big[0][1:4], big[1][1:4]))


def _lines(image, model, trials, seed, row_step, axis=1):
    rows, runs, band = ps.exposure_summary(image, CFG, model, trials=trials,
                                           seed=seed, row_step=row_step,
                                           axis=axis, trial_chunk=3, device="cpu")
    return rows, runs, band


def _device_table(rows, thr):
    """The edge table of host-sampled cut lines (T, R, n)."""
    _, counts = se.edge_runs(rows, thr, 1)
    rise, fall = se.edge_runs(rows, thr, 1, max(1, int(counts.max())))
    return rise, fall, counts


def _image(kind: str) -> np.ndarray:
    """A 128^2 relative intensity: blurred vertical lines at 80 nm pitch
    ("lines"), or the same lines lifted and dimmed so that no deterministic
    run prints and only the noise does ("dark")."""
    x = np.arange(3 * 128)
    lines = np.where((x % 16) < 8, 1.0, 0.05)
    kernel = np.exp(-0.5 * (np.arange(-6, 7) / 1.5) ** 2)
    soft = np.convolve(lines, kernel / kernel.sum(), "same")[128:256]
    img = np.broadcast_to(soft, (128, 128)).astype(np.float32)
    return img if kind == "lines" else (0.6 + 0.4 * img).astype(np.float32)


CASES = {
    "lines": (_image("lines"), ps.StochasticResist(dose_photons_per_nm2=5.0,
                                                   diffusion_nm=8.0, threshold=0.5)),
    "starved": (_image("lines"), ps.StochasticResist(  # breaks and bridges
        dose_photons_per_nm2=0.3, diffusion_nm=3.0, threshold=0.25)),
    "dark, no anchors": (_image("dark"), ps.StochasticResist(
        dose_photons_per_nm2=0.8, diffusion_nm=4.0, threshold=1.02)),
}


def _anchors(image, model, axis, row_step):
    det = model.deterministic_field(image, CFG, device="cpu").numpy()
    centers = ps._reference_centers(det, CFG, axis=axis,
                                    threshold=model.threshold, row_step=row_step)
    anchors = (None if centers is None or not centers.size
               else torch.as_tensor(centers, dtype=torch.float64))
    return det, centers, anchors


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], rtol=REL, atol=0)


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("case", list(CASES))
def test_trial_stats_are_the_host_statistics(case, axis):
    image, model = CASES[case]
    _, centers, anchors = _anchors(image, model, axis, 2)
    assert (centers is None) == (case == "dark, no anchors")
    rows, _, _ = _lines(image, model, 8, 5, 2, axis)
    tables = ps._trial_tables(rows.numpy(), CFG, threshold=model.threshold)
    min_runs = max(4, rows.shape[1] // 8)
    host = ps._edge_stats_tables(tables, CFG, min_runs=min_runs,
                                 ref_centers=centers)
    rise, fall, counts = _device_table(rows, model.threshold)
    got = es.trial_stats(rise, fall, counts, anchors, CFG.pixel_size, min_runs)
    assert got.dtype == torch.float64 and got.shape == (8, 3)
    jax = js._edge_stats_trials(rows.numpy(), JCFG, threshold=model.threshold,
                                ref_centers=centers)
    for i in range(3):
        _close(got[:, i], host[i])
        _close(got[:, i], jax[i])
    assert np.isfinite(host[0]).sum() >= 4
    # feature ids: the host's for every run
    width = (fall - rise) * CFG.pixel_size
    center = 0.5 * (rise + fall) * CFG.pixel_size
    valid = torch.arange(rise.shape[-1]) < counts[..., None]
    fid = es._feature_ids(center, width, valid, anchors, CFG.pixel_size)
    for t, feats in enumerate(tables):
        ref = ps._assign_feature_ids(feats["center_nm"], feats["width_nm"],
                                     centers, CFG.pixel_size)
        np.testing.assert_array_equal(fid[t][valid[t]].numpy(), ref)


def test_a_trials_statistics_do_not_depend_on_its_chunk():
    """The same trial in a chunk of one, and beside others with wider
    tables (more slots, more features a line): the same bits."""
    image, model = CASES["lines"]
    _, _, anchors = _anchors(image, model, 1, 1)
    rows, _, _ = _lines(image, model, 6, 9, 1)
    rise, fall, counts = _device_table(rows, model.threshold)
    whole = es.trial_stats(rise, fall, counts, anchors, CFG.pixel_size, 8)
    for t in range(6):
        _, c = se.edge_runs(rows[t:t + 1], model.threshold, 1)
        r, f = se.edge_runs(rows[t:t + 1], model.threshold, 1, int(c.max()))
        alone = es.trial_stats(r, f, c, anchors, CFG.pixel_size, 8)
        np.testing.assert_array_equal(alone[0].numpy(), whole[t].numpy())


@pytest.mark.parametrize("band", [None, (5, 52)])
@pytest.mark.parametrize("case", [*CASES, "lines, no anchors"])
def test_traces_and_psd_are_the_hosts(case, band):
    image, model = CASES[case.split(",")[0] if case == "lines, no anchors" else case]
    _, centers, anchors = _anchors(image, model, 1, 1)
    if case == "lines, no anchors":  # complete features by the pitch path
        centers = anchors = None
    rows, _, _ = _lines(image, model, 8, 21, 1)
    lo, hi = (0, rows.shape[1] - 1) if band is None else band
    sub = rows[:, lo:hi + 1]
    n_rows = hi - lo + 1
    rise, fall, counts = _device_table(sub, model.threshold)
    traces, complete = es.band_traces(rise, fall, counts, anchors, CFG.pixel_size)
    n_edges = 0
    for t, field in enumerate(sub.numpy()):
        feats = feature_table(field, CFG, threshold=model.threshold)
        host = ps._table_traces(feats, n_rows, CFG, ref_centers=centers)
        mine = traces[t][complete[t]].reshape(-1, n_rows).numpy()
        np.testing.assert_array_equal(mine, np.reshape(host, (-1, n_rows)))
        n_edges += len(host)
    part, edges = es.psd_partial(rise, fall, counts, anchors, CFG.pixel_size, 10.0)
    assert part.shape == (8, n_rows // 2) and edges.shape == (8,)
    kw = dict(threshold=model.threshold, spacing_nm=10.0, ref_centers=centers,
              fit=False, row_band=(lo, hi))
    for t in range(8):  # each trial's own edges
        assert int(edges[t]) == ps.edge_psd(rows[t:t + 1].numpy(), CFG, **kw)["n_edges"]
    ref = ps.edge_psd(rows.numpy(), CFG, **kw)
    jax = js.edge_psd(rows.numpy(), JCFG, **kw)
    assert int(edges.sum()) == ref["n_edges"] == jax["n_edges"] == n_edges
    assert (n_edges > 0) == (case != "dark, no anchors")
    _close(es.tree_sum(part, 0).numpy(), ref["psd_nm3"] * ref["n_edges"])
    _close(es.tree_sum(part, 0).numpy(), jax["psd_nm3"] * jax["n_edges"])


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("case", list(CASES))
def test_ensemble_is_the_host_path(case, axis):
    """``stochastic_ensemble`` against the numpy path on the same trials
    (``exposure_summary``'s rows, runs and band): break and bridge counts
    and the print probability exactly, LER, LWR, LCDU, CD and the PSD
    within rel 1e-12."""
    image, model = CASES[case]
    kw = dict(trials=7, seed=4, row_step=2, axis=axis)
    out = ps.stochastic_ensemble(image, CFG, model, psd=True, trial_chunk=3,
                                 device="cpu", **kw)
    det, centers, _ = _anchors(image, model, axis, 2)
    rows, runs, band = _lines(image, model, **{k: kw[k] for k in
                                               ("trials", "seed", "row_step", "axis")})
    rows, runs = rows.numpy(), runs.numpy()
    tables = ps._trial_tables(rows, CFG, threshold=model.threshold)
    stats = ps._aggregate_edge_stats(*ps._edge_stats_tables(
        tables, CFG, min_runs=max(4, rows.shape[1] // 8), ref_centers=centers))
    for key, value in stats.items():
        _close(out[key], value)
    ref = det > model.threshold
    ref = ref if axis == 1 else ref.T
    pad = np.pad(ref, ((0, 0), (1, 1))).astype(np.int8)
    ref_runs = (np.diff(pad, axis=1) == 1).sum(axis=1)
    live = ref_runs > 0
    cells = int(live.sum()) * kw["trials"]
    if cells:
        assert out["break_rate"] == (runs[:, live] > ref_runs[live]).sum() / cells
        assert out["bridge_rate"] == (runs[:, live] < ref_runs[live]).sum() / cells
    else:
        assert out["break_rate"] == out["bridge_rate"] == 0.0
    if case == "starved" and axis == 1:
        assert out["break_rate"] > 0 and out["bridge_rate"] > 0
    prob = band.numpy() / kw["trials"]
    np.testing.assert_array_equal(out["print_probability"],
                                  (prob if axis == 1 else prob.T).astype(np.float32))
    det_rows = (det if axis == 1 else det.T)[::2]
    psd_band = ps._print_band(det_rows, CFG, threshold=model.threshold,
                              ref_centers=centers)
    lo, hi = (0, rows.shape[1] - 1) if psd_band is None else psd_band
    if hi - lo + 1 < 8:  # too few lines for a PSD (the lines along the cut)
        assert out["psd"]["n_edges"] == 0 and case != "dark, no anchors"
        return
    spec = ps.edge_psd(rows, CFG, threshold=model.threshold, spacing_nm=10.0,
                       ref_centers=centers, fit=True, row_band=(lo, hi))
    assert out["psd"]["n_edges"] == spec["n_edges"]
    for key in ("psd_nm3", "sigma_nm", "ler_3s_nm", "acf_corr_length_nm"):
        if spec["n_edges"]:
            _close(out["psd"][key], spec[key])


def _same(a, b, rtol=0.0):
    for key in a:
        if isinstance(a[key], dict):
            _same(a[key], b[key], rtol)
        else:
            np.testing.assert_allclose(a[key], b[key], rtol=rtol, atol=0)


def test_a_dense_ensemble_keeps_its_bits_within_its_budgets(monkeypatch):
    """Noisy lines, a run every 5 px or so, whose later trial chunks widen
    the tables: with the statistics' blocks taken a trial at a time, and
    with host chunks of two trials sized by the edge tables at their most,
    the ensemble gives the single pass's numbers (bit for bit; the PSD, a
    float64 sum of per-chunk partials on the host, within 1e-12), and no
    host chunk holds more than half the budget in tables and run counts
    (the other half is for the copy that widens them)."""
    x = np.arange(128)
    image = np.broadcast_to(np.where((x % 16) < 8, 1.0, 0.7),
                            (128, 128)).astype(np.float32)
    model = ps.StochasticResist(dose_photons_per_nm2=0.3, diffusion_nm=0.5,
                                threshold=0.8)
    kw = dict(trials=5, seed=1, row_step=2, psd=True, trial_chunk=2, device="cpu")
    rows, _, _ = _lines(image, model, 5, 1, 2)
    _, counts = se.edge_runs(rows, model.threshold, 1)
    assert int(counts.max()) >= 128 // 4 and float(counts.double().mean()) >= 20
    widened, widen = [], ps._widen

    def spy_widen(table, filled, k):
        widened.append(filled)
        return widen(table, filled, k)

    monkeypatch.setattr(ps, "_widen", spy_widen)
    single = ps.stochastic_ensemble(image, CFG, model, **kw)
    assert single["psd"]["n_edges"] > 0 and np.isfinite(single["ler_nm"])
    assert max(widened) > 0  # a later trial chunk widened the tables
    monkeypatch.setattr(es, "_BLOCK_BYTES", 0)
    _same(ps.stochastic_ensemble(image, CFG, model, **kw), single)
    monkeypatch.undo()
    budget = 2 * ps._trial_bytes(128, 2, edges=True)
    monkeypatch.setattr(ps, "_SUMMARY_BYTES", budget)
    held, summary = [], ps._edge_summary

    def spy(*args):
        runs, counts, rise, fall, band = out = summary(*args)
        held.append(runs.nbytes + counts.nbytes + rise.nbytes + fall.nbytes)
        return out

    monkeypatch.setattr(ps, "_edge_summary", spy)
    streamed = ps.stochastic_ensemble(image, CFG, model, **kw)
    # twice the tables fit: the tables and a copy while they widen
    assert len(held) == 3 and 2 * max(held) <= budget
    _same(streamed.pop("psd"), single.pop("psd"), rtol=1e-12)
    _same(streamed, single)


def test_tree_sum_ignores_zero_padding():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(5, 13)))
    s = es.tree_sum(x, 1)
    for pad in (3, 19, 51):
        wide = torch.cat([x, torch.zeros(5, pad, dtype=x.dtype)], dim=1)
        assert torch.equal(es.tree_sum(wide, 1), s)
    np.testing.assert_allclose(s.numpy(), x.numpy().sum(axis=1), rtol=1e-14)
    assert es.tree_sum(x[:, :0], 1).tolist() == [0.0] * 5
