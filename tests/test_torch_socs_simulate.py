"""Port parity: simulate(solver='socs'), simulate_batch, the SOCS artifacts
and the socs CLI of the torch port (device='cpu') against the JAX package.

The SOCS builds draw the port's own torch.Generator probes, so the images
are held as the JAX tests hold theirs (test_socs_bound.py:169-243): the
same report keys, the same chosen rank, and the reported
socs_image_nrms_bound above the error measured against the exact JAX
image. Exact-solver batches match JAX to 1e-6 nRMS; a kernel set saved by
either package loads into the other unchanged.
"""

import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.ops import hopkins as jh
from lithographysimulator_tpu.utils import artifacts as ja
from lithographysimulator_tpu_torch import cli as pcli
from lithographysimulator_tpu_torch.interop import config_from_jax
from lithographysimulator_tpu_torch.utils import artifacts as pa

from .conftest import normalized_rms

psim = importlib.import_module("lithographysimulator_tpu_torch.simulate")

CFG = jt.OpticsConfig(pixel_number=64)
PCFG = config_from_jax(CFG)
ABERR = np.array([0, 0, 0.01, 0, 100, 0.01, 0, 0.01, 0.01, 0.01], np.float32)
SRC = np.asarray(jt.LightSource(CFG, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8))


def _np(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def demo():
    """The 64^2 demo (test_socs_bound.py:32-41): port mask, JAX mask and
    the exact JAX image."""
    jmask = jt.demo_bars(CFG)
    exact = np.asarray(jt.simulate(jmask, SRC, ABERR, solver="gau23").image)
    return pt.demo_bars(PCFG, device="cpu"), jmask, exact


def _socs(mask, **kw):
    return pt.simulate(mask, SRC, ABERR, device="cpu", solver="socs", **kw)


@pytest.mark.parametrize("kw", [dict(socs_rank=24), dict(),
                                dict(socs_tolerance=5e-3)],
                         ids=["pinned", "auto", "tolerance"])
def test_simulate_socs_report_matches_jax(demo, kw):
    mask, jmask, exact = demo
    ours = _socs(mask, **kw)
    ref = jt.simulate(jmask, SRC, ABERR, solver="socs", **kw)
    assert set(ours.report) == set(ref.report)
    assert ours.report["socs_rank"] == ref.report["socs_rank"]
    assert ours.report["socs_energy_captured"] == pytest.approx(
        ref.report["socs_energy_captured"], rel=1e-4)
    for key in ("source_points", "fft_size", "beta", "epsilon", "solver"):
        assert ours.report[key] == ref.report[key]
    bound = ours.report["socs_image_nrms_bound"]
    assert 0 < bound and normalized_rms(_np(ours.image), exact) <= bound
    if "socs_tolerance" in kw:
        assert ours.report["socs_tolerance"] == kw["socs_tolerance"]
        assert bound <= kw["socs_tolerance"]
    assert ours.image.shape == (64, 64) and ours.image.dtype == torch.float32


def test_simulate_socs_cache_and_normalization(demo):
    """A second run reuses the cached kernels (same image, no new build);
    normalize=True divides by the source weight and reports the same
    scale-invariant bound (test_socs_bound.py:234-243)."""
    mask, _, _ = demo
    a = _socs(mask, socs_rank=16)
    size = len(psim._SOCS_BUILD_CACHE)
    b = _socs(mask, socs_rank=16)
    assert len(psim._SOCS_BUILD_CACHE) == size
    np.testing.assert_array_equal(_np(a.image), _np(b.image))
    c = _socs(mask, socs_rank=16, normalize=True)
    np.testing.assert_allclose(_np(c.image), _np(a.image) / SRC.sum(dtype=np.float64),
                               rtol=1e-6, atol=0)
    assert c.report["socs_image_nrms_bound"] == pytest.approx(
        a.report["socs_image_nrms_bound"], rel=1e-4)


def test_socs_cache_is_bounded_in_bytes(demo, monkeypatch):
    """The kernels stay on their device, so the build cache evicts its
    oldest entries once their bytes pass the cap (the newest stays)."""
    mask, _, _ = demo
    one = 8 * 64 * 64 * 8  # a rank-8 kernel set at 64^2
    monkeypatch.setattr(psim, "_SOCS_BUILD_CACHE", {})
    monkeypatch.setattr(psim, "_SOCS_BUILD_CACHE_BYTES", 2.5 * one)
    for k in range(4):
        pt.simulate(mask, SRC, [0, 0, 0, 0, float(k)], device="cpu",
                    solver="socs", socs_rank=8)
    kept = [key[2] for key in psim._SOCS_BUILD_CACHE]
    assert kept == [np.asarray([0, 0, 0, 0, k], np.float32).tobytes() for k in (2, 3)]
    monkeypatch.setattr(psim, "_SOCS_BUILD_CACHE_BYTES", 0.5 * one)
    pt.simulate(mask, SRC, [0, 0, 0, 0, 9.0], device="cpu", solver="socs", socs_rank=8)
    assert len(psim._SOCS_BUILD_CACHE) == 1


def _counts_since(before):
    after = psim.socs_cache_counts()
    return {k: after[k] - before[k] for k in after}


@pytest.fixture
def fresh_cache(monkeypatch):
    monkeypatch.setattr(psim, "_SOCS_BUILD_CACHE", {})
    monkeypatch.setattr(psim, "_SOURCE_KEY_MEMO", None)


def test_source_key_is_the_maps_bytes(fresh_cache):
    """The key memo gives a map's tobytes() and reuses the last key exactly
    when the bytes are the same: a float64 copy of the values, a flipped
    zero's sign, a strided view and a transposed map are other bytes."""
    src = SRC.astype(np.float32)
    flipped = src.copy()
    flipped[0, 0] = -0.0 if flipped[0, 0] == 0 else 0.0
    maps = [src, src.copy(), src.astype(np.float64), flipped, src[:, ::2],
            src.T, np.ascontiguousarray(src.T), src[:3, :3]]
    reused = []
    for a in maps:
        before = psim.socs_cache_counts()["key_reuses"]
        assert psim._source_key(a) == a.tobytes()
        reused.append(psim.socs_cache_counts()["key_reuses"] - before)
    assert reused == [0, 1, 0, 0, 0, 0, 1, 0]


def test_warm_calls_reuse_the_key_and_the_bound_terms(demo, fresh_cache):
    """Two warm calls with one source: each counts one key reuse and one
    bound from the entry's terms, reports the live source points as
    source_points does, and gives the image of the kernel set's own apply
    bit for bit, with the public bound (terms taken afresh)."""
    from lithographysimulator_tpu_torch.ops.fraunhofer import mask_spectrum

    mask, _, _ = demo
    _socs(mask, socs_rank=16)  # builds
    before = psim.socs_cache_counts()
    warm = [_socs(mask, socs_rank=16) for _ in range(2)]
    assert _counts_since(before) == {"hits": 2, "misses": 0, "evictions": 0,
                                     "key_reuses": 2, "bound_from_entry": 2}
    entry = psim._socs_kernels_cached(PCFG, SRC, ABERR, 16, device="cpu")
    spectrum = mask_spectrum(mask.geometry, PCFG, solver="gau23")
    image = pt.socs_image(spectrum, entry.socs, PCFG)
    bound = pt.socs_image_nrms_bound(entry.socs, spectrum, image,
                                     pupil=entry.pupil, source_map=SRC,
                                     config=PCFG)
    for res in warm:
        assert res.report["source_points"] == pt.source_points(SRC).live_count
        assert torch.equal(res.image, image)
        assert res.report["socs_image_nrms_bound"] == pytest.approx(bound, rel=1e-5)


def test_source_changed_in_place_misses_the_key_memo(demo, fresh_cache,
                                                     monkeypatch):
    """The caller's source array changed in place between two calls: the
    second misses the key memo and the cache, and its image and report are
    those of a fresh cache given the changed map."""
    mask, _, _ = demo
    src = SRC.astype(np.float32)
    pt.simulate(mask, src, ABERR, device="cpu", solver="socs", socs_rank=8)
    src[:, : src.shape[1] // 2] = 0  # two of the four poles go dark
    before = psim.socs_cache_counts()
    got = pt.simulate(mask, src, ABERR, device="cpu", solver="socs", socs_rank=8)
    counts = _counts_since(before)
    assert counts["key_reuses"] == 0 and counts["misses"] == 1
    monkeypatch.setattr(psim, "_SOCS_BUILD_CACHE", {})
    monkeypatch.setattr(psim, "_SOURCE_KEY_MEMO", None)
    fresh = pt.simulate(mask, src.copy(), ABERR, device="cpu", solver="socs",
                        socs_rank=8)
    assert torch.equal(got.image, fresh.image)
    assert got.report["source_points"] == pt.source_points(src).live_count
    for key in ("source_points", "socs_energy_captured", "socs_image_nrms_bound"):
        assert got.report[key] == fresh.report[key]


def test_alternating_sources_reuse_nothing_stale(demo, fresh_cache):
    """Two sources in turn (A B A B): no call reuses the other's key, each
    repeat hits its own entry with its first call's image and report; then
    A twice reuses the key once."""
    mask, _, _ = demo
    sources = [SRC, np.asarray(jt.LightSource(CFG, sigma_out=0.6).annular())]
    runs = []
    before = psim.socs_cache_counts()
    for i in (0, 1, 0, 1):
        runs.append(pt.simulate(mask, sources[i], ABERR, device="cpu",
                                solver="socs", socs_rank=8))
    counts = _counts_since(before)
    assert counts["key_reuses"] == 0
    assert (counts["misses"], counts["hits"]) == (2, 2)
    for first, again in ((runs[0], runs[2]), (runs[1], runs[3])):
        assert torch.equal(first.image, again.image)
        assert first.report["socs_image_nrms_bound"] == again.report["socs_image_nrms_bound"]
        assert first.report["source_points"] == again.report["source_points"]
    assert runs[0].report["source_points"] != runs[1].report["source_points"]
    before = psim.socs_cache_counts()
    for _ in range(2):
        pt.simulate(mask, sources[0], ABERR, device="cpu", solver="socs",
                    socs_rank=8)
    assert _counts_since(before)["key_reuses"] == 1


def test_simulate_socs_rejections(demo):
    mask, _, _ = demo
    with pytest.raises(ValueError, match="socs_rank='auto'"):
        _socs(mask, socs_rank=16, socs_tolerance=1e-3)
    with pytest.raises(ValueError, match="solver='socs'"):
        pt.simulate(mask, SRC, ABERR, device="cpu", socs_tolerance=1e-3)
    with pytest.raises(AttributeError):  # a mask3d model needs an .apply
        _socs(mask, mask3d=1)


def test_simulate_socs_dark_source(demo):
    """An all-dark source: zero kernels, a zero image, energy 1 and a zero
    bound, on the pinned and the automatic rank."""
    mask, _, _ = demo
    for kw in (dict(socs_rank=4), dict()):
        res = pt.simulate(mask, np.zeros_like(SRC), device="cpu", solver="socs",
                          normalize=True, **kw)
        assert float(res.image.abs().max()) == 0.0
        assert res.report["socs_energy_captured"] == 1.0
        assert res.report["socs_image_nrms_bound"] == 0.0


def _geometries():
    g = np.asarray(jt.demo_bars(CFG).geometry)
    return np.stack([g, g.T])


@pytest.mark.parametrize("solver", ["gau23", "direct"])
def test_simulate_batch_exact_solvers_match_jax(solver):
    cfg = jt.OpticsConfig(pixel_number=32)
    src = np.asarray(jt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8))
    g = np.asarray(jt.demo_bars(cfg).geometry)
    geoms = np.stack([g, g.T])
    ref = np.asarray(jt.simulate_batch(geoms, cfg, src, ABERR, solver=solver))
    ours = _np(pt.simulate_batch(geoms, config_from_jax(cfg), src, ABERR,
                                 device="cpu", solver=solver))
    assert ours.shape == (2, 32, 32)
    for b in range(2):
        assert normalized_rms(ours[b], ref[b]) < 1e-6


def test_simulate_batch_socs(demo):
    """One kernel set for the whole batch: each image equals simulate() on
    its mask (the same cached kernels) and stays within the bound of the
    exact JAX batch."""
    geoms = _geometries()
    ours = _np(pt.simulate_batch(geoms, PCFG, SRC, ABERR, device="cpu",
                                 solver="socs", socs_rank=24))
    exact = np.asarray(jt.simulate_batch(geoms, CFG, SRC, ABERR))
    for b in range(2):
        single = pt.simulate(pt.from_array(geoms[b], PCFG, device="cpu"), SRC,
                             ABERR, device="cpu", solver="socs", socs_rank=24)
        np.testing.assert_array_equal(ours[b], _np(single.image))
        assert normalized_rms(ours[b], exact[b]) <= single.report["socs_image_nrms_bound"]
    with pytest.raises(ValueError, match="geometries"):
        pt.simulate_batch(geoms[0], PCFG, SRC, device="cpu")


# --- artifacts ------------------------------------------------------------------

def test_socs_npz_crosses_both_ways(tmp_path):
    pup = jt.pupil_function(ABERR, CFG)
    js = jh.tcc_eigensystem(pup, SRC, CFG, rank=8)
    ja.save_socs(tmp_path / "jax.npz", js)
    ours = pa.load_socs(tmp_path / "jax.npz", device="cpu")
    np.testing.assert_array_equal(_np(ours.kernels), np.asarray(js.kernels))
    np.testing.assert_array_equal(_np(ours.eigenvalues), np.asarray(js.eigenvalues))
    assert ours.total_rank == js.total_rank

    ps = pt.tcc_eigensystem(torch.as_tensor(np.asarray(pup)), SRC, PCFG, rank=8)
    path = pa.save_socs(tmp_path / "port", ps)
    assert path.name == "port.npz" and path.exists()
    back = ja.load_socs(path)
    np.testing.assert_array_equal(np.asarray(back.kernels), _np(ps.kernels))
    np.testing.assert_array_equal(np.asarray(back.eigenvalues), _np(ps.eigenvalues))
    assert back.total_rank == ps.total_rank


def test_socs_cache_fingerprint_and_images(tmp_path):
    fp = pa.config_fingerprint(PCFG, source="quasar", rank=8)
    assert fp == ja.config_fingerprint(CFG, source="quasar", rank=8)
    cache = pa.SOCSCache(tmp_path / "cache", device="cpu")
    assert cache.get(fp) is None
    ps = pt.tcc_eigensystem(torch.as_tensor(np.asarray(jt.pupil_function(ABERR, CFG))),
                            SRC, PCFG, rank=4)
    cache.put(fp, ps)
    hit = cache.get(fp)
    np.testing.assert_array_equal(_np(hit.kernels), _np(ps.kernels))
    assert ja.SOCSCache(tmp_path / "cache").get(fp).rank == 4
    img = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    pa.save_image(tmp_path / "img.npy", img, {"solver": "socs"})
    np.testing.assert_array_equal(pa.load_image(tmp_path / "img.npy"), _np(img))
    assert json.loads((tmp_path / "img.report.json").read_text()) == {"solver": "socs"}


# --- CLI ------------------------------------------------------------------------

def _last_json(out: str) -> dict:
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


def test_cli_socs_subcommand(tmp_path, capsys):
    """The socs subcommand runs in-process on the CPU, prints the JAX CLI's
    JSON keys and writes a .npz that the JAX package loads."""
    from lithographysimulator_tpu import cli as jcli

    common = ["--pixel-number", "32", "--rank", "8", "--aberrations", "0", "0", "0.02"]
    out = tmp_path / "k.npz"
    assert pcli.main(["socs", "--device", "cpu", "--lean", "on", "--out", str(out),
                      *common]) == 0
    ours = _last_json(capsys.readouterr().out)
    assert jcli.main(["socs", *common]) == 0
    ref = _last_json(capsys.readouterr().out)
    assert set(ours) == set(ref)
    assert ours["rank"] == ref["rank"] == 8 and ours["channels"] is None
    assert ours["energy_captured"] == pytest.approx(ref["energy_captured"], abs=1e-4)
    assert ja.load_socs(out).rank == 8


def test_cli_simulate_socs(tmp_path, capsys):
    out = tmp_path / "aerial.npy"
    assert pcli.main(["simulate", "--device", "cpu", "--pixel-number", "32",
                      "--solver", "socs", "--socs-rank", "12", "--out", str(out)]) == 0
    report = _last_json(capsys.readouterr().out)
    assert report["solver"] == "socs" and report["socs_rank"] == 12
    assert {"socs_energy_captured", "socs_image_nrms_bound"} <= set(report)
    assert np.load(out).shape == (32, 32)


def test_simulate_socs_bound_past_fft_size_2n():
    """R1 through simulate(): at pixel_size 2.5 nm (fft_size 16n) the
    pinned-rank report gives the sup bound, which dominates the error
    against the exact JAX image."""
    cfg = jt.OpticsConfig(pixel_number=64, pixel_size=2.5)
    src = np.asarray(jt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8))
    exact = np.asarray(jt.simulate(jt.demo_bars(cfg), src, ABERR, solver="gau23").image)
    res = pt.simulate(pt.demo_bars(config_from_jax(cfg), device="cpu"), src, ABERR,
                      device="cpu", solver="socs", socs_rank=2)
    assert normalized_rms(_np(res.image), exact) <= res.report["socs_image_nrms_bound"]


def test_cli_vector_chromatic_perturbed(capsys):
    """simulate with --polarization, --bandwidth-pm and --msd-x, and socs
    with --polarization: the JAX CLI's keys, report strings and channel
    count."""
    from lithographysimulator_tpu import cli as jcli

    common = ["--pixel-number", "32", "--na", "0.9", "--source", "classical",
              "--sigma-out", "0.5"]
    sim = ["simulate", *common, "--polarization", "x", "--bandwidth-pm", "0.3",
           "--chromatic-samples", "3", "--msd-x", "5"]
    assert pcli.main([*sim, "--device", "cpu"]) == 0
    ours = _last_json(capsys.readouterr().out)
    assert jcli.main(sim) == 0
    ref = _last_json(capsys.readouterr().out)
    assert set(ours) == set(ref)
    for key in ("polarization", "chromatic", "perturbation", "source_points"):
        assert ours[key] == ref[key]
    # at NA 0.6 one of the six unpolarized channels is exactly redundant
    socs = ["socs", "--pixel-number", "32", "--na", "0.6", "--rank", "16",
            "--polarization", "unpolarized"]
    assert pcli.main([*socs, "--device", "cpu"]) == 0
    ours = _last_json(capsys.readouterr().out)
    assert jcli.main(socs) == 0
    ref = _last_json(capsys.readouterr().out)
    assert set(ours) == set(ref)
    assert ours["channels"] == ref["channels"] and ours["channels"] is not None
    assert ours["rank"] == ref["rank"] == 16
    assert ours["energy_captured"] == pytest.approx(ref["energy_captured"], rel=1e-3)
