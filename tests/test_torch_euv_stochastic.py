"""The EUV stochastic print (``euv1024.stochastic64``) at CPU sizes: the
port's ``stochastic_ensemble`` against the plain float64 reference
(``litho_bench/reference/stochastic.py``, which imports nothing of the
port and draws the same photon counts), the comparison's controls, the
EUV SOCS image (the pupil's edge at NA/lambda, flare and stage blur)
against its float64 reference (``litho_bench/reference/euv.py``), and the
ensemble's spans and counters.

Sizes: 64^2 to 128^2 clips at the configuration's 1 nm pixels, 4 to 8
trials, seeded gratings and seeded random images; the comparison's limits
are the configuration's own.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lithographysimulator_tpu_torch as pt
from litho_bench import judge, program
from litho_bench import stochastic_controls as sc
from litho_bench.drivers import stochastic_stream as drv
from litho_bench.reference import euv
from litho_bench.reference import optics as ro
from litho_bench.reference import stochastic as rst
from litho_bench.reference import vector as rv
from lithographysimulator_tpu_torch.models import stochastic as ps
from lithographysimulator_tpu_torch.models.resist import feature_table
from lithographysimulator_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
EUV = json.loads((ROOT / "litho_bench" / "configs" / "euv1024.json").read_text())
TRAFFIC = json.loads((ROOT / "litho_bench" / "traffic" / "stochastic64.json")
                     .read_text())
LIMITS = {**EUV["limits"], **EUV["ensemble_limits"]}
SEEDS = (2**31 + 3, 2**40 + 11)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(n: int, rank: int = 16) -> dict:
    return dict(EUV, pixel_number=n, socs_rank=rank,
                reference={"oversample": 32, "iterations": 4})


def _traffic(trials: int) -> dict:
    return dict(TRAFFIC, pool=4, trials=trials, trial_chunk=3)


def _grating_image(cfg: dict, seed: int) -> torch.Tensor:
    geometry, _ = sc.case(cfg, _traffic(4), seed, "cpu")
    return sc.image(cfg, geometry, "cpu")


def _random_image(n: int, seed: int) -> torch.Tensor:
    """A seeded smooth random intensity: low-passed noise, squared."""
    gen = torch.Generator().manual_seed(seed)
    noise = torch.randn((n, n), generator=gen, dtype=torch.float64)
    field = rst.blur(noise, 1.0, 5.0)
    return (field * field + 0.05 * field.abs().max() ** 2).to(torch.float32)


def _line_image(n: int) -> torch.Tensor:
    """Two-beam lines along y at 32 nm pitch."""
    x = torch.arange(n, dtype=torch.float32)
    lines = 0.5 + 0.45 * torch.cos(2 * np.pi * x / 32)
    return lines[None, :].expand(n, n).contiguous()


def _program(cfg, img, s, trials, **resist_over):
    return pt.stochastic_ensemble(img, drv.optics(cfg),
                                  drv.resist(cfg, **resist_over), trials=trials,
                                  seed=s, trial_chunk=3, psd=True)


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("kind", ["grating", "random"])
def test_ensemble_matches_the_float64_reference(n, kind):
    """Every output the judge compares, within the configuration's
    limits, on the same image and seed."""
    cfg = _cfg(n)
    seed = SEEDS[0] + n
    img = _grating_image(cfg, seed) if kind == "grating" else _random_image(n, seed)
    if kind == "random":  # print the brightest 40% of the clip
        det = rst.deterministic(img, cfg["resist"], cfg["pixel_nm"])
        cfg = dict(cfg, resist=dict(cfg["resist"],
                                    threshold=float(torch.quantile(det, 0.6))))
    ens = _program(cfg, img, seed, 6)
    ref = rst.ensemble(img, cfg, seed=seed, trials=6)
    errors = drv.ensemble_errors(ens, ref)
    assert set(errors) == set(drv.CHECKS)
    if kind == "grating":
        assert ref["psd"]["n_edges"] > 0
    assert sc.failed(errors, LIMITS) == [], errors
    assert ref["lines"] >= 1
    assert ens["psd"]["n_edges"] == ref["psd"]["n_edges"]


def test_the_reference_draws_the_programs_counts():
    """Trial i of seed s: the same generator seed and the same float32
    mean, so the same Poisson counts as the port's ``trial_generator``."""
    img = _random_image(64, 5)
    mean = rst.photon_mean(img, EUV["resist"], 1.0)
    for trial in (0, 3):
        gen = ps.trial_generator(SEEDS[1], trial, "cpu")
        rel = img / img.max()
        ours = torch.poisson((EUV["resist"]["dose_photons_per_nm2"] * rel)[None],
                             generator=gen)[0]
        assert torch.equal(rst.draw(mean, SEEDS[1], trial), ours)


@pytest.mark.parametrize("control", ["gaussian noise", "no PAG saturation",
                                     "diffusion +10%", "fewer trials"])
def test_each_ensemble_control_fails_a_check(control):
    cfg = _cfg(128)
    seed = SEEDS[1]
    img = _grating_image(cfg, seed)
    over = {"gaussian noise": {"noise": "gaussian"},
            "no PAG saturation": {"pag_per_nm2": 0.0},
            "diffusion +10%": {"diffusion_nm": 1.1 * cfg["resist"]["diffusion_nm"]},
            "fewer trials": {}}[control]
    trials = 7 if control == "fewer trials" else 8
    ref = rst.ensemble(img, cfg, seed=seed, trials=8)
    sound = drv.ensemble_errors(_program(cfg, img, seed, 8), ref)
    assert sc.failed(sound, LIMITS) == []
    assert sc.failed(drv.ensemble_errors(_program(cfg, img, seed, trials, **over),
                                         ref), LIMITS)


def _image_errors(cfg, geometry, image, kernels):
    ref = euv.image(geometry, *kernels, cfg)
    return {"image_nrms": ro.nrms(image, ref),
            "broadband_nrms": judge.broadband(cfg, image, ref)}


@pytest.mark.parametrize("n", [64, 128])
def test_euv_socs_image_matches_the_float64_reference(n):
    """``simulate(solver='socs')`` with the edge at NA/lambda, flare and
    stage blur, against the float64 SOCS image of the same kernel count."""
    cfg = _cfg(n)
    kernels = euv.kernel_set(cfg, "cpu")
    for seed in SEEDS:
        geometry, _ = sc.case(cfg, _traffic(4), seed, "cpu")
        errors = _image_errors(cfg, geometry, sc.image(cfg, geometry, "cpu"),
                               kernels)
        assert sc.failed(errors, EUV["limits"]) == [], errors


@pytest.mark.parametrize("control", ["rank cut by a quarter",
                                     "pupil edge at 1/lambda", "no perturbation"])
def test_each_image_control_fails_a_check(control):
    cfg = _cfg(128)
    kernels = euv.kernel_set(cfg, "cpu")
    geometry, _ = sc.case(cfg, _traffic(4), SEEDS[0], "cpu")
    if control == "rank cut by a quarter":
        image = sc.image(cfg, geometry, "cpu", rank=12)
    elif control == "pupil edge at 1/lambda":
        image = sc.image(cfg, geometry, "cpu", pupil_at_na=False)
    else:
        oc = drv.optics(cfg)
        image = pt.simulate(pt.Mask(geometry=geometry, config=oc),
                            rv.dipole_source(cfg), program.aberrations(cfg),
                            solver="socs", socs_rank=16, device="cpu").image
    assert sc.failed(_image_errors(cfg, geometry, image, kernels), EUV["limits"])


def _traced(fn):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.recording()


def _tree(rec) -> dict:
    names = {}
    for s in rec["spans"]:
        names.setdefault(s["name"], []).append(s)
    return names


def test_ensemble_spans_nest_under_the_call():
    cfg = _cfg(64)
    img = _line_image(64)
    _, rec = _traced(lambda: _program(cfg, img, 1, 4))
    names = _tree(rec)
    assert set(names) == {"litho.stochastic", "litho.stochastic.deterministic",
                          "litho.stochastic.trials", "litho.stochastic.readback",
                          "litho.stochastic.edges", "litho.stochastic.psd"}
    (root,) = names["litho.stochastic"]
    assert root["attrs"] == {"trials": 4, "n": 64}
    for name, spans in names.items():
        if name != "litho.stochastic":
            assert all(s["parent"] == root["id"] for s in spans)
    # one host chunk: its chain, read-back, edges and PSD, then the fit
    assert [len(names[f"litho.stochastic.{k}"]) for k in
            ("deterministic", "trials", "readback", "edges", "psd")] == [1, 1, 1, 1, 2]
    order = [names[f"litho.stochastic.{k}"][0]["start_ns"] for k in
             ("deterministic", "trials", "readback", "edges", "psd")]
    assert order == sorted(order)


@pytest.mark.parametrize("fn", ["volume", "psd"])
def test_volume_and_psd_spans(fn):
    cfg = _cfg(64)
    oc = drv.optics(cfg)
    model = drv.resist(cfg)
    img = _line_image(64)
    if fn == "volume":
        stack = torch.stack([img, 0.8 * img])
        _, rec = _traced(lambda: pt.stochastic_volume_ensemble(
            stack, oc, model, dz_nm=10.0, trials=3, trial_chunk=2))
        kids = {"deterministic", "trials", "readback", "edges"}
    else:
        _, rec = _traced(lambda: pt.stochastic_psd(img, oc, model, trials=3))
        kids = {"deterministic", "trials", "readback", "psd"}
    names = _tree(rec)
    assert set(names) == {"litho.stochastic"} | {f"litho.stochastic.{k}" for k in kids}
    (root,) = names["litho.stochastic"]
    assert all(s["parent"] == root["id"] for k, v in names.items()
               if k != "litho.stochastic" for s in v)


@pytest.mark.parametrize("host_trials", [None, 2])
def test_counters_count_the_trials_and_the_bytes_read_back(monkeypatch,
                                                            host_trials):
    """``stochastic.trials``, ``stochastic.readback_bytes`` and
    ``stochastic.edge_runs``: the trials run; the deterministic field, and
    a host chunk's largest run count a trial chunk (4 bytes), band, three
    float64 statistics a trial and three int64 tallies; and the runs the
    edge tables hold, traced or not. The trace's tally holds the same."""
    n, trials, row_step, trial_chunk = 64, 5, 2, 2
    if host_trials is not None:
        monkeypatch.setattr(ps, "_SUMMARY_BYTES", host_trials
                            * ps._trial_bytes(n, row_step, edges=True))
        assert ps._host_chunk(n, row_step, trials, edges=True) == host_trials
    chunks = [min(host_trials or trials, trials - s)
              for s in range(0, trials, host_trials or trials)]
    expected = 4 * n * n + sum(4 * -(-m // trial_chunk) + 4 * n * n + 24 * m + 24
                               for m in chunks)
    cfg = _cfg(n)
    img = _line_image(n)
    kw = dict(trials=trials, seed=3, row_step=row_step, trial_chunk=trial_chunk)
    model = drv.resist(cfg)
    lines = ps.exposure_summary(img, drv.optics(cfg), model, **kw)[0].numpy()
    runs = sum(len(feature_table(line, drv.optics(cfg), threshold=model.threshold)["row"])
               for line in lines)
    assert runs > 0
    before = ps.stochastic_counts()
    pt.stochastic_ensemble(img, drv.optics(cfg), model, **kw)
    mid = ps.stochastic_counts()
    assert mid["trials"] - before["trials"] == trials
    assert mid["readback_bytes"] - before["readback_bytes"] == expected
    assert mid["edge_runs"] - before["edge_runs"] == runs
    _, rec = _traced(lambda: pt.stochastic_ensemble(img, drv.optics(cfg), model,
                                                    **kw))
    after = ps.stochastic_counts()
    assert after["trials"] - mid["trials"] == trials
    assert rec["counters"] == {"stochastic.trials": trials,
                               "stochastic.readback_bytes": expected,
                               "stochastic.edge_runs": runs}


def test_spans_leave_the_ensemble_bit_for_bit():
    """A traced and an untraced call give the same numbers."""
    cfg = _cfg(64)
    img = _line_image(64)
    plain = _program(cfg, img, 7, 4)
    traced, _ = _traced(lambda: _program(cfg, img, 7, 4))
    for key in ("ler_nm", "lwr_nm", "lcdu_nm", "mean_cd_nm", "bridge_rate",
                "break_rate", "deterministic_cd_nm"):
        assert plain[key] == traced[key] or (np.isnan(plain[key]) and np.isnan(traced[key]))
    np.testing.assert_array_equal(plain["print_probability"],
                                  traced["print_probability"])
    np.testing.assert_array_equal(plain["psd"]["psd_nm3"], traced["psd"]["psd_nm3"])
