"""The EUV stochastic cell (``euv1024.stochastic64``): a whole small run on
the CPU (set-up, window, comparison, the per-layer readers), the roofline
count of the trials, the readers on a made-up recording, and the
comparison's controls (:mod:`litho_bench.stochastic_controls`).

On the CPU the cell runs at 128^2 with rank 16, 8 trials and 4 masks; on
a card the controls run at the cell's own size over three seeds, each
printed beside the limits:
``python -m pytest litho_bench/tests/test_stochastic_stream.py -m cuda -s``.
"""

from __future__ import annotations

import time

import pytest

from conftest import ROOT, load, write

CELL = "euv1024.stochastic64"
SEEDS = (2**31 + 3, 911, 2**33 + 17)
SMALL = {"pixel_number": 128, "socs_rank": 16,
         "reference": {"oversample": 32, "iterations": 4}}
SMALL_TRAFFIC = {"pool": 4, "trials": 8, "trial_chunk": 3, "sample": 2}
MS = 1_000_000


def _limits(cfg: dict) -> dict:
    return {**cfg["limits"], **cfg["ensemble_limits"]}


@pytest.fixture
def small_bench(tmp_path):
    """A scratch checkout whose stochastic cell runs at CPU size."""
    import shutil

    shutil.copytree(ROOT / "litho_bench", tmp_path / "litho_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = load(ROOT / "BENCHMARK.json")
    cfg_path = tmp_path / "litho_bench" / "configs" / "euv1024.json"
    write(cfg_path, {**load(cfg_path), **SMALL})
    tr_path = tmp_path / "litho_bench" / "traffic" / "stochastic64.json"
    write(tr_path, {**load(tr_path), **SMALL_TRAFFIC})
    write(tmp_path / "BENCHMARK.json", bench)
    return tmp_path, tmp_path / "litho_bench", bench


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct_and_reads_its_metrics(small_bench, trace):
    from litho_bench import harness

    root, bench_dir, bench = small_bench
    out = harness.run(bench, root, CELL, 2**31 + 29, 1.0, trace, device="cpu",
                      t_start=time.perf_counter(), bench_dir=bench_dir)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1
    names = {"image_nrms", "broadband_nrms", "ler_rel", "lwr_rel", "lcdu_rel",
             "mean_cd_abs_nm", "deterministic_cd_abs_nm", "bridge_rate_abs",
             "break_rate_abs", "print_probability_mad", "psd_rel_rms"}
    assert set(out["checks"]) == names
    metrics = out["metrics"]
    if not trace:
        assert set(metrics) == {"mpx_per_s", "setup_s"}
        return
    # no device time on the CPU: the roofline reads nothing, the rest read
    assert {"device_idle_pct.trials", "stochastic_host_ms",
            "stochastic_readback_ms", "readback_mb_per_image"} <= set(metrics)
    n, t = SMALL["pixel_number"], SMALL_TRAFFIC["trials"]
    per_image = 4 * n * n * 2 + t * (n * n * 4 + n * 4)  # row_step 1 at 128^2
    assert metrics["readback_mb_per_image"]["value"] == pytest.approx(per_image / 1e6)


def test_an_empty_window_fails(small_bench):
    from litho_bench.drivers import stochastic_stream as drv

    root, _, _ = small_bench
    cfg = load(root / "litho_bench" / "configs" / "euv1024.json")
    assert drv.checks(cfg, SMALL_TRAFFIC, []) == [("ensembles_compared", 0.0, -1.0)]


def test_the_trials_count_is_under_the_cells_work():
    """The least bytes a trial: 5 fields and the cut lines at 1024^2 with
    512 of them; 64 trials at 3.35 TB/s."""
    from litho_bench import harness

    mod = harness._module_from(ROOT / "litho_bench" / "rooflines" / "stochastic_trials.py",
                               "stochastic_trials_count")
    n = 1024
    assert mod.trial_bytes(n, 2) == 4 * n * n * 3 + 16 * n * (n // 2 + 1) + 4 * 512 * n
    assert mod.least_s(64, n, 2) == pytest.approx(64 * mod.trial_bytes(n, 2) / 3.35e12)


def _span(name, start_ms, end_ms, sid, parent=None):
    return {"name": name, "start_ns": int(start_ms * MS), "end_ns": int(end_ms * MS),
            "thread": 1, "id": sid, "parent": parent, "request": None, "attrs": {}}


SPANS = [
    _span("litho.stochastic", 0, 100, 1),
    _span("litho.stochastic.readback", 10, 14, 2, 1),
    _span("litho.stochastic.edges", 14, 40, 3, 1),
    _span("litho.stochastic.psd", 40, 60, 4, 1),
    _span("litho.stochastic.psd", 60, 61, 5, 1),
    _span("litho.stochastic", 200, 300, 6),
    _span("litho.stochastic.readback", 210, 216, 7, 6),
    _span("litho.stochastic.edges", 216, 236, 8, 6),
    _span("litho.stochastic.psd", 236, 246, 9, 6),
    _span("litho.stochastic", 400, 500, 10),
    _span("litho.stochastic.readback", 410, 418, 11, 10),
    _span("litho.stochastic.edges", 418, 448, 12, 10),
    _span("litho.stochastic.psd", 448, 458, 13, 10),
    _span("litho.stochastic.edges", 600, 700, 14),  # outside any call
]


def _reader(name):
    from litho_bench import harness

    return harness.reader_of(name, ROOT / "litho_bench")


def test_span_readers_take_the_median_call(monkeypatch):
    from lithographysimulator_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "recording",
                        lambda: {"spans": SPANS, "counters": {}, "dropped": 0})
    run = {"trace": {"busy_s": 1.0, "window_s": 2.0}, "window": {}}
    # host: 47, 30, 40 ms; read-back: 4, 6, 8 ms
    assert _reader("stochastic_host_ms").read(run) == pytest.approx(40.0)
    assert _reader("stochastic_readback_ms").read(run) == pytest.approx(6.0)
    assert _reader("stochastic_host_ms").read({**run, "trace": None}) is None
    monkeypatch.setattr(profiling, "recording",
                        lambda: {"spans": [_span("litho.simulate", 0, 1, 1)],
                                 "counters": {}, "dropped": 0})
    assert _reader("stochastic_readback_ms").read(run) is None


def test_counter_and_roofline_readers():
    window = {"images": 4, "trials": 256, "socs_images": 4, "socs_rank": 256,
              "socs_n": 1024, "row_step": 2,
              "stochastic_counts": {"trials": 256, "readback_bytes": 571_473_920}}
    run = {"trace": {"busy_s": 2.0, "window_s": 30.0}, "window": window}
    assert _reader("readback_mb_per_image").read(run) == pytest.approx(142.86848)
    assert _reader("readback_mb_per_image").read(
        {**run, "window": {**window, "stochastic_counts": None}}) is None
    from litho_bench import harness

    apply = harness._module_from(ROOT / "litho_bench" / "rooflines" / "socs_apply.py", "a")
    trials = harness._module_from(ROOT / "litho_bench" / "rooflines" / "stochastic_trials.py", "t")
    least = 4 * apply.image_least_s(256, 1024)[0] + trials.least_s(256, 1024, 2)
    assert _reader("trial_roofline.trials").read(run) == pytest.approx(100 * least / 2.0)
    assert _reader("trial_roofline.trials").read({**run, "trace": None}) is None


def _check_controls(cfg, readings, controls):
    from litho_bench import stochastic_controls as sc

    limits = _limits(cfg)
    assert sc.failed(readings["program"], limits) == [], readings["program"]
    for name in controls:
        assert sc.failed(readings[name], limits), (name, readings[name])


def test_controls_fail_on_cpu():
    """At 128^2 (rank 16, so the rank control cuts to 12 of 16; 8 trials,
    so the trials' control runs 7)."""
    from litho_bench import stochastic_controls as sc

    cfg = {**load(ROOT / "litho_bench" / "configs" / "euv1024.json"), **SMALL}
    traffic = {**load(ROOT / "litho_bench" / "traffic" / "stochastic64.json"),
               **SMALL_TRAFFIC}
    controls = [c for c in sc.CONTROLS if c != "TF32 apply"]
    readings = sc.readings(cfg, traffic, SEEDS[0], "cpu", controls=controls)
    _check_controls(cfg, readings, controls)


@pytest.mark.cuda
def test_controls_fail_on_the_card(card):
    from litho_bench import stochastic_controls as sc
    from litho_bench.reference import euv

    cfg = load(ROOT / "litho_bench" / "configs" / "euv1024.json")
    traffic = load(ROOT / "litho_bench" / "traffic" / "stochastic64.json")
    kernels = euv.kernel_set(cfg, card)
    for seed in SEEDS:
        t0 = time.perf_counter()
        readings = sc.readings(cfg, traffic, seed, card, kernels=kernels)
        for name, reading in readings.items():
            print(f"seed {seed}, {name}: {reading!r}; failed "
                  f"{sc.failed(reading, _limits(cfg))}")
        print(f"({time.perf_counter() - t0:.1f} s)")
        _check_controls(cfg, readings, sc.CONTROLS)
