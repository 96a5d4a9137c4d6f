"""The benchmark's harness on the CPU: files found by name, the result
line, the names in BENCHMARK.json, the roofline counts, and what a run and
the reference may load."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import time

import pytest

from conftest import ROOT, load, write

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def _run(root, bench_dir, bench, cell, trace=False, seconds=0.5):
    from litho_bench import harness

    return harness.run(bench, root, cell, 2**31 + 29, seconds, trace,
                       device="cpu", t_start=time.perf_counter(),
                       bench_dir=bench_dir)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tiny_bench, trace):
    root, bench_dir, bench = tiny_bench
    from litho_bench import harness

    for cell in bench["workloads"]:
        out = _run(root, bench_dir, bench, cell["name"], trace)
        assert list(out)[:5] == list(LINE_KEYS)
        assert list(out)[-1] == "checks"
        assert out["correct"] is True and out["attempted"] > 0
        wanted = {m["name"] for m in harness.metrics_for(bench, cell["name"], trace)}
        if trace:
            assert {"busy_s", "window_s"} <= set(out["device"])
            assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
            assert all(len(v) <= 10 for v in out["breakdown"].values())
        else:
            assert set(out["metrics"]) == wanted
        assert set(out["metrics"]) <= wanted
        json.dumps(out)


def test_files_dropped_in_are_found_by_name(tiny_bench):
    """A configuration, a traffic mix and a metric added as files, and
    named in BENCHMARK.json, run with no edit to any file already there."""
    root, bench_dir, bench = tiny_bench
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    cfg = load(root / "litho_bench" / "configs" / "clip1024.json")
    write(bench_dir / "configs" / "clip1024_sigma.json",
          {**cfg, "name": "clip1024_sigma",
           "illumination": {**cfg["illumination"], "sigma_in": 0.5}})
    write(bench_dir / "traffic" / "socs_pairs.json",
          {**load(bench_dir / "traffic" / "socs_stream.json"), "pool": 2,
           "sample": 1})
    (bench_dir / "metrics" / "images_done.py").write_text(
        "def read(run):\n    return run['window']['images']\n")
    bench["configs"].append({"name": "clip1024_sigma", "source": "https://example.org",
                             "file": "litho_bench/configs/clip1024_sigma.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "clip1024_sigma.socs_pairs",
                               "config": "clip1024_sigma", "traffic": "socs_pairs",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "images_done", "unit": "images",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["clip1024_sigma.socs_pairs"]})
    out = _run(root, bench_dir, bench, "clip1024_sigma.socs_pairs")
    assert out["correct"] is True
    assert out["metrics"]["images_done"]["value"] == out["attempted"]
    assert {p: p.read_bytes() for p in before} == before


def test_a_metric_without_a_file_of_its_own_is_read_by_its_base(tiny_bench):
    """``<base>.<suffix>`` falls back to ``metrics/<base>.py``; a file of
    the whole name, where there is one, comes first."""
    from litho_bench import harness

    _, bench_dir, _ = tiny_bench
    metrics = bench_dir / "metrics"
    assert harness.reader_path("mpx_per_s.other", bench_dir) == metrics / "mpx_per_s.py"
    (metrics / "mpx_per_s.own.py").write_text("def read(run):\n    return 7.0\n")
    assert harness.reader_of("mpx_per_s.own", bench_dir).read({}) == 7.0


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tiny_bench):
    root, bench_dir, bench = tiny_bench
    out = _run(root, bench_dir, bench, "clip1024.socs_stream", trace=True)
    assert "tile_host_gap_ms" not in out["metrics"]


def test_benchmark_json_names_and_units():
    from litho_bench import harness

    bench = load(ROOT / "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for group in (names, cells, metrics):
        assert len(set(group)) == len(group)
        assert all(NAME.match(n) for n in group)
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert (ROOT / "litho_bench" / "traffic" / f"{w['traffic']}.json").exists()
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).exists()
        assert set(c["reduced"]) == set(load(ROOT / c["file"])["reduced"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert harness.reader_path(m["name"], ROOT / "litho_bench").exists()
        for cell in m.get("workloads", []):
            assert cell in cells
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                              "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for cell in cells:
        reported = [m for m in bench["end_to_end"]
                    if "workloads" not in m or cell in m["workloads"]]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])


def test_roofline_counts_hold_to_the_kernel_table():
    """The per-kernel bounds (ms) listed beside the port's kernels at their
    four shapes, and the image count from them."""
    from litho_bench.rooflines import socs_apply as r

    table = {("column_intensity", 4, 1024, 520): (0.0397, "ops"),
             ("column_intensity", 4, 2048, 1032): (0.3150, "ops"),
             ("column_intensity", 4, 1024, 1024): (0.0781, "ops"),
             ("column_intensity", 4, 2048, 2048): (0.6250, "ops"),
             ("row_limb_gemm", 4, 1024, 520): (0.0201, "ops"),
             ("row_limb_gemm", 4, 2048, 1032): (0.1587, "ops"),
             ("row_limb_gemm", 4, 1024, 1024): (0.0781, "ops"),
             ("row_limb_gemm", 4, 2048, 2048): (0.6250, "ops"),
             ("row_requantize", 4, 1024, 520): (0.0111, "bytes"),
             ("row_requantize", 4, 2048, 1032): (0.0435, "bytes"),
             ("row_requantize", 4, 1024, 1024): (0.0213, "bytes"),
             ("row_requantize", 4, 2048, 2048): (0.0852, "bytes")}
    for (name, b, n, w), (ms, by) in table.items():
        s, which = r.kernel_bound_s(name, b, n, w)
        assert round(1e3 * s, 4) == ms and which == by
    per_chunk = sum(r.kernel_bound_s(k, 4, 1024, 1024)[0]
                    for k in ("row_limb_gemm", "column_intensity"))
    least, which = r.image_least_s(256, 1024)
    assert which == "ops" and least == pytest.approx(64 * per_chunk, rel=1e-12)


def _loaded_by(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, cwd=ROOT, check=True,
                         timeout=300)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_bench):
    """Every module of litho_bench and a whole small run, in a fresh
    process: no top-level name is jax's, its relatives' or the JAX
    package's (the port's name starts with it and must pass)."""
    from litho_bench import harness

    root, _, _ = tiny_bench
    code = (f"import sys, time, pathlib; sys.path.insert(0, {str(ROOT)!r})\n"
            "from litho_bench import harness, judge, masks, program, tracing\n"
            f"root = pathlib.Path({str(root)!r})\n"
            "bench = harness.benchmark(root)\n"
            "for cell in bench['workloads']:\n"
            "    harness.run(bench, root, cell['name'], 5, 0.2, True, device='cpu',"
            " t_start=time.perf_counter(), bench_dir=root / 'litho_bench')\n"
            "for m in bench['end_to_end'] + bench['per_layer']:\n"
            "    harness.reader_of(m['name'], root / 'litho_bench')\n")
    loaded = _loaded_by(code)
    assert "lithographysimulator_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    ref = ROOT / "litho_bench" / "reference"
    for path in ref.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert all(m.split(".")[0] in ("numpy", "torch", "math",
                                           "__future__") for m in mods), path
    loaded = _loaded_by(f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
                        "import litho_bench.reference.optics, "
                        "litho_bench.reference.socs")
    assert not {m for m in loaded if m.startswith("lithographysimulator")}


def test_no_card_fails_and_names_it():
    """On a machine without a card the command prints no result, exits
    with another code than 0 and says that the card is missing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "litho_bench/run.py", "--workload",
                          "clip1024.socs_stream", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
