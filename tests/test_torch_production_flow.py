"""Port parity: the production flow (``examples/production_flow_torch.py``)
against the JAX package's tour (``examples/production_flow.py``), both run
in-process on the CPU at the JAX example's defaults (a 128^2 chip of 64^2
tiles). The JAX example is loaded from its file and not edited.

Deterministic stages are equal: the corrected mask bit for bit, the GDS of
the printed contours byte for byte, and the printed MRC, ORC, FEM and
dose-map lines. The stochastic ensemble agrees in distribution only (per-
trial generators, ROADMAP D2), held as ``test_torch_metrology.py`` holds
``tiled_stochastic``: the deterministic CD within 1e-3 nm, the mean CD
within five sampling errors, LER and LWR within 10%, and the defect rates
within five binomial sampling errors of their 8 trials.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt

ROOT = Path(__file__).resolve().parent.parent
MARKERS = ("MRC:", "ORC:", "FEM:", "dose map", "stochastic:", "wrote")
DETERMINISTIC = ("MRC:", "ORC:", "FEM:", "dose map")
TRIALS = 8  # the example's stochastic trials


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, package) -> tuple:
    """``main(argv)``'s exit code and stdout, and the dict its
    ``tiled_stochastic`` call returned (recorded through ``package``)."""
    seen = []
    inner = package.tiled_stochastic

    def recorded(*args, **kwargs):
        seen.append(inner(*args, **kwargs))
        return seen[-1]

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(package, "tiled_stochastic", recorded)
        rc = main(argv)
    assert len(seen) == 1
    return rc, out.getvalue(), seen[0]


@pytest.fixture(scope="module")
def flows(tmp_path_factory, _one_torch_thread):
    jax_dir = tmp_path_factory.mktemp("jax_flow")
    port_dir = tmp_path_factory.mktemp("port_flow")
    ref = _run(_example("production_flow").main,
               ["--cpu", "--out-dir", str(jax_dir)], jt)
    ours = _run(_example("production_flow_torch").main,
                ["--device", "cpu", "--out-dir", str(port_dir)], pt)
    return {"jax": (jax_dir, *ref), "port": (port_dir, *ours)}


def _line(out: str, marker: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith(marker)]
    assert len(lines) == 1, (marker, out)
    return lines[0]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_flow_prints_every_marker_and_writes_both_files(flows, side):
    out_dir, rc, out, _ = flows[side]
    assert rc == 0
    for marker in MARKERS:
        _line(out, marker)
    assert (out_dir / "printed_contours.gds").stat().st_size > 0
    assert np.load(out_dir / "corrected_mask.npy").shape == (128, 128)


def test_flow_files_equal_jax(flows):
    jax_dir, port_dir = flows["jax"][0], flows["port"][0]
    ours = np.load(port_dir / "corrected_mask.npy")
    ref = np.load(jax_dir / "corrected_mask.npy")
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    assert ((port_dir / "printed_contours.gds").read_bytes()
            == (jax_dir / "printed_contours.gds").read_bytes())


@pytest.mark.parametrize("marker", DETERMINISTIC)
def test_flow_line_equals_jax(flows, marker):
    assert _line(flows["port"][2], marker) == _line(flows["jax"][2], marker)


def test_flow_stochastic_agrees_with_jax_in_distribution(flows):
    ours, ref = flows["port"][3], flows["jax"][3]
    assert ours["trials"] == ref["trials"] == TRIALS
    assert ours["deterministic_cd_nm"] == pytest.approx(
        ref["deterministic_cd_nm"], abs=1e-3)
    sigma = np.hypot(ours["lcdu_nm"], ref["lcdu_nm"]) / 3.0 / np.sqrt(TRIALS)
    assert abs(ours["mean_cd_nm"] - ref["mean_cd_nm"]) <= 5.0 * sigma + 1e-3
    for key in ("ler_nm", "lwr_nm"):
        assert ours[key] == pytest.approx(ref[key], rel=0.1), key
    for key in ("break_rate", "bridge_rate"):
        p = 0.5 * (ours[key] + ref[key])
        assert abs(ours[key] - ref[key]) <= 5.0 * np.sqrt(
            2.0 * p * (1.0 - p) / TRIALS), key


def test_run_flow_returns_each_stage_and_the_gds_round_trips(tmp_path,
                                                             flows):
    """``run_flow`` hands back every stage's result; the written contours
    re-rasterize (XOR, centre sampling) to the developed profile bit for
    bit, and the numbers equal the ``main`` run's."""
    from lithographysimulator_tpu_torch.io.contours import rasterize_loops
    from lithographysimulator_tpu_torch.io.gdsii import read_gds

    flow = _example("production_flow_torch")
    with contextlib.redirect_stdout(io.StringIO()):
        res = flow.run_flow(128, 64, tmp_path, "cpu")
    assert set(res) == {"corrected", "mrc", "orc", "fem", "dose_map",
                        "stochastic", "profile", "gds", "stage_s"}
    assert list(res["stage_s"]) == ["design", "opc", "mrc", "orc", "fem",
                                    "dose_map", "stochastic", "contours"]
    np.testing.assert_array_equal(
        res["corrected"], np.load(flows["port"][0] / "corrected_mask.npy"))
    assert res["mrc"]["clean"] and res["orc"]["pass_"]
    assert res["dose_map"]["dose_map"].ndim == 2
    profile = res["profile"]
    assert isinstance(profile, torch.Tensor) and profile.shape == (128, 128)
    loops = [p.xy_nm for p in read_gds(res["gds"]).flatten("CONTOUR")
             if p.layer == 1]
    grid = rasterize_loops(loops, pixel_size=pt.OpticsConfig(
        pixel_number=64).pixel_size, n=128)
    np.testing.assert_array_equal(grid, profile.numpy())


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where there is no card")
def test_device_cuda_without_a_card_raises(tmp_path):
    """``--device cuda`` with no card is an error before any stage runs:
    nothing is printed or written, nothing falls back to the CPU."""
    flow = _example("production_flow_torch")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(
            RuntimeError, match="is_available"):
        flow.main(["--device", "cuda", "--out-dir", str(tmp_path)])
    assert out.getvalue() == ""
    assert list(tmp_path.iterdir()) == []
