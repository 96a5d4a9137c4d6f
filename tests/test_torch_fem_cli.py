"""Port parity: the ``fem`` subcommand of the torch port's CLI
(``--device cpu``, a 128^2 chip through 64^2 tiles) against the JAX
package's, as tests/test_metrology.py::test_cli_fem runs it.

At 37 live source points (classical sigma 0.2) and rank 24 both
packages' kernel builds are exact, so every value of the report but the
wall clock equals JAX's: the CD matrix and the process window are
pixel-quantized widths of binary develops; the subpixel and gradient
statistics (CDU, NILS, EPE, PV bands) are held to 1e-4 relative
(tests/test_torch_metrology.py's class). fem --stream reads the tiles
from a GDSII layout, as the JAX CLI does.
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lithographysimulator_tpu import cli as jcli
from lithographysimulator_tpu_torch import cli as pcli

FEM = ["fem", "--pixel-number", "64", "--big-n", "128", "--mask", "lines",
       "--source", "classical", "--sigma-out", "0.2", "--focus-min", "-80",
       "--focus-max", "80", "--focus-steps", "3", "--doses", "0.9", "1.0",
       "1.1", "--rank", "24", "--halo", "16", "--threshold", "0.25"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _report(module, argv) -> dict:
    out = io.StringIO()
    with redirect_stdout(out):
        assert module.main(argv) == 0
    return json.loads(out.getvalue().splitlines()[0])


def _assert_close(ours, ref, path="") -> None:
    """Equal structure; numbers within 1e-4 relative, the rest equal."""
    if isinstance(ref, dict):
        assert ours.keys() == ref.keys(), path
        for k in ref:
            _assert_close(ours[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_close(a, b, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert ours == pytest.approx(ref, rel=1e-4, abs=1e-9), path
    else:
        assert ours == ref, path


def test_fem_device_defaults_to_cuda():
    assert pcli._parser().parse_args(["fem"]).device == "cuda"


def test_cli_fem_matches_jax(tmp_path):
    extra = ["--hotspot-nils", "2.5"]
    ours = _report(pcli, FEM + extra + [
        "--device", "cpu", "--cdu-map", str(tmp_path / "cdu.npy"),
        "--pv-bands", str(tmp_path / "pv.npz")])
    ref = _report(jcli, FEM + extra + [
        "--cdu-map", str(tmp_path / "cdu_jax.npy"),
        "--pv-bands", str(tmp_path / "pv_jax.npz")])
    assert ours.pop("wall_clock_s") >= 0 and ref.pop("wall_clock_s") >= 0
    assert ours["big_n"] == 128 and ours["tile_n"] == 64
    assert np.asarray(ours["cd_nm"]).shape == (3, 3)
    assert ours["cd_nm"] == ref["cd_nm"]
    for key in ("target_cd_nm", "depth_of_focus_nm", "exposure_latitude",
                "in_spec_fraction"):
        assert ours[key] == ref[key], key
    # weakest-first hotspots: equal lines tie in NILS, so compare the
    # places as a set
    spots, spots_ref = (sorted(r["hotspots"].pop("locations"))
                        for r in (ours, ref))
    np.testing.assert_allclose(spots, spots_ref, rtol=1e-4, atol=0.011)
    _assert_close(ours, ref)
    np.testing.assert_allclose(np.load(tmp_path / "cdu.npy"),
                               np.load(tmp_path / "cdu_jax.npy"), rtol=1e-4)
    pv, pv_ref = np.load(tmp_path / "pv.npz"), np.load(tmp_path / "pv_jax.npz")
    for key in ("outer", "inner", "band"):
        np.testing.assert_array_equal(pv[key], pv_ref[key])


def _lines_gds(path, big_n: int = 128, px: float = 25.0) -> None:
    """A GDSII chip of vertical lines (8 px wide, 16 px pitch) on layer 1
    and a decoy square on layer 2, spanning ``big_n`` pixels."""
    from lithographysimulator_tpu_torch.io.gdsii import write_gds

    h = big_n * px
    lines = [(1, np.array([[x, 0.0], [x + 8 * px, 0.0], [x + 8 * px, h],
                           [x, h]])) for x in np.arange(4, big_n - 8, 16) * px]
    decoy = (2, np.array([[0.0, 0.0], [h, 0.0], [h, h], [0.0, h]]))
    write_gds(path, {"TOP": lines + [decoy]})


def test_cli_fem_stream_matches_jax_and_the_array_path(tmp_path):
    """fem --stream reads the tile windows from the GDSII layout: its report
    equals the JAX CLI's --stream report, and the port's array path on the
    same --mask-file (the chip rasterized whole), but for the wall clock
    and the EPE, which only the array path can measure (it holds the
    target geometry; the JAX CLI's stream report has none either)."""
    gds = tmp_path / "chip.gds"
    _lines_gds(gds)
    layout = ["--mask-file", str(gds), "--gds-layer", "1"]
    stream = _report(pcli, FEM + layout + ["--device", "cpu", "--stream"])
    ref = _report(jcli, FEM + layout + ["--stream"])
    whole = _report(pcli, FEM + layout + ["--device", "cpu"])
    for r in (stream, ref, whole):
        assert r.pop("wall_clock_s") >= 0
    assert stream["big_n"] == 128 and np.asarray(stream["cd_nm"]).shape == (3, 3)
    assert stream["cd_nm"] == ref["cd_nm"]
    _assert_close(stream, ref)
    assert "epe" not in stream and whole.pop("epe")["matched"] > 0
    assert stream == whole


def test_cli_fem_refusals(capsys):
    """What fem still refuses: --stream without a layout --mask-file."""
    with pytest.raises(SystemExit, match="--stream requires --mask-file"):
        pcli.main([*FEM, "--device", "cpu", "--stream"])
