"""Port parity: the ``focus``, ``resist3d``, ``stochastic`` and
``calibrate`` subcommands of the torch port's CLI (``--device cpu``, 32^2)
against the JAX package's CLI, as tests/test_resist_artifacts_cli.py runs
it.

Each report has JAX's keys. Deterministic values (the focus CDs, the
resist3d cleared, through-print and undercut counts, the deterministic CD
of ``stochastic``, every calibrate value) equal JAX's: they are counts and
pixel-quantized widths of binary profiles whose fields agree to the 1e-5
class (tests/test_torch_resist.py), or the same numpy fit; the
deterministic CD is subpixel and held to 1e-3 nm. The Monte-Carlo values
differ by their random streams; their statistics are held to JAX's in
tests/test_torch_stochastic.py, and here they are checked finite and in
range.
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lithographysimulator_tpu import cli as jcli
from lithographysimulator_tpu_torch import cli as pcli

BASE = ["--pixel-number", "32", "--source", "annular", "--sigma-in", "0.2",
        "--sigma-out", "0.6", "--mask", "lines"]
FILM = ["resist3d", "--pixel-number", "32", "--source", "classical",
        "--sigma-out", "0.5", "--mask", "lines", "--nz", "3", "--film",
        "--substrate", "si", "--barc", "37"]
SUBCOMMANDS = ("focus", "resist3d", "stochastic", "calibrate")


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


def _both(argv) -> tuple[dict, dict]:
    return (_report(pcli, argv + ["--device", "cpu"]), _report(jcli, argv))


def _without_clock(report: dict) -> dict:
    return {k: v for k, v in report.items() if k not in ("wall_clock_s", "wall_s")}


@pytest.mark.parametrize("command", SUBCOMMANDS)
def test_device_defaults_to_cuda(command):
    args = ["--images", "a.npy", "--cds", "1"] if command == "calibrate" else []
    assert pcli._parser().parse_args([command, *args]).device == "cuda"


def test_cli_focus_matches_jax():
    ours, ref = _both(["focus", *BASE, "--focus-steps", "3"])
    assert ours.keys() == ref.keys()
    assert _without_clock(ours) == _without_clock(ref)


def test_cli_resist3d_matches_jax(tmp_path):
    argv = ["resist3d", *BASE, "--nz", "4", "--reflectivity", "0.2",
            "--peb", "10", "--lateral-rate-factor", "0.7"]
    ours = _report(pcli, argv + ["--device", "cpu", "--out",
                                 str(tmp_path / "p.npz")])
    ref = _report(jcli, argv + ["--out", str(tmp_path / "j.npz")])
    assert ours.keys() == ref.keys()
    assert _without_clock(ours) == _without_clock(ref)
    assert 0.0 < ours["cleared_fraction"] < 1.0
    np.testing.assert_array_equal(np.load(tmp_path / "p.npz")["profile"],
                                  np.load(tmp_path / "j.npz")["profile"])


def test_cli_resist3d_film_and_volumetric_stochastic_match_jax():
    ours, ref = _both([*FILM, "--trials", "6", "--dose-photons", "40"])
    assert ours.keys() == ref.keys()
    sto, sto_ref = ours.pop("stochastic"), ref.pop("stochastic")
    assert _without_clock(ours) == _without_clock(ref)
    assert ours["exposure"] == "film"
    assert sto.keys() == sto_ref.keys() and sto["trials"] == 6
    assert len(sto["slabs"]) == 3
    for slab, slab_ref in zip(sto["slabs"], sto_ref["slabs"]):
        assert slab.keys() == slab_ref.keys()
        assert slab["depth_nm"] == slab_ref["depth_nm"]
        assert 0.0 <= slab["break_rate"] <= 1.0
        assert 0.0 <= slab["bridge_rate"] <= 1.0


def test_cli_resist3d_refusals(capsys):
    """What resist3d still refuses: the separable model's --reflectivity
    with --film (as the JAX CLI). --big-n is no longer refused: with
    --film it tiles the chip (next test), without it the flag is unused,
    as in the JAX CLI; a layout --mask-file is read (the test after)."""
    assert pcli.main(["resist3d", "--device", "cpu", "--pixel-number", "32",
                      "--mask", "lines", "--film", "--reflectivity", "0.2"]) == 2
    assert "--reflectivity" in capsys.readouterr().err


@pytest.mark.parametrize("film", [[], ["--film"]])
def test_cli_resist3d_layout_mask_file_matches_npy(tmp_path, film):
    """A GDSII --mask-file (with --big-n and --film: the tiled film stack)
    gives the report and profile of the same chip rasterized to .npy."""
    from lithographysimulator_tpu_torch import OpticsConfig
    from lithographysimulator_tpu_torch.io import mask_from_layout, write_gds

    gds = tmp_path / "chip.gds"
    write_gds(gds, {"TOP": [(1, np.array([[x, 0.0], [x + 150.0, 0.0],
                                          [x + 150.0, 1600.0], [x, 1600.0]]))
                            for x in (100.0, 500.0, 900.0, 1300.0)]})
    big = 64 if film else 32
    np.save(tmp_path / "chip.npy", mask_from_layout(
        gds, OpticsConfig(pixel_number=big), device="cpu").geometry.numpy())
    argv = ["resist3d", "--device", "cpu", "--pixel-number", "32", "--big-n",
            "64", "--nz", "3", "--source", "classical", "--sigma-out", "0.2",
            "--rank", "24", "--halo", "8", *film]
    reports = []
    for mask_file in ("chip.gds", "chip.npy"):
        reports.append(_report(pcli, argv + [
            "--mask-file", str(tmp_path / mask_file), "--gds-layer", "1",
            "--out", str(tmp_path / f"{mask_file}.npz")]))
        assert reports[-1].pop("wall_clock_s") >= 0
    assert reports[0] == reports[1] and 0 < reports[0]["cleared_fraction"] < 1
    np.testing.assert_array_equal(np.load(tmp_path / "chip.gds.npz")["profile"],
                                  np.load(tmp_path / "chip.npy.npz")["profile"])


def test_cli_resist3d_film_big_n_matches_jax(tmp_path):
    """resist3d --film --big-n: the 128^2 chip through 64^2 tiles
    (tiled_film_stack on per-slab kernels), then the 3-D develop. At 37
    live source points and rank 24 both packages' film builds are exact,
    so the report equals JAX's (D1's float32 class did not move a voxel
    here) and so does the profile."""
    argv = ["resist3d", "--pixel-number", "64", "--big-n", "128", "--source",
            "classical", "--sigma-out", "0.2", "--mask", "lines", "--nz", "3",
            "--film", "--barc", "37", "--rank", "24", "--halo", "16"]
    ours = _report(pcli, argv + ["--device", "cpu", "--out",
                                 str(tmp_path / "p.npz")])
    ref = _report(jcli, argv + ["--out", str(tmp_path / "j.npz")])
    assert ours.keys() == ref.keys()
    assert _without_clock(ours) == _without_clock(ref)
    assert ours["exposure"] == "film" and 0.0 < ours["cleared_fraction"] < 1.0
    profile = np.load(tmp_path / "p.npz")["profile"]
    assert profile.shape == (3, 128, 128)
    np.testing.assert_array_equal(profile, np.load(tmp_path / "j.npz")["profile"])


def test_cli_stochastic_psd_matches_jax(tmp_path):
    argv = ["stochastic", *BASE, "--trials", "8", "--psd"]
    ours = _report(pcli, argv + ["--device", "cpu", "--out",
                                 str(tmp_path / "band.npy"),
                                 "--psd-out", str(tmp_path / "psd.npz")])
    ref = _report(jcli, argv)
    assert ours.keys() == ref.keys()
    assert ours["trials"] == ref["trials"] == 8
    assert ours["deterministic_cd_nm"] == pytest.approx(
        ref["deterministic_cd_nm"], abs=1e-3)
    for key in ("ler_nm", "lwr_nm", "lcdu_nm", "psd_ler_3s_nm"):
        assert np.isfinite(ours[key]) and ours[key] > 0
    assert ours["psd_n_edges"] == ref["psd_n_edges"]
    band = np.load(tmp_path / "band.npy")
    assert band.shape == (32, 32) and 0.0 <= band.min() <= band.max() <= 1.0
    assert np.load(tmp_path / "psd.npz")["psd_nm3"].size > 0


def test_cli_calibrate_matches_jax(tmp_path):
    from lithographysimulator_tpu.models.calibrate import gauge_cd
    from lithographysimulator_tpu.models.resist import ResistModel
    from lithographysimulator_tpu import OpticsConfig

    cfg = OpticsConfig(pixel_number=32)
    x = np.arange(32)
    paths, cds = [], []
    for i, (pitch, contrast) in enumerate(((8, 0.9), (16, 0.8))):
        im = np.tile((0.5 + 0.5 * contrast * np.cos(2 * np.pi * x / pitch)) ** 2,
                     (32, 1))
        path = tmp_path / f"g{i}.npy"
        np.save(path, im)
        paths.append(str(path))
        cds.append(f"{gauge_cd(ResistModel(threshold=0.42), im, cfg):.4f}")
    argv = ["calibrate", "--pixel-number", "32", "--images", *paths,
            "--cds", *cds, "--fit", "threshold"]
    ours, ref = _both(argv)
    assert ours.keys() == ref.keys()
    assert _without_clock(ours) == _without_clock(ref)
    assert ours["params"]["threshold"] == pytest.approx(0.42, abs=0.01)
