"""Port parity: the ``smo``, ``opc``, ``fitaberr`` and ``lele`` subcommands
of the torch port's CLI (``--device cpu``) against the JAX package's, in
process, on the CPU.

Sizes are tests/test_optimize.py's and tests/test_opc_tiled.py's: 32^2
for smo and fitaberr, a 128^2 chip through 64^2 tiles for opc, 64^2 for
lele. The sources keep every randomized kernel build exact in both
packages (a rank-24 build's 40 probes span the 37 live points of a
classical sigma-0.4 source at 32^2 and sigma-0.2 at 64^2). Losses agree
within 1e-4 relative (optimizer histories, measured in the 1e-6 class
for smo and 5e-5 for fitaberr's near-equal normalized images), the
fitted coefficients within 1e-5 of the largest (and the report's
6-decimal rounding); the fidelity, MRC and
feature reports, which threshold images that agree in the float32 class,
are equal but for their floats, held to 1e-4 relative. lele --gds writes
the same GDSII bytes as the JAX CLI (D9, closed).
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
from lithographysimulator_tpu import cli as jcli
from lithographysimulator_tpu_torch import cli as pcli

SMO = ["smo", "--pixel-number", "32", "--source", "classical",
       "--sigma-out", "0.4", "--chunk", "8", "--steps", "4",
       "--aberrations", "0", "0", "0.02", "0.01", "20"]
OPC = ["opc", "--pixel-number", "64", "--big-n", "128", "--mask", "contacts",
       "--source", "classical", "--sigma-out", "0.2", "--steps", "3",
       "--rank", "24", "--halo", "16", "--mrc-min-width", "50",
       "--mrc-min-area", "5000", "--mrc-repair"]
LELE = ["lele", "--pixel-number", "64", "--mask", "lines", "--source",
        "classical", "--sigma-out", "0.2", "--min-pitch", "200", "--rank",
        "24", "--halo", "16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _report(module, argv) -> dict:
    out = io.StringIO()
    with redirect_stdout(out):
        assert module.main(argv) == 0
    return json.loads(out.getvalue().splitlines()[0])


def _assert_close(ours, ref, rel=1e-4, path="") -> None:
    """Equal structure; floats within ``rel``, the rest equal."""
    if isinstance(ref, dict):
        assert ours.keys() == ref.keys(), path
        for k in ref:
            _assert_close(ours[k], ref[k], rel, f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_close(a, b, rel, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert ours == pytest.approx(ref, rel=rel, abs=1e-9), path
    else:
        assert ours == ref, path


def test_new_subcommands_default_to_cuda():
    for argv in (["smo"], ["opc"], ["lele"], ["fitaberr", "--images", "a.npy"]):
        assert pcli._parser().parse_args(argv).device == "cuda"


@pytest.mark.parametrize("forward", ["abbe", "socs"])
def test_cli_smo_matches_jax(tmp_path, forward):
    extra = ["--forward", forward, "--rank", "24"]
    ours = _report(pcli, SMO + extra + ["--device", "cpu",
                                        "--out", str(tmp_path / "p.npy")])
    ref = _report(jcli, SMO + extra + ["--out", str(tmp_path / "j.npy")])
    assert ours.pop("wall_clock_s") >= 0 and ref.pop("wall_clock_s") >= 0
    assert ours["loss_end"] < ours["loss_start"]
    _assert_close(ours, ref)
    np.testing.assert_allclose(np.load(tmp_path / "p.npy"),
                               np.load(tmp_path / "j.npy"), rtol=0, atol=1e-5)


def test_cli_opc_mrc_matches_jax(tmp_path):
    ours = _report(pcli, OPC + ["--device", "cpu",
                                "--out", str(tmp_path / "p.npy")])
    ref = _report(jcli, OPC + ["--out", str(tmp_path / "j.npy")])
    assert ours.pop("wall_clock_s") >= 0 and ref.pop("wall_clock_s") >= 0
    assert "mrc" in ours and "width_violation_px" in ours["mrc"]
    _assert_close(ours, ref)
    np.testing.assert_allclose(np.load(tmp_path / "p.npy"),
                               np.load(tmp_path / "j.npy"), rtol=0, atol=1e-5)


def test_cli_fitaberr_matches_jax(tmp_path):
    """Images the JAX package formed at known coefficients, written by the
    test; a 3-plane fit in both CLIs."""
    cfg = jt.OpticsConfig(pixel_number=32)
    src = np.asarray(jt.LightSource(cfg, sigma_out=0.4).classical())
    truth = np.array([0, 0, 0.02, 0.05, 25.0, 0, 0, 0.04], np.float32)
    paths = []
    for off in (-80.0, 0.0, 80.0):
        ab = truth.copy()
        ab[4] += off
        img = jt.simulate(jt.demo_bars(cfg), src, ab).image
        paths.append(str(tmp_path / f"m{len(paths)}.npy"))
        np.save(paths[-1], np.asarray(img))
    argv = ["fitaberr", "--pixel-number", "32", "--source", "classical",
            "--sigma-out", "0.4", "--chunk", "8", "--steps", "5",
            "--n-coeffs", "8", "--images", *paths,
            "--defocus", "-80", "0", "80"]
    ours = _report(pcli, argv + ["--device", "cpu"])
    ref = _report(jcli, argv)
    assert ours.pop("wall_clock_s") >= 0 and ref.pop("wall_clock_s") >= 0
    assert ours["planes"] == 3 and ours["loss_final"] < ours["loss_initial"]
    c, c_ref = (np.asarray(r.pop("coefficients")) for r in (ours, ref))
    # plus 1e-6: the report rounds each coefficient to 6 decimals
    np.testing.assert_allclose(c, c_ref, rtol=0,
                               atol=1e-5 * np.abs(c_ref).max() + 1e-6)
    _assert_close(ours, ref)
    with pytest.raises(SystemExit, match="--defocus planes"):
        pcli.main(argv[:-1] + ["--device", "cpu"])


def test_cli_lele_matches_jax(tmp_path):
    extra = ["--masks", "2", "--overlay", "0", "0", "0", "10"]
    ours = _report(pcli, LELE + extra + ["--device", "cpu",
                                         "--out", str(tmp_path / "p.npz")])
    ref = _report(jcli, LELE + extra + ["--out", str(tmp_path / "j.npz")])
    assert ours.pop("wall_clock_s") >= 0 and ref.pop("wall_clock_s") >= 0
    assert ours == ref and ours["violations"] == 0
    p, j = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(p.files) == sorted(j.files)
    for key in j.files:
        np.testing.assert_array_equal(p[key], j[key])
    with pytest.raises(SystemExit, match="dy dx per mask"):
        pcli.main(LELE + ["--device", "cpu", "--overlay", "0", "0"])


def test_cli_lele_gds_is_refused(tmp_path):
    """D9 is closed: ``--gds`` is no longer refused. It writes the
    decomposed masks' contours (mask i on layer i) as the JAX CLI does, to
    the same bytes, and the GDS re-rasterizes to the masks."""
    from lithographysimulator_tpu_torch.io.contours import rasterize_loops
    from lithographysimulator_tpu_torch.io.gdsii import read_gds

    extra = ["--out", None, "--gds", None]
    for module, tag, dev in ((pcli, "p", ["--device", "cpu"]), (jcli, "j", [])):
        extra[1], extra[3] = str(tmp_path / f"{tag}.npz"), str(tmp_path / f"{tag}.gds")
        out = io.StringIO()
        with redirect_stdout(out):
            assert module.main(LELE + dev + extra) == 0
        assert "mask i on layer i" in out.getvalue()
    gds = (tmp_path / "p.gds").read_bytes()
    assert gds == (tmp_path / "j.gds").read_bytes()
    masks = np.load(tmp_path / "p.npz")
    polys = read_gds(tmp_path / "p.gds").flatten("LELE")
    for layer, key in ((1, "mask_a"), (2, "mask_b")):
        loops = [p.xy_nm for p in polys if p.layer == layer]
        assert loops
        np.testing.assert_array_equal(
            rasterize_loops(loops, pixel_size=25.0, n=64) > 0.5,
            masks[key] > 0.5)
