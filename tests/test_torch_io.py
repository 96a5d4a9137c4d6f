"""Port parity: layouts in (``io/native.py``, ``io/gdsii.py``,
``io/oasis.py``, ``io/layout.py``) against the JAX package's ``io``.

The port's rasterizer is its own C++ library (``csrc/rasterizer.cpp``,
built with g++ into ``_build/``); it must equal JAX's ``rasterize`` and the
plain ``_rasterize_numpy`` bit for bit, plain and anti-aliased. GDSII and
OASIS files written by either package read back to equal polygons in the
other. Layout masks and streamed windows equal JAX's bit for bit; the
``simulate`` CLI on a ``.gds`` file equals the JAX CLI's image and the
port's ``.npy`` path.
"""

import io
import json
import warnings
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
from lithographysimulator_tpu import cli as jcli
from lithographysimulator_tpu import io as jio
from lithographysimulator_tpu.io import gdsii as jgdsii
from lithographysimulator_tpu.io import layout as jlayout
from lithographysimulator_tpu.io import oasis as joasis
from lithographysimulator_tpu_torch import OpticsConfig
from lithographysimulator_tpu_torch import cli as pcli
from lithographysimulator_tpu_torch import io as pio
from lithographysimulator_tpu_torch.io import gdsii as pgdsii
from lithographysimulator_tpu_torch.io import layout as playout
from lithographysimulator_tpu_torch.io import native as pnative
from lithographysimulator_tpu_torch.io import oasis as poasis
from lithographysimulator_tpu_torch.ops.kernels import build

CFG = OpticsConfig(pixel_number=32)
JCFG = jt.OpticsConfig(pixel_number=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_polygons(seed: int, count: int = 6):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 800, (k, 2)) for k in rng.integers(3, 9, count)]


def _layout_cells():
    """Two cells: rectangles, an L and a triangle on layers 1 and 2 (nm)."""
    return {"TOP": [
        (1, np.array([[100.0, 100.0], [300.0, 100.0], [300.0, 500.0],
                      [100.0, 500.0]])),
        (1, np.array([[400.0, 0.0], [700.0, 0.0], [700.0, 100.0],
                      [500.0, 100.0], [500.0, 300.0], [400.0, 300.0]])),
        (2, np.array([[0.0, 600.0], [350.0, 600.0], [175.0, 780.0]])),
    ], "AUX": [
        (3, np.array([[-50.0, -50.0], [50.0, -50.0], [50.0, 50.0],
                      [-50.0, 50.0]])),
    ]}


def _polygons_by_cell(lib) -> dict:
    return {name: [(p.layer, p.datatype, p.xy_nm) for p in cell.polygons]
            for name, cell in lib.cells.items()}


def test_library_builds_into_the_package_build_dir():
    lib = pnative.build()
    assert lib.parent == build.BUILD_DIR and lib.is_file()
    assert lib.name.startswith("librasterizer-") and lib == pnative.library_path()
    assert pio.native_available()


@pytest.mark.parametrize("antialias", [0, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_rasterize_matches_jax_and_plain(seed, antialias):
    polys = _random_polygons(seed)
    ours = pio.rasterize(polys, origin=(-10.0, 5.0), pixel_size=25.0, n=32,
                         antialias=antialias)
    ref = jio.rasterize(polys, origin=(-10.0, 5.0), pixel_size=25.0, n=32,
                        antialias=antialias)
    plain = pnative._rasterize_numpy(polys, (-10.0, 5.0), 25.0, 32, antialias)
    assert ours.dtype == np.float32 and ours.shape == (32, 32)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, plain)
    assert 0 < ours.sum() < 32 * 32


def test_rasterize_counts_and_coverage():
    square = [(100.0, 100.0), (300.0, 100.0), (300.0, 300.0), (100.0, 300.0)]
    g = pio.rasterize([square], pixel_size=25.0, n=32)
    assert g.sum() == 64 and g[4, 4] == 1.0 and g[3, 3] == 0.0
    l_shape = [(0, 0), (300, 0), (300, 100), (100, 100), (100, 300), (0, 300)]
    assert pio.rasterize([l_shape], pixel_size=25.0, n=16).sum() == 80
    half = [(12.5, 12.5), (312.5, 12.5), (312.5, 312.5), (12.5, 312.5)]
    aa = pio.rasterize([half], pixel_size=25.0, n=32, antialias=4)
    assert {0.0, 0.25, 0.5, 1.0} <= set(np.round(np.unique(aa), 3))
    assert pio.rasterize([], pixel_size=25.0, n=8).sum() == 0


def test_no_silent_fallback(tmp_path, monkeypatch):
    """D11: a library that does not build raises with g++'s stderr; there
    is no quiet drop to numpy."""
    broken = tmp_path / "rasterizer.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "SOURCE", broken)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(pnative, "_LIBRARY", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        pio.rasterize([[(0, 0), (10, 0), (10, 10)]], pixel_size=1.0, n=8)
    assert not pio.native_available()
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("fmt", ["gds", "oasis"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_layout_round_trip_across_packages(tmp_path, fmt, writer):
    """A file written by one package reads back to the same polygons in
    the other (and in itself)."""
    cells = _layout_cells()
    path = tmp_path / f"chip.{fmt}"
    write = {("gds", "port"): pgdsii.write_gds, ("gds", "jax"): jgdsii.write_gds,
             ("oasis", "port"): poasis.write_oasis,
             ("oasis", "jax"): joasis.write_oasis}[fmt, writer]
    write(path, cells, unit_nm=0.5)
    read_p = pgdsii.read_gds if fmt == "gds" else poasis.read_oasis
    read_j = jgdsii.read_gds if fmt == "gds" else joasis.read_oasis
    ours, ref = _polygons_by_cell(read_p(path)), _polygons_by_cell(read_j(path))
    assert ours.keys() == ref.keys() == cells.keys()
    for name in cells:
        assert len(ours[name]) == len(ref[name]) == len(cells[name])
        for (la, da, xa), (lb, db, xb), (lc, xc) in zip(ours[name], ref[name],
                                                         cells[name]):
            assert la == lb == lc and da == db == 0
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_allclose(xa, xc, atol=0.25)


def test_writers_emit_the_same_bytes(tmp_path):
    cells = _layout_cells()
    for name, ours, ref in (("gds", pgdsii.write_gds, jgdsii.write_gds),
                            ("oas", poasis.write_oasis, joasis.write_oasis)):
        ours(tmp_path / f"p.{name}", cells)
        ref(tmp_path / f"j.{name}", cells)
        assert (tmp_path / f"p.{name}").read_bytes() == \
            (tmp_path / f"j.{name}").read_bytes()


def test_oasis_placements_flatten_across_packages(tmp_path):
    cells = {"UNIT": [(1, np.array([[0.0, 0.0], [100.0, 0.0], [100.0, 40.0],
                                    [0.0, 40.0]]))], "TOP": []}
    placements = {"TOP": [("UNIT", (500.0, 200.0), 2.0, 90.0, False),
                          ("UNIT", (-300.0, 0.0), 1.0, 0.0, True)]}
    for write in (poasis.write_oasis, joasis.write_oasis):
        path = tmp_path / "placed.oas"
        write(path, cells, placements=placements)
        ours = [p.xy_nm for p in poasis.read_oasis(path).flatten("TOP")]
        ref = [p.xy_nm for p in joasis.read_oasis(path).flatten("TOP")]
        assert len(ours) == len(ref) == 2
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


def test_gds_references_and_paths_match_jax(tmp_path):
    """A hand-built GDS with an SREF (rotated, magnified, reflected), an
    AREF and a PATH flattens to the same polygons in both packages."""
    g = jgdsii
    rec = lambda t, d, p=b"": (len(p) + 4).to_bytes(2, "big") + bytes([t, d]) + p
    i16 = lambda *v: b"".join(int(x).to_bytes(2, "big", signed=True) for x in v)
    i32 = lambda *v: b"".join(int(x).to_bytes(4, "big", signed=True) for x in v)
    name = lambda s: s.encode() + (b"\0" if len(s) % 2 else b"")
    blob = [rec(g.HEADER, 2, i16(600)), rec(g.BGNLIB, 2, i16(*[0] * 12)),
            rec(g.LIBNAME, 6, name("L")),
            rec(g.UNITS, 5, g._float_to_real8(1e-3) + g._float_to_real8(1e-9)),
            rec(g.BGNSTR, 2, i16(*[0] * 12)), rec(g.STRNAME, 6, name("UNIT")),
            rec(g.BOUNDARY, 0), rec(g.LAYER, 2, i16(1)), rec(g.DATATYPE, 2, i16(0)),
            rec(g.XY, 3, i32(0, 0, 50, 0, 50, 20, 0, 20, 0, 0)), rec(g.ENDEL, 0),
            rec(g.PATH, 0), rec(g.LAYER, 2, i16(2)), rec(g.DATATYPE, 2, i16(0)),
            rec(g.PATHTYPE, 2, i16(2)), rec(g.WIDTH, 3, i32(10)),
            rec(g.XY, 3, i32(0, 40, 60, 40, 60, 90)), rec(g.ENDEL, 0),
            rec(g.ENDSTR, 0),
            rec(g.BGNSTR, 2, i16(*[0] * 12)), rec(g.STRNAME, 6, name("TOP")),
            rec(g.SREF, 0), rec(g.SNAME, 6, name("UNIT")),
            rec(g.STRANS, 1, (0x8000).to_bytes(2, "big")),
            rec(g.MAG, 5, g._float_to_real8(1.5)),
            rec(g.ANGLE, 5, g._float_to_real8(90.0)),
            rec(g.XY, 3, i32(300, 100)), rec(g.ENDEL, 0),
            rec(g.AREF, 0), rec(g.SNAME, 6, name("UNIT")),
            rec(g.COLROW, 2, i16(3, 2)),
            rec(g.XY, 3, i32(-400, 0, -100, 0, -400, 200)), rec(g.ENDEL, 0),
            rec(g.ENDSTR, 0), rec(g.ENDLIB, 0)]
    path = tmp_path / "refs.gds"
    path.write_bytes(b"".join(blob))
    ours = pgdsii.read_gds(path).flatten()
    ref = jgdsii.read_gds(path).flatten()
    assert len(ours) == len(ref) == 7 * (1 + 3)  # path: 2 rects + a disc
    for a, b in zip(ours, ref):
        assert (a.layer, a.datatype) == (b.layer, b.datatype)
        np.testing.assert_array_equal(a.xy_nm, b.xy_nm)


@pytest.mark.parametrize("join", ["round", "miter", "bevel"])
@pytest.mark.parametrize("pathtype", [0, 1, 2])
def test_path_to_polygons_matches_jax(join, pathtype):
    line = np.array([[0.0, 0.0], [100.0, 0.0], [150.0, 80.0], [150.0, 200.0]])
    ours = pgdsii.path_to_polygons(line, 20.0, pathtype, join=join)
    ref = jgdsii.path_to_polygons(line, 20.0, pathtype, join=join)
    assert len(ours) == len(ref) > 3
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_real8_matches_jax():
    for v in (0.0, 1e-9, 1e-3, 1.0, -2.5, 123456.789, -1e-6):
        assert pgdsii._float_to_real8(v) == jgdsii._float_to_real8(v)
        blob = jgdsii._float_to_real8(v)
        assert pgdsii._real8_to_float(blob) == jgdsii._real8_to_float(blob)


def test_text_elements_are_skipped_with_a_warning(tmp_path):
    g = jgdsii
    rec = lambda t, d, p=b"": (len(p) + 4).to_bytes(2, "big") + bytes([t, d]) + p
    path = tmp_path / "text.gds"
    path.write_bytes(b"".join([
        rec(g.HEADER, 2, (600).to_bytes(2, "big")),
        rec(g.UNITS, 5, g._float_to_real8(1e-3) + g._float_to_real8(1e-9)),
        rec(g.BGNSTR, 2, bytes(24)), rec(g.STRNAME, 6, b"TOP\0"),
        rec(g.TEXT, 0), rec(g.LAYER, 2, (5).to_bytes(2, "big")),
        rec(g.XY, 3, bytes(8)), rec(g.ENDEL, 0),
        rec(g.ENDSTR, 0), rec(g.ENDLIB, 0)]))
    with pytest.warns(UserWarning, match="TEXT"):
        lib = pgdsii.read_gds(path)
    assert lib.cells["TOP"].polygons == []


@pytest.mark.parametrize("fmt", ["gds", "oasis"])
@pytest.mark.parametrize("antialias", [0, 4])
@pytest.mark.parametrize("layer", [None, 1])
def test_mask_from_layout_matches_jax(tmp_path, fmt, antialias, layer):
    path = tmp_path / f"chip.{fmt}"
    (pgdsii.write_gds if fmt == "gds" else poasis.write_oasis)(
        path, _layout_cells())
    ours = playout.mask_from_layout(path, CFG, cell="TOP", layer=layer,
                                    antialias=antialias, device="cpu")
    ref = jlayout.mask_from_layout(path, JCFG, cell="TOP", layer=layer,
                                   antialias=antialias)
    assert ours.geometry.device.type == "cpu" and ours.config == CFG
    np.testing.assert_array_equal(ours.geometry.numpy(),
                                  np.asarray(ref.geometry))
    assert ours.geometry.sum() > 0
    assert playout.mask_from_gds is playout.mask_from_layout
    assert playout.mask_from_oasis is playout.mask_from_layout


def test_mask_from_polygons_centres_like_jax():
    polys = [np.array([[1000.0, 2000.0], [1200.0, 2000.0], [1200.0, 2300.0],
                       [1000.0, 2300.0]])]
    ours = pio.mask_from_polygons(polys, CFG, device="cpu")
    ref = jio.mask_from_polygons(polys, JCFG)
    np.testing.assert_array_equal(ours.geometry.numpy(),
                                  np.asarray(ref.geometry))
    assert ours.geometry.sum() == 8 * 12
    with pytest.raises(TypeError, match="device"):
        pio.mask_from_polygons(polys, CFG)


def test_window_provider_equals_slices_of_the_full_raster(tmp_path):
    """Streamed windows (negative halo corners included) are slices of one
    big raster, bit for bit, and equal JAX's windows."""
    big_n, n = 96, CFG.n
    rng = np.random.default_rng(3)
    polys = [np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]])
             for x, y, w, h in rng.uniform([0, 0, 30, 30],
                                           [2200, 2200, 300, 300], (25, 4))]
    path = tmp_path / "chip.gds"
    pgdsii.write_gds(path, {"TOP": [(1, p) for p in polys]})
    ours = playout.layout_window_provider(path, CFG, big_n, layer=1)
    ref = jlayout.layout_window_provider(path, JCFG, big_n, layer=1)
    lib_polys = [p.xy_nm for p in pgdsii.read_gds(path).flatten()]
    allv = np.concatenate(lib_polys)
    center = 0.5 * (allv.min(axis=0) + allv.max(axis=0))
    origin = center - big_n * CFG.pixel_size / 2.0
    pad = 16
    full = pio.rasterize(lib_polys, origin=tuple(origin - pad * CFG.pixel_size),
                         pixel_size=CFG.pixel_size, n=big_n + 2 * pad)
    for row0, col0 in ((-8, -8), (0, 40), (64, 72), (40, -16)):
        w = ours(row0, col0)
        np.testing.assert_array_equal(w, ref(row0, col0))
        np.testing.assert_array_equal(
            w, full[row0 + pad:row0 + pad + n, col0 + pad:col0 + pad + n])
    assert full.sum() > 0


def _cli_report(module, argv) -> dict:
    out = io.StringIO()
    with redirect_stdout(out):
        assert module.main(argv) == 0
    return json.loads(out.getvalue().splitlines()[0])


def test_cli_simulate_gds_mask_file_matches_jax_and_npy(tmp_path):
    """--mask-file chip.gds --gds-layer 1: the port's image equals the JAX
    CLI's (rtol 1e-6) and the port's own on the rasterized .npy."""
    gds = tmp_path / "chip.gds"
    pgdsii.write_gds(gds, _layout_cells())
    argv = ["simulate", "--pixel-number", "32", "--source", "classical",
            "--sigma-out", "0.5", "--normalize"]
    _cli_report(pcli, argv + ["--device", "cpu", "--mask-file", str(gds),
                              "--gds-layer", "1", "--out",
                              str(tmp_path / "p.npy")])
    _cli_report(jcli, argv + ["--mask-file", str(gds), "--gds-layer", "1",
                              "--out", str(tmp_path / "j.npy")])
    geometry = playout.mask_from_layout(gds, CFG, layer=1, device="cpu")
    np.save(tmp_path / "mask.npy", geometry.geometry.numpy())
    _cli_report(pcli, argv + ["--device", "cpu", "--mask-file",
                              str(tmp_path / "mask.npy"), "--out",
                              str(tmp_path / "n.npy")])
    ours = np.load(tmp_path / "p.npy")
    np.testing.assert_allclose(ours, np.load(tmp_path / "j.npy"), rtol=1e-6,
                               atol=1e-7 * np.abs(ours).max())
    np.testing.assert_array_equal(ours, np.load(tmp_path / "n.npy"))


def test_cli_demo_writes_the_figure_or_refuses(tmp_path, monkeypatch):
    """demo runs the reference's pipeline and writes the six-panel figure;
    without matplotlib it refuses the figure through _pyplot."""
    out = tmp_path / "demo.png"
    argv = ["demo", "--device", "cpu", "--pixel-number", "32", "--out",
            str(out)]
    buf = io.StringIO()
    with redirect_stdout(buf):
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            with pytest.raises(SystemExit, match="matplotlib"):
                pcli.main(argv)
        else:
            assert pcli.main(argv) == 0
            assert out.stat().st_size > 0
    assert "source points" in buf.getvalue()
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    with redirect_stdout(io.StringIO()), warnings.catch_warnings():
        with pytest.raises(SystemExit, match="matplotlib"):
            pcli.main(argv)
