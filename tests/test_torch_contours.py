"""Port parity: printed contours out (``io/contours.py``) against the JAX
package's.

The port traces through its own C++ library (``csrc/rasterizer.cpp``
``trace_loops``); its loops equal JAX's (same start, order and vertices),
re-rasterize to the binary raster bit for bit, equal the plain Python
walk (``_trace_loops_python``) as loop sets, and ``contours_to_gds``
writes the same bytes as JAX's. A device tensor is read back once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lithographysimulator_tpu import OpticsConfig as JConfig
from lithographysimulator_tpu.io import contours as jcontours
from lithographysimulator_tpu.io.gdsii import read_gds as jread_gds
from lithographysimulator_tpu_torch import OpticsConfig
from lithographysimulator_tpu_torch.io import contours as pcontours
from lithographysimulator_tpu_torch.io.native import trace_loops_native


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blobs(seed: int, n: int = 48) -> np.ndarray:
    noise = np.random.default_rng(seed).random((n, n))
    k = np.ones((5, 5)) / 25.0
    sm = np.real(np.fft.ifft2(np.fft.fft2(noise) * np.fft.fft2(k, s=noise.shape)))
    return (sm > np.median(sm)).astype(np.float64)


def _raster(kind: str) -> np.ndarray:
    m = np.zeros((32, 32))
    if kind == "rectangle":
        m[8:20, 4:14] = 1
    elif kind == "components":
        m[4:12, 4:20] = 1
        m[20:28, 8:12] = 1
        m[24:26, 26:30] = 1
    elif kind == "hole":
        m[4:28, 4:28] = 1
        m[10:20, 12:22] = 0
    elif kind == "checkerboard":
        m[8:12, 8:12] = 1
        m[12:16, 12:16] = 1
    elif kind == "full":
        m[:] = 1
    elif kind.startswith("blobs"):
        return _blobs(int(kind[-1]))
    return m


KINDS = ["rectangle", "components", "hole", "checkerboard", "empty", "full",
         "blobs0", "blobs1", "blobs2"]


def _canon(loop) -> tuple:
    pts = [tuple(v) for v in np.asarray(loop, np.int64).tolist()]
    best = min(range(len(pts)), key=lambda i: pts[i])
    return tuple(pts[best:] + pts[:best])


@pytest.mark.parametrize("kind", KINDS)
def test_trace_contours_matches_jax_and_round_trips(kind):
    m = _raster(kind)
    n = m.shape[0]
    ours = pcontours.trace_contours(m, pixel_size=3.0, origin=(5.0, -2.0))
    ref = jcontours.trace_contours(m, pixel_size=3.0, origin=(5.0, -2.0))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    grid = pcontours.rasterize_loops(ours, pixel_size=3.0, n=n,
                                     origin=(5.0, -2.0))
    np.testing.assert_array_equal(grid > 0.5, m > 0.5)
    np.testing.assert_array_equal(
        grid, jcontours.rasterize_loops(ref, pixel_size=3.0, n=n,
                                        origin=(5.0, -2.0)))


@pytest.mark.parametrize("kind", KINDS)
def test_native_walk_matches_the_plain_walk(kind):
    m = _raster(kind) > 0.5
    native = trace_loops_native(m)
    plain = pcontours._trace_loops_python(m)
    assert sorted(map(_canon, native)) == sorted(map(_canon, plain))


def test_rectangle_is_four_vertices_and_hole_is_separate():
    loops = pcontours.trace_contours(_raster("rectangle"))
    assert len(loops) == 1 and loops[0].shape == (4, 2)
    assert len(pcontours.trace_contours(_raster("hole"))) == 2
    assert len(pcontours.trace_contours(_raster("checkerboard"))) == 2


def test_a_device_tensor_profile_is_read_back():
    m = _raster("components")
    ours = pcontours.trace_contours(torch.as_tensor(m, dtype=torch.float32),
                                    threshold=0.5, pixel_size=2.0)
    ref = jcontours.trace_contours(m, threshold=0.5, pixel_size=2.0)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="2-D"):
        pcontours.trace_contours(np.zeros((2, 3, 4)))


def test_contours_to_gds_matches_jax(tmp_path):
    m = np.zeros((32, 32))
    m[6:18, 6:26] = 1
    m[22:28, 10:14] = 1
    m[8:12, 10:14] = 0
    ours = pcontours.contours_to_gds(tmp_path / "p.gds", m,
                                     OpticsConfig(pixel_number=32,
                                                  pixel_size=10.0), layer=7)
    ref = jcontours.contours_to_gds(tmp_path / "j.gds", m,
                                    JConfig(pixel_number=32, pixel_size=10.0),
                                    layer=7)
    assert ours.read_bytes() == ref.read_bytes()
    polys = [p.xy_nm for p in jread_gds(ours).flatten("CONTOUR")
             if p.layer == 7]
    assert len(polys) == 3
    grid = pcontours.rasterize_loops(polys, pixel_size=10.0, n=32)
    np.testing.assert_array_equal(grid > 0.5, m > 0.5)
    # a bare pixel size works in place of a config
    pcontours.contours_to_gds(tmp_path / "q.gds", m, 10.0, layer=7)
    assert (tmp_path / "q.gds").read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("kind", ["hole", "checkerboard", "full", "blobs1",
                                  "blobs2"])
@pytest.mark.parametrize("shift", [0, 5])
def test_rasterize_loops_windows_equal_the_whole_grid(kind, shift):
    """Each loop is rasterized over its bounding box only: the result
    equals the XOR of every loop over the whole grid, also where the grid
    (moved by ``shift`` pixels) cuts loops at its edges."""
    from lithographysimulator_tpu_torch.io.native import rasterize

    m = _raster(kind)
    px, origin = 3.0, (5.0, -2.0)
    loops = pcontours.trace_contours(m, pixel_size=px, origin=origin)
    n = m.shape[0] - shift
    moved = (origin[0] + shift * px, origin[1] + shift * px)
    whole = np.zeros((n, n), bool)
    for loop in loops:
        whole ^= rasterize([loop], origin=moved, pixel_size=px, n=n) > 0.5
    grid = pcontours.rasterize_loops(loops, pixel_size=px, n=n, origin=moved)
    assert grid.dtype == np.float32
    np.testing.assert_array_equal(grid > 0.5, whole)
    np.testing.assert_array_equal(grid > 0.5, m[shift:, shift:] > 0.5)
