"""Port parity: the tiled full-chip imager (ops/tiled.py) of the torch port
(device='cpu') against the JAX package's, on the same kernels.

Both packages tile with the JAX kernel set carried across by
``socs_from_numpy`` (a randomized build draws other probes in each
package). Tolerances: the stitched images of the array, stream, scan and
field paths within 1e-5 of JAX's maximum (TOL_SOCS_PAIR; measured
4.5e-7); the streamed image within 1e-6 of the array path
(tests/test_tiled_stream.py:24-30); a feature inside one tile core within
1e-4 of a single-field image (tests/test_tiled.py:81-103);
tiles_per_dispatch and the scan variant bit for bit. The field path
builds its kernels itself: at 37 live source points and rank 24, the 40
probes span the whole range, so both packages' builds are exact and the
images agree in the same 1e-5 class.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.simulate import _compiled_socs_build
from lithographysimulator_tpu_torch.interop import (config_from_jax,
                                                    mask3d_from_jax,
                                                    socs_from_numpy)

JCFG = jt.OpticsConfig(pixel_number=64)
PCFG = config_from_jax(JCFG)
BIG_N = 160  # not a multiple of the 32 px core step
HALO = 16
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def src():
    return np.asarray(jt.LightSource(JCFG, sigma_out=0.2).classical())


@pytest.fixture(scope="module")
def kernels(src):
    js = _compiled_socs_build(JCFG, 24)(np.zeros(5, np.float32), src)[0]
    return js, socs_from_numpy(np.asarray(js.kernels),
                               np.asarray(js.eigenvalues), js.total_rank,
                               device="cpu")


@pytest.fixture(scope="module")
def chip():
    rng = np.random.default_rng(7)
    m = np.zeros((BIG_N, BIG_N), np.float32)
    for _ in range(14):  # contacts, some across the seams
        y, x = rng.integers(4, BIG_N - 10, 2)
        m[y:y + 6, x:x + 6] = 1.0
    m[20:140, 62:68] = 1.0  # a line through the seam at 64
    return m


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def jax_image(chip, kernels):
    return np.asarray(jt.tiled_socs_image(chip, kernels[0], JCFG, halo=HALO))


def test_layout_helpers_match_jax():
    from lithographysimulator_tpu.ops import tiled as jtl
    from lithographysimulator_tpu_torch.ops import tiled as ptl

    for n, px in ((64, 25.0), (128, 25.0), (1024, 25.0), (512, 10.0)):
        jc = jt.OpticsConfig(pixel_number=n, pixel_size=px)
        for w in (2.0, 8.0):
            assert (pt.default_halo(config_from_jax(jc), wavelengths=w)
                    == jt.default_halo(jc, wavelengths=w))
    for big_n, tile_n, halo in ((8192, 1024, 96), (160, 64, 16), (7, 64, 0)):
        assert ptl.tile_layout(big_n, tile_n, halo) == jtl.tile_layout(
            big_n, tile_n, halo)
    assert ptl.tile_layout(8192, 1024, 96) == (10, 832)
    with pytest.raises(ValueError, match="too large"):
        ptl.tile_layout(256, 64, 32)


def test_tiled_image_matches_jax(chip, kernels, jax_image):
    ours = pt.tiled_socs_image(chip, kernels[1], PCFG, halo=HALO)
    assert isinstance(ours, torch.Tensor) and ours.shape == (BIG_N, BIG_N)
    assert ours.dtype == torch.float32 and ours.device.type == "cpu"
    assert _rel(ours.numpy(), jax_image) <= TOL


def test_stream_matches_array_path_and_jax(chip, kernels, jax_image):
    dense = pt.tiled_socs_image(chip, kernels[1], PCFG, halo=HALO).numpy()
    window_fn = pt.array_window_fn(chip, PCFG.n)
    jwin = jt.array_window_fn(chip, JCFG.n)
    for row0, col0 in ((-16, -16), (48, 80), (144, 150)):
        np.testing.assert_array_equal(window_fn(row0, col0),
                                      jwin(row0, col0))
    streamed = pt.tiled_socs_image_stream(window_fn, BIG_N, kernels[1], PCFG,
                                          halo=HALO, tiles_per_dispatch=3)
    np.testing.assert_allclose(streamed.numpy(), dense, rtol=0,
                               atol=1e-6 * dense.max())
    ref = np.asarray(jt.tiled_socs_image_stream(jwin, BIG_N, kernels[0], JCFG,
                                                halo=HALO))
    assert _rel(streamed.numpy(), ref) <= TOL
    assert _rel(streamed.numpy(), jax_image) <= TOL


def test_scan_and_tiles_per_dispatch_change_nothing(chip, kernels):
    """One group, one tile a group, a non-divisor and more than the tile
    count: the same image, bit for bit (test_tiled.py:123 holds 1e-6)."""
    base = pt.tiled_socs_image(chip, kernels[1], PCFG, halo=HALO)
    for k in (1, 3, 64):
        assert torch.equal(pt.tiled_socs_image(
            chip, kernels[1], PCFG, halo=HALO, tiles_per_dispatch=k), base)
    assert torch.equal(pt.tiled_socs_image_scan(chip, kernels[1], PCFG,
                                                halo=HALO), base)


def test_progress_reports_each_group(chip, kernels):
    seen, ref = [], []
    pt.tiled_socs_image(chip, kernels[1], PCFG, halo=HALO,
                        tiles_per_dispatch=10, progress_cb=seen.append)
    jt.tiled_socs_image(chip, kernels[0], JCFG, halo=HALO,
                        tiles_per_dispatch=10, progress_cb=ref.append)
    assert seen == ref == [1 / 3, 2 / 3, 1.0]  # 25 tiles in groups of 10


def test_isolated_feature_matches_single_field(kernels):
    """A contact inside tile (1, 1)'s core images as the same contact in a
    standalone field (the halo-sufficiency contract)."""
    n = PCFG.n
    step = n - 2 * HALO
    field = np.zeros((n, n), np.float32)
    field[28:36, 28:36] = 1.0
    direct = pt.socs_image(pt.mask_spectrum(torch.as_tensor(field), PCFG),
                           kernels[1], PCFG).numpy()
    big = np.zeros((128, 128), np.float32)
    oy = step - HALO
    big[oy + 28:oy + 36, oy + 28:oy + 36] = 1.0
    tiled = pt.tiled_socs_image(big, kernels[1], PCFG, halo=HALO).numpy()
    core = direct[HALO:HALO + step, HALO:HALO + step]
    np.testing.assert_allclose(tiled[step:2 * step, step:2 * step], core,
                               rtol=1e-4, atol=1e-4 * core.max())


def test_empty_and_non_divisible_chips(kernels):
    empty = pt.tiled_socs_image(np.zeros((128, 128), np.float32), kernels[1],
                                PCFG, halo=HALO)
    assert empty.shape == (128, 128) and float(empty.abs().max()) == 0.0
    rng = np.random.default_rng(3)
    m = (rng.random((100, 100)) < 0.1).astype(np.float32)
    img = pt.tiled_socs_image(m, kernels[1], PCFG, halo=HALO)
    assert img.shape == (100, 100) and bool(torch.isfinite(img).all())
    ref = np.asarray(jt.tiled_socs_image(m, kernels[0], JCFG, halo=HALO))
    assert _rel(img.numpy(), ref) <= TOL


def test_halo_offset_invariance(chip, kernels):
    """Other halos move every seam; the image changes only by PSF-tail
    truncation, and a wider halo comes closer (test_tiled.py:47-62)."""
    a = pt.tiled_socs_image(chip, kernels[1], PCFG, halo=16).numpy()
    b = pt.tiled_socs_image(chip, kernels[1], PCFG, halo=20).numpy()
    wider = pt.tiled_socs_image(chip, kernels[1], PCFG, halo=24).numpy()
    rms = lambda x, y: float(np.sqrt(np.mean((x - y) ** 2)) / y.max())
    assert rms(a, b) < 4e-3
    assert rms(b, wider) < rms(a, wider)


def test_mask3d_halo_check_and_thick_tiles(chip, kernels):
    from lithographysimulator_tpu.ops.mask3d import BoundaryLayer, EdgeKernelM3D

    ek = EdgeKernelM3D(taps_v_rise=(0.1, 0.2, 0.1), taps_v_fall=(0.1, 0.2, 0.1),
                       taps_h_rise=(0.1, 0.2, 0.1), taps_h_fall=(0.1, 0.2, 0.1))
    with pytest.raises(ValueError, match="stencil"):
        pt.tiled_socs_image(chip, kernels[1], PCFG, halo=1,
                            mask3d=mask3d_from_jax(ek))
    bl = BoundaryLayer(width_nm=8.0, beta_h=-0.3, beta_v=-0.3 + 0.1j)
    ours = pt.tiled_socs_image(chip, kernels[1], PCFG, halo=HALO,
                               mask3d=mask3d_from_jax(bl)).numpy()
    ref = np.asarray(jt.tiled_socs_image(chip, kernels[0], JCFG, halo=HALO,
                                         mask3d=bl))
    assert _rel(ours, ref) <= TOL
    thin = pt.tiled_socs_image(chip, kernels[1], PCFG, halo=HALO).numpy()
    assert np.linalg.norm(ours - thin) / np.linalg.norm(thin) > 1e-3


@pytest.mark.parametrize("blend", ["nearest", "linear"])
def test_field_dependent_image_matches_jax(chip, src, blend):
    """Field-sampled kernels (a strong defocus toward the field edge):
    the port's image equals JAX's, and a constant field equals one
    sample."""
    from lithographysimulator_tpu.ops.tiled import tiled_socs_image_field

    def slit(fx, fy):
        return np.array([0, 0, 0, 0, 120.0 * (fx * fx + fy * fy)], np.float32)

    kw = dict(field_points=3, rank=24, halo=HALO, blend=blend)
    ours = pt.tiled_socs_image_field(chip, PCFG, src, slit, device="cpu",
                                     **kw).numpy()
    ref = np.asarray(tiled_socs_image_field(chip, JCFG, src, slit, **kw))
    assert _rel(ours, ref) <= TOL
    flat = lambda fx, fy: np.zeros(5, np.float32)
    one = pt.tiled_socs_image_field(chip, PCFG, src, flat, device="cpu",
                                    **{**kw, "field_points": 1}).numpy()
    three = pt.tiled_socs_image_field(chip, PCFG, src, flat, device="cpu",
                                      **kw).numpy()
    np.testing.assert_allclose(three, one, rtol=1e-5, atol=1e-5 * one.max())
    with pytest.raises(ValueError, match="device"):
        pt.tiled_socs_image_field(chip, PCFG, src, flat, **kw)


def test_per_tile_mask3d_matches_global_apply(src):
    """Applying the boundary layer tile by tile equals applying it to the
    whole chip first and tiling the complex effective mask: the stencil is
    local and the window's wraparound ring lies in the cropped halo
    (tests/test_mask3d.py:311-350 and its tolerance)."""
    from lithographysimulator_tpu_torch.ops.mask3d import (
        BoundaryLayer, apply_boundary_layers)

    socs = pt.randomized_socs(pt.pupil_function(np.zeros(1), PCFG,
                                                device="cpu"),
                              src, PCFG, rank=24, seed=1)
    rng = np.random.default_rng(3)
    chip = (rng.random((128, 128)) > 0.6).astype(np.float32)
    chip[:6] = chip[-6:] = 0.0
    chip[:, :6] = chip[:, -6:] = 0.0
    bl = BoundaryLayer(width_nm=8.0, beta_h=-0.2, beta_v=-0.35 + 0.1j)
    per_tile = pt.tiled_socs_image(chip, socs, PCFG, halo=HALO,
                                   mask3d=bl).numpy()
    eff = apply_boundary_layers(torch.as_tensor(chip), PCFG,
                                width_nm=bl.width_nm, beta_h=bl.beta_h,
                                beta_v=bl.beta_v)
    assert eff.is_complex()
    whole = pt.tiled_socs_image(eff, socs, PCFG, halo=HALO).numpy()
    np.testing.assert_allclose(per_tile, whole, rtol=4e-3,
                               atol=1e-3 * float(whole.max()))


def test_complex_chip_matches_jax(kernels):
    """A complex chip (an attenuated phase-shift mask) stays complex
    through the tiles, as in the JAX package."""
    rng = np.random.default_rng(11)
    chip = np.where(rng.random((128, 128)) > 0.7, 1.0,
                    -0.245j).astype(np.complex64)
    ours = pt.tiled_socs_image(chip, kernels[1], PCFG, halo=HALO).numpy()
    ref = np.asarray(jt.tiled_socs_image(chip, kernels[0], JCFG, halo=HALO))
    assert _rel(ours, ref) <= TOL
    real_only = pt.tiled_socs_image(chip.real.copy(), kernels[1], PCFG,
                                    halo=HALO).numpy()
    assert _rel(real_only, ref) > 1e-2
