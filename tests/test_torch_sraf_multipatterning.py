"""Port parity: assist features (models/sraf.py) and multiple patterning
(models/multipatterning.py), the port's own host copies, against the JAX
package's on the CPU.

The host functions (band, insert, print check, conflict pairs, the two
decompositions, the subpixel shift) must equal JAX's bit for bit,
tensors in as well as numpy. multipatterning_print and lele_print image
each mask through the port's tiled_focus_images: at
tests/test_multipatterning.py's 64^2 dense lines with a classical
sigma-0.2 source (37 live points) at rank 24 the 40 probes of a
randomized build span the whole range, so both packages' kernels are
exact, the images agree in the float32 class and every binary profile
equals JAX's (no pixel sits within that class of the threshold).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
from lithographysimulator_tpu.models import mrc as jmrc
from lithographysimulator_tpu.models import multipatterning as jmp
from lithographysimulator_tpu.models import sraf as jsraf
from lithographysimulator_tpu.models.resist import ResistModel as JResist
from lithographysimulator_tpu_torch.interop import config_from_jax, resist_from_jax
from lithographysimulator_tpu_torch.models import multipatterning as pmp
from lithographysimulator_tpu_torch.models import sraf as psraf

CFG = jt.OpticsConfig(pixel_number=64)
PCFG = config_from_jax(CFG)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dense_lines(n=64, w=3, pitch=6):
    m = np.zeros((n, n), np.float32)
    for x in range(4, n - 4, pitch):
        m[8:-8, x:x + w] = 1.0
    return m


def _triangle():
    m = np.zeros((64, 64), np.float32)
    m[20:26, 20:26] = 1.0
    m[20:26, 30:36] = 1.0
    m[30:36, 25:31] = 1.0
    return m


def _blobs(seed: int, n: int = 48, count: int = 14) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n), np.int8)
    for _ in range(count):
        y, x = rng.integers(2, n - 6, 2)
        h, w = rng.integers(2, 6, 2)
        m[y:y + h, x:x + w] = 1
    return m


def _equal_reports(ours: dict, ref: dict) -> None:
    assert ours.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], list):
            assert len(ours[k]) == len(ref[k])
            for a, b in zip(ours[k], ref[k]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        elif isinstance(ref[k], np.ndarray):
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k])
        else:
            assert ours[k] == ref[k], k


@pytest.mark.parametrize("as_tensor", [False, True])
def test_sraf_functions_equal_jax(as_tensor):
    iso = np.zeros((64, 64), np.float32)
    iso[10:54, 30:36] = 1.0
    iso[10:54, 8:10] = 1.0  # a dense neighbor on one side
    conv = torch.as_tensor if as_tensor else np.asarray
    for pixel in (CFG, 25.0):
        port_pixel = PCFG if pixel is CFG else pixel
        kw = dict(distance_nm=150.0, width_nm=25.0)
        band = psraf.sraf_band(conv(iso), port_pixel, **kw)
        np.testing.assert_array_equal(band, jsraf.sraf_band(iso, pixel, **kw))
        assert band.dtype == bool and band.any()
        ins = psraf.sraf_insert(conv(iso), port_pixel, **kw)
        ref = jsraf.sraf_insert(iso, pixel, **kw)
        assert ins.dtype == ref.dtype
        np.testing.assert_array_equal(ins, ref)
    printed = np.zeros_like(iso)
    printed[10:54, 29:37] = 1.0
    printed[30, 40] = 1.0  # one printed pixel in the assist zone
    ours = psraf.sraf_print_check(conv(printed), conv(ins), conv(iso))
    assert ours == jsraf.sraf_print_check(printed, ins, iso)
    assert ours["sraf_px"] > 0
    for bad in (dict(distance_nm=0.0, width_nm=25.0),
                dict(distance_nm=150.0, width_nm=-1.0)):
        with pytest.raises(ValueError, match="must be > 0"):
            psraf.sraf_band(iso, PCFG, **bad)


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 2), (2, 3), (3, 5)])
def test_conflict_pairs_matches_brute_force(seed, k):
    """tests/test_multipatterning.py's cases: the port's offset scan gives
    JAX's pairs, which are the all-pairs Chebyshev oracle's."""
    from lithographysimulator_tpu_torch.models.mrc import label_components

    m = _blobs(seed)
    labels, count = label_components(m)
    labels_ref, count_ref = jmrc.label_components(m)
    np.testing.assert_array_equal(labels, labels_ref)
    got = pmp.conflict_pairs(labels, k)
    ref = jmp.conflict_pairs(labels_ref, k)
    np.testing.assert_array_equal(got, ref)
    coords = {lab: np.argwhere(labels == lab) for lab in range(1, count + 1)}
    brute = set()
    for a in range(1, count + 1):
        for b in range(a + 1, count + 1):
            d = np.abs(coords[a][:, None, :] - coords[b][None, :, :])
            if d.max(axis=-1).min() <= k:
                brute.add((a, b))
    assert {tuple(p) for p in got} == brute


@pytest.mark.parametrize("layout,pitch,masks", [
    ("dense", 200.0, 2), ("dense", 300.0, 3), ("dense", 300.0, 2),
    ("triangle", 200.0, 2), ("triangle", 200.0, 3), ("blobs", 75.0, 4),
    ("empty", 200.0, 2)])
def test_decompose_equals_jax(layout, pitch, masks):
    m = {"dense": _dense_lines(), "triangle": _triangle(),
         "blobs": _blobs(7, 64, 30).astype(np.float32),
         "empty": np.zeros((64, 64), np.float32)}[layout]
    ours = pmp.decompose_multipatterning(torch.as_tensor(m), PCFG,
                                         min_pitch_nm=pitch, masks=masks)
    _equal_reports(ours, jmp.decompose_multipatterning(
        m, CFG, min_pitch_nm=pitch, masks=masks))
    if masks == 2:
        _equal_reports(pmp.decompose_lele(m, 25.0, min_pitch_nm=pitch),
                       jmp.decompose_lele(m, 25.0, min_pitch_nm=pitch))
    with pytest.raises(ValueError, match="masks >= 2"):
        pmp.decompose_multipatterning(m, PCFG, min_pitch_nm=pitch, masks=1)


def test_subpixel_shift_equals_jax():
    f = np.random.default_rng(3).random((64, 48)).astype(np.float32)
    for dy, dx in ((0.0, 0.0), (0.0, 10.0), (-7.5, 3.25)):
        ours = pmp.subpixel_shift(f, dy, dx, 25.0)
        ref = jmp.subpixel_shift(f, dy, dx, 25.0)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


def _source():
    src = np.asarray(jt.LightSource(CFG, sigma_out=0.2).classical())
    assert (src > 0).sum() == 37
    return src


@pytest.mark.parametrize("overlay", [None, [(0.0, 0.0), (0.0, 10.0), (5.0, 0.0)]])
def test_multipatterning_print_matches_jax(overlay):
    kw = dict(min_pitch_nm=300.0, masks=3, rank=24, halo=16,
              resist=JResist(threshold=0.45), overlay_nm=overlay)
    seen, seen_ref = [], []
    ref = jmp.multipatterning_print(_dense_lines(), CFG, _source(),
                                    progress_cb=seen_ref.append, **kw)
    kw["resist"] = resist_from_jax(kw["resist"])
    ours = pmp.multipatterning_print(_dense_lines(), PCFG, _source(),
                                     progress_cb=seen.append, device="cpu",
                                     **kw)
    assert seen == pytest.approx(seen_ref, rel=1e-12) and max(seen) <= 1.0
    _equal_reports(ours, ref)
    assert ours["profile"].any() and ours["violations"] == 0
    with pytest.raises(ValueError, match="device="):
        pmp.multipatterning_print(_dense_lines(), PCFG, _source(), **kw)
    with pytest.raises(ValueError, match="one \\(dy, dx\\) pair per mask"):
        pmp.multipatterning_print(_dense_lines(), PCFG, _source(),
                                  device="cpu", **{**kw, "overlay_nm": [(0, 0)]})


def test_lele_print_matches_jax():
    kw = dict(min_pitch_nm=200.0, rank=24, halo=16,
              overlay_nm=[(0.0, 0.0), (0.0, 10.0)])
    ref = jmp.lele_print(_dense_lines(), CFG, _source(),
                         resist=JResist(threshold=0.45), **kw)
    ours = pmp.lele_print(torch.as_tensor(_dense_lines()), PCFG, _source(),
                          resist=resist_from_jax(JResist(threshold=0.45)), **kw)
    for key in ("mask_a", "mask_b", "profile_a", "profile_b"):
        assert key in ours and "masks" not in ours and "profiles" not in ours
    _equal_reports(ours, ref)
