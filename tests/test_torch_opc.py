"""Port parity: resist-aware OPC (optimize.opc_correct, opc_correct_pw and
opc_correct_tiled) against the JAX package on the CPU.

opc_correct runs at tests/test_optimize.py's 32^2 grid (demo_bars, chunk
8, classical sigma 0.4) with coma and astigmatism, so no gradient
vanishes by symmetry. The develop normalizes by the image maximum, and
where the maximum is tied jnp.max splits its gradient evenly over the
ties: the port's torch.max does the same (held on a mirror-symmetrized
image, whose maximum is tied by construction). opc_correct_pw runs at
32^2 and rank 16 on a 9-point source (classical sigma 0.2), where both
packages' randomized builds are complete and agree. opc_correct_tiled
runs tests/test_opc_tiled.py's 128^2 chip of rectangles through 64^2
tiles with a 16 px halo (4 x 4 tiles); its sweeps take JAX's own kernel
set (a randomized build draws other probes in each package), and the
public function, which builds its own, uses a classical sigma-0.2 source
(37 live points) at rank 24, where both builds are exact. Tolerances are
measured values with a margin, stated with each.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import lithographysimulator_tpu as jt
from lithographysimulator_tpu import optimize as jo
from lithographysimulator_tpu.models.resist import ResistModel as JResist
from lithographysimulator_tpu.parallel import padded_source_arrays
from lithographysimulator_tpu.simulate import _socs_build_with_channels
from lithographysimulator_tpu_torch import optimize as po
from lithographysimulator_tpu_torch.interop import (config_from_jax,
                                                    resist_from_jax,
                                                    smo_problem_from_jax,
                                                    socs_from_numpy)

CFG = jt.OpticsConfig(pixel_number=32)
PCFG = config_from_jax(CFG)
CHUNK = 8
ABERR = np.array([0, 0, 0.03, 0.02, 20.0, 0, 0, 0.04], np.float32)
RESIST = JResist(threshold=0.35, steepness=30.0)
TILE_CFG = jt.OpticsConfig(pixel_number=64)
TILE_PCFG = config_from_jax(TILE_CFG)
BIG_N = 128
HALO = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def points():
    src = np.asarray(jt.LightSource(CFG, sigma_out=0.4).classical())
    shifts, weights, _ = padded_source_arrays(src, 8 * CHUNK)
    return np.asarray(shifts), np.asarray(weights)


@pytest.fixture(scope="module")
def layout():
    """tests/test_opc_tiled.py's corner-heavy layout of isolated
    rectangles."""
    t = np.zeros((BIG_N, BIG_N), np.float32)
    for y in range(16, BIG_N - 16, 40):
        for x in range(16, BIG_N - 16, 40):
            t[y:y + 12, x:x + 20] = 1.0
    return t


def test_opc_correct_matches_jax(points):
    """History within 1e-5 relative and the corrected mask (in (0, 1))
    within 1e-5 (measured 3.4e-7 and 1.2e-7)."""
    shifts, weights = points
    target = np.asarray(jt.demo_bars(CFG).geometry, np.float32)
    jp = jo.SMOProblem(config=CFG, chunk=CHUNK)
    ref, hist_ref = jo.opc_correct(target, ABERR, shifts, weights, jp,
                                   resist=RESIST, steps=4, learning_rate=0.1)
    ours, hist = po.opc_correct(target, ABERR, shifts, weights,
                                smo_problem_from_jax(jp),
                                resist=resist_from_jax(RESIST), steps=4,
                                learning_rate=0.1, device="cpu")
    assert ours.shape == target.shape and ours.device.type == "cpu"
    assert hist[-1] < hist[0]
    np.testing.assert_allclose(hist, hist_ref, rtol=1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="device="):
        po.opc_correct(target, ABERR, shifts, weights, smo_problem_from_jax(jp),
                       steps=1)


def test_develop_splits_a_tied_maximum_like_jax(points):
    """The OPC loss's gradient in the image when the image maximum is tied:
    both packages split it evenly over the tied pixels."""
    shifts, weights = points
    jp = jo.SMOProblem(config=CFG, chunk=CHUNK)
    design = np.asarray(jt.demo_bars(CFG).geometry, np.float32)
    image = np.asarray(jo.forward(jo.init_params(jp, design),
                                  np.zeros(1, np.float32), shifts, weights, jp))
    image = 0.5 * (image + image[:, ::-1])  # mirror pairs equal bit for bit
    ties = np.argwhere(image == image.max())
    assert len(ties) >= 2

    def loss_ref(img):
        return jnp.mean((RESIST.develop(img, CFG) - design) ** 2)

    g_ref = np.asarray(jax.grad(loss_ref)(jnp.asarray(image)))
    img = torch.as_tensor(image).requires_grad_()
    torch.mean((resist_from_jax(RESIST).develop(img, PCFG)
                - torch.as_tensor(design)) ** 2).backward()
    g = img.grad.numpy()
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=1e-6 * np.abs(g_ref).max())
    at_ties = g[ties[:, 0], ties[:, 1]]
    assert np.all(at_ties == at_ties[0])


def _pw_inputs():
    target = np.asarray(jt.demo_bars(CFG).geometry, np.float32)
    src = np.asarray(jt.LightSource(CFG, sigma_out=0.2).classical())
    assert (src > 0).sum() == 9
    return target, src


def test_opc_correct_pw_matches_jax():
    """3 x 3 corners, rank 16, 3 steps: the report's keys and shapes, the
    history and the last step's corner losses within 1e-5 relative
    (measured 1.8e-7 and 6.0e-7), the mask within 1e-5 (1.2e-7)."""
    target, src = _pw_inputs()
    kw = dict(defocus_nm=(-60.0, 0.0, 60.0), doses=(0.95, 1.0, 1.05),
              steps=3, rank=16, aberrations=np.array([0, 0, 0.02], np.float32))
    ref_mask, ref = jo.opc_correct_pw(target, CFG, src, resist=RESIST, **kw)
    mask, rep = po.opc_correct_pw(target, PCFG, src,
                                  resist=resist_from_jax(RESIST),
                                  device="cpu", **kw)
    assert rep.keys() == ref.keys()
    assert rep["corner_losses"].shape == (3, 3) and isinstance(
        rep["corner_losses"], np.ndarray)
    assert rep["defocus_nm"] == ref["defocus_nm"] and rep["doses"] == ref["doses"]
    h = rep["loss_history"]
    assert len(h) == 3 and h[-1] < h[0]
    np.testing.assert_allclose(h, ref["loss_history"], rtol=1e-5)
    np.testing.assert_allclose(rep["corner_losses"], ref["corner_losses"],
                               rtol=1e-5)
    np.testing.assert_allclose(mask.numpy(), np.asarray(ref_mask), rtol=0,
                               atol=1e-5)


def test_opc_correct_pw_corner_weights():
    target, src = _pw_inputs()
    kw = dict(defocus_nm=(0.0, 50.0), doses=(1.0,), steps=1, rank=16)
    w = np.array([3.0, 1.0], np.float32)
    _, ref = jo.opc_correct_pw(target, CFG, src, resist=RESIST,
                               corner_weights=w, **kw)
    _, rep = po.opc_correct_pw(target, PCFG, src, resist=resist_from_jax(RESIST),
                               corner_weights=w, device="cpu", **kw)
    np.testing.assert_allclose(rep["loss_history"], ref["loss_history"],
                               rtol=1e-5)
    assert rep["loss_history"][0] == pytest.approx(
        float(rep["corner_losses"].ravel() @ (w / w.sum())), rel=1e-6)
    for bad in (np.ones(3, np.float32), np.ones((2, 1), np.float32)):
        with pytest.raises(ValueError, match="corner_weights shape") as exc:
            po.opc_correct_pw(target, PCFG, src, corner_weights=bad,
                              device="cpu", **kw)
        with pytest.raises(ValueError, match="corner_weights shape") as exc_ref:
            jo.opc_correct_pw(target, CFG, src, corner_weights=bad, **kw)
        assert str(exc.value) == str(exc_ref.value)


@pytest.fixture(scope="module")
def tile_source():
    return np.asarray(jt.LightSource(TILE_CFG, sigma_out=0.6).annular())


@pytest.fixture(scope="module")
def jax_kernels(tile_source):
    """The kernel set the JAX package's opc_correct_tiled builds (rank 48),
    carried over to the port."""
    socs = _socs_build_with_channels(TILE_CFG, 48)(
        np.zeros((5,), np.float32), tile_source)[0]
    return socs, socs_from_numpy(np.asarray(socs.kernels),
                                 np.asarray(socs.eigenvalues),
                                 socs.total_rank, device="cpu")


def _tiles(layout, socs, *, sweeps=1, steps=3, progress_cb=None):
    return po._opc_tiles(layout, socs, TILE_PCFG, halo=HALO, steps=steps,
                         learning_rate=0.2, mask_steepness=4.0,
                         resist=resist_from_jax(JResist(threshold=0.3,
                                                        steepness=30.0)),
                         sweeps=sweeps, progress_cb=progress_cb, mask3d=None)


@pytest.mark.parametrize("sweeps", [1, 2])
def test_opc_correct_tiled_sweeps_match_jax(layout, tile_source, jax_kernels,
                                            sweeps):
    """On JAX's kernels, 16 tiles a sweep: the corrected chip within 1e-5
    of JAX's (measured 1.2e-7 after 1 and 2 sweeps), and the same progress
    fractions in the same order."""
    jsocs, psocs = jax_kernels
    seen_ref, seen = [], []
    ref = jo.opc_correct_tiled(
        layout, TILE_CFG, tile_source, resist=JResist(threshold=0.3,
                                                      steepness=30.0),
        halo=HALO, steps=3, rank=48, learning_rate=0.2, sweeps=sweeps,
        progress_cb=seen_ref.append)
    ours = _tiles(layout, psocs, sweeps=sweeps, progress_cb=seen.append)
    assert isinstance(ours, np.ndarray) and ours.shape == (BIG_N, BIG_N)
    assert ours.dtype == np.float32
    assert seen == seen_ref and len(seen) == 16 * sweeps and seen[-1] == 1.0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    # the correction moved the mask beyond the latent's 1e-4 clip
    assert np.abs(ours - layout).max() > 5e-4


def test_opc_correct_tiled_is_gauss_seidel(layout, jax_kernels, monkeypatch):
    """Tile (0, 1), the second in row-major order, starts from a frozen
    ring that holds tile (0, 0)'s corrected core where the two overlap,
    not the design."""
    _, psocs = jax_kernels
    firsts = []
    real = po.mask_spectrum

    def record(mask, *a, **kw):
        firsts.append(mask.detach().clone())
        return real(mask, *a, **kw)

    monkeypatch.setattr(po, "mask_spectrum", record)
    out = _tiles(layout, psocs, steps=3)
    step = 64 - 2 * HALO
    # one mask a step, 3 steps a tile: the first of tile (0, 1), whose
    # window starts at column `step` of the padded chip; its left ring
    # (chip columns step - HALO .. step) lies in tile (0, 0)'s core
    mask01 = firsts[3].numpy()
    ring = mask01[HALO:64 - HALO, :HALO]
    corrected00 = out[:step, step - HALO:step]  # chip = padded - HALO
    design = layout[:step, step - HALO:step]
    np.testing.assert_array_equal(ring, corrected00)
    assert np.abs(ring - design).max() > 5e-4


def test_opc_correct_tiled_builds_like_jax():
    """The public function, building its own kernels (exact at 37 live
    points and rank 24): within 1e-5 of JAX's (measured 2.3e-7); host
    data needs device=."""
    chip = np.zeros((BIG_N, BIG_N), np.float32)
    chip[40:60, 30:90] = 1.0
    src = np.asarray(jt.LightSource(TILE_CFG, sigma_out=0.2).classical())
    kw = dict(halo=HALO, steps=2, rank=24, learning_rate=0.2)
    ref = jo.opc_correct_tiled(chip, TILE_CFG, src, **kw)
    ours = po.opc_correct_tiled(chip, TILE_PCFG, src, device="cpu", **kw)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    again = po.opc_correct_tiled(torch.as_tensor(chip), TILE_PCFG, src, **kw)
    np.testing.assert_array_equal(again, ours)
    with pytest.raises(ValueError, match="device="):
        po.opc_correct_tiled(chip, TILE_PCFG, src, **kw)
