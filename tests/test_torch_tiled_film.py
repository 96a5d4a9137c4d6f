"""Port parity: the full-chip image in the resist (ops/tiled.py
tiled_film_stack) of the torch port (device='cpu') against the JAX
package's, on the same per-slab kernels (JAX's film_socs_kernels carried
across slab by slab with ``socs_from_numpy``).

Tolerances: every slab of the stitched stack within 1e-5 of JAX's maximum
(TOL_SOCS_PAIR, as the aerial tiles of tests/test_torch_tiled.py); a
feature inside one tile core within 1e-4 of the single-field
film_socs_stack (tests/test_tiled_film.py:48-75); other halos within 4e-3
normalized RMS (PSF-tail truncation, tests/test_tiled_film.py:78-93).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.models.resist import DepthResist, MackResist
from lithographysimulator_tpu.simulate import film_socs_kernels
from lithographysimulator_tpu_torch.interop import (config_from_jax,
                                                    socs_from_numpy)

JCFG = jt.OpticsConfig(pixel_number=64)
PCFG = config_from_jax(JCFG)
BARC = 1.82 + 0.39j
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
    return np.asarray(jt.LightSource(JCFG, sigma_out=0.6).classical())


@pytest.fixture(scope="module")
def kernels(src):
    resist = DepthResist(mack=MackResist(thickness_nm=120.0), nz=3,
                         n_resist=1.71, absorbance_per_um=0.5)
    wafer = jt.WaferStack.from_resist(resist, under_layers=((37.0, BARC),))
    jk = film_socs_kernels(src, config=JCFG, wafer_stack=wafer,
                           resist=resist, rank=24)
    return jk, [socs_from_numpy(np.asarray(s.kernels),
                                np.asarray(s.eigenvalues), s.total_rank,
                                device="cpu") for s in jk]


@pytest.fixture(scope="module")
def chip():
    rng = np.random.default_rng(3)
    big = np.zeros((128, 128), np.float32)
    for _ in range(8):
        y, x = rng.integers(4, 118, 2)
        big[y:y + 6, x:x + 6] = 1.0
    big[20:108, 60:66] = 1.0
    return big


def test_tiled_film_stack_matches_jax(kernels, src, chip):
    total = float(src.sum())
    ours = pt.tiled_film_stack(chip, kernels[1], PCFG, source_total=total,
                               halo=HALO, tiles_per_dispatch=3)
    ref = np.asarray(jt.tiled_film_stack(chip, kernels[0], JCFG,
                                         source_total=total, halo=HALO))
    assert isinstance(ours, torch.Tensor) and ours.shape == (3, 128, 128)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=TOL * ref.max())
    raw = pt.tiled_film_stack(chip, kernels[1], PCFG, normalize=False,
                              halo=HALO)
    ref_raw = np.asarray(jt.tiled_film_stack(chip, kernels[0], JCFG,
                                             normalize=False, halo=HALO))
    np.testing.assert_allclose(raw.numpy(), ref_raw, rtol=0,
                               atol=TOL * ref_raw.max())


def test_isolated_feature_matches_single_field(kernels, src):
    n = PCFG.n
    step = n - 2 * HALO
    field = np.zeros((n, n), np.float32)
    field[28:36, 28:36] = 1.0
    total = float(src.sum())
    direct = pt.film_socs_stack(torch.as_tensor(field), kernels[1],
                                config=PCFG, source_total=total).numpy()
    big = np.zeros((128, 128), np.float32)
    oy = step - HALO
    big[oy + 28:oy + 36, oy + 28:oy + 36] = 1.0
    tiled = pt.tiled_film_stack(big, kernels[1], PCFG, source_total=total,
                                halo=HALO).numpy()
    core_direct = direct[:, HALO:HALO + step, HALO:HALO + step]
    core_tiled = tiled[:, step:2 * step, step:2 * step]
    np.testing.assert_allclose(core_tiled, core_direct, rtol=1e-4,
                               atol=1e-4 * core_direct.max())
    # a real depth series: the slabs differ
    assert np.abs(core_tiled[0] - core_tiled[-1]).max() > 1e-3 * core_tiled.max()


def test_tiling_offset_invariance(kernels, src, chip):
    total = float(src.sum())
    a = pt.tiled_film_stack(chip, kernels[1], PCFG, halo=16,
                            source_total=total).numpy()
    b = pt.tiled_film_stack(chip, kernels[1], PCFG, halo=20,
                            source_total=total).numpy()
    assert np.sqrt(np.mean((a - b) ** 2)) / b.max() < 4e-3


def test_empty_chip_progress_and_validation(kernels):
    seen = []
    stack = pt.tiled_film_stack(np.zeros((128, 128), np.float32), kernels[1],
                                PCFG, halo=HALO, source_total=1.0,
                                progress_cb=seen.append)
    assert stack.shape == (3, 128, 128) and float(stack.abs().max()) == 0.0
    assert seen[-1] == 1.0 and len(seen) == 2  # 16 tiles in groups of 8
    zeros = np.zeros((128, 128), np.float32)
    with pytest.raises(ValueError, match="source_total"):
        pt.tiled_film_stack(zeros, kernels[1], PCFG)
    with pytest.raises(ValueError, match="non-empty"):
        pt.tiled_film_stack(zeros, [], PCFG, source_total=1.0)
    short = pt.SOCSKernels(kernels[1][0].kernels[:4],
                           kernels[1][0].eigenvalues[:4], -1)
    with pytest.raises(ValueError, match="one shape"):
        pt.tiled_film_stack(zeros, [kernels[1][0], short], PCFG,
                            source_total=1.0)
