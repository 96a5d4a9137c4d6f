"""Port parity: the rigorous in-film image (simulate.film_stack_images,
film_socs_kernels, film_socs_stack) of the torch port (device='cpu')
against the JAX package, on test_filmstack.py's fixture (32^2, NA 0.85,
150 nm resist over a BARC on silicon, four slabs).

Exact stacks: <= 1e-6 normalized RMS against JAX's, scalar and
unpolarized, thin and thick mask. Film SOCS (randomized builds: jax.random
and torch.Generator draw different probes, so the kernels are never
compared): the leading eigenvalues of every slab within 2e-3 of JAX's (the
randomized-build class of test_torch_vector_socs.py), and the applied
stack within JAX's own classes of the exact stack, measured as that test
measures them, over the whole stack against its peak
(test_filmstack.py::test_film_socs_matches_exact_stack: 1e-4 scalar,
5e-4 unpolarized at rank 48)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.models import resist as jr
from lithographysimulator_tpu.ops import filmstack as jfs
from lithographysimulator_tpu.ops import mask3d as jm
from lithographysimulator_tpu_torch.interop import (config_from_jax,
                                                    mask3d_from_jax,
                                                    resist_from_jax,
                                                    wafer_stack_from_jax)

from .conftest import normalized_rms

TOL = 1e-6
EIG_TOL = 2e-3
SOCS_TOL = {None: 1e-4, "unpolarized": 5e-4}
RANK = 48
CFG = jt.OpticsConfig(pixel_number=32, na=0.85)
PCFG = config_from_jax(CFG)
SRC = np.asarray(jt.LightSource(CFG, sigma_out=0.6).classical())
WAFER = jfs.WaferStack(n_resist=1.71 + 0.0077j, thickness_nm=150.0,
                       under_layers=((37.0, jfs.MATERIALS_193["barc"]),))
PWAFER = wafer_stack_from_jax(WAFER)
# the film calls read a resist for its slab centers: 18.75 ... 131.25 nm
JRESIST = jr.DepthResist(mack=jr.MackResist(thickness_nm=150.0), nz=4)
RESIST = resist_from_jax(JRESIST)
BL = jm.BoundaryLayer(width_nm=8.0, beta_h=-0.2 + 0.1j, beta_v=-0.3)


def _np(x):
    return x.detach().cpu().numpy()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def masks():
    return jt.demo_bars(CFG), pt.demo_bars(PCFG, device="cpu")


@pytest.fixture(scope="module")
def exact(masks):
    """JAX's exact stacks, scalar and unpolarized."""
    jmask, _ = masks
    return {pol: np.asarray(jt.film_stack_images(
        jmask, SRC, config=CFG, wafer_stack=WAFER, resist=JRESIST,
        polarization=pol)) for pol in SOCS_TOL}


@pytest.mark.parametrize("pol", [None, "unpolarized"],
                         ids=["scalar", "unpolarized"])
def test_film_stack_images_match_jax(masks, exact, pol):
    _, pmask = masks
    ours = _np(pt.film_stack_images(pmask, SRC, device="cpu",
                                    wafer_stack=PWAFER, resist=RESIST,
                                    polarization=pol))
    assert ours.shape == exact[pol].shape == (4, 32, 32)
    for z in range(4):
        assert normalized_rms(ours[z], exact[pol][z]) < TOL


def test_film_stack_images_thick_mask_and_aberrations_match_jax(masks):
    """mask3d composes (thick mask at the object side) with aberrations,
    explicit depths, an x polarization and the unnormalized scale."""
    jmask, pmask = masks
    ab = np.array([0, 0, 0.05, 0.03, 30, 0.02], np.float32)
    kw = dict(depths_nm=[10.0, 90.0], polarization="x", normalize=False)
    ref = np.asarray(jt.film_stack_images(jmask, SRC, ab, config=CFG,
                                          wafer_stack=WAFER, mask3d=BL, **kw))
    ours = _np(pt.film_stack_images(pmask, SRC, ab, device="cpu",
                                    wafer_stack=PWAFER,
                                    mask3d=mask3d_from_jax(BL), **kw))
    for z in range(2):
        assert normalized_rms(ours[z], ref[z]) < TOL


@pytest.mark.parametrize("pol", [None, "unpolarized"],
                         ids=["scalar", "unpolarized"])
def test_film_socs_matches_jax(masks, exact, pol):
    """Eigenvalues slab by slab against JAX's build, the stack against
    JAX's exact stack at JAX's own class (slab 0 cold, deeper slabs warm
    from the previous slab's basis in both packages)."""
    jmask, pmask = masks
    ref = jt.film_socs_kernels(SRC, config=CFG, wafer_stack=WAFER,
                               resist=JRESIST, polarization=pol, rank=RANK)
    ours = pt.film_socs_kernels(SRC, device="cpu", config=PCFG,
                                wafer_stack=PWAFER, resist=RESIST,
                                polarization=pol, rank=RANK)
    assert len(ours) == len(ref) == 4
    for socs, jsocs in zip(ours, ref):
        assert socs.rank == jsocs.rank == RANK
        np.testing.assert_allclose(_np(socs.eigenvalues)[:16],
                                   np.asarray(jsocs.eigenvalues)[:16],
                                   rtol=EIG_TOL)
    total = float(SRC.sum())
    stack = _np(pt.film_socs_stack(pmask, ours, source_total=total))
    assert normalized_rms(stack, exact[pol]) < SOCS_TOL[pol]
    with pytest.raises(ValueError, match="source_total"):
        pt.film_socs_stack(pmask, ours)


def test_film_socs_stack_thick_mask_matches_jax_exact(masks):
    """film_socs_stack applies the mask3d model before the spectrum, as
    film_stack_images does."""
    jmask, pmask = masks
    kernels = pt.film_socs_kernels(SRC, device="cpu", config=PCFG,
                                   wafer_stack=PWAFER, depths_nm=[40.0],
                                   rank=RANK)
    ref = np.asarray(jt.film_stack_images(jmask, SRC, config=CFG,
                                          wafer_stack=WAFER, depths_nm=[40.0],
                                          mask3d=BL))
    ours = _np(pt.film_socs_stack(pmask, kernels, source_total=float(SRC.sum()),
                                  mask3d=mask3d_from_jax(BL)))
    assert normalized_rms(ours[0], ref[0]) < SOCS_TOL[None]
