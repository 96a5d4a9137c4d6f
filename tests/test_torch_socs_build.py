"""Port parity: the SOCS kernel builds of the torch port (device='cpu')
against the JAX package on the same numpy inputs.

Inputs are those of tests/test_hopkins.py: a 32^2 grid, an off-axis annular
source and odd aberrations, so a conjugation or shift-convention slip
cannot hide behind symmetry. Tolerances:

* compensated contractions: <= 1e-7 relative (Frobenius norm), against
  float64 and against the JAX functions (their stated accuracy; the worst
  single entry may sit one complex64 ulp, 1.2e-7, from either);
* pupil autocorrelation, Gram matvec, kernel synthesis (same u) and the
  passband support: elementwise to float32 rounding (2e-6 of the peak; the
  support exactly);
* the dense oracle: eigenvalues <= 1e-5 relative, images <= 1e-6 nRMS;
* randomized builds fed the SAME numpy probe block as ``init_basis``: the
  top half of the kept eigenvalues <= 1e-5 relative (the tail agrees to
  float32 rounding of the leading one), images <= 1e-5 nRMS (rr, nystrom,
  krylov);
* the port's own torch.Generator probes, and the lean build (which takes
  no basis in JAX): the JAX tests' own bounds against the dense oracle and
  exact Abbe (test_hopkins.py:62-125).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import lithographysimulator_tpu as jt
from lithographysimulator_tpu.ops import compensated as jc
from lithographysimulator_tpu.ops import hopkins as jh
from lithographysimulator_tpu_torch.interop import config_from_jax
from lithographysimulator_tpu_torch.ops import compensated as pc
from lithographysimulator_tpu_torch.ops import hopkins as ph

from .conftest import normalized_rms

CFG = jt.OpticsConfig(pixel_number=32)
PCFG = config_from_jax(CFG)
ABERR = np.array([0, 0, 0.05, 0.03, 30, 0.02, 0, 0.04], np.float32)


def _np(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def setup():
    spec = np.asarray(jt.spectrum_fft(jt.demo_bars(CFG).geometry, CFG))
    pup = np.asarray(jt.pupil_function(ABERR, CFG))
    src = np.asarray(jt.LightSource(CFG, sigma_in=0.2, sigma_out=0.6,
                                    shift_x=0.1).annular())
    abbe = np.asarray(jt.abbe_image(jnp.asarray(spec), jnp.asarray(pup), src, CFG))
    return spec, pup, src, abbe


def _image(spec, socs):
    return _np(ph.socs_image(torch.as_tensor(spec), socs, PCFG))


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(b)))


# --- compensated contractions ----------------------------------------------

def _fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("conj_a,conj_b", [(False, True), (True, False)])
def test_rowdot_compensated_matches_jax_and_float64(conj_a, conj_b):
    """A Gram of a probe-like block with itself (the SOCS build's shape):
    both packages are within 1e-7 of float64 and of each other."""
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(24, 4096)) + 1j * rng.normal(size=(24, 4096))
         ).astype(np.complex64)
    op = lambda x, c: x.conj() if c else x  # noqa: E731
    exact = op(a.astype(np.complex128), conj_a) @ op(a.astype(np.complex128), conj_b).T
    ours = _np(pc.rowdot_compensated(torch.as_tensor(a), torch.as_tensor(a),
                                     conj_a=conj_a, conj_b=conj_b, chunk=1000))
    ref = np.asarray(jc.rowdot_compensated(jnp.asarray(a), jnp.asarray(a),
                                           conj_a=conj_a, conj_b=conj_b))
    assert ours.dtype == np.complex64
    assert _fro(ours, exact) < 1e-7
    assert _fro(ours, ref) < 1e-7


def test_rowdot3_compensated_matches_jax_and_rowdot():
    rng = np.random.default_rng(1)
    a = (rng.normal(size=(12, 64, 64)) + 1j * rng.normal(size=(12, 64, 64))
         ).astype(np.complex64)
    b = (a[:5] + 0.1 * (rng.normal(size=(5, 64, 64)))).astype(np.complex64)
    exact = a.reshape(12, -1).astype(np.complex128).conj() @ \
        b.reshape(5, -1).astype(np.complex128).T
    ours = _np(pc.rowdot3_compensated(torch.as_tensor(a), torch.as_tensor(b),
                                      conj_a=True, row_chunk=7))
    ref = np.asarray(jc.rowdot3_compensated(jnp.asarray(a), jnp.asarray(b),
                                            conj_a=True))
    flat = _np(pc.rowdot_compensated(torch.as_tensor(a.reshape(12, -1)),
                                     torch.as_tensor(b.reshape(5, -1)),
                                     conj_a=True))
    for got in (ours, ref, flat):
        assert _fro(got, exact) < 1e-7
    assert _fro(ours, ref) < 1e-7
    with pytest.raises(ValueError, match="mismatch"):
        pc.rowdot3_compensated(torch.as_tensor(a), torch.as_tensor(a[:, :8]))


# --- circulant pieces --------------------------------------------------------

def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-6 * np.abs(ref).max())


def test_circulant_pieces_match_jax(setup):
    _, pup, src, _ = setup
    rng = np.random.default_rng(2)
    u = (rng.normal(size=(5, 32, 32)) + 1j * rng.normal(size=(5, 32, 32))
         ).astype(np.complex64)
    sqrt_w = np.sqrt(src).astype(np.complex64)
    pf = np.fft.fft2(pup).astype(np.complex64)
    r_fft = (pf * pf.conj()).astype(np.complex64)
    t = lambda x: torch.as_tensor(x)  # noqa: E731
    _close(_np(ph.pupil_autocorrelation(t(pup))),
           jh.pupil_autocorrelation(jnp.asarray(pup)))
    _close(_np(ph._gram_matvec(t(u), t(sqrt_w), t(r_fft))),
           jh._gram_matvec(jnp.asarray(u), jnp.asarray(sqrt_w), jnp.asarray(r_fft)))
    # same u on both sides, so the kernels themselves must agree
    _close(_np(ph._synthesize_kernels(t(u), t(sqrt_w), t(pf))),
           jh._synthesize_kernels(jnp.asarray(u), jnp.asarray(sqrt_w),
                                  jnp.asarray(pf)))
    shifts = jh.source_points(src).shifts
    np.testing.assert_array_equal(ph.passband_support(t(pup), shifts),
                                  jh.passband_support(pup, shifts))
    gram = rng.normal(size=(6, 6)) + 1j * rng.normal(size=(6, 6))
    gram = (gram @ gram.conj().T).astype(np.complex64)
    _close(_np(ph._cholesky_whiten_mat(t(gram))),
           jh._cholesky_whiten_mat(jnp.asarray(gram)))


# --- dense oracle ------------------------------------------------------------

@pytest.mark.parametrize("side", ["source", "frequency"])
def test_tcc_eigensystem_matches_jax(setup, side):
    spec, pup, src, _ = setup
    ref = jh.tcc_eigensystem(jnp.asarray(pup), src, CFG, rank=16, side=side)
    ours = ph.tcc_eigensystem(torch.as_tensor(pup), src, PCFG, rank=16, side=side)
    assert ours.rank == 16 and ours.total_rank == ref.total_rank
    assert _rel(_np(ours.eigenvalues), ref.eigenvalues) < 1e-5
    ref_img = np.asarray(jh.socs_image(jnp.asarray(spec), ref, CFG))
    assert normalized_rms(_image(spec, ours), ref_img) < 1e-6


def test_tcc_eigensystem_full_rank_and_energy_tol(setup):
    spec, pup, src, abbe = setup
    full = ph.tcc_eigensystem(torch.as_tensor(pup), src, PCFG, energy_tol=0.0,
                              rank=10**9)
    assert normalized_rms(_image(spec, full), abbe) < 1e-5
    loose = ph.tcc_eigensystem(torch.as_tensor(pup), src, PCFG, energy_tol=1e-2)
    tight = ph.tcc_eigensystem(torch.as_tensor(pup), src, PCFG, energy_tol=1e-5)
    assert loose.rank < tight.rank <= loose.total_rank
    assert loose.rank == jh.tcc_eigensystem(jnp.asarray(pup), src, CFG,
                                            energy_tol=1e-2).rank


def test_tcc_eigensystem_component_stack_matches_jax(setup):
    """Stacked component pupils with weights: the summed operator."""
    spec, pup, src, _ = setup
    pup2 = np.asarray(jt.pupil_function(np.array([0, 0, 0, 0, -40], np.float32), CFG))
    stack, q = np.stack([pup, pup2]), np.array([0.7, 0.3])
    ref = jh.tcc_eigensystem(jnp.asarray(stack), src, CFG, rank=8,
                             component_weights=q)
    ours = ph.tcc_eigensystem(torch.as_tensor(stack), src, PCFG, rank=8,
                              component_weights=q)
    assert _rel(_np(ours.eigenvalues), ref.eigenvalues) < 1e-5
    with pytest.raises(ValueError, match="component_weights"):
        ph.tcc_eigensystem(torch.as_tensor(stack), src, PCFG, component_weights=[1.0])


# --- randomized builds on the same probe block -------------------------------

@pytest.mark.parametrize("kw", [dict(method="rr"), dict(method="nystrom"),
                                dict(krylov=True)], ids=["rr", "nystrom", "krylov"])
def test_randomized_same_probes_match_jax(setup, kw):
    """JAX's _warm_omega returns an L-row init_basis unchanged, so both
    packages iterate from the same numpy probes."""
    spec, pup, src, _ = setup
    rank, oversample = 12, 16
    rng = np.random.default_rng(3)
    omega = (rng.normal(size=(rank + oversample, 32, 32))
             + 1j * rng.normal(size=(rank + oversample, 32, 32))).astype(np.complex64)
    ref = jh.randomized_socs(jnp.asarray(pup), src, CFG, rank=rank,
                             oversample=oversample, power_iters=2,
                             init_basis=jnp.asarray(omega), lean=False, **kw)
    ours = ph.randomized_socs(torch.as_tensor(pup), src, PCFG, rank=rank,
                              oversample=oversample, power_iters=2,
                              init_basis=omega, lean=False, **kw)
    assert ours.total_rank == ref.total_rank
    top = rank // 2
    assert _rel(_np(ours.eigenvalues)[:top], np.asarray(ref.eigenvalues)[:top]) < 1e-5
    np.testing.assert_allclose(_np(ours.eigenvalues), ref.eigenvalues, rtol=0,
                               atol=1e-6 * float(ref.eigenvalues[0]))
    ref_img = np.asarray(jh.socs_image(jnp.asarray(spec), ref, CFG))
    assert normalized_rms(_image(spec, ours), ref_img) < 1e-5


def test_randomized_uncompensated_same_probes_match_jax(setup):
    spec, pup, src, _ = setup
    rng = np.random.default_rng(4)
    omega = (rng.normal(size=(20, 32, 32)) + 1j * rng.normal(size=(20, 32, 32))
             ).astype(np.complex64)
    kw = dict(rank=8, oversample=12, power_iters=2, lean=False, compensated=False)
    ref = jh.randomized_socs(jnp.asarray(pup), src, CFG, init_basis=jnp.asarray(omega), **kw)
    ours = ph.randomized_socs(torch.as_tensor(pup), src, PCFG, init_basis=omega, **kw)
    assert _rel(_np(ours.eigenvalues)[:4], np.asarray(ref.eigenvalues)[:4]) < 1e-5


# --- the port's own probes, at the JAX tests' bounds ------------------------

@pytest.mark.parametrize("method", ["rr", "nystrom"])
def test_randomized_own_probes_match_dense(setup, method):
    _, pup, src, _ = setup
    dense = ph.tcc_eigensystem(torch.as_tensor(pup), src, PCFG, rank=12)
    rnd = ph.randomized_socs(torch.as_tensor(pup), src, PCFG, rank=12,
                             power_iters=3, method=method)
    np.testing.assert_allclose(_np(rnd.eigenvalues), _np(dense.eigenvalues),
                               rtol=1e-3)


@pytest.mark.parametrize("kw", [dict(power_iters=2), dict(power_iters=1, method="nystrom"),
                                dict(power_iters=2, krylov=True)],
                         ids=["rr", "nystrom", "krylov"])
def test_randomized_own_probes_image_exact(setup, kw):
    spec, pup, src, abbe = setup
    socs = ph.randomized_socs(torch.as_tensor(pup), src, PCFG, rank=64, **kw)
    assert normalized_rms(_image(spec, socs), abbe) < 2e-4


def test_randomized_direct_solver(setup):
    _, pup, src, _ = setup
    geom = jt.demo_bars(CFG).geometry
    spec_d = np.asarray(jt.spectrum_direct(geom, CFG))
    abbe_d = np.asarray(jt.abbe_image(jnp.asarray(spec_d), jnp.asarray(pup), src,
                                      CFG, solver="direct"))
    socs = ph.randomized_socs(torch.as_tensor(pup), src, PCFG, rank=64)
    img = ph.socs_image(torch.as_tensor(spec_d), socs, PCFG, solver="direct")
    assert normalized_rms(_np(img), abbe_d) < 2e-4


def test_warm_start_and_return_basis(setup):
    """A basis from a rank-8 build warm-starts a rank-16 build (topped up
    with fresh probes): at power_iters=1 the eight directions it carries
    match the dense spectrum."""
    _, pup, src, _ = setup
    tp = torch.as_tensor(pup)
    socs, basis = ph.randomized_socs(tp, src, PCFG, rank=8, return_basis=True)
    assert tuple(basis.shape) == (8, 32, 32)
    warm = ph.randomized_socs(tp, src, PCFG, rank=16, power_iters=1,
                              init_basis=basis)
    dense = ph.tcc_eigensystem(tp, src, PCFG, rank=16)
    np.testing.assert_allclose(_np(warm.eigenvalues)[:8],
                               _np(dense.eigenvalues)[:8], rtol=1e-3)
    with pytest.raises(ValueError, match="warm-start"):
        ph.randomized_socs(tp, src, PCFG, rank="auto", init_basis=basis)


def test_dead_eigenvalues_get_zero_kernels(setup):
    """Zero (or numerically dead) eigenvalues get a zero kernel scale,
    never 1/sqrt(0); a build past rank(TCC) = #live points stays finite."""
    lam = torch.tensor([10.0, 1.0, 0.0, 1e-14])
    np.testing.assert_allclose(_np(ph._kernel_scale(lam, lam[0])).real,
                               [10 ** -0.5, 1.0, 0.0, 0.0], rtol=1e-6)
    _, pup, src, _ = setup
    live = int((src > 0).sum())
    socs = ph.randomized_socs(torch.as_tensor(pup), src, PCFG, rank=live + 8,
                              power_iters=1)
    assert np.isfinite(_np(socs.kernels)).all() and socs.total_rank == live


# --- lean build --------------------------------------------------------------

def test_lean_build_matches_standard_and_exact(setup):
    """The lean build takes no init_basis in JAX, so it is held against the
    port's standard build and the exact references (test_hopkins.py:80-91)."""
    spec, pup, src, abbe = setup
    tp = torch.as_tensor(pup)
    dense = ph.tcc_eigensystem(tp, src, PCFG, rank=12)
    lean = ph.randomized_socs(tp, src, PCFG, rank=12, power_iters=3, lean=True)
    np.testing.assert_allclose(_np(lean.eigenvalues), _np(dense.eigenvalues),
                               rtol=1e-3)
    lean64 = ph.randomized_socs(tp, src, PCFG, rank=64, power_iters=2, lean=True)
    std64 = ph.randomized_socs(tp, src, PCFG, rank=64, power_iters=2, lean=False)
    assert normalized_rms(_image(spec, lean64), abbe) < 2e-4
    assert normalized_rms(_image(spec, lean64), _image(spec, std64)) < 1e-5


def test_lean_build_uncompensated_and_tail_chunks(setup):
    """Odd rank and oversample (tail chunks on every in-place loop) and
    compensated=False (test_hopkins.py:94-100)."""
    spec, pup, src, abbe = setup
    socs = ph._randomized_socs_lean(
        torch.as_tensor(pup), torch.as_tensor(src), PCFG, rank=61, oversample=13,
        power_iters=2, seed=0, compensated=False, live=int((src > 0).sum()),
        row_chunk=7, img_row_chunk=5)
    assert normalized_rms(_image(spec, socs), abbe) < 5e-4


def test_lean_rejections_and_auto_policy(setup):
    _, pup, src, _ = setup
    tp = torch.as_tensor(pup)
    for kw in (dict(krylov=True), dict(method="nystrom"),
               dict(init_basis=np.zeros((4, 32, 32), np.complex64)),
               dict(return_basis=True)):
        with pytest.raises(ValueError):
            ph.randomized_socs(tp, src, PCFG, rank=8, lean=True, **kw)
    # lean='auto' falls back to the standard build where lean cannot serve
    assert ph.randomized_socs(tp, src, PCFG, rank=8, method="nystrom").rank == 8
    # 80 GB card: rank 256 stays standard at 1024^2 (~9 GB) and 2048^2 (~37 GB)
    assert not ph.lean_auto(256 + 16, 1024, device="cpu", hbm_budget=0.9 * 80e9)
    assert not ph.lean_auto(256 + 16, 2048, device="cpu", hbm_budget=0.9 * 80e9)
    assert ph.lean_auto(256 + 16, 2048, device="cpu", hbm_budget=12e9)
    assert not ph.lean_auto(16, 32, device="cpu")  # default budget: free memory
