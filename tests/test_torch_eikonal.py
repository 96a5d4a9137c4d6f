"""Port parity: the eikonal develop-front solver (ops/eikonal.py) of the
torch port (device='cpu') against the JAX package's.

Tolerances:

* One Godunov sweep equals JAX's op-by-op (eager) sweep bit for bit, on
  neighbour times with exact ties, equal and unequal spacings, scalar and
  per-slab lateral factors. A tie order other than the stable one changes
  the answer on these inputs (checked), so equality pins it.
* A solve of many sweeps: XLA compiles JAX's scan and contracts its
  multiply-adds into FMAs, which the port's float32 ops (one rounding an
  op) do not. Both are the float32 class of the same solve: each lies
  within 1e-5 of a float64 solve (relative to the largest arrival time;
  measured up to 2.4e-6 for either at 30 sweeps), and the two within 1e-5
  of each other.
* The vertical-limit invariant (laterally uniform slowness): the arrival
  times equal the cumulative vertical integral to 1e-6 relative, with or
  without a lateral factor, as tests/test_eikonal.py holds JAX's.
* The gradient of a develop loss through 20 sweeps at (4, 32, 32): the
  port's and jax.grad's each within 1e-4 of a float64 autograd gradient,
  and of each other (relative to the largest component; measured 1.7e-5
  for the port, 4.8e-5 for JAX, 4.7e-5 between them: the float32 class of
  the forward, amplified by the sigmoid's slope). The checkpointed sweeps
  give the same gradient, bit for bit, as plain autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lithographysimulator_tpu.ops import eikonal as je
from lithographysimulator_tpu_torch.ops import eikonal as pe

SWEEP_TOL = 1e-5
GRAD_TOL = 1e-4
SPACINGS = {"equal": (10.0, 10.0, 10.0), "unequal": (10.0, 25.0, 25.0),
            "all_unequal": (7.0, 12.5, 20.0)}
LATERAL = {"isotropic": None, "scalar": 0.5,
           "per_slab": np.array([0.3, 0.6, 1.0, 0.8])}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tied_inputs(seed: int):
    """Arrival times on a coarse lattice of values (so a voxel's axis
    neighbours tie exactly, often) and quantized slowness."""
    rng = np.random.default_rng(seed)
    t = (rng.integers(0, 6, size=(4, 12, 12)) * 5.0).astype(np.float32)
    t[rng.random(t.shape) < 0.2] = je._FAR
    slow = (np.round(rng.uniform(0.05, 1.0, (4, 12, 12)) * 4) / 4
            + 0.05).astype(np.float32)
    return t, slow


def _loose_swap(a, h, i, j):
    """A compare-and-swap that swaps ties: an unstable order."""
    swap = a[j] <= a[i]
    a[i], a[j] = torch.where(swap, a[j], a[i]), torch.where(swap, a[i], a[j])
    h[i], h[j] = torch.where(swap, h[j], h[i]), torch.where(swap, h[i], h[j])


@pytest.mark.parametrize("lateral", LATERAL, ids=list(LATERAL))
@pytest.mark.parametrize("spacing", SPACINGS, ids=list(SPACINGS))
def test_sweep_equals_jax_bit_for_bit_with_ties(spacing, lateral, monkeypatch):
    t, slow = _tied_inputs(len(spacing) + len(lateral))
    sp, lf = SPACINGS[spacing], LATERAL[lateral]
    ref = np.asarray(je.godunov_update(jnp.asarray(t), jnp.asarray(slow), sp,
                                       lf))
    ours = pe.godunov_update(torch.tensor(t), torch.tensor(slow), sp, lf).numpy()
    np.testing.assert_array_equal(ours, ref)
    if spacing != "equal" or lateral != "isotropic":
        # ties change the answer here: the tie order is pinned, not moot
        monkeypatch.setattr(pe, "_compare_swap", _loose_swap)
        loose = pe.godunov_update(torch.tensor(t), torch.tensor(slow), sp,
                                  lf).numpy()
        assert (loose != ref).any()


def _f64_solve(slow, spacing, lateral, iterations):
    t = torch.full(slow.shape, pe._FAR, dtype=torch.float64)
    s = torch.tensor(slow, dtype=torch.float64)
    lf = None if lateral is None else torch.tensor(
        np.asarray(lateral, np.float32), dtype=torch.float64)
    for _ in range(iterations):
        t = pe.godunov_update(t, s, spacing, lf)
    return t.numpy()


@pytest.mark.parametrize("lateral", LATERAL, ids=list(LATERAL))
@pytest.mark.parametrize("spacing", ["unequal", "all_unequal"])
def test_arrival_times_match_jax(spacing, lateral):
    _, slow = _tied_inputs(7)
    sp, lf = SPACINGS[spacing], LATERAL[lateral]
    ref = np.asarray(je.arrival_times(slow, sp, iterations=30,
                                      lateral_factor=lf))
    ours = pe.arrival_times(slow, sp, iterations=30, lateral_factor=lf,
                            device="cpu")
    assert ours.dtype == torch.float32 and ours.grad_fn is None
    ours = ours.numpy()
    exact = _f64_solve(slow, sp, lf, 30)
    scale = np.abs(exact).max()
    assert np.abs(ours - exact).max() <= SWEEP_TOL * scale
    assert np.abs(ref - exact).max() <= SWEEP_TOL * scale
    assert np.abs(ours - ref).max() <= SWEEP_TOL * scale


@pytest.mark.parametrize("lateral", LATERAL, ids=list(LATERAL))
def test_vertical_limit_invariant(lateral):
    """Laterally uniform slowness: the front is a flat plane, t at slab
    bottom k is sum_{j<=k} s_j hz, whatever the lateral factor."""
    rng = np.random.default_rng(3)
    per_slab = rng.uniform(0.1, 0.9, 4).astype(np.float32)
    slow = np.broadcast_to(per_slab[:, None, None], (4, 16, 16)).copy()
    hz = 12.5
    t = pe.arrival_times(slow, (hz, 25.0, 25.0), iterations=12,
                         lateral_factor=LATERAL[lateral], device="cpu").numpy()
    expect = np.cumsum(per_slab.astype(np.float64) * hz)
    np.testing.assert_allclose(t, np.broadcast_to(expect[:, None, None], t.shape),
                               rtol=1e-6)
    plain = pe.arrival_times(slow, (hz, 25.0, 25.0), iterations=12,
                             device="cpu").numpy()
    np.testing.assert_array_equal(t, plain)


def test_host_data_needs_a_device():
    with pytest.raises(ValueError, match="device"):
        pe.arrival_times(np.ones((2, 4, 4), np.float32), (1.0, 1.0, 1.0),
                         iterations=2)


def _grad_problem():
    rng = np.random.default_rng(11)
    slow = rng.uniform(0.05, 0.6, (4, 32, 32)).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, (4, 32, 32)).astype(np.float32)
    return slow, weight, (12.5, 25.0, 25.0), 20, 40.0


def test_gradient_matches_jax():
    slow, weight, sp, iters, t_dev = _grad_problem()

    def jloss(s):
        t = je.arrival_times(s, sp, iterations=iters, lateral_factor=0.7)
        return jnp.sum(jax.nn.sigmoid(0.2 * (t_dev - t)) * weight)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(slow)))
    s = torch.tensor(slow, requires_grad=True)
    t = pe.arrival_times(s, sp, iterations=iters, lateral_factor=0.7)
    loss = torch.sum(torch.sigmoid(0.2 * (t_dev - t)) * torch.tensor(weight))
    (ours,) = torch.autograd.grad(loss, s)
    ours = ours.numpy()
    s64 = torch.tensor(slow, dtype=torch.float64, requires_grad=True)
    t = torch.full(s64.shape, pe._FAR, dtype=torch.float64)
    lf = torch.tensor(0.7, dtype=torch.float64)
    for _ in range(iters):
        t = pe.godunov_update(t, s64, sp, lf)
    loss = torch.sum(torch.sigmoid(0.2 * (t_dev - t))
                     * torch.tensor(weight, dtype=torch.float64))
    exact = torch.autograd.grad(loss, s64)[0].numpy()
    scale = np.abs(exact).max()
    assert scale > 0
    assert np.abs(ours - exact).max() <= GRAD_TOL * scale
    assert np.abs(ref - exact).max() <= GRAD_TOL * scale
    assert np.abs(ours - ref).max() <= GRAD_TOL * scale


def test_checkpointed_gradient_equals_plain_autograd():
    slow, weight, sp, iters, t_dev = _grad_problem()
    w = torch.tensor(weight)

    def grad_of(solve):
        s = torch.tensor(slow, requires_grad=True)
        loss = torch.sum(torch.sigmoid(0.2 * (t_dev - solve(s))) * w)
        return torch.autograd.grad(loss, s)[0]

    def plain(s):
        t = torch.full(s.shape, pe._FAR)
        for _ in range(iters):
            t = pe.godunov_update(t, s, sp, 0.7)
        return t

    ckpt = grad_of(lambda s: pe.arrival_times(s, sp, iterations=iters,
                                              lateral_factor=0.7))
    torch.testing.assert_close(ckpt, grad_of(plain), rtol=0, atol=0)
