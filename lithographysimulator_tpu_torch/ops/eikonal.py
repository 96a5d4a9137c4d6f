"""Iterative eikonal solver for resist development fronts.

Port of ``lithographysimulator_tpu/ops/eikonal.py``. Solves
|grad t(x)| = s(x) on a regular 3-D grid — the arrival time t of a front
propagating from the top surface through a medium with local slowness
s = 1/rate — with the Godunov upwind discretization (Rouy & Tourin 1992),
applied as a Jacobi iteration: every voxel recomputes its arrival time from
its six neighbours at once, and ``t <- min(t, update)`` is monotone
non-increasing, so truncating the iteration under-etches, never over-etches.
Each sweep is a dense stencil over the (nz, ny, nx) volume; information
travels one cell a sweep, so ``iterations`` bounds the distance (in cells)
the front can cover.

The JAX package's ``lax.scan`` over sweeps is a loop here. Two things keep
it equal to the JAX solver and usable at full size:

* the three neighbour times of a voxel are sorted by a stable 3-element
  network (strict compare-and-swap), the order ``jnp.argsort`` gives: with
  unequal spacings or a lateral factor, tied times keep their axis' spacing
  in the same order, and the 1-axis update ``a + s h`` depends on it;
* with no input requiring grad no graph is built; when one does, each sweep
  is checkpointed (recomputed in the backward), so autograd holds one
  (nz, n, n) volume a sweep instead of every temporary of every sweep.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .._tensors import to_tensor

# Large-but-safe "unreached" sentinel: w * _FAR^2 with w = 1/h^2 stays
# finite in float32 for any spacing h > ~0.003 nm, so the masked branches
# of the Godunov quadratic never go inf (an inf or nan in a discarded
# torch.where branch would still poison gradients), while staying many
# orders above any physical arrival time.
_FAR = 1e16


def _axis_min_neighbors(t: torch.Tensor, dim: int, *,
                        source_low: bool) -> torch.Tensor:
    """Per-voxel minimum of the two neighbours along ``dim``, non-periodic.

    Outside the volume is unreachable (_FAR), except below the low-z face
    when ``source_low``: the developer sits on the resist top, so the ghost
    layer above z = 0 carries t = 0 (the Dirichlet source plane)."""
    n = t.shape[dim]
    edge = t.narrow(dim, 0, 1)
    lo_pad = torch.zeros_like(edge) if source_low else torch.full_like(edge, _FAR)
    hi_pad = torch.full_like(edge, _FAR)
    from_lo = torch.cat([lo_pad, t.narrow(dim, 0, n - 1)], dim)
    from_hi = torch.cat([t.narrow(dim, 1, n - 1), hi_pad], dim)
    return torch.minimum(from_lo, from_hi)


def _compare_swap(a, h, i: int, j: int) -> None:
    """Order entries i < j of the lists ``a`` (times) and ``h`` (their
    spacings) ascending by time; equal times keep their order (stable)."""
    swap = a[j] < a[i]
    a[i], a[j] = torch.where(swap, a[j], a[i]), torch.where(swap, a[i], a[j])
    h[i], h[j] = torch.where(swap, h[j], h[i]), torch.where(swap, h[i], h[j])


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on every device. torch.sqrt of
    float32 on CUDA is an ulp off for some inputs, where the CPU's is
    correctly rounded; the float64 root rounded to float32 is correct on
    both (53 >= 2 * 24 + 2 bits), so a sweep gives the same bits on the
    card as on the CPU."""
    return torch.sqrt(x.double()).to(x.dtype)


def _solve_quadratic(a: list, w: list, s2: torch.Tensor, m: int) -> torch.Tensor:
    """Root > max(a) of sum_{i<m} w_i (t - a_i)^2 = s2 over the sorted
    neighbour times ``a`` with weights w = 1/h^2. Valid wherever the
    caller's cascade selects this branch; discarded branches stay finite."""
    far = a[0].new_tensor(_FAR)
    a = [torch.minimum(x, far) for x in a[:m]]
    sw = w[0] + w[1]
    swa = w[0] * a[0] + w[1] * a[1]
    swa2 = w[0] * a[0] * a[0] + w[1] * a[1] * a[1]
    if m == 3:
        sw = sw + w[2]
        swa = swa + w[2] * a[2]
        swa2 = swa2 + w[2] * a[2] * a[2]
    disc = swa * swa - sw * (swa2 - s2)
    # double-where guard: sqrt has an infinite derivative at 0, and a
    # discarded branch still reaches the gradient (0 * inf = nan)
    pos = disc > 0
    root = (swa + _sqrt_rn(torch.where(pos, disc, 1.0))) / sw
    return torch.where(pos, root, _FAR)


def _spacings(spacing, lateral_factor, ref: torch.Tensor) -> torch.Tensor:
    """(3, L, 1, 1) per-axis spacings (z, y, x); L = 1, or nz with a
    per-slab lateral factor (lateral steps scaled by 1/factor)."""
    h = torch.tensor(spacing, dtype=ref.dtype, device=ref.device).reshape(3, 1, 1, 1)
    if lateral_factor is None:
        return h
    lf = to_tensor(lateral_factor, device=ref.device,
                   dtype=ref.dtype).reshape(-1).clamp_min(1e-6)
    inv = 1.0 / lf
    return h * torch.stack([torch.ones_like(lf), inv, inv])[:, :, None, None]


def godunov_update(t: torch.Tensor, slowness: torch.Tensor,
                   spacing: tuple[float, float, float],
                   lateral_factor=None) -> torch.Tensor:
    """One monotone Godunov/Jacobi sweep: t <- min(t, local eikonal solve).

    ``spacing`` = (hz, hy, hx) grid steps (nm); ``slowness`` = 1/rate (s/nm)
    per voxel. The source is the plane above the first z-slice (t = 0).

    ``lateral_factor`` (scalar or (nz,); None = isotropic) makes the etch
    anisotropic: the lateral rate is ``lateral_factor * rate``, which is
    the isotropic equation on lateral spacings scaled by 1/factor."""
    a = [_axis_min_neighbors(t, 0, source_low=True),
         _axis_min_neighbors(t, 1, source_low=False),
         _axis_min_neighbors(t, 2, source_low=False)]
    h = list(_spacings(spacing, lateral_factor, t).expand(3, *t.shape).unbind(0))
    _compare_swap(a, h, 0, 1)
    _compare_swap(a, h, 1, 2)
    _compare_swap(a, h, 0, 1)
    w = [1.0 / (x * x) for x in h]
    s2 = slowness * slowness
    t1 = a[0] + slowness * h[0]                  # 1-axis (pure upwind)
    t2 = _solve_quadratic(a, w, s2, 2)           # 2-axis
    t3 = _solve_quadratic(a, w, s2, 3)           # 3-axis
    new = torch.where(t1 <= a[1], t1, torch.where(t2 <= a[2], t2, t3))
    return torch.minimum(t, new)


def arrival_times(slowness, spacing: tuple[float, float, float], *,
                  iterations: int, lateral_factor=None,
                  device=None) -> torch.Tensor:
    """Front arrival times t(z, y, x) from the top surface (z = 0 face,
    t = 0), float32 on the slowness' device (host data needs ``device``).

    ``iterations`` bounds propagation: beyond ``iterations`` cells from the
    source plane values are upper bounds (truncation under-etches). For a
    film of nz slabs and a lateral spread of L pixels, ``nz + L`` sweeps
    suffice along convex paths. ``lateral_factor`` (scalar or per-slab
    (nz,)) sets the lateral/vertical etch-rate ratio; with laterally
    uniform slowness it has no effect (the vertical-limit invariant)."""
    slowness = to_tensor(slowness, device=device, dtype=torch.float32)
    t = torch.full(slowness.shape, _FAR, dtype=torch.float32,
                   device=slowness.device)
    grad = torch.is_grad_enabled() and (
        slowness.requires_grad or (isinstance(lateral_factor, torch.Tensor)
                                   and lateral_factor.requires_grad))
    if not grad:
        with torch.no_grad():
            for _ in range(iterations):
                t = godunov_update(t, slowness, spacing, lateral_factor)
        return t
    for _ in range(iterations):
        t = checkpoint(godunov_update, t, slowness, spacing, lateral_factor,
                       use_reentrant=False)
    return t
