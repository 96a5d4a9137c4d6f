"""Rigorous 2-D (crossed-grating) RCWA: the in-repo electromagnetic oracle
for mask topographies that vary in BOTH lateral directions — line-ends,
corners, contacts — the patterns where the 1-D solvers (:mod:`.rcwa`) and
the 1-D-calibrated edge-kernel M3D model are approximations.

The port's own copy of ``lithographysimulator_tpu/ops/rcwa2d.py``, held
equal to it by ``tests/test_torch_rcwa.py``. The one change:
:func:`boxes_geometry` returns a torch tensor on an explicit ``device``.

This exists to answer one question rigorously (VERDICT round-4 item 3):
*how much does the edge-kernel model, calibrated on 1-D line/space
fixtures, miss at corners and line-ends?* — the dominant M3D error on real
2-D layouts, and exactly the features full-chip OPC moves. The thin-mask
spectrum being corrected is the reference's ``mask.py:42-59``.

Formulation
-----------

The 1-D conical solver (:func:`.rcwa.rcwa_orders_conical`) keeps the full
2N-coupled tangential system derived from Maxwell's curl equations in the
Fourier basis. That derivation never used the 1-D-ness of ε beyond the
factorization rules, so it generalizes verbatim: with per-order diagonal
``Kx``/``Ky`` (doubly-periodic orders, flattened x-fastest) and the layer
Toeplitz-block operators

    dS/dz' = j·F·U,   dU/dz' = j·G·S,       S = [Sy; Sx], U = [Ux; Uy]

    F = [[I − Ky E⁻¹ Ky,  Ky E⁻¹ Kx ],      (E = 2-D Laurent Toeplitz of ε,
         [−Kx E⁻¹ Ky,  −(I − Kx E⁻¹ Kx)]]    used for the continuous-field
                                             εEz product)
    G = [[EY − Kx²,  Kx Ky ],               (EX/EY: Li's mixed rules for
         [−Ky Kx,  −(EX − Ky²)]]             εEx / εEy — inverse rule along
                                             each component's own axis,
                                             direct rule along the other)

the second-order system d²S/dz'² = −F·G·S is eigendecomposed per layer
(2N×2N, N = NxNy) and fed through the SAME enhanced-transmittance
bottom-up recursion (growing exponentials never inverted). Exterior
matching uses the per-order plane-wave admittance relation (H = k×E with
k·E = 0), identical in form to the conical solver's.

Li's mixed factorization (Li, JOSA A 14, 2758 (1997)): the εEx product is
factorized with the INVERSE rule along x (where Ex jumps across ridge
walls) and the direct rule along y — built by sampling y, inverting the
x-Toeplitz of 1/ε per sample, and Fourier-transforming the matrix elements
over y; εEy symmetrically. For 1-D-in-x layers both reduce to the 1-D
rules and the whole solver must (and does, see tests) reproduce
:func:`.rcwa.rcwa_orders_conical` exactly.

Everything is host-side numpy complex128 (general complex eigenproblem;
runs once per fixture at ~2·(2M+1)⁴ matrix sizes). Indices are
physics-style ``n + ik``; internally exp(+jωt) (conjugated), outputs
conjugated back to exp(−iωt). Homogeneous layers (no boxes) skip the
eigendecomposition: −F·G is diagonal per order there, so W = I and the
U-matrix follows from a single linear solve — this keeps the 81-layer EUV
mirror affordable.

Validation contract (tests/test_rcwa2d.py): layers uniform along y
reproduce the 1-D conical solver to ~1e-10 at conical incidence (both
polarizations, including the EUV reflective stack); homogeneous stacks
match the analytic transfer matrix; lossless crossed gratings conserve
energy; an x↔y mirrored fixture under mirrored illumination gives the
mirrored order map.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "PatternedLayer",
    "Rcwa2dResult",
    "rcwa2d_orders",
    "rcwa2d_effective_mask",
    "boxes_geometry",
]


@dataclasses.dataclass(frozen=True)
class PatternedLayer:
    """One layer of thickness ``thickness_nm``: background index ``n_fill``
    with axis-aligned rectangles of index ``n_box`` at ``boxes`` — each box
    ``(x0, y0, x1, y1)`` in FRACTIONS of the (x, y) periods, non-wrapping
    (0 ≤ a0 < a1 ≤ 1) and mutually non-overlapping (their Fourier series
    are summed). No boxes = a homogeneous film."""

    thickness_nm: float
    n_fill: complex = 1.0 + 0.0j
    n_box: complex = 1.0 + 0.0j
    boxes: tuple[tuple[float, float, float, float], ...] = ()

    def __post_init__(self):
        for (x0, y0, x1, y1) in self.boxes:
            if not (0.0 <= x0 < x1 <= 1.0 and 0.0 <= y0 < y1 <= 1.0):
                raise ValueError(f"box {(x0, y0, x1, y1)} must satisfy "
                                 "0 <= a0 < a1 <= 1 on both axes")

    @property
    def homogeneous(self) -> bool:
        return not self.boxes or complex(self.n_box) == complex(self.n_fill)


@dataclasses.dataclass(frozen=True)
class Rcwa2dResult:
    """Doubly-periodic diffraction: flattened per-order (x-fastest)
    tangential E amplitudes (exp(−iωt), unit incident |E|) + efficiencies.
    ``mx``/``my`` give each flattened slot's order pair."""

    mx: np.ndarray
    my: np.ndarray
    ry: np.ndarray
    rx: np.ndarray
    ty: np.ndarray
    tx: np.ndarray
    eff_r: np.ndarray
    eff_t: np.ndarray

    @property
    def energy(self) -> float:
        return float(self.eff_r.sum() + self.eff_t.sum())

    def grid(self, a: np.ndarray) -> np.ndarray:
        """Reshape a flattened per-order vector to (Ny, Nx)."""
        ny = self.my.max() - self.my.min() + 1
        return np.asarray(a).reshape(ny, -1)


def _rect_coeffs(a0: float, a1: float, n_harm: int) -> np.ndarray:
    """Fourier coefficients h = −(n_harm−1)..(n_harm−1) of a unit-height
    rect covering [a0, a1) of a unit period."""
    h = np.arange(-(n_harm - 1), n_harm)
    width = a1 - a0
    center = 0.5 * (a0 + a1)
    return width * np.sinc(h * width) * np.exp(-2j * np.pi * h * center)


def _eps_coeffs_2d(layer: PatternedLayer, nx: int, ny: int) -> np.ndarray:
    """2-D Fourier coefficients of ε(x, y), shape (2·ny−1, 2·nx−1) indexed
    [h_y + ny−1, h_x + nx−1] — analytic (sum of separable rects)."""
    ef = np.conj(complex(layer.n_fill)) ** 2
    eb = np.conj(complex(layer.n_box)) ** 2
    c = np.zeros((2 * ny - 1, 2 * nx - 1), np.complex128)
    c[ny - 1, nx - 1] = ef
    for (x0, y0, x1, y1) in layer.boxes:
        cx = _rect_coeffs(x0, x1, nx)
        cy = _rect_coeffs(y0, y1, ny)
        c += (eb - ef) * cy[:, None] * cx[None, :]
    return c


def _block_toeplitz(c2d: np.ndarray, mx: np.ndarray,
                    my: np.ndarray) -> np.ndarray:
    """Full 2-D Laurent (block-Toeplitz) matrix over the flattened order
    list: T[i, j] = c2d[my_i − my_j, mx_i − mx_j]."""
    ox = mx[:, None] - mx[None, :] + (c2d.shape[1] - 1) // 2
    oy = my[:, None] - my[None, :] + (c2d.shape[0] - 1) // 2
    return c2d[oy, ox]


def _toeplitz_1d(coeffs: np.ndarray, n_ord: int) -> np.ndarray:
    mid = (coeffs.shape[0] - 1) // 2
    idx = np.arange(n_ord)
    return coeffs[idx[:, None] - idx[None, :] + mid]


def _li_mixed(layer: PatternedLayer, nx: int, ny: int,
              invert_axis: str) -> np.ndarray:
    """Li's mixed-rule operator for ε·E_component: INVERSE factorization
    along ``invert_axis`` (the axis the component jumps across), direct
    Laurent rule along the other. For rectilinear layouts the inverted
    1-D Toeplitz is PIECEWISE CONSTANT along the direct axis (between box
    edges), so the direct-axis Fourier transform is done EXACTLY: one
    matrix inverse per interval, weighted by the interval's analytic rect
    coefficients — no sampling/aliasing error (the y-uniform limit then
    reduces to the 1-D rules to machine precision, which
    tests/test_rcwa2d.py pins). Flattened x-fastest to match the solver's
    order layout."""
    ef = np.conj(complex(layer.n_fill)) ** 2
    eb = np.conj(complex(layer.n_box)) ** 2
    inv_f, inv_b = 1.0 / ef, 1.0 / eb
    if invert_axis == "x":
        n_inv, n_dir = nx, ny
        spans = [(y0, y1, x0, x1) for (x0, y0, x1, y1) in layer.boxes]
    else:
        n_inv, n_dir = ny, nx
        spans = [(x0, x1, y0, y1) for (x0, y0, x1, y1) in layer.boxes]
    edges = sorted({0.0, 1.0} | {s[0] for s in spans} | {s[1] for s in spans})
    h0 = np.zeros(2 * n_inv - 1, np.complex128)
    h0[n_inv - 1] = inv_f
    coeffs_dir = np.zeros((2 * n_dir - 1, n_inv, n_inv), np.complex128)
    for lo, hi in zip(edges[:-1], edges[1:]):
        mid_s = 0.5 * (lo + hi)
        coeffs = h0.copy()
        for (d0, d1, c0, c1) in spans:
            if d0 <= mid_s < d1:
                coeffs = coeffs + (inv_b - inv_f) * _rect_coeffs(c0, c1,
                                                                 n_inv)
        mat = np.linalg.inv(_toeplitz_1d(coeffs, n_inv))
        coeffs_dir += _rect_coeffs(lo, hi, n_dir)[:, None, None] * mat[None]

    mxs = np.tile(np.arange(nx), ny)
    mys = np.repeat(np.arange(ny), nx)
    if invert_axis == "x":
        d_dir = mys[:, None] - mys[None, :]       # y-harmonic offsets
        ii, jj = mxs[:, None], mxs[None, :]       # x-Toeplitz indices
    else:
        d_dir = mxs[:, None] - mxs[None, :]
        ii, jj = mys[:, None], mys[None, :]
    return coeffs_dir[d_dir + (n_dir - 1), ii, jj]


def rcwa2d_orders(
    period_x_nm: float,
    period_y_nm: float,
    layers: Sequence[PatternedLayer],
    wavelength_nm: float,
    *,
    n_super: complex = 1.0,
    n_sub: complex = 1.0,
    theta_deg: float = 0.0,
    phi_deg: float = 0.0,
    psi_deg: float = 90.0,
    mx_max: int = 5,
    my_max: int = 5,
) -> Rcwa2dResult:
    """Diffraction-order amplitudes/efficiencies of a doubly-periodic stack
    of :class:`PatternedLayer`\\ s (top-first, like the 1-D solvers),
    illuminated from the superstrate at polar angle ``theta_deg``, azimuth
    ``phi_deg`` (plane of incidence rotated from +x), polarization
    ``psi_deg`` (90° = s, 0° = p — same conventions as
    :func:`.rcwa.rcwa_orders_conical`). Retains orders |m_x| ≤ ``mx_max``,
    |m_y| ≤ ``my_max``."""
    nx, ny = 2 * int(mx_max) + 1, 2 * int(my_max) + 1
    n_tot = nx * ny
    mx = np.tile(np.arange(-mx_max, mx_max + 1), ny)
    my = np.repeat(np.arange(-my_max, my_max + 1), nx)
    mid = (n_tot - 1) // 2  # the (0, 0) order

    nI = np.conj(complex(n_super))
    nII = np.conj(complex(n_sub))
    eps_I, eps_II = nI * nI, nII * nII
    theta = np.deg2rad(theta_deg)
    phi = np.deg2rad(phi_deg)
    psi = np.deg2rad(psi_deg)
    lam = float(wavelength_nm)

    kx = (nI.real * np.sin(theta) * np.cos(phi)
          - mx * lam / float(period_x_nm)).astype(np.complex128)
    ky = (nI.real * np.sin(theta) * np.sin(phi)
          - my * lam / float(period_y_nm)).astype(np.complex128)

    def kz_of(eps: complex) -> np.ndarray:
        kz = np.sqrt(eps - kx * kx - ky * ky)
        flip = (np.abs(kz.real) < 1e-12 * np.abs(kz.imag)) & (kz.imag > 0)
        kz = np.where(flip, -kz, kz)
        return np.where(np.abs(kz) < 1e-9, kz + 1e-9, kz)

    kz_I, kz_II = kz_of(eps_I), kz_of(eps_II)
    ident2 = np.eye(2 * n_tot, dtype=np.complex128)
    k0 = 2.0 * np.pi / lam

    def z_matrix(eps: complex, kz: np.ndarray) -> np.ndarray:
        z = np.zeros((2 * n_tot, 2 * n_tot), np.complex128)
        z[:n_tot, :n_tot] = np.diag(-(eps - kx * kx) / kz)
        z[:n_tot, n_tot:] = np.diag(-(kx * ky) / kz)
        z[n_tot:, :n_tot] = np.diag((kx * ky) / kz)
        z[n_tot:, n_tot:] = np.diag((eps - ky * ky) / kz)
        return z

    Z_I = z_matrix(eps_I, kz_I)
    Z_II = z_matrix(eps_II, kz_II)

    def z_blocks(eps: complex, kz: np.ndarray) -> np.ndarray:
        """Per-order 2×2 blocks of :func:`z_matrix` — (N, 2, 2)."""
        z = np.empty((n_tot, 2, 2), np.complex128)
        z[:, 0, 0] = -(eps - kx * kx) / kz
        z[:, 0, 1] = -(kx * ky) / kz
        z[:, 1, 0] = (kx * ky) / kz
        z[:, 1, 1] = (eps - ky * ky) / kz
        return z

    def densify(blocks: np.ndarray) -> np.ndarray:
        """(N, 2, 2) per-order blocks → (2N, 2N) in [·y; ·x] layout."""
        m = np.zeros((2 * n_tot, 2 * n_tot), np.complex128)
        idx = np.arange(n_tot)
        m[idx, idx] = blocks[:, 0, 0]
        m[idx, n_tot + idx] = blocks[:, 0, 1]
        m[n_tot + idx, idx] = blocks[:, 1, 0]
        m[n_tot + idx, n_tot + idx] = blocks[:, 1, 1]
        return m

    # Orders never couple until the first patterned layer, so the bottom-up
    # recursion runs in per-order 2×2 blocks — O(N) per homogeneous layer
    # instead of O(N³) — and densifies once. This is what keeps the
    # 81-layer EUV reticle (absorber over 40 homogeneous Mo/Si bilayers)
    # at ~1 eigendecomposition total.
    eye2 = np.broadcast_to(np.eye(2, dtype=np.complex128),
                           (n_tot, 2, 2)).copy()
    fb, gb = eye2.copy(), z_blocks(eps_II, kz_II)
    f = g = None  # dense state, created on first patterned layer
    t_chain: list[tuple[str, np.ndarray]] = []

    for layer in reversed(list(layers)):
        if layer.homogeneous:
            eps = np.conj(complex(layer.n_fill)) ** 2
            # −F·G is diagonal per order (shown per plane wave): skip eig.
            qq = np.sqrt(kx * kx + ky * ky - eps)
            qq = np.where(qq.real < 0, -qq, qq)
            qq = np.where(np.abs(qq) < 1e-8, qq + 1e-8, qq)
            Fb = np.empty((n_tot, 2, 2), np.complex128)
            Fb[:, 0, 0] = 1.0 - ky * ky / eps
            Fb[:, 0, 1] = ky * kx / eps
            Fb[:, 1, 0] = -kx * ky / eps
            Fb[:, 1, 1] = -(1.0 - kx * kx / eps)
            Vb = -1j * np.linalg.inv(Fb) * qq[:, None, None]
            Xb = np.exp(-qq * k0 * float(layer.thickness_nm))
            if f is None:
                # still block-diagonal: per-order 2×2 recursion
                ViG = np.linalg.solve(Vb, gb)
                a = 0.5 * (fb + ViG)   # W = I per order
                b = 0.5 * (fb - ViG)
                ab = a @ np.linalg.inv(b)
                XabX = (Xb * Xb)[:, None, None] * ab
                fb = eye2 + XabX
                gb = Vb @ (-eye2 + XabX)
                t_chain.append(("block",
                                np.linalg.inv(b) * Xb[:, None, None]))
                continue
            q = np.concatenate([qq, qq])
            W = np.eye(2 * n_tot, dtype=np.complex128)
            V = densify(Vb)
        else:
            E = _block_toeplitz(_eps_coeffs_2d(layer, nx, ny), mx, my)
            Einv = np.linalg.inv(E)
            EX = _li_mixed(layer, nx, ny, "x")
            EY = _li_mixed(layer, nx, ny, "y")
            Kx, Ky = np.diag(kx), np.diag(ky)

            F = np.zeros((2 * n_tot, 2 * n_tot), np.complex128)
            F[:n_tot, :n_tot] = np.eye(n_tot) - Ky @ Einv @ Ky
            F[:n_tot, n_tot:] = Ky @ Einv @ Kx
            F[n_tot:, :n_tot] = -Kx @ Einv @ Ky
            F[n_tot:, n_tot:] = -(np.eye(n_tot) - Kx @ Einv @ Kx)

            G = np.zeros((2 * n_tot, 2 * n_tot), np.complex128)
            G[:n_tot, :n_tot] = EY - Kx @ Kx
            G[:n_tot, n_tot:] = Kx @ Ky
            G[n_tot:, :n_tot] = -Ky @ Kx
            G[n_tot:, n_tot:] = -(EX - Ky @ Ky)

            eig, W = np.linalg.eig(-F @ G)
            q = np.sqrt(eig)
            q = np.where(q.real < 0, -q, q)
            q = np.where(np.abs(q) < 1e-8, q + 1e-8, q)
            V = -1j * np.linalg.solve(F, W * q[None, :])

        if f is None:
            f, g = densify(fb), densify(gb)
        X = np.exp(-q * k0 * float(layer.thickness_nm))
        WiF = np.linalg.solve(W, f)
        ViG = np.linalg.solve(V, g)
        a = 0.5 * (WiF + ViG)
        b = 0.5 * (WiF - ViG)
        ab = a @ np.linalg.inv(b)
        XabX = (X[:, None] * ab) * X[None, :]
        f = W @ (ident2 + XabX)
        g = V @ (-ident2 + XabX)
        t_chain.append(("dense", np.linalg.inv(b) * X[None, :]))

    if f is None:
        f, g = densify(fb), densify(gb)

    ux = np.cos(psi) * np.cos(theta) * np.cos(phi) - np.sin(psi) * np.sin(phi)
    uy = np.cos(psi) * np.cos(theta) * np.sin(phi) + np.sin(psi) * np.cos(phi)
    s_inc = np.zeros(2 * n_tot, np.complex128)
    s_inc[mid] = uy
    s_inc[n_tot + mid] = ux

    tau = np.linalg.solve(Z_I @ f + g, 2.0 * (Z_I @ s_inc))
    r = f @ tau - s_inc
    t = tau
    for kind, factor in reversed(t_chain):
        if kind == "block":
            pair = np.stack([t[:n_tot], t[n_tot:]], axis=1)  # (N, 2)
            pair = (factor @ pair[:, :, None])[:, :, 0]
            t = np.concatenate([pair[:, 0], pair[:, 1]])
        else:
            t = factor @ t

    def flux(s: np.ndarray, u: np.ndarray) -> np.ndarray:
        sy, sx = s[:n_tot], s[n_tot:]
        uxv, uyv = u[:n_tot], u[n_tot:]
        return (sx * np.conj(uyv) - sy * np.conj(uxv)).real

    u_inc = Z_I @ s_inc
    flux_in = float(flux(s_inc, u_inc)[mid])
    eff_r = -flux(r, -(Z_I @ r)) / flux_in
    eff_t = flux(t, Z_II @ t) / flux_in

    return Rcwa2dResult(
        mx=mx, my=my,
        ry=np.conj(r[:n_tot]), rx=np.conj(r[n_tot:]),
        ty=np.conj(t[:n_tot]), tx=np.conj(t[n_tot:]),
        eff_r=eff_r.astype(np.float64), eff_t=eff_t.astype(np.float64))


# ---------------------------------------------------------------------------
# Imaging bridge: 2-D rigorous near field -> effective mask on the grid
# ---------------------------------------------------------------------------


def _scalar_orders_2d(ey, ex, kx, ky, eps_exit, pol: str):
    """Per-order scalar amplitudes with the SAME convention as the 1-D
    bridges: Ey for y-polarized tangential E, Hy (which carries the order's
    full |E| magnitude) for x-polarized — reconstructed from the tangential
    amplitudes via the exit medium's plane-wave admittance (exp(−iωt))."""
    if pol == "y":
        return ey
    kz = np.sqrt(eps_exit - kx * kx - ky * ky + 0j)
    kz = np.where(kz.imag < 0, -kz, kz)
    kz = np.where(np.abs(kz) < 1e-9, kz + 1e-9, kz)
    return (kx * ky * ey + (eps_exit - ky * ky) * ex) / kz


def rcwa2d_effective_mask(
    config,
    *,
    boxes: Sequence[tuple[float, float, float, float]],
    pitch_x_px: int,
    pitch_y_px: int | None = None,
    stack="binary_cr",
    pol: str = "x",
    magnification: float = 4.0,
    mx_max: int = 7,
    my_max: int = 7,
    incidence_deg: float = 0.0,
    azimuth_deg: float = 0.0,
) -> np.ndarray:
    """Rigorous effective complex transmission of a DOUBLY-periodic layout
    (absorber ``boxes`` in fractions of the (x, y) tile) on the simulation
    grid — the 2-D analog of :func:`.rcwa.rcwa_effective_mask`, and the
    oracle that bounds the 1-D-calibrated edge-kernel model at corners and
    line-ends. Both tile pitches must divide ``config.pixel_number``.

    ``pol`` is the incident tangential-E direction in the layout frame
    ('x' or 'y'); the scalar bridge uses Ey for 'y' and Hy for 'x', which
    reduces to the 1-D bridge's TE/TM conventions in the y-uniform /
    x-uniform limits. The synthesized pattern is MIRRORED in both axes
    relative to the box coordinates (the exp(−iωt) order m carries
    exp(−2πimx/Λ); synthesizing on the +harmonic grid is the scanner's
    180° image rotation — the same convention as the 1-D bridge).
    :func:`boxes_geometry` rasterizes the matching thin layout with the
    identical mirroring, so rigorous-vs-thin comparisons line up pixel for
    pixel. Keep box edges on HALF-PIXEL fractions ((k + 0.5)/pitch): the
    synthesis samples pixel corners, so half-pixel-aligned edges avoid
    Gibbs-midpoint raster ambiguity (the 2-D analog of the odd-duty rule,
    see :func:`..mask3d.grating_geometry`)."""
    from .rcwa import resolve_stack

    n = int(config.pixel_number)
    pitch_x_px = int(pitch_x_px)
    pitch_y_px = int(pitch_y_px if pitch_y_px is not None else pitch_x_px)
    for p in (pitch_x_px, pitch_y_px):
        if p <= 0 or n % p:
            raise ValueError(f"tile pitch {p} must divide pixel_number={n}")
    if pol not in ("x", "y"):
        raise ValueError(f"pol must be 'x' or 'y', got {pol!r}")
    stack = resolve_stack(stack, float(config.wavelength))
    boxes = tuple(tuple(float(v) for v in b) for b in boxes)

    period_x = float(magnification) * pitch_x_px * float(config.pixel_size)
    period_y = float(magnification) * pitch_y_px * float(config.pixel_size)
    # The SOLVE retains the requested orders (accuracy); the SYNTHESIS
    # keeps only those below the grid Nyquist — mirroring the 1-D bridge,
    # which solves at n_harmonics and crops to the pitch.
    mx_keep = min(int(mx_max), (pitch_x_px - 1) // 2)
    my_keep = min(int(my_max), (pitch_y_px - 1) // 2)

    absorber = [PatternedLayer(th, n_fill=1.0, n_box=nr, boxes=boxes)
                for th, nr in stack.layers]
    blank_abs = [PatternedLayer(th, n_fill=1.0) for th, nr in stack.layers]
    mirror = [PatternedLayer(th, n_fill=nm) for th, nm in stack.mirror]

    theta_r = np.deg2rad(float(incidence_deg))
    phi_r = np.deg2rad(float(azimuth_deg))
    if pol == "y":
        psi = np.degrees(np.arctan2(np.cos(theta_r) * np.cos(phi_r),
                                    np.sin(phi_r)))
    else:
        psi = np.degrees(np.arctan2(-np.cos(theta_r) * np.sin(phi_r),
                                    np.cos(phi_r)))

    kwargs = dict(n_super=complex(stack.n_blank),
                  n_sub=complex(stack.n_substrate),
                  theta_deg=float(incidence_deg),
                  phi_deg=float(azimuth_deg), psi_deg=float(psi),
                  mx_max=int(mx_max), my_max=int(my_max))
    res = rcwa2d_orders(period_x, period_y, absorber + mirror,
                        float(config.wavelength), **kwargs)
    blank = rcwa2d_orders(period_x, period_y, blank_abs + mirror,
                          float(config.wavelength), **kwargs)

    nr0 = complex(stack.n_blank).real
    kx = (nr0 * np.sin(theta_r) * np.cos(phi_r)
          - res.mx * float(config.wavelength) / period_x)
    ky = (nr0 * np.sin(theta_r) * np.sin(phi_r)
          - res.my * float(config.wavelength) / period_y)
    n_exit = stack.n_blank if stack.reflective else stack.n_substrate
    eps_exit = complex(n_exit) ** 2
    if stack.reflective:
        s_res = _scalar_orders_2d(res.ry, res.rx, kx, ky, eps_exit, pol)
        s_blank = _scalar_orders_2d(blank.ry, blank.rx, kx, ky, eps_exit,
                                    pol)
    else:
        s_res = _scalar_orders_2d(res.ty, res.tx, kx, ky, eps_exit, pol)
        s_blank = _scalar_orders_2d(blank.ty, blank.tx, kx, ky, eps_exit,
                                    pol)
    mid = (len(s_blank) - 1) // 2
    t = s_res / s_blank[mid]

    keep = (np.abs(res.mx) <= mx_keep) & (np.abs(res.my) <= my_keep)
    t, kmx, kmy = t[keep], res.mx[keep], res.my[keep]
    ix = np.arange(pitch_x_px)
    iy = np.arange(pitch_y_px)
    ph_x = np.exp(2j * np.pi * np.outer(kmx, ix) / pitch_x_px)
    ph_y = np.exp(2j * np.pi * np.outer(kmy, iy) / pitch_y_px)
    tile = np.einsum("m,mx,my->yx", t, ph_x, ph_y)
    field = np.tile(tile, (n // pitch_y_px, n // pitch_x_px))
    return field.astype(np.complex64)


def boxes_geometry(config, boxes, pitch_x_px: int,
                   pitch_y_px: int | None = None,
                   transmission: complex = 0.0, *, device):
    """Drawn thin-mask layout matching :func:`rcwa2d_effective_mask`'s
    synthesis orientation exactly: the boxes rasterized MIRRORED in both
    axes (pixel (iy, ix) samples fractional coordinates ((−iy) mod p)/p) —
    absorber pixels carry complex ``transmission``, background 1. Keep box
    edges on half-pixel fractions so the strict inside test is
    unambiguous. Returns a tensor on ``device`` like
    :func:`..mask3d.grating_geometry` (real float32 for opaque binary,
    complex64 otherwise)."""
    import torch

    n = int(config.pixel_number)
    pitch_x_px = int(pitch_x_px)
    pitch_y_px = int(pitch_y_px if pitch_y_px is not None else pitch_x_px)
    for p in (pitch_x_px, pitch_y_px):
        if p <= 0 or n % p:
            raise ValueError(f"tile pitch {p} must divide pixel_number={n}")
    sx = ((-np.arange(pitch_x_px)) % pitch_x_px) / pitch_x_px
    sy = ((-np.arange(pitch_y_px)) % pitch_y_px) / pitch_y_px
    inside = np.zeros((pitch_y_px, pitch_x_px), bool)
    for (x0, y0, x1, y1) in boxes:
        inside |= ((sy[:, None] >= y0) & (sy[:, None] < y1)
                   & (sx[None, :] >= x0) & (sx[None, :] < x1))
    tile = np.where(inside, complex(transmission), 1.0 + 0.0j)
    geom = np.tile(tile, (n // pitch_y_px, n // pitch_x_px))
    if complex(transmission) == 0.0:
        return torch.as_tensor(np.ascontiguousarray(geom.real),
                               dtype=torch.float32, device=device)
    return torch.as_tensor(np.ascontiguousarray(geom), dtype=torch.complex64,
                           device=device)
