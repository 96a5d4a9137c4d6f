"""Rigorous coupled-wave analysis (RCWA): the in-repo electromagnetic oracle.

The port's own copy of ``lithographysimulator_tpu/ops/rcwa.py`` (that
module imports only numpy; the port imports nothing of the JAX package).
``tests/test_torch_rcwa.py`` pins its outputs equal to the JAX package's,
bit for bit.

The imaging stack everywhere treats the mask as a thin Kirchhoff screen
(the reference builds spectra straight from the drawn layout,
the reference's ``mask.py:42-59``); :mod:`.mask3d` adds the boundary-layer
(BL) thick-mask correction whose parameters are *calibrated* against a
rigorous solver. This module IS that rigorous solver for 1-D (line/space)
mask topographies: a stable multilayer RCWA (Moharam, Grann, Pommet &
Gaylord, JOSA A 12, 1068 & 1077 (1995) — the enhanced transmittance matrix
formulation) with Li's inverse factorization rule for TM polarization, so
the framework can certify and fit its M3D model end to end without any
external EMF tool.

Scope and design:

- Planar (:func:`rcwa_orders`) AND conical (:func:`rcwa_orders_conical`)
  diffraction by a stack of lamellar grating layers: period ``Λ``,
  per-layer complex ridge/groove indices and duty cycles, illuminated from
  a semi-infinite superstrate (mask blank, e.g. glass) at polar angle
  ``theta_deg`` (and, conically, azimuth ``phi_deg`` between the plane of
  incidence and the grating vector), transmitting into a semi-infinite
  substrate (air). This covers the photomask calibration problem exactly:
  absorber lines on a blank, TE (E ∥ lines) and TM (E ⊥ lines) — the two
  polarizations whose difference *is* the H–V bias the BL model's
  (β_h, β_v) split encodes — plus, conically, the EUV chief ray tilted
  ALONG the lines (azimuth 90°), the horizontal-edge geometry the planar
  mount cannot represent.
- Everything is host-side ``numpy`` complex128. RCWA needs a general
  (non-Hermitian) complex eigendecomposition, and the oracle runs once per
  calibration at ~41×41 matrix sizes, so there is nothing to accelerate
  on the device. No torch import: this module is usable anywhere.
- Conventions: refractive indices are given physics-style ``n + i k``
  (k ≥ 0 absorbs). Internally the solve runs in the exp(+jωt) convention
  (indices conjugated) where the principal complex sqrt picks the correct
  decaying/outgoing branch for lossy media without sign surgery; outputs
  are conjugated back, so returned complex amplitudes compose with the
  rest of the framework's exp(−iωt) fields. Amplitudes are normalized to a
  unit incident wave in the superstrate.

Validation contract (tests/test_rcwa.py): a homogeneous "grating" must
reproduce the analytic thin-film transfer-matrix solution
(:func:`transfer_matrix_stack`) to ~1e-12 for both polarizations at oblique
incidence; lossless gratings conserve energy to 1e-10; a thin opaque
absorber converges to the Kirchhoff duty-cycle orders; TM converges with
order count (Li's rule).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np

__all__ = [
    "GratingLayer",
    "RcwaResult",
    "RcwaConicalResult",
    "rcwa_orders",
    "rcwa_orders_conical",
    "kirchhoff_orders",
    "transfer_matrix_stack",
    "thin_mask_transmission",
    "rcwa_effective_mask",
    "MaskStack",
    "MASK_STACKS",
]


@dataclasses.dataclass(frozen=True)
class GratingLayer:
    """One lamellar layer: ``thickness_nm`` of ``n_ridge`` lines in an
    ``n_groove`` background, lines covering fraction ``duty`` of the period,
    centered (offset 0) unless ``offset`` shifts the ridge center by a
    fraction of the period. ``duty=0`` (or equal indices) makes the layer a
    homogeneous film — the analytic-limit test case."""

    thickness_nm: float
    n_ridge: complex
    n_groove: complex = 1.0 + 0.0j
    duty: float = 0.5
    offset: float = 0.0


@dataclasses.dataclass(frozen=True)
class RcwaResult:
    orders: np.ndarray  # (n_ord,) int, m from -M..M
    r: np.ndarray  # complex reflected amplitudes (tangential field, exp(-iwt))
    t: np.ndarray  # complex transmitted amplitudes
    eff_r: np.ndarray  # reflected diffraction efficiencies
    eff_t: np.ndarray  # transmitted diffraction efficiencies

    @property
    def energy(self) -> float:
        return float(self.eff_r.sum() + self.eff_t.sum())


def _toeplitz(coeffs: np.ndarray, n_ord: int) -> np.ndarray:
    """Toeplitz matrix T[i, j] = coeffs[i - j + (len-1)//2] for i,j < n_ord."""
    mid = (coeffs.shape[0] - 1) // 2
    idx = np.arange(n_ord)
    return coeffs[idx[:, None] - idx[None, :] + mid]


def _layer_fourier(eps_r: complex, eps_g: complex, duty: float, offset: float,
                   n_ord: int) -> tuple[np.ndarray, np.ndarray]:
    """Fourier coefficients h = -(n_ord-1)..(n_ord-1) of ε(x) and 1/ε(x) for a
    binary layer (analytic: difference × duty × sinc with an offset phase)."""
    h = np.arange(-(n_ord - 1), n_ord)
    # np.sinc is sin(pi x)/(pi x): coefficient of a width-`duty` centered rect
    rect = duty * np.sinc(h * duty) * np.exp(-2j * np.pi * h * offset)
    eps = np.where(h == 0, eps_g, 0.0).astype(np.complex128)
    eps = eps + (eps_r - eps_g) * rect
    inv = np.where(h == 0, 1.0 / eps_g, 0.0).astype(np.complex128)
    inv = inv + (1.0 / eps_r - 1.0 / eps_g) * rect
    return eps, inv


def rcwa_orders(
    period_nm: float,
    layers: Sequence[GratingLayer],
    wavelength_nm: float,
    *,
    pol: str = "te",
    n_super: complex = 1.0,
    n_sub: complex = 1.0,
    theta_deg: float = 0.0,
    n_harmonics: int = 21,
) -> RcwaResult:
    """Diffraction-order amplitudes/efficiencies of a lamellar stack.

    ``pol='te'``: E field along the lines (y). ``pol='tm'``: H along the
    lines (amplitudes are the Hy coefficients; efficiencies are physical
    either way). ``n_harmonics`` is the retained order count (odd; 21 is
    ample for photomask absorbers at λ/Λ ~ 0.25-1).
    """
    if pol not in ("te", "tm"):
        raise ValueError(f"pol must be 'te' or 'tm', got {pol!r}")
    if n_harmonics < 3 or n_harmonics % 2 == 0:
        raise ValueError("n_harmonics must be odd and >= 3")
    n_ord = int(n_harmonics)
    mm = (n_ord - 1) // 2
    orders = np.arange(-mm, mm + 1)

    # exp(+jwt) internally: conjugate the physics-convention n + ik indices.
    nI = np.conj(complex(n_super))
    nII = np.conj(complex(n_sub))
    eps_I, eps_II = nI * nI, nII * nII
    theta = np.deg2rad(theta_deg)
    lam = float(wavelength_nm)

    # Normalized tangential wavevectors kx_m / k0.
    kx = nI.real * np.sin(theta) - orders * lam / float(period_nm)
    kx = kx.astype(np.complex128)

    def kz_of(eps: complex) -> np.ndarray:
        kz = np.sqrt(eps - kx * kx)
        # exp(+jwt): propagation e^{-j kz z} needs Re kz >= 0, decay Im kz <= 0.
        # Principal sqrt is right except on the negative real axis (evanescent
        # in a lossless medium), where it returns +j|.|: flip those.
        flip = (np.abs(kz.real) < 1e-12 * np.abs(kz.imag)) & (kz.imag > 0)
        return np.where(flip, -kz, kz)

    kz_I, kz_II = kz_of(eps_I), kz_of(eps_II)
    K = np.diag(kx)

    if pol == "te":
        z_I = np.diag(kz_I)
        z_II = np.diag(kz_II)
    else:
        z_I = np.diag(kz_I / eps_I)
        z_II = np.diag(kz_II / eps_II)

    ident = np.eye(n_ord, dtype=np.complex128)
    k0 = 2.0 * np.pi / lam

    # Bottom boundary condition: transmitted wave only, tangential pair
    # (S, dS/dz') = (I, -j z_II) t  — build f/g upward with the enhanced
    # transmittance recursion (growing exponentials never inverted).
    f = ident
    g = -1j * z_II
    t_chain: list[np.ndarray] = []  # per-layer b̃^{-1} X factors, bottom-first

    for layer in reversed(list(layers)):
        er = np.conj(complex(layer.n_ridge)) ** 2
        eg = np.conj(complex(layer.n_groove)) ** 2
        eps_f, inv_f = _layer_fourier(er, eg, float(layer.duty),
                                      float(layer.offset), n_ord)
        E = _toeplitz(eps_f, n_ord)
        if pol == "te":
            A = K @ K - E
            eig, W = np.linalg.eig(A)
            q = np.sqrt(eig)
            q = np.where(q.real < 0, -q, q)  # decay-down branch
        else:
            Einv = _toeplitz(inv_f, n_ord)  # Li's inverse rule
            A = np.linalg.solve(Einv, K @ np.linalg.solve(E, K) - ident)
            eig, W = np.linalg.eig(A)
            q = np.sqrt(eig)
            q = np.where(q.real < 0, -q, q)
        # A mode exactly at a Rayleigh anomaly (period = m·λ in a lossless
        # layer) has q = 0, which would make V = W·diag(q) singular; nudge it
        # off the branch point (no measurable effect on regular modes).
        q = np.where(np.abs(q) < 1e-8, q + 1e-8, q)
        V = (W if pol == "te" else Einv @ W) * q[None, :]
        X = np.exp(-q * k0 * float(layer.thickness_nm))

        WiF = np.linalg.solve(W, f)
        ViG = np.linalg.solve(V, g)
        a = 0.5 * (WiF + ViG)   # upward-decaying coefficients
        b = 0.5 * (WiF - ViG)   # downward-decaying coefficients
        # f_l = W (I + X a b^{-1} X), g_l = V (-I + X a b^{-1} X):
        ab = a @ np.linalg.inv(b)
        XabX = (X[:, None] * ab) * X[None, :]
        f = W @ (ident + XabX)
        g = V @ (-ident + XabX)
        t_chain.append(np.linalg.inv(b) * X[None, :])  # b^{-1} diag(X)

    # Top matching: S = δ + r, dS/dz' = -j z_I δ + j z_I r  = (f, g) τ.
    delta = np.zeros(n_ord, np.complex128)
    delta[mm] = 1.0
    lhs = g - 1j * z_I @ f
    tau = np.linalg.solve(lhs, -2j * (z_I @ delta))
    r = f @ tau - delta

    t = tau
    for factor in reversed(t_chain):  # top layer's factor applied first
        t = factor @ t

    kz0 = kz_I[mm].real
    if pol == "te":
        eff_r = np.abs(r) ** 2 * (kz_I.real / kz0)
        eff_t = np.abs(t) ** 2 * (kz_II.real / kz0)
    else:
        eff_r = np.abs(r) ** 2 * ((kz_I / eps_I).real / (kz0 / eps_I.real))
        eff_t = np.abs(t) ** 2 * ((kz_II / eps_II).real / (kz0 / eps_I.real))

    # Back to the physics exp(-iwt) convention.
    return RcwaResult(orders=orders, r=np.conj(r), t=np.conj(t),
                      eff_r=eff_r.real.astype(np.float64),
                      eff_t=eff_t.real.astype(np.float64))


@dataclasses.dataclass(frozen=True)
class RcwaConicalResult:
    """Conical-mount diffraction: per-order tangential E-field amplitudes
    (exp(−iωt) convention, unit incident |E|) plus efficiencies. ``ry/rx``
    are the reflected Ey/Ex harmonics, ``ty/tx`` transmitted."""

    orders: np.ndarray  # (n_ord,) int, m from -M..M
    ry: np.ndarray
    rx: np.ndarray
    ty: np.ndarray
    tx: np.ndarray
    eff_r: np.ndarray
    eff_t: np.ndarray

    @property
    def energy(self) -> float:
        return float(self.eff_r.sum() + self.eff_t.sum())


def rcwa_orders_conical(
    period_nm: float,
    layers: Sequence[GratingLayer],
    wavelength_nm: float,
    *,
    n_super: complex = 1.0,
    n_sub: complex = 1.0,
    theta_deg: float = 0.0,
    phi_deg: float = 0.0,
    psi_deg: float = 90.0,
    n_harmonics: int = 21,
) -> RcwaConicalResult:
    """Conical-mount RCWA: the same lamellar stacks as :func:`rcwa_orders`,
    illuminated with the plane of incidence rotated by azimuth ``phi_deg``
    away from the grating vector (x). ``psi_deg`` is the polarization angle
    of the incident E field: 90° = s (E ⊥ plane of incidence, so pure Ey at
    ``phi_deg=0`` — the planar TE case), 0° = p (E in the plane).

    Formulation: the coupled-wave equations for a 1-D (ε(x)-only) grating at
    transverse momentum ky ≠ 0 are derived directly from Maxwell's curl
    equations in the Fourier basis (Moharam/Grann/Pommet/Gaylord, JOSA A 12,
    1068 (1995), conical mount), keeping the full 2N-coupled tangential
    system in S = [Sy; Sx] (E-field harmonics) and U = [Ux; Uy] (H-field):

        dS/dz' = j·M1·U,   dU/dz' = j·M2·S,   d²S/dz'² = −M1·M2·S

    with Li's inverse factorization on the ε·Ex product (the only field
    component discontinuous across the ridge walls). The 2N×2N eigenmodes
    feed the SAME enhanced-transmittance bottom-up recursion as the planar
    solver (growing exponentials never inverted). Unlike the classic
    decoupled-into-two-N-problems presentation, the block form makes no
    symmetry assumption — it reduces to the planar TE/TM blocks exactly at
    ``phi_deg=0`` (pinned by tests/test_rcwa_conical.py) and matches the
    analytic transfer matrix for homogeneous stacks at any azimuth.

    Validation contract (tests/test_rcwa_conical.py): homogeneous stacks
    reproduce :func:`transfer_matrix_stack` s/p amplitudes at conical
    incidence to ~1e-10; ``phi_deg=0`` matches :func:`rcwa_orders`
    efficiencies and TE amplitudes; lossless gratings conserve energy;
    a centered grating at ``phi_deg=90`` has m ↔ −m symmetric orders (the
    tilt is along the lines, so nothing shadows across them)."""
    if n_harmonics < 3 or n_harmonics % 2 == 0:
        raise ValueError("n_harmonics must be odd and >= 3")
    n_ord = int(n_harmonics)
    mm = (n_ord - 1) // 2
    orders = np.arange(-mm, mm + 1)

    # exp(+jwt) internally: conjugate the physics-convention n + ik indices.
    nI = np.conj(complex(n_super))
    nII = np.conj(complex(n_sub))
    eps_I, eps_II = nI * nI, nII * nII
    theta = np.deg2rad(theta_deg)
    phi = np.deg2rad(phi_deg)
    psi = np.deg2rad(psi_deg)
    lam = float(wavelength_nm)

    # Normalized transverse wavevectors: kx per order, ky common to all.
    kx = nI.real * np.sin(theta) * np.cos(phi) - orders * lam / float(period_nm)
    kx = kx.astype(np.complex128)
    ky = complex(nI.real * np.sin(theta) * np.sin(phi))

    def kz_of(eps: complex) -> np.ndarray:
        kz = np.sqrt(eps - kx * kx - ky * ky)
        # exp(+jwt): e^{-j kz z} decays downward for Im kz <= 0; principal
        # sqrt is right except lossless-evanescent (negative real axis).
        flip = (np.abs(kz.real) < 1e-12 * np.abs(kz.imag)) & (kz.imag > 0)
        kz = np.where(flip, -kz, kz)
        # The exterior admittance matrices carry 1/kz: nudge exact Rayleigh
        # anomalies off the singularity (no effect on regular orders).
        return np.where(np.abs(kz) < 1e-9, kz + 1e-9, kz)

    kz_I, kz_II = kz_of(eps_I), kz_of(eps_II)
    ident = np.eye(n_ord, dtype=np.complex128)
    ident2 = np.eye(2 * n_ord, dtype=np.complex128)
    k0 = 2.0 * np.pi / lam

    def z_matrix(eps: complex, kz: np.ndarray) -> np.ndarray:
        """U = Z S for a DOWNWARD (+z, e^{-j kz z}) plane-wave set: per
        order, Hx = −[(ε−kx²)Ey + kx·ky·Ex]/kz and Hy = [kx·ky·Ey +
        (ε−ky²)Ex]/kz (from H = k×E with k·E = 0). Upward waves flip the
        sign. Block layout matches S = [Sy; Sx], U = [Ux; Uy]."""
        z = np.zeros((2 * n_ord, 2 * n_ord), np.complex128)
        z[:n_ord, :n_ord] = np.diag(-(eps - kx * kx) / kz)
        z[:n_ord, n_ord:] = np.diag(-(kx * ky) / kz)
        z[n_ord:, :n_ord] = np.diag((kx * ky) / kz)
        z[n_ord:, n_ord:] = np.diag((eps - ky * ky) / kz)
        return z

    Z_I = z_matrix(eps_I, kz_I)
    Z_II = z_matrix(eps_II, kz_II)
    K = np.diag(kx)

    # Bottom boundary condition: transmitted (downward) waves only.
    f = ident2
    g = Z_II.copy()
    t_chain: list[np.ndarray] = []

    for layer in reversed(list(layers)):
        er = np.conj(complex(layer.n_ridge)) ** 2
        eg = np.conj(complex(layer.n_groove)) ** 2
        eps_f, inv_f = _layer_fourier(er, eg, float(layer.duty),
                                      float(layer.offset), n_ord)
        E = _toeplitz(eps_f, n_ord)
        Einv = np.linalg.inv(E)
        E11 = np.linalg.inv(_toeplitz(inv_f, n_ord))  # Li: the ε·Ex product
        KEiK = K @ Einv @ K

        M1 = np.zeros((2 * n_ord, 2 * n_ord), np.complex128)
        M1[:n_ord, :n_ord] = ident - (ky * ky) * Einv
        M1[:n_ord, n_ord:] = ky * (Einv @ K)
        M1[n_ord:, :n_ord] = -ky * (K @ Einv)
        M1[n_ord:, n_ord:] = -(ident - KEiK)

        M2 = np.zeros((2 * n_ord, 2 * n_ord), np.complex128)
        M2[:n_ord, :n_ord] = E - K @ K
        M2[:n_ord, n_ord:] = ky * K
        M2[n_ord:, :n_ord] = -ky * K
        M2[n_ord:, n_ord:] = -(E11 - (ky * ky) * ident)

        eig, W = np.linalg.eig(-M1 @ M2)
        q = np.sqrt(eig)
        q = np.where(q.real < 0, -q, q)  # decay-down branch
        q = np.where(np.abs(q) < 1e-8, q + 1e-8, q)
        # U-field mode matrix: U = (1/j) M1^{-1} dS/dz' → V = −j M1^{-1} W q.
        V = -1j * np.linalg.solve(M1, W * q[None, :])
        X = np.exp(-q * k0 * float(layer.thickness_nm))

        WiF = np.linalg.solve(W, f)
        ViG = np.linalg.solve(V, g)
        a = 0.5 * (WiF + ViG)   # upward-decaying coefficients
        b = 0.5 * (WiF - ViG)   # downward-decaying coefficients
        ab = a @ np.linalg.inv(b)
        XabX = (X[:, None] * ab) * X[None, :]
        f = W @ (ident2 + XabX)
        g = V @ (-ident2 + XabX)
        t_chain.append(np.linalg.inv(b) * X[None, :])

    # Incident field: unit |E| at polarization psi (90° = s, 0° = p).
    ux = np.cos(psi) * np.cos(theta) * np.cos(phi) - np.sin(psi) * np.sin(phi)
    uy = np.cos(psi) * np.cos(theta) * np.sin(phi) + np.sin(psi) * np.cos(phi)
    s_inc = np.zeros(2 * n_ord, np.complex128)
    s_inc[mm] = uy
    s_inc[n_ord + mm] = ux

    # Top matching: S = S_inc + S_r, U = Z_I S_inc − Z_I S_r = (f, g) τ.
    tau = np.linalg.solve(Z_I @ f + g, 2.0 * (Z_I @ s_inc))
    r = f @ tau - s_inc

    t = tau
    for factor in reversed(t_chain):
        t = factor @ t

    def flux(s: np.ndarray, u: np.ndarray) -> np.ndarray:
        """Per-order z-Poynting Re(Ex·Hy* − Ey·Hx*) — exact per order in a
        homogeneous exterior (transverse orthogonality), and safe at
        evanescent orders (no 1/Re(kz))."""
        sy, sx = s[:n_ord], s[n_ord:]
        uxv, uyv = u[:n_ord], u[n_ord:]
        return (sx * np.conj(uyv) - sy * np.conj(uxv)).real

    u_inc = Z_I @ s_inc
    u_r = -(Z_I @ r)
    u_t = Z_II @ t
    flux_in = float(flux(s_inc, u_inc)[mm])
    eff_r = -flux(r, u_r) / flux_in
    eff_t = flux(t, u_t) / flux_in

    # Back to the physics exp(-iwt) convention.
    return RcwaConicalResult(
        orders=orders,
        ry=np.conj(r[:n_ord]), rx=np.conj(r[n_ord:]),
        ty=np.conj(t[:n_ord]), tx=np.conj(t[n_ord:]),
        eff_r=eff_r.astype(np.float64), eff_t=eff_t.astype(np.float64))


def kirchhoff_orders(duty: float, orders: np.ndarray,
                     transmission: complex = 0.0,
                     offset: float = 0.0) -> np.ndarray:
    """Ideal thin-mask order amplitudes of the same lamellar pattern: clear
    background of transmission 1, ridge of complex ``transmission`` covering
    ``duty`` — the limit RCWA approaches as topography vanishes."""
    m = np.asarray(orders)
    rect = duty * np.sinc(m * duty) * np.exp(-2j * np.pi * m * offset)
    base = np.where(m == 0, 1.0, 0.0).astype(np.complex128)
    return base + (complex(transmission) - 1.0) * rect


def transfer_matrix_stack(
    n_list: Sequence[complex],
    d_list_nm: Sequence[float],
    wavelength_nm: float,
    *,
    pol: str = "te",
    n_super: complex = 1.0,
    n_sub: complex = 1.0,
    theta_deg: float = 0.0,
) -> tuple[complex, complex]:
    """Analytic thin-film (r, t) of a homogeneous multilayer — the exact
    oracle the RCWA must match when every layer is homogeneous.

    Amplitudes follow the same tangential-field normalization as
    :func:`rcwa_orders` (TE: Ey; TM: Hy), exp(−iωt) convention.
    """
    lam = float(wavelength_nm)
    k0 = 2.0 * np.pi / lam
    nI = complex(n_super)
    kx = nI.real * np.sin(np.deg2rad(theta_deg))

    def kz_of(n: complex) -> complex:
        # Normalized by k0. exp(-iwt): decay in +z needs Im kz >= 0;
        # principal sqrt has Im >= 0 for Im(eps) >= 0 and on the negative
        # real axis. Guard the remaining corner anyway.
        n = complex(n)
        kz = complex(np.sqrt(np.complex128(n * n - kx * kx)))
        return -kz if kz.imag < 0 else kz

    def admittance(n: complex) -> complex:
        return kz_of(n) if pol == "te" else kz_of(n) / (complex(n) ** 2)

    # Work on the tangential pair (S, h), h = i*q*S per traveling wave —
    # exactly the quantities RCWA matches, so amplitudes are comparable.
    # Layer map (S,h)_top = M_l (S,h)_bottom with phase phi = kz*k0*d:
    # M_l = [[cos phi, -sin phi / q], [q sin phi, cos phi]].
    M = np.eye(2, dtype=np.complex128)
    for n, d in zip(n_list, d_list_nm):
        q = admittance(n)
        phi = kz_of(n) * k0 * float(d)
        c, s = np.cos(phi), np.sin(phi)
        M = M @ np.array([[c, -s / q], [q * s, c]], np.complex128)

    # Top: S = 1 + r, h = i qI (1 - r); bottom: S = t, h = i qII t.
    qI = admittance(nI)
    qII = admittance(complex(n_sub))
    p = M[0, 0] + 1j * qII * M[0, 1]
    q2 = M[1, 0] + 1j * qII * M[1, 1]
    t = 2j * qI / (q2 + 1j * qI * p)
    r = p * t - 1.0
    return complex(r), complex(t)


# ---------------------------------------------------------------------------
# Imaging bridge: RCWA near field -> effective mask on the simulation grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MaskStack:
    """A named absorber stack for :func:`rcwa_effective_mask`.

    ``layers_fn(duty)`` would be overkill: the stack is the list of
    (thickness, ridge index) pairs; the groove is the blank's ambient
    (air in the etched regions), and the blank itself is the superstrate.

    A non-empty ``mirror`` makes the stack REFLECTIVE (EUV): the absorber
    ``layers`` sit on top of the homogeneous ``mirror`` films (e.g. 40
    Mo/Si bilayers) over ``n_substrate``, illumination comes from the
    ``n_blank`` side (vacuum), and the working field is the *reflected*
    near field normalized to the bare mirror's specular reflection.
    """

    layers: tuple[tuple[float, complex], ...]  # (thickness_nm, n_ridge)
    n_blank: complex = 1.5631  # fused silica at 193 nm
    description: str = ""
    mirror: tuple[tuple[float, complex], ...] = ()  # homogeneous, top-first
    n_substrate: complex = 1.0
    # The wavelength the refractive indices were tabulated at. Optical
    # constants are strongly dispersive (Cr at 193 nm vs 13.5 nm differ by
    # integer factors), so running a named stack at the wrong config
    # wavelength is silent garbage: resolve_stack() guards against it.
    # None (custom stacks) disables the check.
    design_wavelength_nm: float | None = None

    @property
    def reflective(self) -> bool:
        return bool(self.mirror)


# Representative production stacks (indices from published 193-nm optical
# constants; close enough for model calibration — the BL fit absorbs small
# index errors by construction).
MASK_STACKS = {
    # ~68 nm Cr + ~20 nm CrOx ARC binary absorber
    "binary_cr": MaskStack(
        layers=((20.0, 1.965 + 1.201j), (68.0, 0.842 + 1.647j)),
        description="Binary chrome-on-glass (CrOx ARC / Cr), 193 nm",
        design_wavelength_nm=193.0,
    ),
    # ~72 nm MoSi 6% attenuated PSM (thickness at the pi-phase point:
    # (n-1) k0 d ~ pi; T ~ 6%, relative phase ~175 deg vs the clear path)
    "att_psm_mosi": MaskStack(
        layers=((72.0, 2.343 + 0.586j),),
        description="6% MoSi attenuated PSM, 193 nm",
        design_wavelength_nm=193.0,
    ),
    # EUV reticle: ~60 nm TaBN absorber over a 40-bilayer Mo/Si Bragg
    # mirror (Si 4.17 / Mo 2.76 nm) on Si, vacuum ambient. Indices are
    # published 13.5-nm optical constants (n = 1-delta + i*beta); the bare
    # mirror reflects ~73% at the 6 deg chief ray, matching real blanks.
    "euv_ta": MaskStack(
        layers=((60.0, 0.9260 + 0.0440j),),
        n_blank=1.0,
        mirror=tuple(f for _ in range(40)
                     for f in ((4.17, 0.9990 + 0.0018j),
                               (2.76, 0.9238 + 0.0064j))),
        n_substrate=0.9990 + 0.0018j,
        description="EUV TaBN absorber on 40x Mo/Si multilayer, 13.5 nm",
        design_wavelength_nm=13.5,
    ),
}


def resolve_stack(stack: "MaskStack | str",
                  wavelength_nm: float | None = None,
                  rtol: float = 0.05) -> MaskStack:
    """Look up a named stack and, when ``wavelength_nm`` is given, verify it
    sits within ``rtol`` of the stack's ``design_wavelength_nm`` — the
    tabulated refractive indices are meaningless at other wavelengths (an
    EUV TaBN stack "run" at 193 nm produces a confidently wrong near
    field). Raises ValueError naming the fix (set the config wavelength, or
    build a custom :class:`MaskStack` with indices for your wavelength)."""
    if isinstance(stack, str):
        try:
            stack = MASK_STACKS[stack]
        except KeyError:
            raise ValueError(
                f"unknown mask stack {stack!r}; available: "
                f"{sorted(MASK_STACKS)}") from None
    lam0 = stack.design_wavelength_nm
    if wavelength_nm is not None and lam0 is not None:
        if abs(float(wavelength_nm) - lam0) > rtol * lam0:
            raise ValueError(
                f"stack {stack.description!r} carries optical constants "
                f"tabulated at {lam0} nm but the configured wavelength is "
                f"{float(wavelength_nm)} nm; set OpticsConfig.wavelength to "
                f"{lam0} (CLI: --wavelength {lam0}) or supply a custom "
                f"MaskStack with indices for your wavelength")
    return stack


def thin_mask_transmission(stack: MaskStack | str,
                           wavelength_nm: float = 193.0,
                           incidence_deg: float = 0.0) -> complex:
    """Complex thin-mask (Kirchhoff) transmission of the stack's absorber:
    the blanket film's amplitude relative to the clear path through the same
    physical distance of air — ~0 for binary chrome, ~0.25·e^{i·pi} for a 6%
    attenuated PSM. This is the value a drawn PSM layout should carry so the
    thin-mask model and :func:`rcwa_effective_mask` agree away from edges.

    Reflective (EUV) stacks return the blanket absorber's specular
    REFLECTION relative to the bare multilayer mirror (absorber regions
    etched to vacuum) — the same normalization the effective reflected
    near field uses."""
    stack = resolve_stack(stack, wavelength_nm)
    d_total = sum(th for th, _ in stack.layers)
    if stack.reflective:
        film_n = ([nr for _, nr in stack.layers]
                  + [nm for _, nm in stack.mirror])
        film_d = ([th for th, _ in stack.layers]
                  + [th for th, _ in stack.mirror])
        r_film, _ = transfer_matrix_stack(
            film_n, film_d, wavelength_nm, n_super=stack.n_blank,
            n_sub=stack.n_substrate, theta_deg=incidence_deg)
        clear_n = [1.0 + 0.0j] + [nm for _, nm in stack.mirror]
        clear_d = [d_total] + [th for th, _ in stack.mirror]
        r_clear, _ = transfer_matrix_stack(
            clear_n, clear_d, wavelength_nm, n_super=stack.n_blank,
            n_sub=stack.n_substrate, theta_deg=incidence_deg)
        return complex(r_film / r_clear)
    _, t_film = transfer_matrix_stack(
        [nr for _, nr in stack.layers], [th for th, _ in stack.layers],
        wavelength_nm, n_super=stack.n_blank, theta_deg=incidence_deg)
    _, t_clear = transfer_matrix_stack(
        [1.0 + 0.0j], [d_total], wavelength_nm, n_super=stack.n_blank,
        theta_deg=incidence_deg)
    return complex(t_film / t_clear)


@functools.lru_cache(maxsize=64)
def _cached_orders(period_nm, layers_key, wavelength_nm, pol, n_super, n_sub,
                   theta_deg, n_harmonics):
    layers = [GratingLayer(*args) for args in layers_key]
    return rcwa_orders(period_nm, layers, wavelength_nm, pol=pol,
                       n_super=n_super, n_sub=n_sub, theta_deg=theta_deg,
                       n_harmonics=n_harmonics)


@functools.lru_cache(maxsize=64)
def _cached_conical(period_nm, layers_key, wavelength_nm, psi_deg, n_super,
                    n_sub, theta_deg, phi_deg, n_harmonics):
    layers = [GratingLayer(*args) for args in layers_key]
    return rcwa_orders_conical(period_nm, layers, wavelength_nm,
                               n_super=n_super, n_sub=n_sub,
                               theta_deg=theta_deg, phi_deg=phi_deg,
                               psi_deg=psi_deg, n_harmonics=n_harmonics)


def _conical_scalar_orders(res: RcwaConicalResult, pol: str, reflective: bool,
                           n_medium: complex, n_inc: complex,
                           wavelength_nm: float, period_nm: float,
                           theta_deg: float, phi_deg: float) -> np.ndarray:
    """Per-order scalar amplitudes from a conical solve, using the SAME
    field components as the planar bridge — Ey for TE-like, Hy for TM-like
    (the Hy amplitude carries the order's full |E| magnitude, which is what
    the scalar imaging stack propagates) — so the conical path reduces to
    the planar one exactly as the azimuth goes to 0, for both
    polarizations. Hy is reconstructed from the tangential E amplitudes via
    the plane-wave admittance of the exit medium (exp(−iωt) convention;
    reflected sets carry a global −1 that cancels in the blank-normalized
    ratio)."""
    ey = res.ry if reflective else res.ty
    if pol == "te":
        return ey
    ex = res.rx if reflective else res.tx
    theta = np.deg2rad(theta_deg)
    phi = np.deg2rad(phi_deg)
    lam = float(wavelength_nm)
    nr = complex(n_inc).real
    kx = nr * np.sin(theta) * np.cos(phi) - res.orders * lam / period_nm
    ky = nr * np.sin(theta) * np.sin(phi)
    eps = complex(n_medium) ** 2
    kz = np.sqrt(eps - kx * kx - ky * ky + 0j)
    kz = np.where(kz.imag < 0, -kz, kz)  # exp(-iwt): decay away from mask
    kz = np.where(np.abs(kz) < 1e-9, kz + 1e-9, kz)
    return (kx * ky * ey + (eps - ky * ky) * ex) / kz


def rcwa_effective_mask(
    config,
    *,
    pitch_px: int,
    duty: float,
    stack: MaskStack | str = "binary_cr",
    pol: str = "te",
    axis: int = 1,
    magnification: float = 4.0,
    n_harmonics: int = 21,
    incidence_deg: float = 0.0,
    azimuth_deg: float = 0.0,
) -> np.ndarray:
    """Rigorous effective complex transmission of a line/space mask, on the
    simulation grid — a drop-in replacement for the drawn layout on EVERY
    imaging path (Hopkins decomposition: imaging the rigorous near field
    through the thin-mask machinery is exact for the collected orders).

    ``pitch_px`` must divide ``config.pixel_number`` (the pattern tiles the
    FFT grid exactly, so RCWA orders land on integer grid harmonics). The
    RCWA runs at MASK scale: period ``magnification × pitch_px ×
    config.pixel_size`` (scanner reduction, 4× default), illuminated from
    the blank; order m of the mask grating maps to harmonic m of the
    wafer-side pattern under demagnification. Amplitudes are normalized to
    the bare blank's transmission so the clear field is exactly 1 — the
    thin-mask convention the rest of the framework assumes.

    ``axis=1``: lines run along rows (vertical lines, transmission varies
    along x). TE then means E ∥ lines (y-polarized). The duty is the
    ABSORBER cover fraction (lines), centered on the period.

    ``incidence_deg`` tilts the illumination; ``azimuth_deg`` rotates the
    plane of that tilt away from the grating vector (0°, the default: tilt
    ACROSS the lines — the planar mount; 90°: tilt ALONG the lines — the
    geometry the EUV chief ray presents to HORIZONTAL edges, solved with
    :func:`rcwa_orders_conical`). For reflective (EUV) stacks the returned
    field is the REFLECTED near field normalized to the bare mirror's
    specular order; at the ~6° chief ray across the lines it carries the
    absorber-shadowing asymmetry (order m ≠ order −m) that prints as the
    EUV pattern shift — the effect the asymmetric boundary-layer model
    (:func:`..mask3d.edge_fields_signed`) is calibrated to reproduce.
    Along the lines the orders stay symmetric but the obliquely-traversed
    absorber still perturbs the near field by several percent — the
    H-edge correction the conical calibration captures. The conical
    bridge synthesizes the same per-order field components as the planar
    one (Ey for TE, Hy for TM), so ``azimuth_deg → 0`` reduces to the
    planar path continuously for both polarizations.

    Synthesis convention (mask → wafer image inversion): order m is laid
    down as ``exp(+2πimx/pitch)``, while under this module's exp(-iωt)
    convention the Moharam order m (kx_m = n_I sinθ − mλ/Λ) propagates as
    ``exp(-2πimx/Λ)``. The sign flip IS the scanner's image inversion (a
    single-telescope projector maps mask x → −x at the wafer; this
    framework keeps demo parity with the reference by drawing layouts in
    WAFER coordinates). Consequence at oblique incidence: with
    ``incidence_deg > 0`` (transverse momentum along +x at the MASK) the
    shadowing pattern shift appears along **+x at the wafer**. Calibration
    (:func:`..mask3d` m3dcal) and application share this synthesis, so
    every consumer is self-consistent; the absolute direction is pinned by
    ``tests/test_rcwa.py::test_shadow_shift_direction_pinned``.
    """
    n = int(config.pixel_number)
    pitch_px = int(pitch_px)
    if pitch_px <= 0 or n % pitch_px:
        raise ValueError(f"pitch_px={pitch_px} must divide pixel_number={n}")
    stack = resolve_stack(stack, float(config.wavelength))

    period_nm = float(magnification) * pitch_px * float(config.pixel_size)
    mirror_key = tuple((float(th), complex(nm), complex(nm), 0.0, 0.0)
                       for th, nm in stack.mirror)
    layers_key = tuple(
        (float(th), complex(nr), complex(1.0), float(duty), 0.0)
        for th, nr in stack.layers) + mirror_key
    blank_key = tuple((float(th), complex(nr), complex(1.0), 0.0, 0.0)
                      for th, nr in stack.layers) + mirror_key
    if float(azimuth_deg) == 0.0:
        res = _cached_orders(period_nm, layers_key, float(config.wavelength),
                             pol, complex(stack.n_blank),
                             complex(stack.n_substrate), float(incidence_deg),
                             int(n_harmonics))
        blank = _cached_orders(period_nm, blank_key, float(config.wavelength),
                               pol, complex(stack.n_blank),
                               complex(stack.n_substrate),
                               float(incidence_deg), int(n_harmonics))
        if stack.reflective:
            t = res.r / blank.r[(len(blank.r) - 1) // 2]
        else:
            t = res.t / blank.t[(len(blank.t) - 1) // 2]
    else:
        # Conical mount. The incident polarization angle psi is chosen so
        # the tangential E lies along the lines (pol='te') or across them
        # ('tm') — the natural continuation of the planar TE/TM split.
        theta_r = np.deg2rad(float(incidence_deg))
        phi_r = np.deg2rad(float(azimuth_deg))
        if pol == "te":
            psi = np.degrees(np.arctan2(np.cos(theta_r) * np.cos(phi_r),
                                        np.sin(phi_r)))
        else:
            psi = np.degrees(np.arctan2(-np.cos(theta_r) * np.sin(phi_r),
                                        np.cos(phi_r)))
        args = (period_nm, float(config.wavelength), float(psi),
                complex(stack.n_blank), complex(stack.n_substrate),
                float(incidence_deg), float(azimuth_deg), int(n_harmonics))
        res = _cached_conical(args[0], layers_key, *args[1:])
        blank = _cached_conical(args[0], blank_key, *args[1:])
        n_exit = stack.n_blank if stack.reflective else stack.n_substrate
        s_res = _conical_scalar_orders(
            res, pol, stack.reflective, n_exit, stack.n_blank,
            float(config.wavelength), period_nm, float(incidence_deg),
            float(azimuth_deg))
        s_blank = _conical_scalar_orders(
            blank, pol, stack.reflective, n_exit, stack.n_blank,
            float(config.wavelength), period_nm, float(incidence_deg),
            float(azimuth_deg))
        t = s_res / s_blank[(len(s_blank) - 1) // 2]

    # Keep only orders below the grid Nyquist; synthesize one period.
    m_max = min((pitch_px - 1) // 2, (len(t) - 1) // 2)
    mid = (len(t) - 1) // 2
    x = np.arange(pitch_px)
    profile = np.zeros(pitch_px, np.complex128)
    for m in range(-m_max, m_max + 1):
        profile += t[mid + m] * np.exp(2j * np.pi * m * x / pitch_px)

    row = np.tile(profile, n // pitch_px).astype(np.complex64)
    field = np.broadcast_to(row[None, :], (n, n))
    if axis == 0:
        field = field.T
    return np.ascontiguousarray(field)
