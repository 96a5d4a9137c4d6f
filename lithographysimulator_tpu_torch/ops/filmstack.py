"""Wafer-side thin-film stack: the rigorous image **in** the resist.

The port's own copy of ``lithographysimulator_tpu/ops/filmstack.py``, on
the port's :class:`..config.OpticsConfig`, :class:`..grid.Grid` and
:mod:`.vector`; ``tests/test_torch_filmstack.py`` pins it equal to the JAX
package's module (1e-12).

:class:`..models.resist.DepthResist` shapes its 3-D latent image with the
classic separable approximation ``I(x, y, z) = I_aerial(x, y) * D(z)`` — a
through-focus aerial stack times Mack's analytic standing-wave profile (one
substrate reflectivity knob, normal-incidence interference only). This
module replaces that with the exact electromagnetic treatment used by
production resist simulators ("image in resist"): every plane wave the
projector focuses at the wafer refracts into the resist film, bounces off
the underlayers (BARC) and the substrate, and the exposing intensity at
depth ``z`` is the interference of its downward and upward branches —
per pupil angle, per polarization.

For a pupil position sigma (tangential wavevector ``kx = NA * |sigma|`` in
vacuum units, continuous through every interface) the field inside the
resist is a two-wave Airy sum

    F(sigma, z) = A(sigma) e^{+i kz_r k0 z} + B(sigma) e^{-i kz_r k0 z},

with ``A = t_top / (1 + r_top r_bot e^{2 i phi})`` and
``B = A r_bot e^{2 i phi}`` (phi = kz_r k0 T), where ``r_bot`` is the
effective reflection of everything below the resist (recursive Fresnel over
the underlayers and substrate) and ``r_top``/``t_top`` the resist-top
interface coefficients. Conventions match :func:`..ops.rcwa.rcwa_orders` /
:func:`..ops.rcwa.transfer_matrix_stack` exactly — exp(-i omega t), kz
normalized by k0 with Im kz >= 0, tangential amplitudes (TE: Ey, TM: Hy),
admittance ``q = kz`` (TE) / ``kz / n^2`` (TM) — so the total stack
reflectivity is pinned against that independent analytic oracle in
tests/test_filmstack.py.

Three depth factors feed the vector imaging engine (:mod:`.vector`), one
per E-field component of each plane wave (Mack, *Fundamental Principles of
Optical Lithography* ch. 4.4-4.6; Flagello & Milster JOSA A 13, 1996):

* TE (tangential):      F_te(z)  =          A_s e^{+i k z} + B_s e^{-i k z}
* TM in-plane:  F_tm_in(z) = (kz_r/n_r^2) n_top (A_p e^{+ikz} - B_p e^{-ikz})
* TM longitudinal: F_tm_z(z) = -(kx/n_r^2) n_top (A_p e^{+ikz} + B_p e^{-ikz})

(the upward TM branch flips its in-plane E component but not its z
component, which is why standing-wave nodes of the two TM components are
half-a-period apart — an effect no separable D(z) can represent). In the
no-film limit (resist index = immersion index, no underlayers, substrate =
immersion) these reduce at z = 0 to the vector pupil factors of
:func:`.vector._vector_factors` — 1, cos(theta), -sin(theta) — and the
e^{+i kz z} propagation IS the exact through-depth defocus, replacing the
paraxial ``z / n_resist`` offsets of ``DepthResist.film_defocus_nm``.

Everything here is host-side complex128 (one (n, n) Airy solve per config x
stack, cached); the imaging consumers receive per-slab component-pupil
multipliers and ship them to the device as complex64.

The reference has no resist or wafer-film model at all (resist modeling is
an unchecked roadmap item, reference README.md:19).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np

from ..config import OpticsConfig
from ..grid import Grid

__all__ = [
    "WaferStack",
    "film_coefficients",
    "film_depth_factors",
    "film_component_multipliers",
    "open_frame_profile",
    "substrate_reflectance",
    "underlayer_sweep",
    "MATERIALS_193",
]

#: typical optical constants at 193 nm for named wafer materials
#: (silicon: Aspnes/Palik tabulation; organic BARC and SiO2: vendor-typical)
MATERIALS_193 = {
    "si": 0.883 + 2.778j,
    "sio2": 1.563 + 0.0j,
    "barc": 1.82 + 0.39j,
    "air": 1.0 + 0.0j,
}


def _coerce_complex(value) -> complex:
    return complex(value)


@dataclasses.dataclass(frozen=True)
class WaferStack:
    """The films the image forms in: resist over underlayers over substrate.

    ``n_resist`` is complex — its imaginary part is the resist absorption
    (k = absorbance_per_nm * wavelength / 4 pi), so Beer-Lambert decay,
    standing waves and their oblique-incidence/polarization structure all
    come out of one Airy solve. ``under_layers`` are (thickness_nm, n)
    pairs listed top-first (the first one touches the resist bottom);
    typically a single BARC. The medium above the resist is the imaging
    config's ``immersion_index`` (air or water) — the same index the vector
    engine measures focus angles in, which is what makes the in-film
    factors splice exactly onto the Jones pupil.

    Frozen + hashable so it can key compiled-pipeline caches like every
    other config object in this framework.
    """

    n_resist: complex = 1.71 + 0.00768j
    thickness_nm: float = 100.0
    under_layers: tuple = ()  # ((thickness_nm, n_complex), ...) top-first
    n_substrate: complex = MATERIALS_193["si"]

    def __post_init__(self):
        object.__setattr__(self, "n_resist", complex(self.n_resist))
        object.__setattr__(self, "n_substrate", complex(self.n_substrate))
        layers = tuple(
            (float(d), complex(n)) for d, n in self.under_layers)
        object.__setattr__(self, "under_layers", layers)
        if self.thickness_nm <= 0:
            raise ValueError("resist thickness must be positive")

    @classmethod
    def from_resist(cls, resist, *, wavelength_nm: float | None = None,
                    under_layers: Sequence = (),
                    n_substrate: complex = MATERIALS_193["si"]) -> "WaferStack":
        """Build from a :class:`..models.resist.DepthResist`: the real index
        and thickness carry over, the Dill absorbance becomes Im(n_resist).
        The resist's analytic ``substrate_reflectivity`` knob is superseded
        by the actual stack below (pass the DepthResist on with
        ``absorbance_per_um=0, substrate_reflectivity=0`` — see
        ``DepthResist.rigorous()`` — so attenuation is not double-counted).
        """
        lam = float(wavelength_nm if wavelength_nm is not None
                    else resist.wavelength_nm)
        k = resist.absorbance_per_um * 1e-3 * lam / (4.0 * np.pi)
        return cls(
            n_resist=complex(resist.n_resist, k),
            thickness_nm=float(resist.mack.thickness_nm),
            under_layers=tuple((float(d), complex(n)) for d, n in under_layers),
            n_substrate=complex(n_substrate),
        )


def _kz(n: complex, kx: np.ndarray) -> np.ndarray:
    """Normalized kz = sqrt(n^2 - kx^2) on the Im >= 0 branch (decay in +z
    under exp(-i omega t); matches rcwa.transfer_matrix_stack)."""
    kz = np.sqrt((complex(n) ** 2 - kx.astype(np.complex128) ** 2))
    return np.where(kz.imag < 0, -kz, kz)


def _admittance(n: complex, kx: np.ndarray, pol: str) -> np.ndarray:
    kz = _kz(n, kx)
    return kz if pol == "te" else kz / (complex(n) ** 2)


def film_coefficients(stack: WaferStack, kx, wavelength_nm: float, *,
                      pol: str, n_top: complex = 1.0):
    """Airy coefficients of the two-wave field inside the resist.

    ``kx``: tangential wavevector normalized by k0 (vacuum units; any
    shape). Returns ``(a, b, kz_r, r_total)`` — tangential-amplitude
    downward/upward coefficients at the resist top for a unit-amplitude
    incident tangential field (TE: Ey = 1; TM: Hy = 1), the normalized
    resist kz, and the total stack reflection coefficient seen from the top
    medium (the quantity pinned against
    :func:`..ops.rcwa.transfer_matrix_stack`).
    """
    if pol not in ("te", "tm"):
        raise ValueError(f"pol must be 'te' or 'tm', got {pol!r}")
    kx = np.asarray(kx, np.float64)
    k0 = 2.0 * np.pi / float(wavelength_nm)

    # effective reflection looking down from inside each medium, bottom-up
    gamma = np.zeros(kx.shape, np.complex128)  # inside the substrate
    n_below = stack.n_substrate
    for d, n_l in reversed(stack.under_layers):
        q_l = _admittance(n_l, kx, pol)
        q_b = _admittance(n_below, kx, pol)
        r_int = (q_l - q_b) / (q_l + q_b)
        gamma = (r_int + gamma) / (1.0 + r_int * gamma)
        gamma = gamma * np.exp(2j * _kz(n_l, kx) * k0 * d)
        n_below = n_l

    q_r = _admittance(stack.n_resist, kx, pol)
    q_b = _admittance(n_below, kx, pol)
    r_int = (q_r - q_b) / (q_r + q_b)
    r_bot = (r_int + gamma) / (1.0 + r_int * gamma)  # at the resist bottom

    q_top = _admittance(n_top, kx, pol)
    r_top = (q_top - q_r) / (q_top + q_r)
    t_top = 2.0 * q_top / (q_top + q_r)
    kz_r = _kz(stack.n_resist, kx)
    phase2 = np.exp(2j * kz_r * k0 * stack.thickness_nm)
    denom = 1.0 + r_top * r_bot * phase2
    a = t_top / denom
    b = a * r_bot * phase2
    r_total = (r_top + r_bot * phase2) / denom
    return a, b, kz_r, r_total


@functools.lru_cache(maxsize=16)
def _pupil_film_solution(stack: WaferStack, config: OpticsConfig):
    """Per-config Airy solve on the full sigma grid (host, complex128).

    Returns (a_s, b_s, a_p, b_p, kz_r, kx, propagating): tangential-unit
    coefficients for both polarizations at kx = NA * rho, plus the
    top-medium propagation mask (NA rho < immersion_index — the same
    evanescent cut the vector pupil applies)."""
    rho = Grid(config).radius()
    kx = config.na * rho
    n_top = complex(config.immersion_index)
    propagating = kx < config.immersion_index * (1.0 - 1e-12)
    kx_safe = np.where(propagating, kx, 0.0)
    a_s, b_s, kz_r, _ = film_coefficients(
        stack, kx_safe, config.wavelength, pol="te", n_top=n_top)
    a_p, b_p, _, _ = film_coefficients(
        stack, kx_safe, config.wavelength, pol="tm", n_top=n_top)
    return a_s, b_s, a_p, b_p, kz_r, kx_safe, propagating


def film_depth_factors(stack: WaferStack, config: OpticsConfig,
                       depth_nm: float):
    """The three E-field depth factors on the sigma grid at one depth.

    Returns host complex128 ``(f_te, f_tm_in, f_tm_z)``, each (n, n):
    multiply a scalar pupil by ``f_te`` (TE component), ``f_tm_in`` (radial
    in-plane component, replaces cos(theta)) and ``f_tm_z`` (longitudinal,
    replaces -sin(theta)) to image the field at ``depth_nm`` below the
    resist top. Evanescent top-medium positions are zeroed.
    """
    a_s, b_s, a_p, b_p, kz_r, kx, prop = _pupil_film_solution(stack, config)
    k0 = 2.0 * np.pi / config.wavelength
    down = np.exp(1j * kz_r * k0 * float(depth_nm))
    up = np.exp(-1j * kz_r * k0 * float(depth_nm))
    n_top = complex(config.immersion_index)
    inv_nr2 = 1.0 / (stack.n_resist ** 2)
    f_te = a_s * down + b_s * up
    f_tm_in = (kz_r * inv_nr2) * n_top * (a_p * down - b_p * up)
    f_tm_z = -(kx * inv_nr2) * n_top * (a_p * down + b_p * up)
    return f_te * prop, f_tm_in * prop, f_tm_z * prop


def film_component_multipliers(config: OpticsConfig, stack: WaferStack,
                               depths_nm, *, polarization=None,
                               apodize: bool = True) -> np.ndarray:
    """(nz, C, n, n) complex128 per-slab pupil multipliers for the imaging
    engine: image slab z as ``sum_c AbbeIntensity(pupil * mult[z, c])``.

    ``polarization=None`` is the scalar image-in-resist (C = 1, the TE
    Airy factor — the standard scalar-resist convention); any spec accepted
    by :func:`.vector.polarization_states` gives the full vector treatment
    (C = 3 per state, state weights folded in as sqrt(w), identically-zero
    components dropped like :func:`.vector.component_factors` does).
    """
    depths = np.atleast_1d(np.asarray(depths_nm, np.float64))
    if polarization is None:
        mult = np.stack([
            film_depth_factors(stack, config, z)[0] for z in depths])
        return mult[:, None]  # (nz, 1, n, n)

    from .vector import _vector_basis, polarization_states

    tx, ty, rx, ry, gamma, _, inside = _vector_basis(config)
    apod = (1.0 / np.sqrt(np.maximum(gamma, 1e-6))) if apodize else 1.0
    comps: list = []
    for z in depths:
        f_te, f_tm_in, f_tm_z = film_depth_factors(stack, config, z)
        per_state: list = []
        for weight, (jx, jy) in polarization_states(polarization):
            jt = jx * tx + jy * ty  # tangential projection of J
            jr = jx * rx + jy * ry  # radial projection of J
            root_w = np.sqrt(weight)
            for comp in (
                (tx * jt) * f_te + (rx * jr) * f_tm_in,   # Ex
                (ty * jt) * f_te + (ry * jr) * f_tm_in,   # Ey
                jr * f_tm_z,                              # Ez
            ):
                per_state.append(root_w * comp * apod * inside)
        comps.append(np.stack(per_state))
    mult = np.stack(comps)  # (nz, S*3, n, n)
    # drop components that are identically zero across every slab (e.g. the
    # z component at tiny NA after float rounding) before tracing
    live = np.abs(mult).reshape(mult.shape[0], mult.shape[1], -1).max(
        axis=(0, 2)) > 0.0
    if not live.all():
        mult = mult[:, live]
    return mult


def open_frame_profile(stack: WaferStack, config: OpticsConfig,
                       depths_nm, *, normalize: bool = True) -> np.ndarray:
    """|E(z)|^2 of the normal-incidence open-frame exposure — the rigorous
    counterpart of ``DepthResist.depth_profile()`` (and the swing-curve
    integrand). ``normalize=True`` references the resist-top value (the
    D(0) = 1 convention); ``normalize=False`` references the incident wave
    instead, keeping the thickness-dependent coupling efficiency — the term
    that drives much of the E0 swing curve."""
    a, b, kz_r, _ = film_coefficients(
        stack, np.zeros(()), config.wavelength, pol="te",
        n_top=complex(config.immersion_index))
    k0 = 2.0 * np.pi / config.wavelength
    z = np.atleast_1d(np.asarray(depths_nm, np.float64))
    field = a * np.exp(1j * kz_r * k0 * z) + b * np.exp(-1j * kz_r * k0 * z)
    if not normalize:
        return np.abs(field) ** 2
    ref = a + b
    return np.abs(field) ** 2 / max(abs(ref) ** 2, 1e-300)


def substrate_reflectance(stack: WaferStack, config: OpticsConfig, *,
                          kx: float = 0.0, pol: str = "te") -> float:
    """Intensity reflectance |r_bot|^2 the resist sees looking down at its
    bottom interface (the quantity BARC design minimizes). ``kx`` in vacuum
    units (0 = normal incidence; NA for the pupil edge)."""
    # reuse film_coefficients' recursion by reading b/a at z-independent
    # level: r_bot = (b / a) * e^{-2 i phi}
    a, b, kz_r, _ = film_coefficients(
        stack, np.asarray(float(kx)), config.wavelength, pol=pol,
        n_top=complex(config.immersion_index))
    k0 = 2.0 * np.pi / config.wavelength
    phase2 = np.exp(2j * kz_r * k0 * stack.thickness_nm)
    return float(np.abs(b / a / phase2) ** 2)


def underlayer_sweep(stack: WaferStack, config: OpticsConfig,
                     thicknesses_nm, *, layer: int = 0,
                     kx: float = 0.0) -> np.ndarray:
    """Unpolarized substrate reflectance vs one underlayer's thickness —
    the classic BARC thickness-tuning curve. Returns |r_bot|^2 averaged
    over TE/TM at ``kx`` for each thickness."""
    if not stack.under_layers:
        raise ValueError("stack has no underlayers to sweep")
    out = []
    for t in np.asarray(thicknesses_nm, np.float64):
        layers = list(stack.under_layers)
        layers[layer] = (float(t), layers[layer][1])
        cand = dataclasses.replace(stack, under_layers=tuple(layers))
        out.append(0.5 * (substrate_reflectance(cand, config, kx=kx, pol="te")
                          + substrate_reflectance(cand, config, kx=kx,
                                                  pol="tm")))
    return np.asarray(out)
