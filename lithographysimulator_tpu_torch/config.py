"""Optics configuration and wavelength-scaling (Gau 2023) parameters.

All static geometry/solver parameters live here as frozen dataclasses so they
are hashable and can key the host-side caches (interpolation matrices, Zernike
bases, zoom-DFT windows). A copy of ``lithographysimulator_tpu.config``: the
JAX package's ``__init__`` imports jax, so this port keeps its own.
Everything the reference spreads across four copies of grid code
(reference ``mask.py:32-35,63-72``, ``pupil.py:50-54``, ``lightsource.py:36-45``,
``imageformation.py:5-8``) is derived once from :class:`OpticsConfig`.

Grid conventions (shared-grid invariant of the whole framework):

* sigma/pupil plane: sigma in [-2, 2), step ``4 / pixel_number``; the unit
  pupil (r <= 1) occupies the central half of the array.
* frequency (k) plane: identical to the sigma plane (``delta_k = 4/n``), which
  is why a source point at integer array offset shifts the pupil by an integer
  roll with no interpolation.
* spatial plane: x in [-n/2 * pixel_size, n/2 * pixel_size) nm.
"""

from __future__ import annotations

import dataclasses

SIGMA_SPAN = 2.0  # sigma grid spans [-2, 2); unit pupil is the central half.

# Power-of-two FFT sizes considered by the wavelength-scaling solver
# (reference mask.py:63-65 uses the same fixed table).
_POW2_TABLE = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def nearest_pow2(value: float) -> int:
    """Nearest power of two from the fixed table (ties -> smaller, matching
    ``argmin`` over the ascending table in reference ``mask.py:63-65``)."""
    return min(_POW2_TABLE, key=lambda s: (abs(s - value), s))


@dataclasses.dataclass(frozen=True)
class WavelengthScaling:
    """Gau'23 wavelength-scaling parameters (reference ``mask.py:67-72``).

    beta = wavelength / (delta_k * pixel_size); N = nearest power of two;
    epsilon = N / beta is the mask upsample factor that makes the FFT grid
    wavelength-consistent.
    """

    beta: float
    fft_size: int  # N
    epsilon: float

    @property
    def n(self) -> int:
        return self.fft_size


@dataclasses.dataclass(frozen=True)
class OpticsConfig:
    """Static configuration of the imaging system.

    Parameters mirror the knobs of the reference constructors
    (``mask.py:5``, ``pupil.py:6``, ``lightsource.py:5``) but live in one
    place: ``pixel_number`` (grid size n), ``pixel_size`` (nm), ``wavelength``
    (nm), ``na`` (projection numerical aperture).
    """

    pixel_number: int = 64
    pixel_size: float = 25.0
    wavelength: float = 193.0
    na: float = 0.7
    #: refractive index of the medium between lens and wafer (1.0 = dry;
    #: 1.437 = water at 193 nm). Consumed by the vector/high-NA engine:
    #: sin(theta) = NA * rho / n_medium, and pupil positions with
    #: NA * rho >= n_medium are evanescent (cannot propagate) and carry no
    #: field. The scalar engine is index-independent (parity with the
    #: scalar reference).
    immersion_index: float = 1.0
    #: trace tolerance for principal-channel compression of
    #: weighted-component SOCS kernel builds (polarization / chromatic):
    #: channels carrying less than this fraction of the summed-TCC trace
    #: are dropped before subspace iteration (error bound exact — see
    #: ops.hopkins.principal_channel_rotation). The 1e-6 default only ever
    #: removes numerically negligible or exactly redundant channels; raise
    #: it (e.g. 3e-3) to trade accuracy for build speed on vector stacks,
    #: or set 0.0 to drop exact redundancies only.
    channel_tol: float = 1e-6
    #: central pupil obscuration as a fraction of NA (0 = unobscured).
    #: High-NA EUV projection optics have an obscured central pupil zone
    #: (~0.2 of NA): frequencies with rho < obscuration carry no field.
    #: Applied at the pupil function, so it flows through every solver,
    #: the vector engine, SOCS builds, and metrology automatically.
    obscuration: float = 0.0

    def __post_init__(self):
        if self.pixel_number < 2 or self.pixel_number % 2 != 0:
            raise ValueError(
                f"pixel_number must be an even integer >= 2, got {self.pixel_number}"
            )
        if self.pixel_size <= 0 or self.wavelength <= 0:
            raise ValueError("pixel_size and wavelength must be > 0")
        if not (0 < self.na <= 1.7):
            # immersion lithography reaches NA ~1.35 (water) / ~1.55+
            # (high-index fluids); nothing in the sigma-grid math caps at 1
            raise ValueError(f"na must be in (0, 1.7], got {self.na}")
        if self.immersion_index < 1.0:
            raise ValueError(
                f"immersion_index must be >= 1, got {self.immersion_index}")
        if not (0.0 <= self.channel_tol < 1.0):
            raise ValueError(
                f"channel_tol must be in [0, 1), got {self.channel_tol}")
        if not (0.0 <= self.obscuration < 1.0):
            raise ValueError(
                f"obscuration must be in [0, 1), got {self.obscuration}")

    # --- derived grid constants (reference mask.py:32-35) -----------------
    @property
    def n(self) -> int:
        return self.pixel_number

    @property
    def delta_k(self) -> float:
        return 2.0 * SIGMA_SPAN / self.pixel_number  # = 4 / n

    @property
    def k_bound(self) -> float:
        return self.pixel_number / 2 * self.delta_k  # = 2.0

    @property
    def delta_sigma(self) -> float:
        return self.delta_k

    @property
    def pixel_bound(self) -> float:
        return self.pixel_number / 2 * self.pixel_size

    @property
    def field_nm(self) -> float:
        """Physical field width in nm."""
        return self.pixel_number * self.pixel_size

    # --- wavelength scaling (Gau'23) --------------------------------------
    def wavelength_scaling(self) -> WavelengthScaling:
        beta = self.wavelength / (self.delta_k * self.pixel_size)
        fft_size = nearest_pow2(beta)
        return WavelengthScaling(beta=beta, fft_size=fft_size, epsilon=fft_size / beta)

    def defocus_nm_to_waves(self, defocus_nm: float) -> float:
        """Convert nm of defocus into waves of the Z4 (OSA index 4) Zernike
        coefficient: NA^2 / (4 * wavelength) (Mack eq. 3.24; reference
        ``pupil.py:92`` — but pure, without mutating the caller's array)."""
        return defocus_nm * self.na**2 / (4.0 * self.wavelength)


@dataclasses.dataclass(frozen=True)
class LaserSpectrum:
    """Finite laser bandwidth for chromatic (polychromatic) imaging.

    Excimer sources are not monochromatic: the E95 spectral width couples
    through the projection lens's longitudinal chromatic aberration to a
    focus blur — each wavelength offset ``d_lambda`` images at a defocus
    ``focus_nm_per_pm * d_lambda``, and the aerial image is the incoherent
    sum over the laser spectrum. (The reference is strictly monochromatic —
    single ``wavelength`` scalar, ``mask.py:5`` / ``pupil.py:6`` — so this
    subsystem has no counterpart there.)

    Frozen/hashable so it can key jit caches as a static argument.

    ``bandwidth_pm``: E95 width of the spectrum in picometres (the interval
    containing 95% of the spectral energy — the standard excimer spec;
    typical ArF values 0.2-1.2 pm).

    ``focus_nm_per_pm``: longitudinal chromatic aberration of the lens in
    nm of wafer-side defocus per pm of wavelength; all-refractive 193 nm
    projection optics sit in the hundreds (default -250).

    ``samples``: number of spectral quadrature points (odd keeps the center
    wavelength in the set for symmetric shapes).

    ``shape``: 'gaussian', 'lorentzian', or 'tophat' line shape.
    """

    bandwidth_pm: float
    focus_nm_per_pm: float = -250.0
    samples: int = 7
    shape: str = "gaussian"

    def __post_init__(self):
        if self.bandwidth_pm < 0:
            raise ValueError(f"bandwidth_pm must be >= 0, got {self.bandwidth_pm}")
        if self.samples < 1:
            raise ValueError(f"samples must be >= 1, got {self.samples}")
        if self.shape not in ("gaussian", "lorentzian", "tophat"):
            raise ValueError(f"unknown spectrum shape {self.shape!r}")

    def wavelength_offsets_pm(self):
        """(C,) spectral sample offsets in pm: equal-probability quantile
        midpoints of the line shape (each sample carries weight 1/C, the
        sample mean is exact for any symmetric shape, and bandwidth 0
        degenerates to all-zero offsets = monochromatic)."""
        import numpy as np

        p = (np.arange(self.samples) + 0.5) / self.samples
        if self.bandwidth_pm == 0:
            return np.zeros(self.samples, np.float64)
        if self.shape == "gaussian":
            import statistics

            # E95 = 2 * 1.95996 * sigma
            sigma = self.bandwidth_pm / (2.0 * 1.959964)
            nd = statistics.NormalDist(0.0, sigma)
            return np.array([nd.inv_cdf(float(q)) for q in p])
        if self.shape == "lorentzian":
            # CDF within +-x of a Lorentzian of FWHM g is
            # (2/pi) atan(2x/g): E95 => g = E95 / tan(0.475 pi).
            g = self.bandwidth_pm / np.tan(0.475 * np.pi)
            return (g / 2.0) * np.tan(np.pi * (p - 0.5))
        # tophat of full width W covers 95% of itself in 0.95 W
        return (self.bandwidth_pm / 0.95) * (p - 0.5)

    def defocus_offsets_nm(self):
        """(C,) defocus offsets in nm: the spectral samples mapped through
        the lens's longitudinal chromatic aberration."""
        return self.wavelength_offsets_pm() * self.focus_nm_per_pm

    def weights(self):
        """(C,) spectral weights (equal by construction, sum to 1)."""
        import numpy as np

        return np.full(self.samples, 1.0 / self.samples)


DEMO_CONFIG = OpticsConfig(pixel_number=64, pixel_size=25.0, wavelength=193.0, na=0.7)
