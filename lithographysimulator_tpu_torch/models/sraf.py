"""Sub-resolution assist features (SRAFs / scattering bars).

The port's own copy of ``lithographysimulator_tpu/models/sraf.py`` (numpy
on the host, bound to the port's :class:`..config.OpticsConfig`, with the
port's :mod:`.mrc` morphology); a tensor mask is read back to the host
first, and the results are host arrays as in the JAX package.

Isolated features print with less depth of focus than dense ones: their
diffraction spectrum lacks the neighbor orders that keep dense-pattern
edges steep through focus. Scattering bars — assist features placed a set
distance off each edge, too narrow to print themselves — fake the dense
environment. This module places them geometrically (iso-distance bands via
Chebyshev-ball dilations from :mod:`.mrc`) and verifies they stay
sub-printing.

Placement: the assist band is the set of pixels whose Chebyshev distance
to the nearest feature lies in [distance, distance + width). Dense regions
self-exclude: where neighboring features sit closer than twice the assist
distance, no band forms between them — exactly the rule-based behavior
(assist isolated, leave dense alone). Measured on the framework's own
imaging (tests): a 150 nm isolated line at NA 0.7 gains ~10% edge NILS at
250 nm defocus from a 25 nm bar at 150 nm distance, with zero printed
assist pixels.

No reference counterpart (the reference has no OPC/RET at all).
"""

from __future__ import annotations

import numpy as np

from ..config import OpticsConfig
from .mrc import _dilate, _host


def _px(config_or_pixel) -> float:
    return (config_or_pixel.pixel_size
            if isinstance(config_or_pixel, OpticsConfig)
            else float(config_or_pixel))


def sraf_band(mask, config_or_pixel, *, distance_nm: float,
              width_nm: float) -> np.ndarray:
    """Boolean assist-feature band: pixels at Chebyshev distance
    [distance, distance + width) from the thresholded feature set."""
    px = _px(config_or_pixel)
    if distance_nm <= 0 or width_nm <= 0:
        raise ValueError("distance_nm and width_nm must be > 0")
    d1 = max(1, int(round(distance_nm / px)))
    w = max(1, int(round(width_nm / px)))
    arr = (np.abs(_host(mask)) > 0.5).astype(np.int8)
    # distance >= d1  <=>  outside the radius-(d1-1) ball;
    # distance <= d1 + w - 1  <=>  inside the radius-(d1+w-1) ball
    inner = _dilate(arr, 2 * (d1 - 1) + 1)
    outer = _dilate(arr, 2 * (d1 + w - 1) + 1)
    return (outer > 0) & (inner == 0)


def sraf_insert(mask, config_or_pixel, *, distance_nm: float,
                width_nm: float) -> np.ndarray:
    """Mask with assist bars added (float32; main features unchanged)."""
    band = sraf_band(mask, config_or_pixel, distance_nm=distance_nm,
                     width_nm=width_nm)
    arr = (np.abs(_host(mask)) > 0.5).astype(np.float32)
    return np.maximum(arr, band.astype(np.float32))


def sraf_print_check(printed_profile, mask_with_sraf, base_mask, *,
                     guard_px: int = 1) -> dict:
    """Verify assist features did NOT print: counts printed pixels inside
    the assist zone (the SRAF'd mask minus the base features, minus a
    ``guard_px`` halo of the base features so legitimate main-feature
    blooming is not miscounted). ``clean`` is the commit gate."""
    profile = _host(printed_profile) > 0.5
    base = (np.abs(_host(base_mask)) > 0.5).astype(np.int8)
    zone = ((np.abs(_host(mask_with_sraf)) > 0.5)
            & (_dilate(base, 2 * guard_px + 1) == 0))
    printed = int((profile & zone).sum())
    return {"sraf_px": int(zone.sum()), "printed_px": printed,
            "clean": printed == 0}
