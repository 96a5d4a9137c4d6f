"""Least time of the exact (Abbe) engine's contraction, counted from sizes
alone.

A field is one source point through one component pupil:
``E = T0 X T0^T`` with ``X`` the ``(w, w)`` window of the shifted pupil
times the spectrum that holds the unit disk (``n / 2 + 1`` samples, two
of guard, rounded up to a multiple of 8) and ``T0`` the ``(n, w)`` chirp,
and its weighted ``|E|^2`` summed into the image. Counted as the
three-limb int8 work, the program's accuracy class, as
:mod:`.socs_apply` counts a SOCS kernel: ``36 n w^2`` operations for the
row transform and ``36 n^2 w`` for the column transform and the intensity,
``36 n w (w + n)`` a field. Bytes, every input read once and the image
written once, a pass (one component pupil over every source point): the
pupil, the spectrum, the chirp, the points' weights, the image.

The fields of an image come from the configuration's source: its live
points times the field components times the Jones states. The count reads
no kernel name, launch or chunk of the program.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1979e12  # H100 SXM, dense int8 tensor cores, 700 W
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def window_width(n: int) -> int:
    """The side of the window that holds a shifted unit disk."""
    return min(n, ((n // 2 + 3 + 7) // 8) * 8)


def field_ops(n: int) -> float:
    w = window_width(n)
    return 36.0 * n * w * (w + n)


def pass_bytes(n: int, points: int) -> float:
    return 8.0 * n * n + 8.0 * n * n + 8.0 * n * window_width(n) + 4.0 * points + 4.0 * n * n


def least_s(fields: int, passes: int, n: int) -> tuple[float, str]:
    """(seconds, 'ops' or 'bytes') of ``fields`` fields in ``passes``
    passes on an ``n``-point grid."""
    points = fields // passes if passes else 0
    t_ops = fields * field_ops(n) / INT8_OPS_PER_S
    t_bytes = passes * pass_bytes(n, points) / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
