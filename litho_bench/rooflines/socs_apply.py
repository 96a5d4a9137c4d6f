"""Least time of the SOCS apply's contraction, counted from sizes alone.

An image at rank ``r`` on an ``n``-point grid with kernel windows of width
``w`` (``w = n`` for SOCS: the window is the whole kernel) is ``r``
coherent fields ``E_j = T0 X_j T0^T`` (``X_j`` the kernel times the
spectrum, ``T0`` the ``(n, w)`` chirp) and their weighted ``|E_j|^2``
summed. Counted as the three-limb int8 work, the program's accuracy
class: a complex product as three real ones (3M), each over the six limb
pairs that three limbs keep, two operations a multiply-add. So one
``(B, n, w)`` chunk costs ``36 B n w^2`` operations for the row transform
and ``36 B n^2 w`` for the column transform and the intensity, and an
image ``36 r n w (w + n)``. Bytes: every input read once (the kernels'
windows, the spectrum, the chirp, the weights) and the image written once.

The least time is the larger of the operations at the card's int8 peak
and the bytes at its memory rate; at every SOCS shape of the benchmark the
operations rule (about 10.0 ms against 0.64 ms at rank 256, 1024^2). The
count does not read kernel names, launches or the program's chunk: a change
that fuses, re-chunks or renames kernels leaves it as it is.

``kernel_bound_s`` keeps the per-kernel counts of three of the int8
kernels (with their intermediate limbs, which the image count leaves out),
so that a test can hold this file to the bounds listed beside the port's
kernels.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1979e12  # H100 SXM, dense int8 tensor cores, 700 W
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
K_ALIGN = 32  # the limb kernels pad the contraction to a multiple of this


def padded(w: int) -> int:
    return -(-w // K_ALIGN) * K_ALIGN


def _least(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def image_ops(rank: int, n: int, w: int) -> float:
    return 36.0 * rank * n * w * (w + n)


def image_bytes(rank: int, n: int, w: int) -> float:
    kernels = 8.0 * rank * w * w
    spectrum = 8.0 * n * n
    chirp = 8.0 * n * w
    return kernels + spectrum + chirp + 4.0 * rank + 4.0 * n * n


def image_least_s(rank: int, n: int, w: int | None = None) -> tuple[float, str]:
    """(seconds, 'ops' or 'bytes') of one image's contraction."""
    w = n if w is None else w
    return _least(image_ops(rank, n, w), image_bytes(rank, n, w))


def kernel_bound_s(name: str, batch: int, n: int, w: int) -> tuple[float, str]:
    """(seconds, 'ops' or 'bytes') of one call of a three-limb kernel on a
    ``(batch, n, w)`` chunk."""
    kp = padded(w)
    limbs, dots = 3, 6
    if name == "row_limb_gemm":
        ops = 3 * dots * 2 * batch * n * w * w
        nbytes = (3 * limbs * (batch * w + n) * kp + 12 * (batch * w + n)
                  + 8 * batch * n * w)
    elif name == "column_intensity":
        ops = 3 * dots * 2 * batch * n * n * w
        nbytes = (3 * limbs * (batch * n + n) * kp + 12 * (batch * n + n)
                  + 4 * batch + 8 * n * n)
    elif name == "row_requantize":
        ops = 0.0
        nbytes = 8 * batch * n * w + 9 * batch * n * kp + 12 * batch * n
    else:
        raise ValueError(f"no count for kernel {name!r}")
    return _least(float(ops), float(nbytes))
