"""Wide contractions of the SOCS build, accumulated in double precision.

Port of ``lithographysimulator_tpu/ops/compensated.py``. A float32 dot of
K terms carries ~eps * sqrt(K) rounding error; for the SOCS Gram matrices
(K = n^2, up to 4M at 2048^2) that floors the randomized
eigendecomposition, and every image made from its kernels, at ~5e-5
relative. The JAX package emulates wide accumulation with TwoSum scans
because the TPU has no fp64. Here the contraction axis is walked in chunks,
each chunk is cast to complex128 (float64 for real operands) and multiplied
natively, and the chunks are summed in that precision: the result is exact
to float64 rounding, then returned in the operands' own dtype, as the JAX
functions return it.

Only one chunk of each operand is ever widened: a complex128 copy of a
whole (L, n^2) operand would be 18 GB at 2048^2 with L = 272.
"""

from __future__ import annotations

import torch

#: elements of the contraction per widened chunk (rows * columns of the
#: trailing axes): a (272, 65536) complex128 chunk is 285 MB
CHUNK_ELEMS = 1 << 16


def _wide(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype.is_complex else torch.float64


def _chunk_dot(a, b, conj_a: bool, conj_b: bool, wide) -> torch.Tensor:
    """``op(a) @ op(b).T`` of two chunks (M, ...) / (N, ...) in ``wide``,
    contracting every axis after the first (flattened after widening, so a
    strided slice is copied once)."""
    a = a.to(wide).reshape(a.shape[0], -1)
    b = b.to(wide).reshape(b.shape[0], -1)
    if conj_a:
        a = a.conj()
    if conj_b:
        b = b.conj()
    return a @ b.T


def matmul_compensated(a: torch.Tensor, b: torch.Tensor, *,
                       chunk: int = 512) -> torch.Tensor:
    """``a @ b`` for a (M, K) and b (K, N), float32 or complex64, walked in
    chunks of ``chunk`` contraction columns, each widened to
    complex128/float64 and accumulated there; returns the operands'
    promoted dtype (the JAX package's double-float scan, with native fp64
    in place of TwoSum)."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    wide = _wide(out_dtype)
    acc = torch.zeros((m, n), dtype=wide, device=a.device)
    for s in range(0, k, chunk):
        acc += a[:, s:s + chunk].to(wide) @ b[s:s + chunk].to(wide)
    return acc.to(out_dtype)


def rowdot_compensated(a: torch.Tensor, b: torch.Tensor, *,
                       chunk: int = CHUNK_ELEMS, conj_a: bool = False,
                       conj_b: bool = False) -> torch.Tensor:
    """``op(a) @ op(b).T`` for row-major stacks a (M, K), b (N, K),
    contracting the last axis of both (no transposed copy of either) and
    conjugating per chunk. Accumulates in complex128/float64; returns the
    operands' promoted dtype."""
    m, k = a.shape
    n, k2 = b.shape
    if k != k2:
        raise ValueError(f"row-contraction mismatch: {tuple(a.shape)} x {tuple(b.shape)}")
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    wide = _wide(out_dtype)
    acc = torch.zeros((m, n), dtype=wide, device=a.device)
    for s in range(0, k, chunk):
        acc += _chunk_dot(a[:, s:s + chunk], b[:, s:s + chunk], conj_a, conj_b,
                          wide)
    return acc.to(out_dtype)


def rowdot3_compensated(a: torch.Tensor, b: torch.Tensor, *,
                        row_chunk: int | None = None, conj_a: bool = False,
                        conj_b: bool = False) -> torch.Tensor:
    """``op(a) . op(b)`` contracting the trailing (n, n) image axes of two
    stacks (M, n, n) and (N, n, n) -> (M, N), walked in chunks of image
    rows. Never reshapes the whole operand, so slices of a larger buffer
    (the lean build's) work without a copy."""
    m, n1, n2 = a.shape
    nb = b.shape[0]
    if a.shape[1:] != b.shape[1:]:
        raise ValueError(f"image-axes mismatch: {tuple(a.shape)} x {tuple(b.shape)}")
    if row_chunk is None:
        row_chunk = max(1, CHUNK_ELEMS // max(n2, 1))
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    wide = _wide(out_dtype)
    acc = torch.zeros((m, nb), dtype=wide, device=a.device)
    for s in range(0, n1, row_chunk):
        acc += _chunk_dot(a[:, s:s + row_chunk], b[:, s:s + row_chunk],
                          conj_a, conj_b, wide)
    return acc.to(out_dtype)
