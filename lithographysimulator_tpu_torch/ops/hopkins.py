"""Hopkins TCC imaging through SOCS kernels (scalar path).

Port of ``lithographysimulator_tpu/ops/hopkins.py``. The transmission cross
coefficient ``T(k, k') = sum_s w_s P(k - s) conj(P(k' - s))`` is
eigendecomposed once (Cobb's Sum Of Coherent Systems) into kernels phi_j
and weights lambda_j, and every mask is then imaged as

    I(x) = sum_j lambda_j |F(phi_j * M)(x)|^2,

which costs one transform per kernel instead of one per source point.

* :func:`tcc_eigensystem`: the dense, exact oracle over the passband
  support (source-side or frequency-side Gram, whichever is smaller).
* :func:`randomized_socs`: the matrix-free randomized eigendecomposition of
  the source-side Gram operator, whose matvec is two n^2 FFTs (cuFFT on the
  card); Rayleigh-Ritz, Nystrom or block-Krylov cores, warm starts, and the
  lean single-buffer build (:func:`_randomized_socs_lean`).
* :func:`socs_image`: the apply, on the ``fft``, ``matmul``, ``int8`` and
  ``int8_fast`` engines of :mod:`.abbe` or the direct solver; the int8
  engines run the hand-written limb kernels with the full (n, n) chirp.
* :func:`socs_image_nrms_bound` and :func:`auto_rank_socs`: the a-priori
  image-error bound and the rank-doubling loop built on it.

Probes come from a ``torch.Generator`` seeded with ``seed`` on the pupil's
device; the JAX package's ``jax.random`` draws other numbers from the same
seed, so randomized builds agree with it in eigenvalues and images, not in
kernels. The vector, chromatic, component and film builds are ROADMAP.md
Queue 1 items 9-10.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from .._tensors import to_tensor
from ..config import OpticsConfig
from .abbe import (_intensity_windowed_int8, _postprocess_gau23,
                   _zoom_dft_kernel, resolve_engine, source_points)
from .compensated import rowdot3_compensated, rowdot_compensated
from .fourier import centered_ifft2, crop_center, pad_center
from .fraunhofer import separable_dft
from .kernels.intensity_int8 import check_window_starts, prepare_t0_limbs


@dataclasses.dataclass(frozen=True)
class SOCSKernels:
    """Truncated SOCS decomposition: (rank, n, n) complex64 kernels on the
    full sigma grid and their (rank,) float32 eigenvalues, descending.
    ``total_rank`` is the passband/source size the decomposition ran on."""

    kernels: torch.Tensor
    eigenvalues: torch.Tensor
    total_rank: int = -1

    @property
    def rank(self) -> int:
        return self.kernels.shape[0]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _hermitian(m: torch.Tensor) -> torch.Tensor:
    return 0.5 * (m + m.conj().T)


def _eigh_descending(m: torch.Tensor):
    """Eigenpairs of a Hermitian matrix, eigenvalues descending (real)."""
    vals, vecs = torch.linalg.eigh(m)  # ascending, as jnp.linalg.eigh
    return vals.flip(0).real, vecs.flip(1)


def passband_support(pupil, shifts: np.ndarray) -> np.ndarray:
    """Boolean (n, n) union support of the pupil rolled to every source
    offset: frequencies outside it never pass light, so the TCC restricted
    to this set is exact."""
    base = np.abs(_host(pupil)) > 0
    n = base.shape[0]
    iy, ix = np.nonzero(base)
    support = np.zeros((n, n), dtype=bool)
    for dy, dx in np.unique(shifts, axis=0):
        support[(iy + dy) % n, (ix + dx) % n] = True
    return support


def tcc_eigensystem(
    pupil,
    source_map,
    config: OpticsConfig,
    *,
    rank: int | None = None,
    energy_tol: float = 1e-4,
    side: str = "auto",
    component_weights=None,
    device=None,
) -> SOCSKernels:
    """Build the passband-restricted TCC and eigendecompose it exactly.

    ``rank=None`` keeps every kernel with eigenvalue > energy_tol * max;
    ``rank=k`` keeps the top k. Eigenvalues are in the Abbe engine's
    unnormalized source-weight units, so full-rank SOCS reproduces
    :func:`..ops.abbe.abbe_image`.

    ``side``: ``"frequency"`` eigendecomposes the (D, D) TCC over the
    passband support, ``"source"`` the isospectral (P, P) source-side Gram
    A A^H and lifts the eigenvectors through A^H, ``"auto"`` the smaller.
    A stacked (C, n, n) ``pupil`` with ``component_weights`` (C,) decomposes
    the summed operator sum_i q_i A_i^H A_i.

    The oracle runs in complex128 (A, its Gram and the eigendecomposition),
    where the JAX package, without fp64 on the TPU, ran a compensated
    complex64 Gram and a complex64 eigh; the kernels and eigenvalues are
    returned in complex64 and float32.
    """
    n = config.n
    pts = source_points(_host(source_map))
    pupil = to_tensor(pupil, device=device, dtype=torch.complex64)
    dev = pupil.device
    stack = (pupil if pupil.ndim == 3 else pupil[None]).to(torch.complex128)
    n_comp = stack.shape[0]
    comp_w = (np.ones(n_comp) if component_weights is None
              else np.asarray(component_weights, np.float64))
    if comp_w.shape != (n_comp,):
        raise ValueError(f"component_weights shape {comp_w.shape} != ({n_comp},)")

    support = passband_support(np.max(np.abs(_host(stack)), axis=0), pts.shifts)
    sup_idx = np.argwhere(support)  # (D, 2)
    d = len(sup_idx)
    p = n_comp * len(pts.shifts)
    if side == "auto":
        side = "source" if p < d else "frequency"

    # A[(i, s), d] = sqrt(q_i w_s) * C_i(k_d - s): gather with wraparound
    # (the integer sigma-grid shift of the Abbe roll), components stacked
    # row-wise.
    ky = torch.as_tensor((sup_idx[None, :, 0] - pts.shifts[:, None, 0]) % n, device=dev)
    kx = torch.as_tensor((sup_idx[None, :, 1] - pts.shifts[:, None, 1]) % n, device=dev)
    sqrt_ws = torch.sqrt(torch.as_tensor(pts.weights, dtype=torch.float64,
                                         device=dev))[:, None]
    a = torch.cat([stack[i][ky, kx] * (float(np.sqrt(comp_w[i])) * sqrt_ws)
                   for i in range(n_comp)])

    if side == "source":
        eigvals, u = _eigh_descending(_hermitian(a @ a.conj().T))  # (P, P)
        limit = min(p, d)
    else:
        eigvals, eigvecs = _eigh_descending(_hermitian(a.conj().T @ a))  # TCC
        limit = d

    if rank is None:
        keep = int((eigvals > energy_tol * max(float(eigvals[0]), 1e-30)).sum())
        keep = max(keep, 1)
    else:
        keep = min(rank, limit)

    if side == "source":
        # v_j = A^H u_j / sqrt(lambda_j), unit norm for nonzero eigenvalues;
        # dead eigenvalues get a zero kernel, as in randomized_socs.
        lam = eigvals[:keep]
        alive = lam > 1e-12 * max(float(eigvals[0]), 1e-30)
        scale = torch.where(alive, torch.rsqrt(torch.where(alive, lam, 1.0)), 0.0)
        eigvecs = (a.conj().T @ u[:, :keep]) * scale[None, :].to(a.dtype)

    # I(x) = c^H T c with c = M . f_x, so each rank-1 term is
    # lambda_j |F(conj(phi_j) * M)|^2: the kernel that multiplies the mask
    # spectrum is the CONJUGATE eigenvector.
    kernels = torch.zeros((keep, n, n), dtype=torch.complex64, device=dev)
    kernels[:, torch.as_tensor(sup_idx[:, 0], device=dev),
            torch.as_tensor(sup_idx[:, 1], device=dev)] = (
                eigvecs[:, :keep].conj().T.to(torch.complex64))
    return SOCSKernels(kernels=kernels,
                       eigenvalues=eigvals[:keep].clamp(min=0.0).float(),
                       total_rank=limit)


def socs_image(
    spectrum,
    socs: SOCSKernels,
    config: OpticsConfig,
    *,
    solver: str = "gau23",
    chunk: int = 4,
    engine: str = "auto",
) -> torch.Tensor:
    """Aerial image ``I = sum_j lambda_j |F(phi_j * M)|^2`` on the kernels'
    device, post-processed as the Abbe engine's image.

    ``engine``: ``fft``, ``matmul`` (zoom-DFT ``T X T^T``, TF32 off), or the
    int8 limb kernels (``int8``, ``int8_fast``); ``auto`` picks ``int8`` on
    CUDA and ``fft`` on the CPU. An explicit int8 engine raises unless
    ``solver='gau23'`` and ``fft_size >= n``; ``auto`` then takes
    ``matmul``."""
    if solver not in ("gau23", "direct"):
        raise ValueError(f"unknown socs solver {solver!r}")
    explicit_int8 = engine in ("int8", "int8_fast")
    kernels = socs.kernels
    device = kernels.device
    spectrum = to_tensor(spectrum, device=device, dtype=torch.complex64)
    engine = resolve_engine(engine, device=device)
    n = config.n
    fft_size = config.wavelength_scaling().fft_size
    if engine in ("int8", "int8_fast") and (solver != "gau23" or fft_size < n):
        if explicit_int8:
            raise ValueError(
                "engine='int8' needs solver='gau23' with fft_size >= n "
                f"(got solver={solver!r}, fft_size={fft_size}, n={n})")
        engine = "matmul"
    lams = socs.eigenvalues.to(device=device, dtype=torch.float32)
    if solver == "gau23" and engine in ("int8", "int8_fast"):
        # The SOCS kernels are centered, so there is no per-point window:
        # the "T0" of the limb kernels is the whole (n, n) chirp, quantized
        # once per call. Divergence from the JAX package, on purpose: there
        # the VMEM rules sent this call site through the split-K row kernel
        # at 1024^2 and through an f32 row transform with a halved batch at
        # 2048^2 (its abbe.py:279-321); here one K-looped row_limb_gemm
        # serves every width, so both sizes run the int8 row kernel
        # (ROADMAP.md Queue 3, R3).
        t_full = _zoom_dft_kernel(n, fft_size)
        t_limbs, t_scales = prepare_t0_limbs(
            torch.as_tensor(t_full.real, dtype=torch.float32, device=device),
            torch.as_tensor(t_full.imag, dtype=torch.float32, device=device))
        # each chunk's window is the whole kernel and spectrum: zero starts
        starts = torch.as_tensor(
            check_window_starts(np.zeros((chunk, 4), np.int32), n,
                                kernels.shape, spectrum.shape), device=device)
        spectrum = spectrum.contiguous()
    elif solver == "gau23" and engine == "matmul":
        t = torch.as_tensor(_zoom_dft_kernel(n, fft_size), dtype=spectrum.dtype,
                            device=device)

    acc = torch.zeros((n, n), dtype=torch.float32, device=device)
    for c in range(0, socs.rank, chunk):
        ls = lams[c:c + chunk]
        if solver == "gau23" and engine in ("int8", "int8_fast"):
            _intensity_windowed_int8(kernels[c:c + chunk], spectrum,
                                     starts[:len(ls)], n, t_limbs, t_scales,
                                     ls, fast=engine == "int8_fast", out=acc)
            continue
        prod = kernels[c:c + chunk] * spectrum
        if solver == "direct":
            fields = separable_dft(prod, config, sign=-1, dtype=spectrum.dtype)
        elif engine == "matmul":
            fields = t @ prod @ t.T
        else:
            fields = crop_center(centered_ifft2(pad_center(prod, fft_size)), n)
        acc += torch.sum(ls[:, None, None] * fields.abs() ** 2, dim=0)
    if solver == "gau23":
        acc = _postprocess_gau23(acc, config)
    return acc


# ---------------------------------------------------------------------------
# Matrix-free randomized SOCS
# ---------------------------------------------------------------------------
#
# Stack the shifted pupils into A[s, k] = sqrt(w_s) P(k - s). The TCC is
# T = A^H A, and the source-side Gram G = A A^H has the same nonzero
# spectrum and a circulant structure:
#
#     G[s, s'] = sqrt(w_s w_s') R(s' - s),   R(t) = sum_u P(u + t) conj(P(u))
#
# so G's matvec is sqrt(w) * conv_R(sqrt(w) * v): two n^2 FFTs, never a
# matrix. A randomized Hermitian eigensolver on G gives the top eigenpairs,
# and the kernels come back through one convolution each:
# phi_j = A^H u_j / sqrt(lambda_j). Everything wraps mod n like the Abbe
# engine's integer roll, so the circular FFT convolutions are exact.

# Whitening clip relative to the leading eigenvalue of the Gram (squared
# singular values): directions below sqrt(clip) of the leading one carry
# only fp32 rounding noise and are zeroed instead of renormalized.
_WHITEN_CLIP = 1e-12


def _cholesky_whiten_mat(gram: torch.Tensor) -> torch.Tensor:
    """Shifted-Cholesky whitening matrix L^-1 with gram + shift I = L L^H
    (Fukaya et al. 2020); the eps * trace shift keeps the factorization
    from breaking. Shared by the standard and lean builds."""
    gram = _hermitian(gram)
    shift = 1.2e-7 * torch.trace(gram).real
    eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    lc = torch.linalg.cholesky(gram + shift * eye)
    return torch.linalg.solve_triangular(lc, eye, upper=False)


def pupil_autocorrelation(pupil: torch.Tensor) -> torch.Tensor:
    """R(t) = sum_u P(u + t) conj(P(u)) with circular wraparound, via FFT."""
    f = torch.fft.fft2(pupil)
    return torch.fft.ifft2(f * f.conj())


def _gram_matvec(v, sqrt_w, r_fft):
    """G v for a block of source-grid vectors v: (..., n, n)."""
    return sqrt_w * torch.fft.ifft2(torch.fft.fft2(sqrt_w * v) * r_fft)


def _synthesize_kernels(u, sqrt_w, pupil_fft):
    """phi(k) = sum_s sqrt(w_s) u(s) conj(P(k - s)) for a block of source-
    space eigenvectors u: a circular correlation, via FFT.

    Source-space functions sit at grid index s + n//2 (array center = zero
    shift). The Gram matvec does not see that offset (G depends only on
    s - s'), but the synthesis does: the raw result comes out circularly
    shifted by n//2 on both axes, undone here."""
    n = u.shape[-1]
    x = sqrt_w * u
    # sum_s x(s) conj(P(k - s)) = conj( sum_s conj(x(s)) P(k - s) )
    conv = torch.fft.ifft2(torch.fft.fft2(x.conj()) * pupil_fft).conj()
    return torch.roll(conv, (n // 2, n // 2), dims=(-2, -1))


def _free_bytes(device) -> int:
    """Memory the build may still take on ``device``: on CUDA the free
    device memory (``cudaMemGetInfo``) plus what PyTorch's caching allocator holds unused; on the
    CPU the available physical memory."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def lean_auto(block_rows: int, n: int, *, device,
              hbm_budget: float | None = None) -> bool:
    """Auto policy for the lean in-place build: go lean only when the
    standard build's peak would not fit ``hbm_budget`` bytes. That peak is
    up to 4x the (block_rows, n, n) complex64 probe block: on an H100 at
    1024^2, rank 256 (a 2.28 GB block), the Rayleigh-Ritz build peaked at
    7.18 GB and the Nystrom build at 9.20 GB. The default budget is 90% of
    what :func:`_free_bytes` finds on ``device`` when the build starts; on
    an 80 GB H100 with nothing else resident (~71 GB), rank 256 stays on
    the standard build at 1024^2 (~9 GB) and at 2048^2 (~37 GB). The lean
    build serializes work the standard build batches, so it is never a free
    default."""
    if hbm_budget is None:
        hbm_budget = 0.9 * _free_bytes(device)
    return 4.0 * block_rows * n * n * 8 > hbm_budget


def _random_probe_block(generator: torch.Generator, rows: int, n: int, *,
                        device, row_chunk: int = 16) -> torch.Tensor:
    """(rows, n, n) complex64 probes, real and imaginary parts standard
    normal (as the JAX package's), drawn chunk-wise into the output buffer
    so the float32 temporaries stay at chunk size."""
    buf = torch.empty((rows, n, n), dtype=torch.complex64, device=device)
    for s in range(0, rows, row_chunk):
        k = min(row_chunk, rows - s)
        buf[s:s + k] = torch.view_as_complex(
            torch.randn((k, n, n, 2), generator=generator, device=device))
    return buf


def _warm_omega(init_basis, l: int, n: int, generator, device) -> torch.Tensor:
    """Probe block seeded from a previous build's Ritz basis (warm start):
    the converged subspace of a nearby operator (adjacent focal plane, or
    the same operator at a smaller rank) is a near-perfect starting range.
    Rows beyond the warm basis are topped up with fresh random probes."""
    init_basis = to_tensor(init_basis, device=device, dtype=torch.complex64)
    fresh = l - init_basis.shape[0]
    if fresh <= 0:
        return init_basis[:l]
    return torch.cat([init_basis,
                      _random_probe_block(generator, fresh, n, device=device)])


def _rows_apply(fn, block: torch.Tensor, chunk: int | None) -> torch.Tensor:
    """fn over leading-axis chunks of ``block`` into a new buffer (one
    chunk's temporaries live at a time); ``chunk=None`` is one call."""
    if chunk is None or chunk >= block.shape[0]:
        return fn(block)
    out = torch.empty_like(block)
    for s in range(0, block.shape[0], chunk):
        out[s:s + chunk] = fn(block[s:s + chunk])
    return out


def _randomized_range_eigh(matvec_all, omega: torch.Tensor, *, rank: int,
                           power_iters: int, compensated: bool, krylov: bool,
                           method: str = "rr"):
    """Shared core of the randomized builds: block subspace (or
    block-Krylov) iteration with CholQR2-style Gram whitening, then
    Rayleigh-Ritz (``method='rr'``) or the fixed-rank PSD Nystrom
    approximation (``method='nystrom'``). ``matvec_all`` applies the
    Hermitian PSD operator to an (L, n, n) block out of place.

    Returns ``(eigvals, u)``: the Ritz eigenvalues of the full basis,
    descending and clipped at 0, and the top-``rank`` Ritz vectors
    ``u = top^T q`` as a (rank, n, n) block (not conjugated: callers own
    the operator's conjugation convention)."""
    if method not in ("rr", "nystrom"):
        raise ValueError(f"unknown randomized-eigh method {method!r} "
                         "(expected 'rr' or 'nystrom')")
    n = omega.shape[-1]

    def wide_rowdot(x, y, conj_a=False, conj_b=False):
        # op(x) @ op(y).T, contracting the n^2 axis of two (L, n^2) stacks
        if compensated:
            return rowdot_compensated(x, y, conj_a=conj_a, conj_b=conj_b)
        x = x.conj() if conj_a else x
        y = y.conj() if conj_b else y
        return x @ y.T

    def whiten_once_eigh(f):
        # eigh-clip whitening: handles arbitrary rank deficiency (the
        # Krylov sandwich feeds nearly dead projected residuals through it)
        s, v = torch.linalg.eigh(_hermitian(wide_rowdot(f, f, conj_b=True)))
        inv_sqrt = torch.where(s > _WHITEN_CLIP * s.max(),
                               torch.rsqrt(s.abs()), 0.0)
        return ((v * inv_sqrt[None, :].to(v.dtype)) @ v.conj().T) @ f

    def whiten_once_chol(f):
        return _cholesky_whiten_mat(wide_rowdot(f, f, conj_b=True)) @ f

    def orthonormalize(block):
        # Gram whitening twice (CholQR2): one pass squares the condition
        # number in fp32, the second restores orthogonality to ~eps.
        whiten_once = whiten_once_eigh if krylov else whiten_once_chol
        flat = block.reshape(block.shape[0], -1)
        return whiten_once(whiten_once(flat)).reshape(block.shape)

    def project_out(block, basis_blocks):
        # block Gram-Schmidt against every earlier Krylov block
        flat = block.reshape(block.shape[0], -1)
        for qb in basis_blocks:
            qf = qb.reshape(qb.shape[0], -1)
            flat = flat - wide_rowdot(qf, flat, conj_a=True).T @ qf
        return flat.reshape(block.shape)

    if method == "nystrom":
        # Fixed-rank PSD Nystrom (Tropp et al. 2017, shifted for Cholesky
        # stability): basis B from `power_iters` whitened subspace
        # iterations, one further Y = G B, and G ~ Y_nu S_nu^-1 Y_nu^H with
        # S_nu = B^H Y + nu I: one block matvec fewer than Rayleigh-Ritz.
        # The factor F = Y_nu L^-H is never formed; its Gram is
        # L^-1 (Y_nu^H Y_nu) L^-H.
        if krylov:
            raise ValueError("method='nystrom' is incompatible with "
                             "krylov=True (use the RR core)")
        b = orthonormalize(omega)
        del omega
        for _ in range(power_iters):
            b = orthonormalize(matvec_all(b))
        lq = b.shape[0]
        bf = b.reshape(lq, -1)
        yf = matvec_all(b).reshape(lq, -1)
        small = _hermitian(wide_rowdot(bf, yf, conj_a=True))  # B^H Y
        nu = 1.2e-7 * torch.trace(small).real
        y_nu = yf + nu.to(yf.dtype) * bf
        del b, bf, yf
        eye = torch.eye(lq, dtype=small.dtype, device=small.device)
        lc = torch.linalg.cholesky(small + nu.to(small.dtype) * eye)
        linv = torch.linalg.solve_triangular(lc, eye, upper=False)
        gy = _hermitian(wide_rowdot(y_nu, y_nu, conj_a=True))  # Y_nu^H Y_nu
        sig2, v = _eigh_descending(_hermitian(linv @ gy @ linv.conj().T))
        eigvals = (sig2 - nu).clamp(min=0.0)
        # eigvecs of G: U = Y_nu (L^-H V Sigma^-1); collapsed singular
        # values get zero vectors, as the whitening clip does
        inv_sig = torch.where(
            sig2 > _WHITEN_CLIP * sig2[0].clamp(min=1e-30),
            torch.rsqrt(sig2.clamp(min=0.0)), 0.0)
        c = linv.conj().T @ (v[:, :rank] * inv_sig[None, :rank].to(v.dtype))
        return eigvals, (c.T @ y_nu).reshape(rank, n, n)

    if krylov:
        # Block-Krylov Rayleigh-Ritz over all iterates [Q_0, G Q_0, ...]
        # (Musco & Musco 2015), orthogonalized by the project -> whiten ->
        # project -> whiten sandwich.
        blocks = [orthonormalize(omega)]
        del omega
        for _ in range(power_iters):
            y = matvec_all(blocks[-1])
            # Noise-floor guard: a projected residual direction below ~1e-5
            # of the block's strongest (pre-projection) direction is fp32
            # noise; zero it rather than whiten it into a basis vector.
            y_energy = y.reshape(y.shape[0], -1).abs().square().sum(dim=1)
            r = project_out(y, blocks)
            energy = r.reshape(r.shape[0], -1).abs().square().sum(dim=1)
            keep = energy > 1e-10 * y_energy.max().clamp(min=1e-30)
            r = r * keep[:, None, None].to(r.dtype)
            y = orthonormalize(r)
            blocks.append(orthonormalize(project_out(y, blocks)))
        q = orthonormalize(torch.cat(blocks))
        del blocks
    else:
        y = matvec_all(omega)
        del omega
        for _ in range(power_iters):
            y = matvec_all(orthonormalize(y))
        q = orthonormalize(y)  # (L, n, n) orthonormal basis of the range
        del y

    lq = q.shape[0]  # L, or L * (power_iters + 1) on the Krylov path
    qf = q.reshape(lq, -1)
    small = _hermitian(wide_rowdot(qf, matvec_all(q).reshape(lq, -1),
                                   conj_a=True))
    eigvals, eigvecs = _eigh_descending(small)
    return eigvals.clamp(min=0.0), (eigvecs[:, :rank].T @ qf).reshape(rank, n, n)


def _kernel_scale(top_vals: torch.Tensor, lead: torch.Tensor) -> torch.Tensor:
    """1/sqrt(lambda) per kept eigenvalue; zero (or numerically dead)
    eigenvalues get a zero kernel, not a 1/sqrt(0) blow-up."""
    alive = top_vals > 1e-12 * lead.clamp(min=1e-30)
    return torch.where(alive, torch.rsqrt(torch.where(alive, top_vals, 1.0)),
                       0.0).to(torch.complex64)


def randomized_socs(
    pupil,
    source_map,
    config: OpticsConfig,
    *,
    rank: int | str = 64,
    oversample: int = 16,
    power_iters: int = 2,
    seed: int = 0,
    probe_chunk: int | None | str = "auto",
    compensated: bool = True,
    krylov: bool = False,
    lean: bool | str = "auto",
    init_basis=None,
    return_basis: bool = False,
    method: str = "rr",
    tolerance: float | None = None,
    spectrum=None,
    device=None,
) -> SOCSKernels:
    """Top-``rank`` SOCS kernels via matrix-free randomized
    eigendecomposition of the source-side Gram operator, on the pupil's
    device (``device`` places host data).

    ``method='nystrom'`` uses the fixed-rank PSD Nystrom core: one block
    matvec fewer per build. ``compensated=True`` accumulates the n^2-wide
    Gram and Rayleigh-Ritz contractions in float64
    (:mod:`.compensated`). ``krylov=True`` does Rayleigh-Ritz on the whole
    block-Krylov subspace. ``probe_chunk`` bounds the FFT temporaries of
    the block matvecs and the kernel synthesis at (chunk, n, n); ``"auto"``
    is 16 rows.

    ``lean`` routes to the single-buffer in-place build
    (:func:`_randomized_socs_lean`); ``"auto"`` takes it only where
    :func:`lean_auto` says the standard build would not fit the device.

    ``init_basis`` warm-starts the iteration from a previous build's Ritz
    basis (``return_basis=True`` makes this return ``(socs, basis)``).
    ``rank='auto'`` (or a ``tolerance``) delegates to
    :func:`auto_rank_socs`."""
    if rank == "auto" or tolerance is not None:
        if init_basis is not None or return_basis:
            raise ValueError("rank='auto' does not compose with warm-start "
                             "bases; call auto_rank_socs directly")
        return auto_rank_socs(
            pupil, source_map, config, tolerance=tolerance, spectrum=spectrum,
            oversample=oversample, power_iters=power_iters, seed=seed,
            probe_chunk=probe_chunk, compensated=compensated, krylov=krylov,
            lean=lean, method=method, device=device)
    rank = int(rank)
    n = config.n
    pupil = to_tensor(pupil, device=device, dtype=torch.complex64)
    dev = pupil.device
    w = to_tensor(source_map, device=dev, dtype=torch.float32)
    live = int((w > 0).sum())
    if live == 0:
        # a dark source: the TCC is zero, and so is every kernel (the
        # whitening's Cholesky has nothing to factor)
        zeros = torch.zeros((rank, n, n), dtype=torch.complex64, device=dev)
        socs = SOCSKernels(kernels=zeros,
                           eigenvalues=torch.zeros(rank, device=dev), total_rank=0)
        return (socs, zeros) if return_basis else socs
    if lean == "auto":
        lean = (not krylov and init_basis is None and not return_basis
                and method == "rr"
                and lean_auto(rank + oversample, n, device=dev))
    if lean:
        if krylov:
            raise ValueError("krylov=True has no lean-memory variant")
        if method != "rr":
            raise ValueError(f"method={method!r} has no lean-memory variant")
        if init_basis is not None or return_basis:
            raise ValueError("warm-start basis is not supported by the "
                             "lean build (pass lean=False)")
        return _randomized_socs_lean(
            pupil, w, config, rank=rank, oversample=oversample,
            power_iters=power_iters, seed=seed, compensated=compensated,
            live=live)
    if probe_chunk == "auto":
        probe_chunk = 16
    sqrt_w = torch.sqrt(w).to(torch.complex64)
    pupil_fft = torch.fft.fft2(pupil)
    r_fft = pupil_fft * pupil_fft.conj()  # FFT of the autocorrelation

    l = rank + oversample
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    # The probe block is passed without a name here, so the core can free
    # it once it is consumed. A warm basis is a Ritz basis of THIS operator
    # (conj(G), see below): it goes in un-conjugated.
    eigvals, u = _randomized_range_eigh(
        lambda b: _rows_apply(lambda c: _gram_matvec(c, sqrt_w, r_fft), b,
                              probe_chunk),
        _random_probe_block(generator, l, n, device=dev) if init_basis is None
        else _warm_omega(init_basis, l, n, generator, dev),
        rank=rank, power_iters=power_iters, compensated=compensated,
        krylov=krylov, method=method)
    # _gram_matvec convolves with R(s - s') where G's entry is
    # conj(R(s - s')) = R(s' - s): it applies conj(G), whose eigenvectors
    # are the conjugates of G's. Conjugate before synthesis, and store
    # conj(phi_j) = conj(A^H u_j) / sqrt(lambda_j): the kernel that
    # multiplies the mask spectrum (see tcc_eigensystem).
    scale = _kernel_scale(eigvals[:rank], eigvals[0])
    kernels = torch.empty_like(u)
    step = probe_chunk or rank
    for s in range(0, rank, step):
        kernels[s:s + step] = _synthesize_kernels(
            u[s:s + step].conj(), sqrt_w, pupil_fft).conj() * scale[s:s + step, None, None]
    socs = SOCSKernels(kernels=kernels, eigenvalues=eigvals[:rank].float(),
                       total_rank=live)
    return (socs, u) if return_basis else socs


# ---------------------------------------------------------------------------
# Lean build: one probe buffer, updated in place
# ---------------------------------------------------------------------------
#
# The JAX package's lean build carries a pair of buffers [qm; qo] (rank and
# oversample rows) through fori_loops so that XLA aliases them. Here the
# pair is ONE (rank + oversample, n, n) buffer and qm, qo are its two views;
# every step writes into it in place, chunk by chunk, so the peak is ~1x
# the probe block plus (chunk, n, n) or (L, chunk, n) temporaries. The math
# is that of randomized_socs (same matvec, double Cholesky whitening,
# Rayleigh-Ritz, synthesis); only the buffer lifetimes differ.


def _rows_inplace(fn, buf: torch.Tensor, chunk: int) -> torch.Tensor:
    """buf[c] = fn(buf[c]) over leading-axis chunks, in place. fn must be
    row-local."""
    for s in range(0, buf.shape[0], chunk):
        buf[s:s + chunk] = fn(buf[s:s + chunk])
    return buf


def _pair_gram(buf: torch.Tensor, compensated: bool) -> torch.Tensor:
    """(L, L) Gram of the stacked buffer [qm; qo], contracting the image
    axes in image-row chunks (no reshape of the buffer)."""
    if compensated:
        return rowdot3_compensated(buf, buf, conj_b=True)
    flat = buf.reshape(buf.shape[0], -1)
    return flat @ flat.conj().T


def _pair_left_apply(mat: torch.Tensor, buf: torch.Tensor,
                     img_row_chunk: int, rows: int | None = None) -> torch.Tensor:
    """buf[:rows] <- (mat @ buf) along the stack axis, in place, chunked
    over image rows (each chunk of every row is read before it is
    written). ``mat`` is (rows, L); ``rows`` defaults to L."""
    rows = buf.shape[0] if rows is None else rows
    for s in range(0, buf.shape[1], img_row_chunk):
        chunk = buf[:, s:s + img_row_chunk]
        buf[:rows, s:s + img_row_chunk] = torch.tensordot(mat, chunk, dims=1)
    return buf


def _randomized_socs_lean(
    pupil: torch.Tensor,
    w: torch.Tensor,
    config: OpticsConfig,
    *,
    rank: int,
    oversample: int,
    power_iters: int,
    seed: int,
    compensated: bool,
    live: int,
    row_chunk: int = 16,
    img_row_chunk: int = 128,
) -> SOCSKernels:
    """Single-buffer variant of :func:`randomized_socs` (same algorithm,
    in-place buffer discipline; see the section comment above).
    ``row_chunk`` (probe rows per in-place matvec, Rayleigh-Ritz and
    synthesis step) and ``img_row_chunk`` (image rows per in-place matrix
    apply) set the temporaries, (chunk, n, n) and (L, chunk, n) complex.
    An eager FFT matvec keeps about six (row_chunk, n, n) temporaries
    alive, so row_chunk is the standard build's 16, not the JAX package's
    32: on an H100 at 1024^2 that took the lean peak from 2.44 to 1.64 GB
    at rank 64 (standard build 2.31 GB) and from 4.05 to 3.25 GB at rank
    256 (standard 7.14 GB), for 7-17% more build time."""
    n = config.n
    dev = pupil.device
    sqrt_w = torch.sqrt(w).to(torch.complex64)
    pupil_fft = torch.fft.fft2(pupil)
    r_fft = pupil_fft * pupil_fft.conj()
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    buf = _random_probe_block(generator, rank + oversample, n, device=dev)

    def mv(c):
        return _gram_matvec(c, sqrt_w, r_fft)

    def orthonormalize():
        for _ in range(2):  # CholQR2, as the standard build
            _pair_left_apply(_cholesky_whiten_mat(_pair_gram(buf, compensated)),
                             buf, img_row_chunk)

    _rows_inplace(mv, buf, row_chunk)
    for _ in range(power_iters):
        orthonormalize()
        _rows_inplace(mv, buf, row_chunk)
    orthonormalize()

    # Rayleigh-Ritz matrix without materializing G Q: per row chunk c,
    # small[:, c] = Q^H (G q_c).
    cols = []
    for s in range(0, buf.shape[0], row_chunk):
        gq = mv(buf[s:s + row_chunk])
        cols.append(rowdot3_compensated(buf, gq, conj_a=True) if compensated
                    else buf.reshape(buf.shape[0], -1).conj()
                    @ gq.reshape(gq.shape[0], -1).T)
    eigvals, eigvecs = _eigh_descending(_hermitian(torch.cat(cols, dim=1)))
    eigvals = eigvals.clamp(min=0.0)

    # u = top^T Q written into qm (the first `rank` rows), then synthesis,
    # conjugation and 1/sqrt(lambda) scaling in place: the kernels ARE qm.
    _pair_left_apply(eigvecs[:, :rank].T, buf, img_row_chunk, rows=rank)
    kernels = buf[:rank]
    scale = _kernel_scale(eigvals[:rank], eigvals[0])
    for s in range(0, rank, row_chunk):
        ker = _synthesize_kernels(kernels[s:s + row_chunk].conj(), sqrt_w,
                                  pupil_fft).conj()
        kernels[s:s + row_chunk] = ker * scale[s:s + row_chunk, None, None]
    return SOCSKernels(kernels=kernels, eigenvalues=eigvals[:rank].float(),
                       total_rank=live)


# ---------------------------------------------------------------------------
# Accounting: trace, captured energy, the image-error bound, auto rank
# ---------------------------------------------------------------------------

def _field_power(field) -> float:
    """sum |field|^2 of a tensor (on its device) or host array, accumulated
    in float64."""
    if isinstance(field, torch.Tensor):
        return float(field.abs().square().sum(dtype=torch.float64))
    return float(np.sum(np.abs(np.asarray(field, np.complex128)) ** 2))


def _device_of(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("pass the pupil or the spectrum as a tensor: it fixes "
                     "the device of the computation")


def tcc_total_trace(pupil, source_map) -> float:
    """Exact trace of the scalar TCC without a decomposition:
    trace(G) = sum_s w_s * R(0), R(0) = sum |P|^2, in the units of
    ``SOCSKernels.eigenvalues``. (The vector trace is Queue 1 item 9.)"""
    return float(np.sum(_host(source_map), dtype=np.float64)) * _field_power(pupil)


def socs_energy_captured(socs: SOCSKernels, pupil, source_map) -> float:
    """Fraction of the TCC's trace captured by the kept kernels; values
    near 1 mean the truncation is faithful."""
    trace = tcc_total_trace(pupil, source_map)
    if trace <= 0:
        return 1.0
    return float(socs.eigenvalues.sum(dtype=torch.float64)) / trace


def _tcc_diag_weighted_m2(pupil, source_map, spec) -> float:
    """sum_k |M(k)|^2 * diag_TCC(k), diag_TCC(k) = sum_s w_s |P(k - s)|^2
    by one circular convolution (the Abbe roll convention; the ifftshift
    aligns the source's zero shift, as tests/test_socs_bound.py pins). The
    raw-grid mean of the exact image in eigenvalue units, in float64."""
    dev = _device_of(pupil, spec)
    pupil = to_tensor(pupil, device=dev)
    src = to_tensor(source_map, device=dev, dtype=torch.float64)
    spec = to_tensor(spec, device=dev)
    p2 = pupil.abs().double().square()
    diag = torch.fft.ifft2(torch.fft.fft2(torch.fft.ifftshift(src))
                           * torch.fft.fft2(p2)).real
    return float((spec.abs().double().square() * diag).sum())


def _kept_tail_mean(kernels: torch.Tensor, eigenvalues: torch.Tensor, spec,
                    chunk: int = 16) -> float:
    """sum_j lambda_j ||phi_j * M||^2: the raw-grid mean of the SOCS image
    in eigenvalue units, one (chunk, n, n) product at a time."""
    spec = to_tensor(spec, device=kernels.device)
    lam = eigenvalues.to(device=kernels.device, dtype=torch.float64)
    total = torch.zeros((), dtype=torch.float64, device=kernels.device)
    for s in range(0, kernels.shape[0], chunk):
        norms = (kernels[s:s + chunk] * spec).abs().square().sum(
            dim=(-2, -1), dtype=torch.float64)
        total += (lam[s:s + chunk] * norms).sum()
    return float(total)


def socs_image_nrms_bound(socs: SOCSKernels, spectrum, image, *,
                          trace: float | None = None, pupil=None,
                          source_map=None, config: OpticsConfig | None = None,
                          total_weight: float | None = None) -> float:
    """A-priori bound on the truncation error's normalized RMS,
    nRMS = RMS(I_exact - I_socs) / max(I_exact), from the dropped eigenvalue
    tail alone (no exact Abbe run).

    For exact eigenkernels the pointwise deficit is
    Delta I(x) = sum_dropped lambda_j |F(phi_j M)(x)|^2, and by Cauchy-
    Schwarz with completeness, Delta I <= min(dropped_trace, lambda_min_kept)
    * sum|M|^2. The Gau'23 post-process is a convex average, and
    Delta I >= 0 gives max(I_exact) >= max(I_socs), hence

        nRMS <= min(dropped_trace, lambda_min_kept) * sum|M|^2 / max(I_socs).

    ``image`` is the SOCS image the bound certifies; if it was normalized
    by the source-weight sum, pass that ``total_weight``. Give ``trace``,
    or ``pupil`` and ``source_map`` to compute it.

    With ``pupil``, ``source_map`` and ``config``, the exact tail mean
    refines it: mean(Delta I) on the raw grid is
    :func:`_tcc_diag_weighted_m2` minus :func:`_kept_tail_mean` (floored at
    1e-6 of the former, the float rounding floor), and with
    0 <= Delta I <= S, RMS <= 2 sqrt(S mean(Delta I)), the 2 from a
    post-process that reuses a raw pixel at most 4 times. Divergence from
    the JAX package, on purpose (ROADMAP.md Queue 3, R1): the image is the
    central n x n crop of the fft_size grid, which can concentrate the tail
    by up to (fft_size/n)^2, so the factor 4 covers only fft_size <= 2n;
    elsewhere this reports the sup bound above, where the JAX package
    under-reports (e.g. 2.7e-2 against 6.1e-2 measured at pixel_number=64,
    pixel_size=2.5, rank 2).

    For randomized builds the kept pairs are Ritz approximations (the Ritz
    values under-estimate the true ones), so the bound holds in practice,
    not as a theorem (R2). It covers SOCS truncation only, not the int8
    apply's ~1e-7 limb quantization."""
    if trace is None:
        if pupil is None or source_map is None:
            raise ValueError("socs_image_nrms_bound needs trace= or "
                             "pupil=/source_map= to compute it")
        trace = tcc_total_trace(pupil, source_map)
    refine = pupil is not None and source_map is not None
    if refine and config is None:
        raise ValueError("the tail-mean refinement (pupil=/source_map=) "
                         "needs config= for its fft_size <= 2n condition")
    eig = socs.eigenvalues
    kept = float(eig.sum(dtype=torch.float64))
    dropped = max(trace - kept, 0.0)
    lam_min = float(eig.min())
    sup_scale = min(dropped, lam_min) if lam_min > 0 else dropped
    m2 = _field_power(spectrum)
    peak = float(image.max())
    if total_weight is not None:
        peak *= float(total_weight)
    if peak <= 0:
        return 0.0 if sup_scale * m2 == 0 else float("inf")
    bound = sup_scale * m2 / peak
    n = socs.kernels.shape[-1]
    if refine and config.wavelength_scaling().fft_size <= 2 * n:
        a_all = _tcc_diag_weighted_m2(pupil, source_map, spectrum)
        a_kept = _kept_tail_mean(socs.kernels, eig, spectrum)
        tail_mean = max(a_all - a_kept, 1e-6 * abs(a_all))
        bound = min(bound, 2.0 * math.sqrt(sup_scale * m2 * tail_mean) / peak)
    return bound


def auto_rank_socs(
    pupil,
    source_map,
    config: OpticsConfig,
    *,
    energy_target: float = 0.999,
    start_rank: int = 32,
    max_rank: int = 512,
    tolerance: float | None = None,
    spectrum=None,
    image_chunk: int = 4,
    device=None,
    **kwargs,
) -> SOCSKernels:
    """SOCS kernels at the smallest power-of-two-stepped rank whose captured
    energy fraction meets ``energy_target`` (one :func:`randomized_socs`
    build per step). ``tolerance`` stops instead once
    :func:`socs_image_nrms_bound` <= tolerance for the mask whose
    ``spectrum`` is given (each step then pays one :func:`socs_image`
    apply). At ``max_rank`` the best effort is returned."""
    if tolerance is not None and spectrum is None:
        raise ValueError("tolerance= needs spectrum= (the image-error bound "
                         "is mask-dependent); pass mask_spectrum(geometry, "
                         "config)")
    pupil = to_tensor(pupil, device=device, dtype=torch.complex64)
    trace = tcc_total_trace(pupil, source_map)

    def converged(socs) -> bool:
        if tolerance is None:
            kept = float(socs.eigenvalues.sum(dtype=torch.float64))
            return trace <= 0 or kept / trace >= energy_target
        image = socs_image(spectrum, socs, config, chunk=image_chunk)
        return socs_image_nrms_bound(
            socs, spectrum, image, trace=trace, pupil=pupil,
            source_map=source_map, config=config) <= tolerance

    rank = start_rank
    socs = randomized_socs(pupil, source_map, config, rank=rank, **kwargs)
    while not converged(socs) and rank < max_rank:
        rank = min(rank * 2, max_rank)
        socs = randomized_socs(pupil, source_map, config, rank=rank, **kwargs)
    return socs
