"""Mesh-sharded randomized SOCS kernel builds.

Port of ``lithographysimulator_tpu/parallel/socs_build_sharded.py``: the
builds of :func:`..ops.hopkins.randomized_socs` and
:func:`..ops.hopkins.randomized_socs_components` with their (L, n, n) probe
block (L = rank + oversample) split over the entries of one mesh axis.

The build alternates between two kinds of work with different natural
splits of the block:

* the FFT stages (the Gram-operator matvecs, the kernel synthesis) are
  independent a probe row: **row shards**, each entry convolving its
  L/D rows on its device;
* the Gram and whitening contractions sum over the n^2 image axis:
  **column shards** of the image's last axis, each entry contracting its
  n/D columns; the (L, L) partials meet in one sum on the mesh's first
  device, where the small factorizations run, and the (L, L) mixes of the
  block stay local to each shard.

The layout changes are device copies (the JAX package's all-to-alls):
row shard r's columns c go to column shard c's device. With
``compensated=True`` each column shard accumulates its partial in
complex128 (chunk by chunk, as :mod:`..ops.compensated`) and the partials
are summed in complex128 before the one rounding to complex64.

The probes are drawn once on the first device from the same
``torch.Generator`` as the local build, then split: at equal ``seed`` the
sharded build is the local build up to summation order (eigenvalues to
``rtol=1e-4``, images to 1e-5 normalized RMS, as the JAX package pins its
own pair). The Krylov and lean variants stay local-only, as in the JAX
package: the lean build exists for one device's memory, which the split
itself relieves.
"""

from __future__ import annotations

import torch

from .._tensors import to_tensor
from ..config import OpticsConfig
from ..ops.compensated import CHUNK_ELEMS, _chunk_dot, _wide
from ..ops.hopkins import (
    SOCSKernels,
    _WHITEN_CLIP,
    _cholesky_whiten_mat,
    _eigh_descending,
    _gram_matvec,
    _hermitian,
    _kernel_scale,
    _random_probe_block,
    _rows_apply,
    _synthesize_kernels,
    _warm_omega,
    apply_channel_rotation,
    compress_components,
    principal_channel_rotation,
)
from .mesh import SOURCE_AXIS, Mesh

#: probe rows a matvec or synthesis call transforms at once, as the local
#: build's ``probe_chunk="auto"``
PROBE_CHUNK = 16


def _build_axis(mesh: Mesh, axis: str | None) -> str:
    if axis is not None:
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh axes {mesh.axis_names}")
        return axis
    return SOURCE_AXIS if SOURCE_AXIS in mesh.axis_names else mesh.axis_names[0]


def _bounds(total: int, parts: int) -> list:
    """``parts`` contiguous (start, stop) blocks of ``range(total)``, sizes
    differing by at most one (L and n need not divide over the mesh)."""
    return [(k * total // parts, (k + 1) * total // parts) for k in range(parts)]


class _Blocks:
    """The two layouts of (rows, n, n) blocks over ``devices``: a block is
    a list with one shard a device, rows (``[r0:r1]``, full images) or
    columns (``[..., c0:c1]`` of every row)."""

    def __init__(self, devices: list, first: torch.device, n: int):
        self.devices = devices
        self.first = first
        self.cols = _bounds(n, len(devices))

    def split_rows(self, full: torch.Tensor) -> list:
        return [full[r0:r1].to(dev) for dev, (r0, r1)
                in zip(self.devices, _bounds(full.shape[0], len(self.devices)))]

    def split_cols(self, full: torch.Tensor) -> list:
        return [full[..., c0:c1].to(dev)
                for dev, (c0, c1) in zip(self.devices, self.cols)]

    def to_cols(self, rows: list) -> list:
        return [torch.cat([r[..., c0:c1].to(dev) for r in rows])
                for dev, (c0, c1) in zip(self.devices, self.cols)]

    def to_rows(self, cols: list) -> list:
        bounds = _bounds(cols[0].shape[0], len(self.devices))
        return [torch.cat([c[r0:r1].to(dev) for c in cols], dim=-1)
                for dev, (r0, r1) in zip(self.devices, bounds)]

    def gather_rows(self, rows: list) -> torch.Tensor:
        return torch.cat([r.to(self.first) for r in rows])

    def gram(self, a: list, b: list, *, compensated: bool, conj_a=False,
             conj_b=False) -> torch.Tensor:
        """``op(A) . op(B)`` over the image axes of two column-sharded
        blocks: the (M, N) partials of the shards, summed on the first
        device (in complex128 when ``compensated``)."""
        total = None
        for x, y in zip(a, b):
            if compensated:
                part = _wide_rowdot3(x, y, conj_a, conj_b)
            else:
                xf = x.reshape(x.shape[0], -1)
                yf = y.reshape(y.shape[0], -1)
                part = (xf.conj() if conj_a else xf) @ (yf.conj() if conj_b else yf).T
            part = part.to(self.first)
            total = part if total is None else total + part
        return total.to(torch.promote_types(a[0].dtype, b[0].dtype))

    def mix(self, m: torch.Tensor, cols: list) -> list:
        """``m @ block`` for an (out, in) matrix and a column-sharded
        (in, n, c) block, each shard on its own device."""
        return [(m.to(c.device) @ c.reshape(c.shape[0], -1)).reshape(
            m.shape[0], *c.shape[1:]) for c in cols]


def _wide_rowdot3(a: torch.Tensor, b: torch.Tensor, conj_a: bool,
                  conj_b: bool) -> torch.Tensor:
    """:func:`..ops.compensated.rowdot3_compensated` of a column shard,
    left in its wide accumulator (the shards' sum rounds once)."""
    rc = max(1, CHUNK_ELEMS // max(a.shape[-1], 1))
    wide = _wide(torch.promote_types(a.dtype, b.dtype))
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=wide, device=a.device)
    for s in range(0, a.shape[1], rc):
        acc += _chunk_dot(a[:, s:s + rc], b[:, s:s + rc], conj_a, conj_b, wide)
    return acc


def _range_eigh_sharded(blocks: _Blocks, matvec_rows, omega: torch.Tensor, *,
                        rank: int, power_iters: int, compensated: bool,
                        method: str = "rr"):
    """Sharded twin of :func:`..ops.hopkins._randomized_range_eigh` (the
    subspace-iteration path): CholQR2 Gram whitening, then Rayleigh-Ritz
    (``'rr'``) or the fixed-rank PSD Nystrom core (``'nystrom'``).
    ``matvec_rows`` applies the operator to a row-sharded block. Returns
    ``(eigvals, u)`` as the local twin, ``u`` row-sharded."""
    if method not in ("rr", "nystrom"):
        raise ValueError(f"unknown randomized-eigh method {method!r} "
                         "(expected 'rr' or 'nystrom')")

    def gram(a, b, **kw):
        return blocks.gram(a, b, compensated=compensated, **kw)

    def orthonormalize(cols):
        for _ in range(2):  # CholQR2, as the local twin
            cols = blocks.mix(_cholesky_whiten_mat(gram(cols, cols, conj_b=True)),
                              cols)
        return cols

    def matvec_cols(cols):
        return blocks.to_cols(matvec_rows(blocks.to_rows(cols)))

    if method == "nystrom":
        # the local Nystrom core: basis B, one further Y = G B, and
        # G ~ Y_nu S_nu^-1 Y_nu^H with S_nu = B^H Y + nu I
        b = orthonormalize(blocks.split_cols(omega))
        del omega
        for _ in range(power_iters):
            b = orthonormalize(matvec_cols(b))
        lq = b[0].shape[0]
        y = matvec_cols(b)
        small = _hermitian(gram(b, y, conj_a=True))  # B^H Y
        nu = 1.2e-7 * torch.trace(small).real
        y_nu = [yc + nu.to(yc.device, yc.dtype) * bc for yc, bc in zip(y, b)]
        del b, y
        eye = torch.eye(lq, dtype=small.dtype, device=small.device)
        lc = torch.linalg.cholesky(small + nu.to(small.dtype) * eye)
        linv = torch.linalg.solve_triangular(lc, eye, upper=False)
        gy = _hermitian(gram(y_nu, y_nu, conj_a=True))  # Y_nu^H Y_nu
        sig2, v = _eigh_descending(_hermitian(linv @ gy @ linv.conj().T))
        eigvals = (sig2 - nu).clamp(min=0.0)
        inv_sig = torch.where(
            sig2 > _WHITEN_CLIP * sig2[0].clamp(min=1e-30),
            torch.rsqrt(sig2.clamp(min=0.0)), 0.0)
        c = linv.conj().T @ (v[:, :rank] * inv_sig[None, :rank].to(v.dtype))
        return eigvals, blocks.to_rows(blocks.mix(c.T, y_nu))

    y = matvec_rows(blocks.split_rows(omega))
    del omega
    for _ in range(power_iters):
        y = matvec_rows(blocks.to_rows(orthonormalize(blocks.to_cols(y))))
    q = orthonormalize(blocks.to_cols(y))  # column-sharded orthonormal basis
    del y
    small = _hermitian(gram(q, matvec_cols(q), conj_a=True))  # (L, L)
    eigvals, eigvecs = _eigh_descending(small)
    u = blocks.mix(eigvecs[:, :rank].T, q)
    return eigvals.clamp(min=0.0), blocks.to_rows(u)


def _dark(rank: int, n: int, device, return_basis: bool):
    """A dark source: the TCC is zero, and so is every kernel (as the
    local builds)."""
    zeros = torch.zeros((rank, n, n), dtype=torch.complex64, device=device)
    socs = SOCSKernels(kernels=zeros,
                       eigenvalues=torch.zeros(rank, device=device), total_rank=0)
    return (socs, zeros) if return_basis else socs


def _omega(generator, init_basis, l: int, n: int, device) -> torch.Tensor:
    """The local builds' probe block, on ``device``."""
    if init_basis is None:
        return _random_probe_block(generator, l, n, device=device)
    return _warm_omega(init_basis, l, n, generator, device)


def randomized_socs_sharded(
    pupil,
    source_map,
    config: OpticsConfig,
    mesh: Mesh,
    *,
    rank: int = 64,
    oversample: int = 16,
    power_iters: int = 2,
    seed: int = 0,
    compensated: bool = True,
    axis: str | None = None,
    init_basis=None,
    return_basis: bool = False,
    method: str = "rr",
) -> SOCSKernels:
    """Mesh-sharded :func:`..ops.hopkins.randomized_socs` (the scalar
    source-side build): FFT matvecs split over probe rows, the whitening
    and Rayleigh-Ritz contractions over image columns, on the entries of
    ``axis`` (default the mesh's 'source' axis). The kernels (and with
    ``return_basis`` the Ritz basis, interchangeable with the local
    build's) are gathered on the mesh's first device; a host pupil goes
    there first."""
    devices = mesh.axis_devices(_build_axis(mesh, axis))
    first = mesh.first
    n = config.n
    pupil = to_tensor(pupil, device=first, dtype=torch.complex64)
    w = to_tensor(source_map, device=first, dtype=torch.float32)
    live = int((w > 0).sum())
    if live == 0:
        return _dark(rank, n, first, return_basis)
    sqrt_w = torch.sqrt(w).to(torch.complex64)
    pupil_fft = torch.fft.fft2(pupil)
    r_fft = pupil_fft * pupil_fft.conj()
    on = {dev: (sqrt_w.to(dev), r_fft.to(dev), pupil_fft.to(dev))
          for dev in devices}
    blocks = _Blocks(devices, first, n)

    def matvec_rows(rows):
        return [_rows_apply(lambda c, d=r.device: _gram_matvec(
            c, on[d][0], on[d][1]), r, PROBE_CHUNK) for r in rows]

    generator = torch.Generator(device=first)
    generator.manual_seed(seed)
    eigvals, u = _range_eigh_sharded(
        blocks, matvec_rows,
        _omega(generator, init_basis, rank + oversample, n, first),
        rank=rank, power_iters=power_iters, compensated=compensated,
        method=method)
    # as the local build: _gram_matvec applies conj(G), so the Ritz vectors
    # are conjugated before the synthesis and the kernels after it
    scale = _kernel_scale(eigvals[:rank], eigvals[0])
    shards = []
    for r, (r0, _) in zip(u, _bounds(rank, len(devices))):
        sq, _, pf = on[r.device]
        s_dev = scale.to(r.device)
        k = torch.empty_like(r)
        for s in range(0, r.shape[0], PROBE_CHUNK):
            e = min(s + PROBE_CHUNK, r.shape[0])
            k[s:e] = _synthesize_kernels(r[s:e].conj(), sq, pf).conj() \
                * s_dev[r0 + s:r0 + e, None, None]
        shards.append(k)
    socs = SOCSKernels(kernels=blocks.gather_rows(shards),
                       eigenvalues=eigvals[:rank].float(), total_rank=live)
    return (socs, blocks.gather_rows(u)) if return_basis else socs


def randomized_socs_components_sharded(
    components,
    weights,
    source_map,
    config: OpticsConfig,
    mesh: Mesh,
    *,
    rank: int = 64,
    oversample: int = 16,
    power_iters: int = 2,
    seed: int = 0,
    compensated: bool = True,
    axis: str | None = None,
    channels: int | str | None = None,
    channel_rotation=None,
    init_basis=None,
    return_basis: bool = False,
    method: str = "rr",
) -> SOCSKernels:
    """Mesh-sharded :func:`..ops.hopkins.randomized_socs_components` (the
    frequency-side summed-TCC build of the vector, chromatic and film
    paths): each probe row's 2 + 2C FFTs on its row shard, the whitening
    and Rayleigh-Ritz contractions over image columns. ``channels`` and
    ``channel_rotation`` follow the local build (``"auto"`` picks the
    count with :func:`..ops.hopkins.principal_channel_rotation`). Results
    are gathered on the mesh's first device."""
    devices = mesh.axis_devices(_build_axis(mesh, axis))
    first = mesh.first
    n = config.n
    components = to_tensor(components, device=first, dtype=torch.complex64)
    if channel_rotation is None and channels == "auto":
        channel_rotation, _ = principal_channel_rotation(components, weights)
        channels = None
    if channel_rotation is not None:
        components, weights = apply_channel_rotation(components, weights,
                                                     channel_rotation)
    elif channels is not None:
        components, weights = compress_components(components, weights,
                                                  int(channels))
    # the matvec's source coordinate is the physical shift (the local
    # build's roll note)
    w = torch.roll(to_tensor(source_map, device=first, dtype=torch.float32),
                   (-(n // 2), -(n // 2)), dims=(0, 1))
    live = int((w > 0).sum())
    if live == 0:
        return _dark(rank, n, first, return_basis)
    chats = torch.fft.fft2(components.conj())  # (C, n, n)
    q = to_tensor(weights, device=first, dtype=torch.float32)
    on = {dev: (chats.conj().to(dev), w.to(dev),
                (q[:, None, None] * chats).to(dev)) for dev in devices}
    blocks = _Blocks(devices, first, n)

    def tcc_matvec(v):
        chats_conj, w_d, weighted = on[v.device]
        u = torch.fft.ifft2(chats_conj[:, None] * torch.fft.fft2(v)[None])
        y = torch.fft.fft2(u.mul_(w_d))
        del u
        return torch.fft.ifft2(y.mul_(weighted[:, None]).sum(dim=0))

    chunk = 4 if n >= 2048 else (8 if n >= 1024 else None)  # the local "auto"

    def matvec_rows(rows):
        return [_rows_apply(tcc_matvec, r, chunk) for r in rows]

    generator = torch.Generator(device=first)
    generator.manual_seed(seed)
    eigvals, u = _range_eigh_sharded(
        blocks, matvec_rows,
        _omega(generator, init_basis, rank + oversample, n, first),
        rank=rank, power_iters=power_iters, compensated=compensated,
        method=method)
    basis = blocks.gather_rows(u)
    # u rows are Ritz vectors of T itself; the kernel that multiplies the
    # mask spectrum is conj(phi_j), conjugated in memory (the int8 kernels
    # read memory, not a lazy conj view)
    socs = SOCSKernels(kernels=basis.conj_physical(),
                       eigenvalues=eigvals[:rank].float(), total_rank=live)
    return (socs, basis) if return_basis else socs
