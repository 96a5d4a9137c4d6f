"""Plain PyTorch reference of the SOCS kernel set, in float64.

The transmission cross coefficient of a source ``w`` (weights on the
sigma plane) and a pupil ``P`` is ``T = B^H B`` with
``B[s, k] = sqrt(w_s) conj(P(k - s))`` (offsets wrap mod ``n``): so
``T(k, k') = sum_s w_s P(k - s) conj(P(k' - s))``, and an image is
``sum_j lambda_j |F(phi_j M)|^2`` over the eigenpairs of ``T``. ``B`` and
``B^H`` are circular correlations, two FFTs each. The eigenpairs come from
the source-side Gram ``G = B B^H`` (one row a live source point) by
subspace iteration with Rayleigh-Ritz, with a wide oversampling and more
iterations than a production build takes, so that its top-``rank`` set is
the converged one to well below the image differences the benchmark
compares; the kernels are ``phi_j = B^H u_j / sqrt(lambda_j)``.

Its probes come from its own generator, so it shares no random numbers
with the program: what two good builds of one TCC share is the image they
give, not their kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .optics import C128


class Operator:
    """``B`` and ``B^H`` of one pupil and source on the pupil's device."""

    def __init__(self, pup: torch.Tensor, source: np.ndarray):
        self.n = pup.shape[-1]
        self.device = pup.device
        self.fp = torch.fft.fft2(pup.to(C128))
        # a source map's centre is offset 0: index by the offset mod n
        offsets = np.fft.ifftshift(source).reshape(-1)
        live = np.flatnonzero(offsets > 0)
        self.live = torch.as_tensor(live, device=self.device)
        self.sqrt_w = torch.as_tensor(np.sqrt(offsets[live]),
                                      device=self.device, dtype=torch.float64)

    @property
    def size(self) -> int:
        return int(self.live.numel())

    def adjoint(self, u: torch.Tensor) -> torch.Tensor:
        """(L, S) source-side vectors -> (L, n, n) ``B^H u``."""
        full = torch.zeros((u.shape[0], self.n * self.n), dtype=C128,
                           device=self.device)
        full[:, self.live] = u * self.sqrt_w
        full = full.view(-1, self.n, self.n)
        return torch.fft.ifft2(self.fp * torch.fft.fft2(full))

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        """(L, n, n) sigma-plane maps -> (L, S) ``B v``."""
        corr = torch.fft.ifft2(torch.fft.fft2(v) * self.fp.conj())
        return corr.reshape(v.shape[0], -1)[:, self.live] * self.sqrt_w

    def gram(self, u: torch.Tensor, block: int = 32) -> torch.Tensor:
        """(S, L) -> (S, L) ``G u``, ``block`` columns at a time."""
        out = torch.empty_like(u)
        for c in range(0, u.shape[1], block):
            out[:, c:c + block] = self.forward(self.adjoint(
                u[:, c:c + block].T.contiguous())).T
        return out


def kernel_set(pup: torch.Tensor, source: np.ndarray, rank: int, *,
               oversample: int | None = None, iterations: int = 4,
               seed: int = 12345, block: int = 32):
    """(kernels (rank, n, n) complex128, eigenvalues (rank,) float64) of
    the TCC, descending."""
    op = Operator(pup, source)
    size = op.size
    width = min(size, rank + (rank if oversample is None else oversample))
    gen = torch.Generator(device=op.device).manual_seed(seed)
    omega = torch.randn((size, width), generator=gen, device=op.device,
                        dtype=torch.float64).to(C128)
    q = torch.linalg.qr(op.gram(omega, block))[0]
    for _ in range(iterations):
        q = torch.linalg.qr(op.gram(q, block))[0]
    gq = op.gram(q, block)
    h = q.conj().T @ gq
    vals, vecs = torch.linalg.eigh((h + h.conj().T) / 2)
    order = torch.argsort(vals, descending=True)[:rank]
    vals, u = vals[order], q @ vecs[:, order]
    kernels = torch.empty((len(order), op.n, op.n), dtype=C128, device=op.device)
    for c in range(0, len(order), block):
        kernels[c:c + block] = op.adjoint(u[:, c:c + block].T.contiguous())
    kernels /= torch.sqrt(vals.clamp(min=1e-300))[:, None, None]
    return kernels, vals
