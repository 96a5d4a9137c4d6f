"""Int8 limb-emulated fp32 row transform + column intensity.

Port of ``lithographysimulator_tpu/ops/kernels/intensity_int8.py``. The
exact-Abbe hot loop spends its work on the windowed zoom-DFT
``E_b = T0 @ X_b @ T0^T``; these functions compute it from int8 limb dots
that reach fp32 accuracy (~2^-24 relative to each row's max):

* an f32 row (or column) splits into 3 signed radix-256 limbs with one
  scale, ``a ~ s * (l0 + l1/256 + l2/65536)`` (:func:`quantize_rows`,
  :func:`quantize_cols`);
* a product needs the 6 limb pairs of weight >= 2^-16, each an exact
  int8 x int8 -> int32 dot, dequantized as ``sA sB (S0 + S1/256 +
  S2/65536)``; ``fast`` drops the 2^-16 group (3 dots, ~1e-5 accuracy);
* complex products use the 3M planes r, i and r+i.

Three hand-written CUDA kernels (``csrc/intensity_int8.cu``) carry it on
the card, each behind a wrapper with a plain PyTorch version beside it:

=================  ==========================================  ===========
wrapper            computes                                    TPU kernel
=================  ==========================================  ===========
row_limb_gemm      ``Y_b = T0 @ X_b`` as f32 planes (yr, yi)    K2 and K3
row_requantize     per-row limbs of yr, yi and yr + yi          (in K2/K3)
column_intensity   ``acc += sum_b w_b |Y_b @ T0^T|^2``          K1
=================  ==========================================  ===========

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel (or raises) and adds one to :data:`LAUNCHES`. The plain
versions run the integer dots as float64 matmuls of integer-valued tensors,
exact because ``|S| <= 3 * w * 127^2 < 2^53``, on either device.

Limb stacks are int8 tensors ``(3 planes [r, i, r+i], 3 limbs, ..., rows,
kp)`` whose contraction dim is padded with zero limbs to ``kp``, a multiple
of :data:`K_ALIGN` (exact: zero limbs add nothing); scales are f32
``(3 planes, ..., rows)``.
"""

from __future__ import annotations

import torch

#: contraction padding; equals the CUDA kernels' shared-memory slab depth KT
K_ALIGN = 32

#: kernel launches by name (wrappers count only their CUDA launches)
LAUNCHES = {"row_limb_gemm": 0, "row_requantize": 0, "column_intensity": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def padded_width(w: int) -> int:
    return -(-w // K_ALIGN) * K_ALIGN


# ---------------------------------------------------------------------------
# Limb quantizers (plain torch on both devices)
# ---------------------------------------------------------------------------

def _split_limbs(q: torch.Tensor) -> torch.Tensor:
    """(3, ...) int8 limbs of ``q = a / scale`` (|q| <= 127 * 65536);
    torch.round rounds half to even, as jnp.round."""
    l0 = torch.round(q * (1.0 / 65536.0))          # |l0| <= 127 by the scale
    r = q - l0 * 65536.0                            # |r| <= 2^15
    l1 = torch.round(r * (1.0 / 256.0))             # in [-128, 128]
    carry = (l1 > 127.0).to(q.dtype)                # +128 only; -128 fits int8
    l0 = l0 + carry
    l1 = l1 - 256.0 * carry
    r = q - l0 * 65536.0 - l1 * 256.0               # |r| <= 128
    l2 = torch.clamp(torch.round(r), -128, 127)     # clip loses <= 1 ulp
    return torch.stack([l0, l1, l2]).to(torch.int8)


def _quantize(a: torch.Tensor, dim: int):
    amax = a.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax > 0, amax / (127.0 * 65536.0),
                        torch.ones_like(amax))
    return _split_limbs(a / scale), (scale * 65536.0).squeeze(dim)


def quantize_rows(a: torch.Tensor):
    """f32 (..., w) -> limbs (3, ..., w) int8 + per-row scale (...,); the
    scale folds in 2^16, so values are ``scale * (l0 + l1/256 + l2/65536)``."""
    return _quantize(a, -1)


def quantize_cols(a: torch.Tensor):
    """Per-COLUMN split of f32 (..., u, v): limbs (3, ..., u, v) int8 +
    scale (..., v), for operands contracted over their leading matrix dim."""
    return _quantize(a, -2)


def _pad_k(limbs: torch.Tensor, kp: int) -> torch.Tensor:
    w = limbs.shape[-1]
    out = limbs.new_zeros(limbs.shape[:-1] + (kp,))
    out[..., :w] = limbs
    return out


def _planes(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """The 3M planes (r, i, r + i) stacked on a new leading dim."""
    return torch.stack([re, im, re + im])


def prepare_t0_limbs(t0r: torch.Tensor, t0i: torch.Tensor):
    """Row-quantize the static (n, w) T0 planes once per configuration:
    limbs (3, 3, n, kp) int8 and scales (3, n) f32."""
    limbs, scales = quantize_rows(_planes(t0r, t0i))
    kp = padded_width(t0r.shape[-1])
    return _pad_k(limbs.transpose(0, 1), kp), scales


def quantize_x(x: torch.Tensor):
    """(B, w, w) complex windowed products -> transposed column limbs
    (3, 3, B, w, kp) int8 (row v holds column v of X_b, contiguous along the
    contraction) and per-column scales (3, B, w)."""
    limbs, scales = quantize_cols(_planes(x.real, x.imag))
    kp = padded_width(x.shape[-1])
    return _pad_k(limbs.transpose(0, 1).transpose(-1, -2), kp), scales


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _limb_group(a: torch.Tensor, b: torch.Tensor, fast: bool) -> torch.Tensor:
    """``S0 + S1/256 (+ S2/65536)`` in f32 for limbs a (3, ..., M, K) and
    b (3, ..., N, K), contracting K; the dots are exact f64 matmuls."""
    a = a.double()
    b = b.double().transpose(-1, -2)
    s0 = a[0] @ b[0]
    s1 = a[0] @ b[1] + a[1] @ b[0]
    m = s0.float() + s1.float() * (1.0 / 256.0)
    if fast:
        return m
    s2 = a[0] @ b[2] + a[1] @ b[1] + a[2] @ b[0]
    return m + s2.float() * (1.0 / 65536.0)


def row_limb_gemm_plain(x_limbs, x_scales, t_limbs, t_scales, *,
                        fast: bool = False):
    """Plain version of :func:`row_limb_gemm`."""
    m = [_limb_group(t_limbs[p], x_limbs[p], fast)
         * (t_scales[p][:, None] * x_scales[p][:, None, :]) for p in range(3)]
    return m[0] - m[1], m[2] - m[0] - m[1]


def row_requantize_plain(yr: torch.Tensor, yi: torch.Tensor, kp: int):
    """Plain version of :func:`row_requantize`."""
    limbs, scales = quantize_rows(_planes(yr, yi))
    return _pad_k(limbs.transpose(0, 1), kp), scales


def column_intensity_int8_plain(y_limbs, y_scales, t_limbs, t_scales,
                                weights, *, fast: bool = False,
                                out: torch.Tensor | None = None):
    """Plain version of :func:`column_intensity_int8`."""
    batch, n = y_limbs.shape[2], y_limbs.shape[3]
    acc = torch.zeros((n, n), dtype=torch.float32, device=y_limbs.device)
    for b in range(batch):
        m = [_limb_group(y_limbs[p, :, b], t_limbs[p], fast)
             * (y_scales[p, b][:, None] * t_scales[p][None, :])
             for p in range(3)]
        er = m[0] - m[1]
        ei = m[2] - m[0] - m[1]
        acc = acc + weights[b] * (er * er + ei * ei)
    if out is None:
        return acc
    return out.add_(acc)


def row_transform_int8_plain(x, t_limbs, t_scales, *, fast: bool = False):
    """Plain version of :func:`row_transform_int8`."""
    x_limbs, x_scales = quantize_x(x)
    yr, yi = row_limb_gemm_plain(x_limbs, x_scales, t_limbs, t_scales,
                                 fast=fast)
    return row_requantize_plain(yr, yi, t_limbs.shape[-1])


def window_intensity_int8_plain(yr, yi, t_limbs, t_scales, weights):
    """``sum_b w_b |Y_b @ T0^T|^2`` from f32 Y planes: quantize the rows,
    then the plain column intensity (counterpart of the JAX package's
    ``reference_window_intensity_int8``)."""
    y_limbs, y_scales = row_requantize_plain(yr, yi, t_limbs.shape[-1])
    return column_intensity_int8_plain(y_limbs, y_scales, t_limbs, t_scales,
                                       weights)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _on_cuda(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"int8 kernels need all tensors on one CPU or CUDA "
                     f"device, got {sorted(str(t.device) for t in tensors)}")


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(name: str, device: torch.device, *args) -> None:
    from .build import load_library

    fn = getattr(load_library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    LAUNCHES[name] += 1


def row_limb_gemm(x_limbs, x_scales, t_limbs, t_scales, *, fast: bool = False):
    """``Y_b = T0 @ X_b`` from limbs: x_limbs (3, 3, B, w, kp) with scales
    (3, B, w) from :func:`quantize_x`, t_limbs (3, 3, n, kp) with scales
    (3, n) from :func:`prepare_t0_limbs` -> f32 planes yr, yi (B, n, w)."""
    if not _on_cuda(x_limbs, x_scales, t_limbs, t_scales):
        return row_limb_gemm_plain(x_limbs, x_scales, t_limbs, t_scales,
                                   fast=fast)
    _, _, batch, w, kp = x_limbs.shape
    n = t_limbs.shape[2]
    _check(x_limbs, "x_limbs", torch.int8, (3, 3, batch, w, kp))
    _check(x_scales, "x_scales", torch.float32, (3, batch, w))
    _check(t_limbs, "t_limbs", torch.int8, (3, 3, n, kp))
    _check(t_scales, "t_scales", torch.float32, (3, n))
    if kp % K_ALIGN:
        raise ValueError(f"kp={kp} must be a multiple of {K_ALIGN}")
    yr = torch.empty((batch, n, w), dtype=torch.float32, device=x_limbs.device)
    yi = torch.empty_like(yr)
    _launch("row_limb_gemm", x_limbs.device, t_limbs.data_ptr(),
            t_scales.data_ptr(), x_limbs.data_ptr(), x_scales.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), batch, n, w, kp, int(fast))
    return yr, yi


def row_requantize(yr: torch.Tensor, yi: torch.Tensor, kp: int):
    """Per-row limbs of the planes yr, yi, yr + yi (B, n, w) f32 ->
    y_limbs (3, 3, B, n, kp) int8 and y_scales (3, B, n) f32."""
    if not _on_cuda(yr, yi):
        return row_requantize_plain(yr, yi, kp)
    batch, n, w = yr.shape
    _check(yr, "yr", torch.float32, (batch, n, w))
    _check(yi, "yi", torch.float32, (batch, n, w))
    if kp % K_ALIGN or kp < w:
        raise ValueError(f"kp={kp} must be a multiple of {K_ALIGN} and >= w={w}")
    y_limbs = torch.empty((3, 3, batch, n, kp), dtype=torch.int8,
                          device=yr.device)
    y_scales = torch.empty((3, batch, n), dtype=torch.float32, device=yr.device)
    _launch("row_requantize", yr.device, yr.data_ptr(), yi.data_ptr(),
            y_limbs.data_ptr(), y_scales.data_ptr(), batch * n, w, kp)
    return y_limbs, y_scales


def row_transform_int8(x, t_limbs, t_scales, *, fast: bool = False):
    """``Y_b = T0 @ X_b`` for (B, w, w) complex X, returned row-quantized for
    :func:`column_intensity_int8`: y_limbs (3, 3, B, n, kp), y_scales
    (3, B, n). One K-looped kernel serves every window size (the TPU
    package's square-block and split-K row kernels)."""
    x_limbs, x_scales = quantize_x(x)
    yr, yi = row_limb_gemm(x_limbs, x_scales, t_limbs, t_scales, fast=fast)
    return row_requantize(yr, yi, t_limbs.shape[-1])


def column_intensity_int8(y_limbs, y_scales, t_limbs, t_scales, weights, *,
                          fast: bool = False, out: torch.Tensor | None = None):
    """``sum_b w_b |Y_b @ T0^T|^2`` (n, n) f32 from limbs; with ``out``
    given, the sum is added to it in place and ``out`` is returned."""
    if not _on_cuda(y_limbs, y_scales, t_limbs, t_scales, weights):
        return column_intensity_int8_plain(y_limbs, y_scales, t_limbs,
                                           t_scales, weights, fast=fast,
                                           out=out)
    _, _, batch, n, kp = y_limbs.shape
    _check(y_limbs, "y_limbs", torch.int8, (3, 3, batch, n, kp))
    _check(y_scales, "y_scales", torch.float32, (3, batch, n))
    _check(t_limbs, "t_limbs", torch.int8, (3, 3, n, kp))
    _check(t_scales, "t_scales", torch.float32, (3, n))
    weights = weights.to(torch.float32).contiguous()
    if tuple(weights.shape) != (batch,):
        raise ValueError(f"weights: expected ({batch},), got {tuple(weights.shape)}")
    if out is None:
        out = torch.zeros((n, n), dtype=torch.float32, device=y_limbs.device)
    else:
        _check(out, "out", torch.float32, (n, n))
    _launch("column_intensity", y_limbs.device, y_limbs.data_ptr(),
            y_scales.data_ptr(), t_limbs.data_ptr(), t_scales.data_ptr(),
            weights.data_ptr(), out.data_ptr(), batch, n, kp, int(fast))
    return out
