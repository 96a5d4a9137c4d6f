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

Four hand-written CUDA kernels (``csrc/intensity_int8.cu``, ``sm_90a``)
carry it on the card, each behind a wrapper with a plain PyTorch version
beside it. The two GEMM kernels run the limb dots on Hopper's int8 tensor
cores (``wgmma`` s8 x s8 -> s32, operands brought in by TMA); the two limb
quantizers are memory-bound passes that read their input once:

====================  ==========================================  ==========
wrapper               computes                                    TPU kernel
====================  ==========================================  ==========
window_product_limbs  column limbs of the window products X_b     (in K2/K3)
row_limb_gemm         ``Y_b = T0 @ X_b`` as f32 planes (yr, yi)   K2 and K3
row_requantize        per-row limbs of yr, yi and yr + yi         (in K2/K3)
column_intensity      ``acc += sum_b w_b |Y_b @ T0^T|^2``         K1
====================  ==========================================  ==========

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel (or raises) and adds one to :data:`LAUNCHES`. The plain
versions run the integer dots as float64 matmuls of integer-valued tensors,
exact because ``|S| <= 3 * w * 127^2 < 2^53``, on either device.

A chunk of the exact engine or the SOCS apply is the four kernels in the
order of the table. On the card :func:`int8_chunk_loop` issues every chunk
of an apply or a pass from native code, in one host call
(``ops/abbe.int8_intensity`` is its one caller); on CPU tensors the four
wrappers serve one chunk at a time.

Limb stacks are int8 tensors ``(3 planes [r, i, r+i], 3 limbs, ..., rows,
kp)`` whose contraction dim is padded with zero limbs to ``kp``, a multiple
of :data:`K_ALIGN` (exact: zero limbs add nothing); scales are f32
``(3 planes, ..., rows)``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..._spans import Counters

#: contraction padding: the depth of one int8 wgmma (the kernels' TMA boxes
#: zero-fill their 128-byte slabs past it)
K_ALIGN = 32

#: the kernels of a chunk, in the order a chunk launches them
CHUNK_KERNELS = ("window_product_limbs", "row_limb_gemm", "row_requantize",
                 "column_intensity")

# the launch counts, in the port's counter store (tallied as
# ``int8_launches.<kernel>`` while a trace records)
_LAUNCH_COUNTS = Counters("int8_launches", CHUNK_KERNELS)
#: kernel launches by name (wrappers count only their CUDA launches)
LAUNCHES = _LAUNCH_COUNTS.totals


def reset_launch_counts() -> None:
    _LAUNCH_COUNTS.reset()


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to :data:`LAUNCHES`."""
    _LAUNCH_COUNTS.add(name)


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
    # a true division, as the kernels' and jnp's: on CUDA torch turns a
    # division by a Python number into a product with its rounded reciprocal
    # (tests/test_torch_intensity_int8.py holds these limbs to the JAX
    # package's quantize_rows and quantize_cols)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0 * 65536.0),
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


def check_window_starts(starts, w: int, a_shape, b_shape) -> np.ndarray:
    """Window origins (B, 4) = (a row, a col, b row, b col) validated on the
    host, once, before upload: raises ValueError unless every (w, w) window
    lies inside its operand (``a_shape[-2:]``, ``b_shape[-2:]``). Returns
    them as C-contiguous int32, the layout :func:`window_product_limbs`
    reads. The kernel itself never syncs to check."""
    s = np.asarray(starts)
    if s.ndim != 2 or s.shape[1] != 4 or not np.issubdtype(s.dtype, np.integer):
        raise ValueError(f"window starts must be integer (B, 4), got "
                         f"{s.dtype} {s.shape}")
    hi = np.array([*a_shape[-2:], *b_shape[-2:]], np.int64) - w
    bad = np.nonzero(((s < 0) | (s > hi)).any(axis=1))[0]
    if w < 1 or bad.size:
        raise ValueError(f"(w={w}, w) windows outside their operands "
                         f"{tuple(a_shape[-2:])} and {tuple(b_shape[-2:])}: "
                         f"starts {s[bad[:4]].tolist() if bad.size else []}")
    return np.ascontiguousarray(s, dtype=np.int32)


def window_products(a: torch.Tensor, b: torch.Tensor, starts: torch.Tensor,
                    w: int) -> torch.Tensor:
    """(B, w, w) products ``a[ba, ar:ar+w, ac:ac+w] * b[br:br+w, bc:bc+w]``
    of the windows at ``starts`` (B, 4), with ``ba = b`` when ``a`` holds a
    batch (a.shape[0] == B) and 0 when it holds one array: two batched
    gathers and one multiply. When both operands are whole (w, w) arrays the
    only window is the whole array, and the product is taken directly."""
    batch = starts.shape[0]
    if tuple(a.shape[-2:]) == (w, w) and tuple(b.shape) == (w, w):
        return (a * b).expand(batch, w, w)
    ar = torch.arange(w, device=starts.device)
    rows = starts[:, :, None] + ar  # (B, 4, w) int64 indices
    if a.shape[0] == 1:
        win_a = a[0][rows[:, 0, :, None], rows[:, 1, None, :]]
    else:
        win_a = a[torch.arange(batch, device=starts.device)[:, None, None],
                  rows[:, 0, :, None], rows[:, 1, None, :]]
    return win_a * b[rows[:, 2, :, None], rows[:, 3, None, :]]


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


def window_product_limbs_plain(a: torch.Tensor, b: torch.Tensor,
                               starts: torch.Tensor, w: int):
    """Plain version of :func:`window_product_limbs`: the gather and
    product, then :func:`quantize_x`. Host-side starts are validated."""
    if starts.device.type == "cpu":
        check_window_starts(starts.numpy(), w, a.shape, b.shape)
    return quantize_x(window_products(a, b, starts, w))


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
    if t.is_conj() or t.is_neg():
        # a lazy view: the kernel would read the memory, not the values
        raise ValueError(f"{name} is a lazy conjugate or negative view; "
                         "pass .resolve_conj() / .resolve_neg() of it")


@contextlib.contextmanager
def _device_stream(device: torch.device):
    """Enter ``device`` and give the handle of its current stream: a launch
    inside runs on that device, on PyTorch's stream."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, device: torch.device, *args) -> None:
    from .build import load_library

    fn = getattr(load_library(), name)
    with _device_stream(device) as stream:
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    count_launch(name)


def row_limb_gemm(x_limbs, x_scales, t_limbs, t_scales, *, fast: bool = False):
    """``Y_b = T0 @ X_b`` from limbs: x_limbs (3, 3, B, w, kp) with scales
    (3, B, w) from :func:`window_product_limbs` (or :func:`quantize_x`),
    t_limbs (3, 3, n, kp) with scales
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


def window_product_limbs(a: torch.Tensor, b: torch.Tensor,
                         starts: torch.Tensor, w: int):
    """Column limbs of the window products ``X_b`` (:func:`window_products`)
    without forming X: a (Ba, Ha, Wa) complex64 with Ba in {1, B}, b
    (Hb, Wb) complex64, starts (B, 4) int32 from
    :func:`check_window_starts` (the kernel reads out-of-range windows as
    NaN scales; it never syncs to check) -> x_limbs (3, 3, B, w, kp) int8
    with kp = :func:`padded_width` (w) and x_scales (3, B, w) f32, as
    :func:`quantize_x` of the products."""
    if not _on_cuda(a, b, starts):
        return window_product_limbs_plain(a, b, starts, w)
    batch = starts.shape[0]
    a_batch, ha, wa = a.shape
    hb, wb = b.shape
    _check(a, "a", torch.complex64, (a_batch, ha, wa))
    _check(b, "b", torch.complex64, (hb, wb))
    _check(starts, "starts", torch.int32, (batch, 4))
    if a_batch not in (1, batch):
        raise ValueError(f"a holds {a_batch} arrays for {batch} windows")
    if not 1 <= w <= min(ha, wa, hb, wb):
        raise ValueError(f"w={w} must lie in [1, the operands' sides]")
    kp = padded_width(w)
    x_limbs = torch.empty((3, 3, batch, w, kp), dtype=torch.int8, device=a.device)
    x_scales = torch.empty((3, batch, w), dtype=torch.float32, device=a.device)
    _launch("window_product_limbs", a.device, a.data_ptr(), b.data_ptr(),
            starts.data_ptr(), x_limbs.data_ptr(), x_scales.data_ptr(), batch,
            a_batch, ha, wa, hb, wb, w, kp)
    return x_limbs, x_scales


def window_product_limbs_plan(a: torch.Tensor, b: torch.Tensor, w: int) -> dict:
    """How :func:`window_product_limbs` runs on the card for these CUDA
    operands (the kernel's own rule, read from the built library): ``path``
    ``"tma"`` or ``"per-thread"`` (a row pitch that is not a multiple of 16
    bytes), ``cluster`` blocks a 16-column strip, and ``rows``, ``slots``
    of b's ring, ``smem`` bytes and ``threads`` a block."""
    from .build import load_library

    out = torch.zeros(6, dtype=torch.int32)
    err = load_library().window_product_limbs_plan(
        a.data_ptr(), b.data_ptr(), a.shape[-1], b.shape[-1], w,
        padded_width(w), out.data_ptr())
    if err:
        raise ValueError(f"window_product_limbs takes no (w={w}, w) window "
                         f"of {tuple(a.shape)} and {tuple(b.shape)}: error {err}")
    keys = ("tma", "cluster", "rows", "slots", "smem", "threads")
    plan = dict(zip(keys, out.tolist()))
    plan["path"] = "tma" if plan.pop("tma") else "per-thread"
    return plan


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


def chunk_table(a: torch.Tensor, starts: torch.Tensor, weights: torch.Tensor,
                chunk: int) -> np.ndarray:
    """The rows (chunks, 5) int64 that :func:`int8_chunk_loop` hands to the
    native loop, one a chunk of ``chunk`` windows (the last may be short):
    the address of the chunk's first array of ``a`` and how many arrays it
    reads there, the addresses of its ``starts`` and ``weights``, and its
    batch. They are what the per-chunk loop passes to the four wrappers:
    ``a[c:c + chunk]`` (or the whole of a one-array ``a``),
    ``starts[c:c + chunk]`` and ``weights[c:c + chunk]``."""
    count = starts.shape[0]
    first = np.arange(0, count, chunk, dtype=np.int64)
    batch = np.minimum(chunk, count - first)
    table = np.empty((len(first), 5), np.int64)
    if a.shape[0] == 1:
        table[:, 0], table[:, 1] = a.data_ptr(), 1
    else:
        table[:, 0] = a.data_ptr() + first * (a.stride(0) * a.element_size())
        table[:, 1] = batch
    table[:, 2] = starts.data_ptr() + first * (starts.stride(0)
                                               * starts.element_size())
    table[:, 3] = weights.data_ptr() + first * weights.element_size()
    table[:, 4] = batch
    return table


def int8_chunk_loop(a: torch.Tensor, b: torch.Tensor, starts: torch.Tensor,
                    w: int, t_limbs: torch.Tensor, t_scales: torch.Tensor,
                    weights: torch.Tensor, *, chunk: int, fast: bool = False,
                    out: torch.Tensor) -> torch.Tensor:
    """``out += sum_b weights_b |T0 @ X_b @ T0^T|^2`` over the windows at
    ``starts`` (P, 4), ``chunk`` windows a chunk, on the card in one host
    call: a native loop issues each chunk's four kernels with the launches
    of :func:`window_product_limbs`, :func:`row_limb_gemm`,
    :func:`row_requantize` and :func:`column_intensity_int8` (``out``
    given), in that order, and adds the chunks into ``out`` in order, so
    ``out`` ends bit for bit as after the per-chunk loop. ``a`` (1 or P,
    Ha, Wa) complex64: every window reads the one array, or window b reads
    ``a[b]``; ``b``, ``starts`` (inside the operands, as
    :func:`check_window_starts` validates them), ``w``, ``t_limbs``,
    ``t_scales`` as the wrappers take them; ``weights`` (P,).
    One chunk's workspace serves every chunk. The launches are counted in
    :data:`LAUNCHES`; a refused launch raises RuntimeError naming the kernel and the chunk, after the
    launches before it were issued. CUDA tensors only. Returns ``out``."""
    if not _on_cuda(a, b, starts, t_limbs, t_scales, weights, out):
        raise ValueError("int8_chunk_loop issues the kernels: it takes CUDA "
                         "tensors only")
    count = starts.shape[0]
    a_count, ha, wa = a.shape
    hb, wb = b.shape
    n, kp = t_limbs.shape[2], t_limbs.shape[-1]
    _check(a, "a", torch.complex64, (a_count, ha, wa))
    _check(b, "b", torch.complex64, (hb, wb))
    _check(starts, "starts", torch.int32, (count, 4))
    _check(t_limbs, "t_limbs", torch.int8, (3, 3, n, kp))
    _check(t_scales, "t_scales", torch.float32, (3, n))
    _check(out, "out", torch.float32, (n, n))
    weights = weights.to(torch.float32).contiguous()
    if tuple(weights.shape) != (count,):
        raise ValueError(f"weights: expected ({count},), got "
                         f"{tuple(weights.shape)}")
    if a_count not in (1, count):
        raise ValueError(f"a holds {a_count} arrays for {count} windows")
    if not 1 <= w <= min(ha, wa, hb, wb) or kp != padded_width(w):
        raise ValueError(f"w={w} must lie in [1, the operands' sides] with "
                         f"T0's kp={kp} = padded_width(w)")
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be at least 1")
    if count == 0:
        return out
    from .build import load_library

    table = chunk_table(a, starts, weights, chunk)
    chunks, batch, dev = len(table), min(chunk, count), out.device
    x_limbs = torch.empty((3, 3, batch, w, kp), dtype=torch.int8, device=dev)
    x_scales = torch.empty((3, batch, w), dtype=torch.float32, device=dev)
    yr = torch.empty((batch, n, w), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    y_limbs = torch.empty((3, 3, batch, n, kp), dtype=torch.int8, device=dev)
    y_scales = torch.empty((3, batch, n), dtype=torch.float32, device=dev)
    where = np.zeros(2, np.int32)  # the chunk and kernel of a refused launch
    lib = load_library()
    with _device_stream(dev) as stream:
        err = lib.int8_chunk_loop(
            table.ctypes.data, chunks, b.data_ptr(), t_limbs.data_ptr(),
            t_scales.data_ptr(), x_limbs.data_ptr(), x_scales.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), y_limbs.data_ptr(),
            y_scales.data_ptr(), out.data_ptr(), ha, wa, hb, wb, n, w, kp,
            int(fast), where.ctypes.data, stream)
    failed_chunk, failed_kernel = int(where[0]), int(where[1])
    issued = 4 * failed_chunk + failed_kernel if err else 4 * chunks
    for i, name in enumerate(CHUNK_KERNELS):
        _LAUNCH_COUNTS.add(name, issued // 4 + (i < issued % 4))
    if err:
        raise RuntimeError(
            f"CUDA kernel {CHUNK_KERNELS[failed_kernel]} failed to launch in "
            f"chunk {failed_chunk} of {chunks} (int8_chunk_loop): error {err}")
    return out
