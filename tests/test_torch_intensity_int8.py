"""Port parity: the int8 limb kernels' plain PyTorch versions (what the
wrappers run on CPU tensors) against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs.

Tolerances: the limb round trip loses <= rowmax * 2^-23 per entry (the l2
clip); dequantized outputs <= 1e-6 normalized RMS against JAX in 3-limb
mode (both sides emulate fp32; the residual is the limb quantization);
the 2-limb ``fast`` mode is its own accuracy class, <= 1e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from lithographysimulator_tpu.ops.kernels import intensity_int8 as jk
from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as pk

from .conftest import normalized_rms

TOL = 1e-6
TOL_FAST = 1e-4


def _operands(b, n, w, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, w, w)) + 1j * rng.normal(size=(b, w, w))
         ).astype(np.complex64)
    t0 = np.exp(1j * rng.normal(size=(n, w))).astype(np.complex64)
    return x, t0


def _jax_t(t0):
    return jk.prepare_t0_limbs(jnp.asarray(t0.real), jnp.asarray(t0.imag))


def _port_t(t0):
    return pk.prepare_t0_limbs(torch.as_tensor(t0.real), torch.as_tensor(t0.imag))


def _deq_jax(limbs, scales):
    """JAX Y limbs (3, B, n, w) + scales (B, n) -> f64 values."""
    l = np.asarray(limbs, np.float64)
    return (l[0] + l[1] / 256.0 + l[2] / 65536.0) * np.asarray(scales)[..., None]


def _deq_port(limbs, scales, w):
    """Port limbs (3, 3, ..., kp) + scales (3, ...) -> (3, ..., w) f64."""
    l = limbs.double().numpy()[..., :w]
    s = scales.double().numpy()[..., None]
    return (l[:, 0] + l[:, 1] / 256.0 + l[:, 2] / 65536.0) * s


def test_quantize_rows_roundtrip():
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(5, 64)) * 10.0 ** rng.integers(-3, 4, (5, 1))
         ).astype(np.float32)
    a[2] = 0.0  # an all-zero row gets scale 1 and zero limbs
    limbs, scale = pk.quantize_rows(torch.as_tensor(a))
    l = limbs.double().numpy()
    back = (l[0] + l[1] / 256.0 + l[2] / 65536.0) * scale.double().numpy()[..., None]
    assert (np.abs(back - a).max(axis=-1) <= np.abs(a).max(axis=-1) * 2.0 ** -23).all()
    assert scale[2] == 65536.0 and not limbs[:, 2].any()
    j_limbs, j_scale = jk.quantize_rows(jnp.asarray(a))
    j_back = _deq_jax(j_limbs, j_scale)
    assert normalized_rms(back, j_back) < TOL


def test_quantize_cols_and_t0_layout():
    x, t0 = _operands(2, 48, 24, 1)
    x_limbs, x_scales = pk.quantize_x(torch.as_tensor(x))
    assert tuple(x_limbs.shape) == (3, 3, 2, 24, pk.padded_width(24)) == (3, 3, 2, 24, 32)
    assert not x_limbs[..., 24:].any()  # zero limbs in the padding
    # row v of the transposed stack is column v of X, scaled per column
    xr = _deq_port(x_limbs, x_scales, 24)[0]
    np.testing.assert_allclose(xr, np.swapaxes(x.real, -1, -2), atol=1e-6)
    j_limbs, j_scale = jk.quantize_cols(jnp.asarray(x.real))
    np.testing.assert_allclose(x_scales[0].numpy(), np.asarray(j_scale), rtol=1e-7)
    t_limbs, t_scales = _port_t(t0)
    assert tuple(t_limbs.shape) == (3, 3, 48, 32) and tuple(t_scales.shape) == (3, 48)


@pytest.mark.parametrize("fast", [False, True])
def test_row_transform_matches_jax(fast):
    """Port plain row transform vs JAX row_transform_int8 at (2, 128, 72)."""
    x, t0 = _operands(2, 128, 72, 2)
    ylr, yli, yls, ysc = jk.row_transform_int8(jnp.asarray(x), *_jax_t(t0),
                                               interpret=True, fast=fast)
    y_limbs, y_scales = pk.row_transform_int8(torch.as_tensor(x), *_port_t(t0),
                                              fast=fast)
    ours = _deq_port(y_limbs, y_scales, 72)
    tol = TOL_FAST if fast else TOL
    assert normalized_rms(ours[0] + 1j * ours[1],
                          _deq_jax(ylr, ysc[0]) + 1j * _deq_jax(yli, ysc[1])) < tol
    assert normalized_rms(ours[2], _deq_jax(yls, ysc[2])) < tol
    y_f64 = np.einsum("iw,bwv->biv", t0.astype(np.complex128), x)
    assert normalized_rms(ours[0] + 1j * ours[1], y_f64) < tol


@pytest.mark.parametrize("fast", [False, True])
def test_row_transform_matches_jax_splitk(fast):
    """Same port function vs JAX row_transform_int8_splitk at (2, 128, 96):
    the one K-looped kernel replaces both TPU row kernels."""
    x, t0 = _operands(2, 128, 96, 3)
    ylr, yli, yls, ysc = jk.row_transform_int8_splitk(
        jnp.asarray(x), *_jax_t(t0), tile_k=32, interpret=True, fast=fast)
    y_limbs, y_scales = pk.row_transform_int8(torch.as_tensor(x), *_port_t(t0),
                                              fast=fast)
    ours = _deq_port(y_limbs, y_scales, 96)
    tol = TOL_FAST if fast else TOL
    assert normalized_rms(ours[0] + 1j * ours[1],
                          _deq_jax(ylr, ysc[0]) + 1j * _deq_jax(yli, ysc[1])) < tol


@pytest.mark.parametrize("fast", [False, True])
def test_column_intensity_matches_jax(fast):
    """Port plain column intensity vs JAX column_intensity_int8 at (3, 64, 40),
    each fed its own row quantization of the same f32 Y planes."""
    rng = np.random.default_rng(4)
    b, n, w = 3, 64, 40
    yr = rng.normal(size=(b, n, w)).astype(np.float32)
    yi = rng.normal(size=(b, n, w)).astype(np.float32)
    _, t0 = _operands(b, n, w, 5)
    weights = rng.random(b).astype(np.float32)
    ylr, syr = jk.quantize_rows(jnp.asarray(yr))
    yli, syi = jk.quantize_rows(jnp.asarray(yi))
    yls, sys_ = jk.quantize_rows(jnp.asarray(yr + yi))
    ref = np.asarray(jk.column_intensity_int8(
        (ylr, yli, yls), jnp.stack([syr, syi, sys_]), *_jax_t(t0),
        jnp.asarray(weights), interpret=True, fast=fast))
    t_limbs, t_scales = _port_t(t0)
    y_limbs, y_scales = pk.row_requantize(torch.as_tensor(yr), torch.as_tensor(yi),
                                          t_limbs.shape[-1])
    ours = pk.column_intensity_int8(y_limbs, y_scales, t_limbs, t_scales,
                                    torch.as_tensor(weights), fast=fast).numpy()
    assert normalized_rms(ours, ref) < (TOL_FAST if fast else TOL)
    # in-place accumulation into the caller's buffer
    acc = torch.ones((n, n))
    out = pk.column_intensity_int8(y_limbs, y_scales, t_limbs, t_scales,
                                   torch.as_tensor(weights), fast=fast, out=acc)
    assert out is acc
    np.testing.assert_allclose(acc.numpy(), ours + 1.0, rtol=1e-6)


def test_window_intensity_plain_matches_jax_reference():
    rng = np.random.default_rng(6)
    b, n, w = 3, 64, 40
    yr = rng.normal(size=(b, n, w)).astype(np.float32)
    yi = rng.normal(size=(b, n, w)).astype(np.float32)
    _, t0 = _operands(b, n, w, 7)
    weights = rng.random(b).astype(np.float32)
    ref = np.asarray(jk.reference_window_intensity_int8(
        jnp.asarray(yr), jnp.asarray(yi), *_jax_t(t0), jnp.asarray(weights)))
    ours = pk.window_intensity_int8_plain(
        torch.as_tensor(yr), torch.as_tensor(yi), *_port_t(t0),
        torch.as_tensor(weights)).numpy()
    assert normalized_rms(ours, ref) < TOL
    # limb math vs the true f32 contraction: quantization error only
    e = np.einsum("biw,jw->bij", yr + 1j * yi, t0.astype(np.complex128))
    exact = np.sum(weights[:, None, None] * np.abs(e) ** 2, axis=0)
    assert normalized_rms(ours, exact) < TOL


def _window_case(kind, seed=9):
    """Operands of window_product_limbs and their numpy (B, w, w) products:
    ``exact`` is the tiled 2n x 2n pupil (Ba = 1) with starts from
    abbe._window_starts at n = 64, w = 40; ``batched`` the same starts on a
    batch of 2n x 2n arrays (Ba = B); ``socs`` a batch of (n, n) kernels at
    zero starts, w = n = 48; ``odd`` the exact starts at w = 37 (neither a
    multiple of 16 nor of 4) in a (1, 2n + 1, 2n + 1) array and an
    (n + 1, n + 1) one, whose odd row pitches send the card's kernel to its
    per-thread loads. Column 35 of b is zero, so every window but the
    SOCS ones holds an all-zero column of X."""
    from lithographysimulator_tpu_torch.ops import abbe as pa

    rng = np.random.default_rng(seed)
    b_count, n = 3, (48 if kind == "socs" else 64)

    def cplx(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)

    if kind == "socs":
        w, a, starts = n, cplx(b_count, n, n), np.zeros((b_count, 4), np.int64)
    else:
        w = 37 if kind == "odd" else 40
        pupil = cplx(n, n)
        a = (np.tile(pupil, (2, 2))[None] if kind == "exact"
             else cplx(1, 2 * n + 1, 2 * n + 1) if kind == "odd"
             else cplx(b_count, 2 * n, 2 * n))
        shifts = rng.integers(-(n // 4 - 2), n // 4 - 1, size=(b_count, 2))
        starts = pa._window_starts(shifts, n, w, n // 4 - 1)
    b = cplx(n + 1, n + 1) if kind == "odd" else cplx(n, n)
    if kind != "socs":
        b[:, 35] = 0.0
    ba = np.zeros(b_count, int) if a.shape[0] == 1 else np.arange(b_count)
    x = np.stack([a[ba[k], r0:r0 + w, c0:c0 + w] * b[r1:r1 + w, c1:c1 + w]
                  for k, (r0, c0, r1, c1) in enumerate(starts)])
    return a, b, starts, w, x


@pytest.mark.parametrize("kind", ["exact", "batched", "socs", "odd"])
def test_window_product_limbs_plain_matches_jax_quantize_cols(kind):
    """The X-side limbs: the port's gather-product-quantize (what the wrapper
    runs on CPU tensors) against the JAX package's quantize_cols of the
    same products, plane by plane (r, i, r + i). The products themselves
    match numpy's to f32 rounding (torch may fuse the complex multiply), so
    both quantizers get the port's products."""
    a, b, starts, w, x_np = _window_case(kind)
    checked = pk.check_window_starts(starts, w, a.shape, b.shape)
    args = (torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(checked), w)
    x = pk.window_products(*args).numpy()
    np.testing.assert_allclose(x, x_np, rtol=1e-6, atol=1e-6 * np.abs(x_np).max())
    limbs, scales = pk.window_product_limbs(*args)
    kp = pk.padded_width(w)
    assert tuple(limbs.shape) == (3, 3, len(x), w, kp) and limbs.dtype == torch.int8
    assert tuple(scales.shape) == (3, len(x), w)
    assert not limbs[..., w:].any()  # zero limbs past w
    ours = np.swapaxes(_deq_port(limbs, scales, w), -1, -2)  # (3, B, u, v)
    planes = np.stack([x.real, x.imag, x.real + x.imag]).astype(np.float64)
    col_max = np.abs(planes).max(axis=-2, keepdims=True)
    for p, plane in enumerate((x.real, x.imag, x.real + x.imag)):
        j_limbs, j_scale = jk.quantize_cols(jnp.asarray(plane))
        np.testing.assert_allclose(scales[p].numpy(), np.asarray(j_scale), rtol=1.2e-7)
        theirs = _deq_jax(np.moveaxis(np.asarray(j_limbs), -1, -2),
                          np.asarray(j_scale))  # (B, v, u)
        assert (np.abs(ours[p] - np.swapaxes(theirs, -1, -2))
                <= col_max[p] * 2.0 ** -23).all()
    assert (np.abs(ours - planes) <= col_max * 2.0 ** -22).all()
    if kind != "socs":  # the zero column: scale 1 (2^16 folded), zero limbs
        zero = np.argwhere(~x.any(axis=1))
        assert len(zero) == len(x)
        for k, v in zero:
            assert (scales[:, k, v] == 65536.0).all() and not limbs[:, :, k, v].any()


def test_row_requantize_plain_matches_jax_quantize_rows():
    """Per-row limbs of yr, yi and yr + yi, zero past w, against the JAX
    package's quantize_rows plane by plane; an all-zero row gets scale 1."""
    rng = np.random.default_rng(10)
    b, n, w = 2, 24, 40
    yr = (rng.normal(size=(b, n, w)) * 10.0 ** rng.integers(-3, 4, (b, n, 1))
          ).astype(np.float32)
    yi = rng.normal(size=(b, n, w)).astype(np.float32)
    yr[1, 3] = yi[1, 3] = 0.0
    kp = pk.padded_width(w)
    limbs, scales = pk.row_requantize(torch.as_tensor(yr), torch.as_tensor(yi), kp)
    assert tuple(limbs.shape) == (3, 3, b, n, kp) and tuple(scales.shape) == (3, b, n)
    assert not limbs[..., w:].any()
    assert (scales[:, 1, 3] == 65536.0).all() and not limbs[:, :, 1, 3].any()
    ours = _deq_port(limbs, scales, w)
    for p, plane in enumerate((yr, yi, yr + yi)):
        j_limbs, j_scale = jk.quantize_rows(jnp.asarray(plane))
        np.testing.assert_allclose(scales[p].numpy(), np.asarray(j_scale), rtol=1.2e-7)
        row_max = np.abs(plane).max(axis=-1, keepdims=True)
        assert (np.abs(ours[p] - _deq_jax(j_limbs, j_scale)) <= row_max * 2.0 ** -23).all()
        assert (np.abs(ours[p] - plane) <= row_max * 2.0 ** -22).all()


@pytest.mark.parametrize("bad", [(-1, 0, 0, 0), (0, 89, 0, 0), (0, 0, 25, 0),
                                 (0, 0, 0, -3)])
def test_window_starts_outside_the_operands_raise(bad):
    """Starts are checked once on the host: a window past either operand's
    edge raises, in the check and in the plain path of the wrapper."""
    a_shape, b_shape, w = (1, 128, 128), (64, 64), 40
    good = np.array([[0, 88, 24, 0], [3, 5, 7, 11]])
    out = pk.check_window_starts(good, w, a_shape, b_shape)
    assert out.dtype == np.int32 and out.flags.c_contiguous
    starts = np.concatenate([good, [bad]])
    with pytest.raises(ValueError, match="outside"):
        pk.check_window_starts(starts, w, a_shape, b_shape)
    with pytest.raises(ValueError, match="outside"):
        pk.window_product_limbs(torch.zeros(a_shape, dtype=torch.complex64),
                                torch.zeros(b_shape, dtype=torch.complex64),
                                torch.as_tensor(starts, dtype=torch.int32), w)
    with pytest.raises(ValueError, match="integer"):
        pk.check_window_starts(good[:, :3], w, a_shape, b_shape)


def test_cpu_tensors_run_the_plain_versions():
    """CPU inputs never touch the CUDA library and never count a launch."""
    pk.reset_launch_counts()
    x, t0 = _operands(1, 32, 24, 8)
    t_limbs, t_scales = _port_t(t0)
    pk.window_product_limbs(torch.as_tensor(x), torch.as_tensor(x[0]),
                            torch.zeros((1, 4), dtype=torch.int32), 24)
    y_limbs, y_scales = pk.row_transform_int8(torch.as_tensor(x), t_limbs, t_scales)
    pk.column_intensity_int8(y_limbs, y_scales, t_limbs, t_scales, torch.ones(1))
    assert set(pk.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):  # no silent device mixing
        pk.row_requantize(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3, device="meta"), 32)

