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


def test_cpu_tensors_run_the_plain_versions():
    """CPU inputs never touch the CUDA library and never count a launch."""
    pk.reset_launch_counts()
    x, t0 = _operands(1, 32, 24, 8)
    t_limbs, t_scales = _port_t(t0)
    y_limbs, y_scales = pk.row_transform_int8(torch.as_tensor(x), t_limbs, t_scales)
    pk.column_intensity_int8(y_limbs, y_scales, t_limbs, t_scales, torch.ones(1))
    assert set(pk.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):  # no silent device mixing
        pk.row_requantize(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3, device="meta"), 32)

