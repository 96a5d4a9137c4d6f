"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version, and the int8 engine end to end. They skip without a
CUDA device. The GPU host has no jax, so this file imports neither jax nor
``tests/conftest.py``; run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: 1e-6 normalized RMS, the int8 engine's accuracy class (the
kernels and the plain versions differ only in f32 rounding order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TOL = 1e-6


def _nrms(a, b) -> float:
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.sqrt(np.mean(np.abs(a - b) ** 2)) / np.abs(b).max())


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int8 kernels have no CPU mode")
    return torch.device("cuda")


def _deq(limbs, scales):
    l = limbs.double()
    return ((l[:, 0] + l[:, 1] / 256.0 + l[:, 2] / 65536.0)
            * scales.double()[..., None]).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("b,n,w", [(3, 96, 40), (2, 256, 136)])
def test_kernels_match_plain(b, n, w, fast):
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    rng = np.random.default_rng(n + w)
    x = torch.as_tensor((rng.normal(size=(b, w, w)) + 1j * rng.normal(size=(b, w, w))
                         ).astype(np.complex64), device=dev)
    t0 = np.exp(1j * rng.normal(size=(n, w))).astype(np.complex64)
    t_limbs, t_scales = ik.prepare_t0_limbs(torch.as_tensor(t0.real, device=dev),
                                            torch.as_tensor(t0.imag, device=dev))
    args = (*ik.quantize_x(x), t_limbs, t_scales)
    before = dict(ik.LAUNCHES)
    yr, yi = ik.row_limb_gemm(*args, fast=fast)
    pr, pi = ik.row_limb_gemm_plain(*args, fast=fast)
    assert _nrms(torch.complex(yr, yi).cpu(), torch.complex(pr, pi).cpu()) < TOL
    kp = t_limbs.shape[-1]
    assert _nrms(_deq(*ik.row_requantize(pr, pi, kp)),
                 _deq(*ik.row_requantize_plain(pr, pi, kp))) < TOL
    y_limbs, y_scales = ik.row_requantize_plain(pr, pi, kp)
    weights = torch.as_tensor(rng.random(b).astype(np.float32), device=dev)
    cargs = (y_limbs, y_scales, t_limbs, t_scales, weights)
    img = ik.column_intensity_int8(*cargs, fast=fast)
    ref = ik.column_intensity_int8_plain(*cargs, fast=fast)
    assert _nrms(img.cpu(), ref.cpu()) < TOL
    torch.cuda.synchronize()
    assert all(ik.LAUNCHES[k] == before[k] + 1 for k in before)


@pytest.mark.cuda
def test_int8_engine_end_to_end():
    """simulate() on the card runs the kernels and agrees with the fft engine."""
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.ops import abbe
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    _cuda()
    cfg = lt.OpticsConfig(pixel_number=128)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    ik.reset_launch_counts()
    res = lt.simulate(lt.demo_bars(cfg, device="cuda"), src, [0, 0, 0.01, 0, 50],
                      device="cuda")
    assert min(ik.LAUNCHES.values()) > 0
    fft = abbe.abbe_image(res.spectrum, res.pupil, src, cfg, device="cuda",
                          engine="fft")
    assert _nrms(res.image.cpu(), fft.cpu()) < 1e-5
