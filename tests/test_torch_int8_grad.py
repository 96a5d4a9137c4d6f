"""Port parity: gradients through the port's int8 engine (device='cpu',
where each kernel wrapper runs its plain version).

The int8 chunk is a torch.autograd.Function whose backward re-forms X and
differentiates the float32 3M contraction, as the JAX package's
custom_vjp does (ops/abbe.py bwd). Held to jax.grad of the JAX package's
float32 path on the same inputs (its accumulate_intensity on the matmul
engine, i.e. _intensity_windowed_3m of the same windowed X) within
atol = 1e-6 * max|g|, JAX's own class (tests/test_pallas_kernel.py:200-202),
for the spectrum and the pupil. The weights' gradient, sum(M |E_b|^2) over
the n^2 pixels, is held to a float64 evaluation of the same sum at that
class: JAX's float32 reduction of it lies 1.3e-6 * max|g| from the float64
value at this size and the port's 1.3e-7, so against JAX the pair would
measure JAX's rounding (ROADMAP.md Queue 3, F4). socs_image's int8 apply
against the matmul engine's autograd (tests/test_hopkins.py:175). Without
gradients the engine still makes four kernel calls a chunk, builds no
graph and gives the same image bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu as jt
import lithographysimulator_tpu_torch as pt
from lithographysimulator_tpu.ops import abbe as ja
from lithographysimulator_tpu.ops import hopkins as jh
from lithographysimulator_tpu_torch.interop import config_from_jax
from lithographysimulator_tpu_torch.ops import abbe as pa

CFG = jt.OpticsConfig(pixel_number=32)
PCFG = config_from_jax(CFG)
ABERR = np.array([0, 0, 0.05, 0.03, 30, 0.02, 0, 0.04], np.float32)
SRC = np.asarray(jt.LightSource(CFG, sigma_in=0.2, sigma_out=0.6,
                                shift_x=0.1).annular())
CHUNK = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    """Host spectrum, pupil, padded points and the fixed random image
    weighting M of the loss sum(image * M)."""
    spectrum = np.array(jt.mask_spectrum(jt.demo_bars(CFG).geometry, CFG))
    pupil = np.array(jt.pupil_function(ABERR, CFG))
    pts = ja.source_points(SRC)
    shifts, weights = ja._pad_points(pts.shifts, pts.weights, CHUNK)
    # a positive weighting, as an image-space loss weight is: with signed
    # M the weights' gradient sum(M |E_b|^2) cancels to float32 noise
    m = (0.5 + np.random.default_rng(19).random((CFG.n, CFG.n))).astype(np.float32)
    return spectrum, pupil, shifts, weights, m


def _jax_grads(spectrum, pupil, shifts, weights, m):
    """jax.grad of sum(image * M) through the JAX package's float32
    windowed path, over real (re, im) parametrizations of the complex
    inputs: (d spectrum, d pupil) as (2, n, n) each, and d weights."""
    max_shift = int(np.abs(shifts).max())

    def loss(s_parts, p_parts, w):
        img = ja.accumulate_intensity(
            p_parts[0] + 1j * p_parts[1], s_parts[0] + 1j * s_parts[1],
            jnp.asarray(shifts), w, CFG, chunk=CHUNK, engine="matmul",
            max_abs_shift=max_shift)
        return jnp.sum(img * m)

    def parts(z):
        return jnp.stack([jnp.real(z), jnp.imag(z)]).astype(jnp.float32)

    gs, gp, gw = jax.grad(loss, argnums=(0, 1, 2))(
        parts(spectrum), parts(pupil), jnp.asarray(weights))
    return np.asarray(gs), np.asarray(gp), np.asarray(gw)


def _port_grads(spectrum, pupil, shifts, weights, m, engine):
    s = torch.as_tensor(spectrum).requires_grad_()
    p = torch.as_tensor(pupil).requires_grad_()
    w = torch.as_tensor(weights).requires_grad_()
    img = pa.accumulate_intensity(p, s, shifts, w, PCFG, chunk=CHUNK,
                                  engine=engine,
                                  max_abs_shift=int(np.abs(shifts).max()))
    (img * torch.as_tensor(m)).sum().backward()
    # torch's gradient of a real loss in a complex leaf is dL/dRe + i dL/dIm
    return (np.stack([s.grad.real.numpy(), s.grad.imag.numpy()]),
            np.stack([p.grad.real.numpy(), p.grad.imag.numpy()]),
            w.grad.numpy())


def _close(g, ref) -> None:
    np.testing.assert_allclose(g, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def _weights_grad_f64(spectrum, pupil, shifts, weights, m):
    """d sum(image * M) / d w_b = sum(M |E_b|^2), each point's intensity
    from the fft engine in complex128."""
    kw = dict(chunk=CHUNK, engine="fft", max_abs_shift=int(np.abs(shifts).max()))
    p = torch.as_tensor(pupil, dtype=torch.complex128)
    s = torch.as_tensor(spectrum, dtype=torch.complex128)
    mt = torch.as_tensor(m, dtype=torch.float64)
    grads = []
    for b in range(len(weights)):
        one = torch.zeros(len(weights), dtype=torch.float64)
        one[b] = 1.0
        grads.append(float((pa.accumulate_intensity(p, s, shifts, one, PCFG,
                                                    **kw) * mt).sum()))
    return np.asarray(grads)


@pytest.fixture(scope="module")
def reference_grads(inputs):
    gs, gp, _ = _jax_grads(*inputs)
    return gs, gp, _weights_grad_f64(*inputs)


@pytest.mark.parametrize("engine", ["int8", "int8_fast", "pallas"])
def test_int8_gradients_match_jax_f32_vjp(inputs, reference_grads, engine):
    for g, r, name in zip(_port_grads(*inputs, engine), reference_grads,
                          ("spectrum", "pupil", "weights")):
        assert np.abs(r).max() > 0, name
        _close(g, r)


class _Count:
    """Counts the int8 chunk's kernel-wrapper calls made through the
    engine (the plain versions run on the CPU)."""

    NAMES = ("window_product_limbs", "row_limb_gemm", "row_requantize",
             "column_intensity_int8")

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            fn = getattr(pa, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)

            monkeypatch.setattr(pa, name, counted)


def test_no_grad_path_unchanged_and_grad_path_uses_the_kernels(inputs,
                                                               monkeypatch):
    """Without gradients: four kernel calls a chunk, no graph, and the same
    image bit for bit as the forward of the differentiable path, which also
    runs the four kernels a chunk (no silent matmul fallback)."""
    spectrum, pupil, shifts, weights, _ = inputs
    chunks = len(weights) // CHUNK
    count = _Count(monkeypatch)
    kw = dict(chunk=CHUNK, engine="int8", max_abs_shift=int(np.abs(shifts).max()))
    plain = pa.accumulate_intensity(torch.as_tensor(pupil),
                                    torch.as_tensor(spectrum), shifts,
                                    torch.as_tensor(weights), PCFG, **kw)
    assert not plain.requires_grad and plain.grad_fn is None
    assert count.calls == dict.fromkeys(_Count.NAMES, chunks)
    s = torch.as_tensor(spectrum).requires_grad_()
    graded = pa.accumulate_intensity(torch.as_tensor(pupil), s, shifts,
                                     torch.as_tensor(weights), PCFG, **kw)
    assert graded.requires_grad
    assert count.calls == dict.fromkeys(_Count.NAMES, 2 * chunks)
    np.testing.assert_array_equal(graded.detach().numpy(), plain.numpy())
    with torch.no_grad():
        again = pa.accumulate_intensity(torch.as_tensor(pupil), s, shifts,
                                        torch.as_tensor(weights), PCFG, **kw)
    assert again.grad_fn is None
    np.testing.assert_array_equal(again.numpy(), plain.numpy())


@pytest.fixture(scope="module")
def socs(inputs):
    """A rank-8 exact JAX kernel set, carried over to the port."""
    ref = jh.tcc_eigensystem(inputs[1], SRC, CFG, rank=8)
    return ref, np.array(ref.kernels), np.array(ref.eigenvalues)


def test_socs_image_int8_gradient_matches_matmul_and_jax(inputs, socs):
    """socs_image's int8 apply is differentiable in the spectrum, the
    kernels and the eigenvalues, and its gradients equal the matmul
    engine's autograd; the spectrum's also equals jax.grad of the JAX
    package's matmul apply on the same kernels."""
    spectrum, _, _, _, m = inputs
    ref_socs, kernels, eigs = socs
    mt = torch.as_tensor(m)
    grads = {}
    for engine in ("int8", "matmul"):
        k = torch.as_tensor(kernels).requires_grad_()
        lam = torch.as_tensor(eigs).requires_grad_()
        s = torch.as_tensor(spectrum).requires_grad_()
        img = pt.socs_image(s, pt.SOCSKernels(kernels=k, eigenvalues=lam,
                                              total_rank=ref_socs.total_rank),
                            PCFG, engine=engine)
        (img * mt).sum().backward()
        grads[engine] = [x.grad.numpy() for x in (s, k, lam)]
    for g, r in zip(grads["int8"], grads["matmul"]):
        assert np.isfinite(g).all() and np.abs(r).max() > 0
        _close(g, r)

    def loss(parts):
        img = jh.socs_image(parts[0] + 1j * parts[1], ref_socs, CFG,
                            engine="matmul")
        return jnp.sum(img * m)

    parts = jnp.stack([jnp.real(spectrum), jnp.imag(spectrum)]).astype(jnp.float32)
    g_jax = np.asarray(jax.grad(loss)(parts))
    g_s = grads["int8"][0]
    _close(np.stack([g_s.real, g_s.imag]), g_jax)


@pytest.mark.parametrize("engine", ["fft", "int8"])
def test_normalized_image_keeps_the_weights_sum_in_the_graph(inputs, engine):
    """abbe_image_points(normalize=True) divides by the weights' sum as a
    tensor, so the weights' gradient has its term through the sum, as in
    the JAX package (ROADMAP.md Queue 3, F5: a float sum left it out, and
    the gradient lay 74.6 * max|g| from JAX's). Held to a float64
    evaluation of the same normalized image at 1e-5 * max|g|: the two
    terms nearly cancel (measured: fft 1.9e-6, int8 1.6e-6)."""
    spectrum, pupil, shifts, weights, m = inputs
    w = torch.as_tensor(weights).requires_grad_()
    img = pa.abbe_image_points(spectrum, pupil, shifts, w, PCFG, device="cpu",
                               chunk=CHUNK, normalize=True, engine=engine)
    (img * torch.as_tensor(m)).sum().backward()
    w64 = torch.as_tensor(weights, dtype=torch.float64).requires_grad_()
    img64 = pa.accumulate_intensity(
        torch.as_tensor(pupil, dtype=torch.complex128),
        torch.as_tensor(spectrum, dtype=torch.complex128), shifts, w64, PCFG,
        chunk=CHUNK, engine="fft", max_abs_shift=int(np.abs(shifts).max()))
    img64 = pa.postprocess_gau23(img64, PCFG) / w64.sum()
    (img64 * torch.as_tensor(m, dtype=torch.float64)).sum().backward()
    ref = w64.grad.numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(w.grad.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
