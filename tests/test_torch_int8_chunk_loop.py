"""The int8 chunk loop's dispatch, without a card.

On the card ``ops/abbe.int8_intensity`` hands a whole apply or exact pass,
with or without gradients, to ``intensity_int8.int8_chunk_loop``, which
issues every chunk from native code in one host call; on CPU tensors each
chunk runs through the four wrappers' plain versions. Here:

* off CUDA, with and without grad, the SOCS apply and the exact pass
  launch nothing and give the plain per-chunk composition bit for bit;
* the SOCS apply and the exact engine's passes read one T0 cache
  (``abbe.t0_operands``);
* the rows that the native loop reads (``chunk_table``) are what the
  per-chunk loop passes to the wrappers: the addresses of ``a[c:c+chunk]``
  (or of the one array), ``starts[c:c+chunk]`` and ``weights[c:c+chunk]``,
  the arrays a chunk reads and its batch, a short last chunk included;
* the wrapper hands the table, the operands, the workspace and the sizes
  to the library (a stub in place of ``load_library()``), counts the
  launches, and raises naming the kernel and chunk of a refused
  launch.

The card tests (``tests/test_torch_cuda.py``) hold the native loop's image
to the per-chunk path's bit for bit."""

import contextlib
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lithographysimulator_tpu_torch as pt  # noqa: E402
from lithographysimulator_tpu_torch.ops import abbe as pa  # noqa: E402
from lithographysimulator_tpu_torch.ops import hopkins as ph  # noqa: E402
from lithographysimulator_tpu_torch.ops.kernels import build  # noqa: E402
from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik  # noqa: E402

N = 32
CHUNK = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run's workers share the cores: one torch thread each
    keeps them from oversubscribing. No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cplx(rng, *shape):
    return torch.as_tensor((rng.normal(size=shape) + 1j * rng.normal(size=shape))
                           .astype(np.complex64))


def _operands(kind: str, count: int, seed: int = 0):
    """(a, b, starts, w, t_limbs, t_scales, weights) as the two callers
    pass them: ``exact``, windows of one tiled (1, 2N, 2N) pupil at w < N;
    ``socs``, one (N, N) kernel a window, w = N, zero starts."""
    rng = np.random.default_rng(seed)
    b = _cplx(rng, N, N)
    if kind == "exact":
        w = 24
        a = _cplx(rng, 1, 2 * N, 2 * N)
        starts = np.stack([rng.integers(0, 2 * N - w + 1, count),
                           rng.integers(0, 2 * N - w + 1, count),
                           rng.integers(0, N - w + 1, count),
                           rng.integers(0, N - w + 1, count)], axis=1)
    else:
        w = N
        a = _cplx(rng, count, N, N)
        starts = np.zeros((count, 4), np.int64)
    starts = torch.as_tensor(ik.check_window_starts(starts, w, a.shape, b.shape))
    t0 = np.exp(1j * rng.normal(size=(N, w))).astype(np.complex64)
    t_limbs, t_scales = ik.prepare_t0_limbs(torch.as_tensor(t0.real),
                                            torch.as_tensor(t0.imag))
    weights = torch.as_tensor(rng.random(count).astype(np.float32))
    return a, b, starts, w, t_limbs, t_scales, weights


def _per_chunk_rows(a, starts, weights, chunk):
    """What the per-chunk loop passes for each chunk, as table rows."""
    rows = []
    for c in range(0, starts.shape[0], chunk):
        a_c = a[c:c + chunk] if a.shape[0] > 1 else a
        s_c, w_c = starts[c:c + chunk], weights[c:c + chunk]
        rows.append([a_c.data_ptr(), a_c.shape[0], s_c.data_ptr(),
                     w_c.data_ptr(), s_c.shape[0]])
    return np.array(rows, np.int64)


CASES = [("exact", 8, 4), ("exact", 6, 4), ("socs", 256, 4), ("socs", 6, 4),
         ("socs", 3, 1), ("socs", 1, 4)]


@pytest.mark.parametrize("kind,count,chunk", CASES)
def test_chunk_table_matches_the_per_chunk_slices(kind, count, chunk):
    a, _, starts, _, _, _, weights = _operands(kind, count)
    table = ik.chunk_table(a, starts, weights, chunk)
    assert table.dtype == np.int64 and table.shape == (-(-count // chunk), 5)
    np.testing.assert_array_equal(table, _per_chunk_rows(a, starts, weights, chunk))


class _StubLibrary:
    """Stands in for the built library: records each int8_chunk_loop call
    (the table read from its address while the call lasts) and returns
    ``err`` after writing ``where``."""

    def __init__(self, err=0, where=(0, 0)):
        self.err, self.where, self.calls = err, where, []

    def int8_chunk_loop(self, *args):
        table_addr, chunks = args[0], args[1]
        table = np.ctypeslib.as_array(
            (ctypes.c_int64 * (5 * chunks)).from_address(table_addr)).reshape(chunks, 5)
        where = np.ctypeslib.as_array((ctypes.c_int32 * 2).from_address(args[20]))
        where[:] = self.where
        self.calls.append({"table": table.copy(), "args": args})
        return self.err


@pytest.fixture()
def stub(monkeypatch):
    """The wrapper's native branch on CPU tensors: every tensor counts as
    on the card, the device context yields a fake stream handle, and the
    library is a :class:`_StubLibrary`."""
    lib = _StubLibrary()

    @contextlib.contextmanager
    def fake_stream(device):
        yield 0xC0FFEE

    monkeypatch.setattr(ik, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(ik, "_device_stream", fake_stream)
    monkeypatch.setattr(build, "load_library", lambda: lib)
    return lib


def _counts():
    return dict(ik.LAUNCHES)


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("kind,count,chunk", CASES)
def test_native_loop_hands_its_operands_to_the_library(stub, kind, count, chunk,
                                                       fast):
    a, b, starts, w, t_limbs, t_scales, weights = _operands(kind, count)
    out = torch.zeros((N, N), dtype=torch.float32)
    launches = _counts()
    got = ik.int8_chunk_loop(a, b, starts, w, t_limbs, t_scales, weights,
                             chunk=chunk, fast=fast, out=out)
    assert got is out
    (call,) = stub.calls
    args = call["args"]
    assert len(args) == len(build.SIGNATURES["int8_chunk_loop"])
    n_chunks = -(-count // chunk)
    assert args[1] == n_chunks
    np.testing.assert_array_equal(call["table"],
                                  _per_chunk_rows(a, starts, weights, chunk))
    assert args[2:5] == (b.data_ptr(), t_limbs.data_ptr(), t_scales.data_ptr())
    assert args[11] == out.data_ptr()
    kp = ik.padded_width(w)
    assert args[12:20] == (a.shape[1], a.shape[2], N, N, N, w, kp, int(fast))
    assert args[21] == 0xC0FFEE
    # six workspace buffers, one chunk's, none of them an operand
    work = args[5:11]
    assert len(set(work)) == 6 and not set(work) & {
        a.data_ptr(), b.data_ptr(), out.data_ptr(), starts.data_ptr()}
    per_kernel = {k: n_chunks for k in ik.CHUNK_KERNELS}
    assert _delta(launches, ik.LAUNCHES) == per_kernel


@pytest.mark.parametrize("where,name,issued", [
    ((0, 0), "window_product_limbs", 0), ((0, 1), "row_limb_gemm", 1),
    ((1, 2), "row_requantize", 6), ((1, 3), "column_intensity", 7)])
def test_refused_launch_in_the_loop_names_kernel_and_chunk(stub, where, name,
                                                           issued):
    stub.err, stub.where = 9, where
    a, b, starts, w, t_limbs, t_scales, weights = _operands("socs", 6)
    out = torch.zeros((N, N), dtype=torch.float32)
    launches = _counts()
    with pytest.raises(RuntimeError,
                       match=f"{name} failed to launch in chunk {where[0]} of 2"):
        ik.int8_chunk_loop(a, b, starts, w, t_limbs, t_scales, weights,
                           chunk=CHUNK, out=out)
    # the launches before the refused one were issued, and are counted
    assert _delta(launches, ik.LAUNCHES) == {
        k: issued // 4 + (i < issued % 4) for i, k in enumerate(ik.CHUNK_KERNELS)}


def test_native_loop_refuses_what_the_kernels_cannot_take(stub):
    a, b, starts, w, t_limbs, t_scales, weights = _operands("socs", 6)
    out = torch.zeros((N, N), dtype=torch.float32)
    bad = {
        "weights": dict(weights=weights[:5]),
        "holds 3 arrays": dict(a=a[:3]),
        "padded_width": dict(t_limbs=torch.zeros((3, 3, N, 64), dtype=torch.int8)),
        "out": dict(out=torch.zeros((N, N + 1), dtype=torch.float32)),
        "starts": dict(starts=starts.to(torch.int64)),
        "chunk=0": dict(chunk=0),
    }
    base = dict(a=a, b=b, starts=starts, w=w, t_limbs=t_limbs,
                t_scales=t_scales, weights=weights, chunk=CHUNK, out=out)
    for message, change in bad.items():
        with pytest.raises(ValueError, match=message):
            ik.int8_chunk_loop(**{**base, **change})
    assert not stub.calls


def test_native_loop_takes_cuda_tensors_only():
    a, b, starts, w, t_limbs, t_scales, weights = _operands("socs", 6)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ik.int8_chunk_loop(a, b, starts, w, t_limbs, t_scales, weights,
                           chunk=CHUNK, out=torch.zeros((N, N)))


def _socs_call(rank: int):
    rng = np.random.default_rng(rank)
    cfg = pt.OpticsConfig(pixel_number=N)
    socs = ph.SOCSKernels(kernels=_cplx(rng, rank, N, N),
                          eigenvalues=torch.as_tensor(
                              np.sort(rng.random(rank))[::-1].astype(np.float32).copy()))
    return _cplx(rng, N, N), socs, cfg


def _exact_inputs():
    cfg = pt.OpticsConfig(pixel_number=N)
    src = pt.LightSource(cfg, sigma_in=0.2, sigma_out=0.6).annular()
    pupil = pt.pupil_function(np.array([0, 0, 0.05, 0.03, 30], np.float32), cfg,
                              device="cpu")
    spectrum = pt.mask_spectrum(pt.demo_bars(cfg, device="cpu").geometry, cfg)
    return cfg, src, pupil, spectrum


def _planes(t0: np.ndarray):
    return (torch.as_tensor(t0.real, dtype=torch.float32),
            torch.as_tensor(t0.imag, dtype=torch.float32))


def _plain_image(a, b, starts, w, t0, weights, cfg):
    """The plain per-chunk composition: the four kernels' plain versions,
    CHUNK windows a chunk, added into zeros, then post-processed."""
    t_limbs, t_scales = ik.prepare_t0_limbs(*_planes(t0))
    out = torch.zeros((N, N))
    for c in range(0, starts.shape[0], CHUNK):
        x = ik.window_product_limbs_plain(a[c:c + CHUNK] if a.shape[0] > 1 else a,
                                          b, starts[c:c + CHUNK], w)
        y = ik.row_limb_gemm_plain(*x, t_limbs, t_scales)
        y = ik.row_requantize_plain(*y, t_limbs.shape[-1])
        ik.column_intensity_int8_plain(*y, t_limbs, t_scales,
                                       weights[c:c + CHUNK], out=out)
    return pa.postprocess_gau23(out, cfg)


@pytest.mark.parametrize("rank", [6, 8])
def test_socs_apply_off_cuda_runs_the_per_chunk_path(rank):
    spectrum, socs, cfg = _socs_call(rank)
    launches = _counts()
    img = pt.socs_image(spectrum, socs, cfg, engine="int8")
    assert _delta(launches, ik.LAUNCHES) == dict.fromkeys(ik.CHUNK_KERNELS, 0)
    ref = _plain_image(socs.kernels, spectrum,
                       torch.zeros((rank, 4), dtype=torch.int32), N,
                       pa._zoom_dft_kernel(N, cfg.wavelength_scaling().fft_size),
                       socs.eigenvalues, cfg)
    assert torch.equal(img, ref)


@pytest.mark.parametrize("grad", [False, True])
def test_exact_pass_off_cuda_and_under_grad_runs_the_per_chunk_path(grad):
    cfg, src, pupil, spectrum = _exact_inputs()
    spectrum = spectrum.detach().clone().requires_grad_(grad)
    launches = _counts()
    img = pa.abbe_image(spectrum, pupil, src, cfg, device="cpu", engine="int8")
    assert img.requires_grad == grad
    assert _delta(launches, ik.LAUNCHES) == dict.fromkeys(ik.CHUNK_KERNELS, 0)
    pts = pa.source_points(src)
    shifts, weights = pa._pad_points(pts.shifts, pts.weights, CHUNK)
    w = pa._window_size(N)
    a = pupil.repeat(2, 2)[None]
    starts = torch.as_tensor(ik.check_window_starts(
        pa._window_starts(shifts, N, w, N // 4 - 1), w, a.shape, spectrum.shape))
    ref = _plain_image(a, spectrum.detach(), starts, w,
                       pa._zoom_dft_window(N, cfg.wavelength_scaling().fft_size),
                       torch.as_tensor(weights), cfg)
    assert torch.equal(img.detach(), ref)
    if grad:
        img.sum().backward()
        assert spectrum.grad is not None and torch.isfinite(spectrum.grad).all()


@pytest.mark.parametrize("engine", ["int8", "matmul"])
def test_socs_apply_and_exact_passes_share_one_t0_cache(engine):
    """One configuration's SOCS apply (T0 the whole chirp, w = N) and two
    exact passes on ``engine`` (T0 the window) read one T0 cache: a miss
    for each width, then hits; its entries are the planes the engines
    formed inline before, and their limbs."""
    spectrum, socs, cfg = _socs_call(6)
    _, src, pupil, exact_spectrum = _exact_inputs()
    fft_size = cfg.wavelength_scaling().fft_size
    pa.t0_operands.cache_clear()
    pt.socs_image(spectrum, socs, cfg, engine="int8")
    for _ in range(2):
        pa.abbe_image(exact_spectrum, pupil, src, cfg, device="cpu",
                      engine=engine)
    info = pa.t0_operands.cache_info()
    assert (info.misses, info.hits, info.currsize) == (2, 1, 2)
    pt.socs_image(spectrum, socs, cfg, engine="int8")
    assert pa.t0_operands.cache_info().hits == 2
    for w, t0 in ((N, pa._zoom_dft_kernel(N, fft_size)),
                  (pa._window_size(N), pa._zoom_dft_window(N, fft_size))):
        got = pa.t0_operands(N, fft_size, w, torch.device("cpu"))
        planes = _planes(t0)
        for x, y in zip(got, (*planes, *ik.prepare_t0_limbs(*planes))):
            assert torch.equal(x, y)
    pa.t0_operands.cache_clear()
