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


def _operands(ik, dev, b, n, w):
    """X's limbs and scales from the plain window_product_limbs, T0's limbs
    and scales, and the window operands (a, b, starts), from seed n + w:
    for w < n windows of a tiled 2n x 2n array and an n x n one at odd
    columns (8-byte aligned rows), for w = n whole arrays at zero starts."""
    rng = np.random.default_rng(n + w)

    def cplx(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)

    if w == n:
        a, bb, starts = cplx(b, n, n), cplx(n, n), np.zeros((b, 4), np.int64)
    else:
        a, bb = cplx(1, 2 * n, 2 * n), cplx(n, n)
        starts = np.stack([rng.integers(0, 2 * n - w + 1, b),
                           rng.integers(0, (2 * n - w) // 2, b) * 2 + 1,
                           rng.integers(0, n - w + 1, b),
                           rng.integers(0, (n - w) // 2, b) * 2 + 1], axis=1)
    starts = ik.check_window_starts(starts, w, a.shape, bb.shape)
    window = (torch.as_tensor(a, device=dev), torch.as_tensor(bb, device=dev),
              torch.as_tensor(starts, device=dev), w)
    t0 = np.exp(1j * rng.normal(size=(n, w))).astype(np.complex64)
    t_limbs, t_scales = ik.prepare_t0_limbs(torch.as_tensor(t0.real, device=dev),
                                            torch.as_tensor(t0.imag, device=dev))
    return (*ik.window_product_limbs_plain(*window), t_limbs, t_scales), window, rng


def _assert_same_limbs(kernel, plain):
    """Limbs and scales equal bit for bit (scales as bits: NaN == NaN)."""
    assert torch.equal(kernel[0], plain[0])
    assert torch.equal(kernel[1].view(torch.int32), plain[1].view(torch.int32))


# Shapes at every edge of the 64 x 64 output tiles and the 64-byte K stages:
# B = 1; n and w neither multiples of 64 nor of the stage (kp = 160, 288,
# where the last stage is half full); a tiny ragged one; odd w (37: the
# quantizers' scalar loads); and the SOCS apply's (4, 1024, 1024).
@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("b,n,w", [(3, 96, 40), (2, 256, 136), (1, 200, 136),
                                   (2, 328, 264), (2, 64, 37), (4, 1024, 1024)])
def test_kernels_match_plain(b, n, w, fast):
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    args, window, rng = _operands(ik, dev, b, n, w)
    t_limbs, t_scales = args[2], args[3]
    kp = t_limbs.shape[-1]
    before = dict(ik.LAUNCHES)
    # the two quantizers give the plain versions' limbs and scales bit for bit
    _assert_same_limbs(ik.window_product_limbs(*window), args[:2])
    yr, yi = ik.row_limb_gemm(*args, fast=fast)
    pr, pi = ik.row_limb_gemm_plain(*args, fast=fast)
    assert _nrms(torch.complex(yr, yi).cpu(), torch.complex(pr, pi).cpu()) < TOL
    y_limbs, y_scales = ik.row_requantize_plain(pr, pi, kp)
    _assert_same_limbs(ik.row_requantize(pr, pi, kp), (y_limbs, y_scales))
    weights = torch.as_tensor(rng.random(b).astype(np.float32), device=dev)
    cargs = (y_limbs, y_scales, t_limbs, t_scales, weights)
    img = ik.column_intensity_int8(*cargs, fast=fast)
    ref = ik.column_intensity_int8_plain(*cargs, fast=fast)
    assert _nrms(img.cpu(), ref.cpu()) < TOL
    torch.cuda.synchronize()
    assert all(ik.LAUNCHES[k] == before[k] + 1 for k in before)


def _gemm_operands(ik, dev, b, n, w):
    """row_limb_gemm's operands and column_intensity's (Y's limbs from the
    plain row_limb_gemm and row_requantize, weights from the seed)."""
    args, _, rng = _operands(ik, dev, b, n, w)
    y_limbs, y_scales = ik.row_requantize_plain(
        *ik.row_limb_gemm_plain(*args), args[2].shape[-1])
    weights = torch.as_tensor(rng.random(b).astype(np.float32), device=dev)
    return args, (y_limbs, y_scales, args[2], args[3], weights)


# The GEMM kernels at the edges of their grids and rings: more 128 x 64
# tiles than the H100's 132 SMs and not a multiple of them (row_limb_gemm
# 459 and column_intensity 162 at (3, 1152, 1088); 2048 and 512 at (4, 2048,
# 2048)), fewer (the other three), a last 128-byte K slab partly zero-filled
# (kp 1088, 224, 608, 320), batch 1 and batch 8, even and odd w.
@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("b,n,w", [(3, 1152, 1088), (4, 2048, 2048), (2, 256, 200),
                                   (1, 640, 600), (8, 384, 320), (2, 200, 131)])
def test_gemm_tile_edges_match_plain(b, n, w, fast):
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    args, cargs = _gemm_operands(ik, dev, b, n, w)
    yr, yi = ik.row_limb_gemm(*args, fast=fast)
    pr, pi = ik.row_limb_gemm_plain(*args, fast=fast)
    assert _nrms(torch.complex(yr, yi).cpu(), torch.complex(pr, pi).cpu()) < TOL
    img = ik.column_intensity_int8(*cargs, fast=fast)
    ref = ik.column_intensity_int8_plain(*cargs, fast=fast)
    assert _nrms(img.cpu(), ref.cpu()) < TOL


# Two launches on the same inputs give the same bits (one block sums an
# output tile over (b, plane) in order, with no atomics, whichever warp
# refills the ring), and a given `out` receives exactly out + the image: the
# kernel adds its tile sum once.
@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("b,n,w", [(3, 1152, 1088), (4, 1024, 1024)])
def test_gemm_kernels_repeat_bit_for_bit(b, n, w, fast):
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    args, cargs = _gemm_operands(ik, dev, b, n, w)
    first, second = (ik.row_limb_gemm(*args, fast=fast) for _ in range(2))
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    img = ik.column_intensity_int8(*cargs, fast=fast)
    assert torch.equal(img, ik.column_intensity_int8(*cargs, fast=fast))
    base = torch.as_tensor(np.random.default_rng(n).random((n, n), np.float32),
                           device=dev)
    out = ik.column_intensity_int8(*cargs, fast=fast, out=base.clone())
    assert torch.equal(out, base + img)


# Rows wider than one thread a segment (kp > 16 * 512 = 8192): the kernel
# loops over a row's segments; 16-byte loads (w % 4 == 0) and scalar ones.
@pytest.mark.cuda
@pytest.mark.parametrize("rows,w", [(3, 8200), (2, 9001), (1, 20000)])
def test_row_requantize_wide_rows(rows, w):
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    rng = np.random.default_rng(w)
    yr, yi = (torch.as_tensor(rng.normal(size=(1, rows, w)).astype(np.float32),
                              device=dev) for _ in range(2))
    kp = ik.padded_width(w)
    _assert_same_limbs(ik.row_requantize(yr, yi, kp),
                       ik.row_requantize_plain(yr, yi, kp))


@pytest.mark.cuda
def test_window_outside_its_operand_gives_nan_scales():
    """The kernel never syncs to check starts (the host does, once): a
    window past its operand reads nothing and poisons its scales."""
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    a = torch.ones((1, 128, 128), dtype=torch.complex64, device=dev)
    b = torch.ones((64, 64), dtype=torch.complex64, device=dev)
    starts = torch.tensor([[0, 0, 0, 0], [0, 0, 30, 0]], dtype=torch.int32, device=dev)
    _, scales = ik.window_product_limbs(a, b, starts, 40)
    scales = scales.cpu()
    # products 1 + 0i: planes r and r + i have max 1, plane i is all zero
    torch.testing.assert_close(scales[:, 0], torch.tensor(
        [[1.0 / 127.0], [65536.0], [1.0 / 127.0]]).expand(3, 40))
    assert scales[:, 1].isnan().all()


def _window_path_case(case, dev):
    """Operands (a, b, starts, w) of window_product_limbs for one of its
    launch paths, and the (path, cluster) its plan must choose."""
    rng = np.random.default_rng(7)

    def cplx(*shape):
        return torch.as_tensor((rng.normal(size=shape) + 1j * rng.normal(size=shape)
                                ).astype(np.complex64), device=dev)

    def odd_starts(batch, a_side, b_side, w):
        return np.stack([rng.integers(0, a_side - w + 1, batch),
                         rng.integers(0, (a_side - w) // 2, batch) * 2 + 1,
                         rng.integers(0, b_side - w + 1, batch),
                         rng.integers(0, (b_side - w) // 2, batch) * 2 + 1], axis=1)

    if case == "cluster":      # the SOCS apply at 2048^2: 8 blocks a strip
        a, b, w, starts = cplx(4, 2048, 2048), cplx(2048, 2048), 2048, np.zeros((4, 4))
        expect = ("tma", 8)
    elif case == "per-thread":  # odd row pitches, exact-like odd starts
        a, b, w = cplx(1, 2047, 2047), cplx(1025, 1025), 520
        starts, expect = odd_starts(4, 2047, 1025, w), ("per-thread", 2)
    elif case == "per-thread-socs":  # odd pitches, whole arrays, w % 16 = 15
        a, b, w, starts = cplx(4, 1023, 1023), cplx(1023, 1023), 1023, np.zeros((4, 4))
        expect = ("per-thread", 4)
    elif case == "a-batch-1":  # one shared a for B = 4 windows
        a, b, w = cplx(1, 2048, 2048), cplx(1040, 1040), 1024
        starts, expect = odd_starts(4, 2048, 1040, w), ("tma", 4)
    elif case == "last-start":  # every window at its last valid start
        a, b, w = cplx(1, 2048, 2048), cplx(1024, 1024), 520
        starts = np.tile([2048 - w, 2048 - w, 1024 - w, 1024 - w], (4, 1))
        expect = ("tma", 2)
    elif case == "ragged":     # w = 264 and 40: a half strip, kp past w
        a, b, w = cplx(1, 656, 656), cplx(328, 328), 264
        starts, expect = odd_starts(2, 656, 328, w), ("tma", 1)
    elif case == "ring":       # more boxes than the ring holds: refills
        a, b, w, starts = cplx(1, 7200, 7200), cplx(7200, 7200), 7200, np.zeros((1, 4))
        expect = ("tma", 8)
    else:                      # "per-thread-ring"
        a, b, w, starts = cplx(1, 7201, 7201), cplx(7201, 7201), 7201, np.zeros((1, 4))
        expect = ("per-thread", 8)
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    starts = ik.check_window_starts(np.asarray(starts, np.int64), w, a.shape, b.shape)
    return (a, b, torch.as_tensor(starts, device=dev), w), expect


# window_product_limbs on each of its launch paths: TMA loads or per-thread
# cp.async (odd row pitches), one block a strip or a cluster of 2-8, the b
# rows all in flight or in a refilled ring; limbs and scales bit for bit.
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cluster", "per-thread", "per-thread-socs",
                                  "a-batch-1", "last-start", "ragged", "ring",
                                  "per-thread-ring"])
def test_window_product_limbs_paths(case):
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    window, (path, cluster) = _window_path_case(case, dev)
    plan = ik.window_product_limbs_plan(window[0], window[1], window[3])
    assert (plan["path"], plan["cluster"]) == (path, cluster), plan
    if case.endswith("ring"):
        assert plan["slots"] < plan["rows"] // 32, plan
    before = ik.LAUNCHES["window_product_limbs"]
    _assert_same_limbs(ik.window_product_limbs(*window),
                       ik.window_product_limbs_plain(*window))
    assert ik.LAUNCHES["window_product_limbs"] == before + 1


@pytest.mark.cuda
def test_window_outside_its_operand_at_a_cluster_shape():
    """A window past its operand at a shape that runs 4-block clusters:
    its scales are NaN, and the valid window beside it is the plain
    version's bit for bit."""
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    rng = np.random.default_rng(5)
    a = torch.as_tensor((rng.normal(size=(2, 1024, 1024)) + 1j * rng.normal(
        size=(2, 1024, 1024))).astype(np.complex64), device=dev)
    b = torch.as_tensor(rng.normal(size=(1024, 1024)).astype(np.complex64), device=dev)
    assert ik.window_product_limbs_plan(a, b, 1024)["cluster"] == 4
    starts = torch.tensor([[0, 0, 0, 0], [0, 0, 1, 0]], dtype=torch.int32, device=dev)
    limbs, scales = ik.window_product_limbs(a, b, starts, 1024)
    ref_limbs, ref_scales = ik.window_product_limbs_plain(a[:1], b, starts[:1], 1024)
    assert scales[:, 1].isnan().all()
    _assert_same_limbs((limbs[:, :, :1].contiguous(), scales[:, :1].contiguous()),
                       (ref_limbs, ref_scales))


@pytest.mark.cuda
def test_window_too_wide_for_a_cluster_is_refused():
    """Past kp = 12,032 a cluster of 8 cannot hold a strip: the plan and
    the launch raise, and nothing is counted."""
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    a = torch.zeros((1, 13900, 13900), dtype=torch.complex64, device=dev)
    starts = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="takes no"):
        ik.window_product_limbs_plan(a, a[0], 13900)
    before = dict(ik.LAUNCHES)
    with pytest.raises(RuntimeError, match="failed to launch"):
        ik.window_product_limbs(a, a[0], starts, 13900)
    assert ik.LAUNCHES == before


@pytest.mark.cuda
def test_refused_launch_raises():
    """A launch the card refuses (more dynamic shared memory than a block
    may have) raises and is not counted; it never hands back the zeros the
    wrapper allocated. The next launch at the kernels' own size works."""
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik
    from lithographysimulator_tpu_torch.ops.kernels.build import load_library

    dev = _cuda()
    args, _, rng = _operands(ik, dev, 2, 96, 40)
    y_limbs, y_scales = ik.row_requantize_plain(
        *ik.row_limb_gemm_plain(*args), args[2].shape[-1])
    weights = torch.as_tensor(rng.random(2).astype(np.float32), device=dev)
    cargs = (y_limbs, y_scales, args[2], args[3], weights)
    lib = load_library()
    before = dict(ik.LAUNCHES)
    lib.set_dynamic_smem(256 * 1024)  # above the 227 KB a block may use
    try:
        with pytest.raises(RuntimeError, match="failed to launch"):
            ik.row_limb_gemm(*args)
        with pytest.raises(RuntimeError, match="failed to launch"):
            ik.column_intensity_int8(*cargs)
    finally:
        lib.set_dynamic_smem(0)
    assert ik.LAUNCHES == before
    img = ik.column_intensity_int8(*cargs)
    assert _nrms(img.cpu(), ik.column_intensity_int8_plain(*cargs).cpu()) < TOL


def _loop_operands(dev, kind, count):
    """Operands of ``int8_chunk_loop`` at the main path's shapes, from seed
    ``count``: ``socs``, ``count`` random (1024, 1024) kernels at zero
    starts against the whole chirp (w = n); ``exact``, ``count`` windows of
    w = 520 of one tiled (1, 2048, 2048) pupil at the engine's own window
    starts (shifts up to 248 px, odd columns included) against its T0."""
    from lithographysimulator_tpu_torch.ops import abbe
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    n = 1024
    gen = torch.Generator(device=dev).manual_seed(count)
    rng = np.random.default_rng(count)
    b = torch.randn((n, n), dtype=torch.complex64, device=dev, generator=gen)
    if kind == "socs":
        w = n
        a = torch.randn((count, n, n), dtype=torch.complex64, device=dev,
                        generator=gen)
        starts = np.zeros((count, 4), np.int64)
        t0 = abbe._zoom_dft_kernel(n, 4 * n)
    else:
        w = abbe._window_size(n)
        a = torch.randn((1, 2 * n, 2 * n), dtype=torch.complex64, device=dev,
                        generator=gen)
        shifts = rng.integers(-248, 249, size=(count, 2))
        starts = abbe._window_starts(shifts, n, w, n // 4 - 1)
        t0 = abbe._zoom_dft_window(n, 4 * n)
    starts = torch.as_tensor(ik.check_window_starts(starts, w, a.shape, b.shape),
                             device=dev)
    t0r = torch.as_tensor(t0.real, dtype=torch.float32, device=dev)
    t0i = torch.as_tensor(t0.imag, dtype=torch.float32, device=dev)
    weights = torch.as_tensor(rng.random(count).astype(np.float32), device=dev)
    return (a, b, starts, w, *ik.prepare_t0_limbs(t0r, t0i), weights)


def _per_chunk(a, b, starts, w, t_limbs, t_scales, weights, chunk, fast, out):
    """The per-chunk composition: the four public wrappers (one launch
    each), chunk by chunk, into out."""
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    for c in range(0, starts.shape[0], chunk):
        x = ik.window_product_limbs(a[c:c + chunk] if a.shape[0] > 1 else a, b,
                                    starts[c:c + chunk], w)
        y = ik.row_limb_gemm(*x, t_limbs, t_scales, fast=fast)
        y = ik.row_requantize(*y, t_limbs.shape[-1])
        ik.column_intensity_int8(*y, t_limbs, t_scales, weights[c:c + chunk],
                                 fast=fast, out=out)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("kind,count", [("socs", 256), ("socs", 6), ("exact", 64)])
def test_native_chunk_loop_matches_the_per_chunk_path(kind, count, fast):
    """The native chunk loop against the per-chunk path (chunk 4): SOCS at
    1024^2 rank 256, SOCS at rank 6 (a short last chunk), the exact pass at
    (1024, w = 520) with one array for every window. The images are equal
    bit for bit, each way adds to a nonzero ``out`` in place, and the loop
    launches each kernel once a chunk."""
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    ops = _loop_operands(dev, kind, count)
    n, chunks = ops[4].shape[2], -(-count // 4)
    start = torch.rand((n, n), device=dev, generator=torch.Generator(
        device=dev).manual_seed(7))
    ref = _per_chunk(*ops, 4, fast, start.clone())
    launches = dict(ik.LAUNCHES)
    out = start.clone()
    got = ik.int8_chunk_loop(*ops, chunk=4, fast=fast, out=out)
    torch.cuda.synchronize()
    assert got is out
    assert {k: ik.LAUNCHES[k] - launches[k] for k in launches} == dict.fromkeys(
        ik.CHUNK_KERNELS, chunks)
    assert torch.equal(out, ref)
    assert not torch.equal(out, start)


@pytest.mark.cuda
def test_native_chunk_loop_refused_launch_raises():
    """A launch the card refuses inside the native loop (row_limb_gemm's
    shared memory above a block's limit) raises RuntimeError naming the
    kernel and the chunk; only the launch before it (chunk 0's
    window_product_limbs) is counted. At the kernels' own size the loop
    then runs and equals the per-chunk path."""
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik
    from lithographysimulator_tpu_torch.ops.kernels.build import load_library

    dev = _cuda()
    ops = _loop_operands(dev, "socs", 6)
    n = ops[4].shape[2]
    lib = load_library()
    launches = dict(ik.LAUNCHES)
    lib.set_dynamic_smem(256 * 1024)  # above the 227 KB a block may use
    try:
        with pytest.raises(RuntimeError,
                           match="row_limb_gemm failed to launch in chunk 0 of 2"):
            ik.int8_chunk_loop(*ops, chunk=4,
                               out=torch.zeros((n, n), device=dev))
    finally:
        lib.set_dynamic_smem(0)
    torch.cuda.synchronize()
    assert {k: ik.LAUNCHES[k] - launches[k] for k in launches} == {
        "window_product_limbs": 1, "row_limb_gemm": 0, "row_requantize": 0,
        "column_intensity": 0}
    out = ik.int8_chunk_loop(*ops, chunk=4, out=torch.zeros((n, n), device=dev))
    ref = _per_chunk(*ops, 4, False, torch.zeros((n, n), device=dev))
    assert torch.equal(out, ref)


def _count_native_loops(monkeypatch):
    """Wraps the engines' one call of the native loop: the list gets the
    chunk count of each call."""
    from lithographysimulator_tpu_torch.ops import abbe

    calls, loop = [], abbe.int8_chunk_loop

    def counted(a, b, starts, *args, chunk, **kw):
        calls.append(-(-starts.shape[0] // chunk))
        return loop(a, b, starts, *args, chunk=chunk, **kw)

    monkeypatch.setattr(abbe, "int8_chunk_loop", counted)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["gau23", "socs"])
def test_simulate_issues_its_chunks_natively(solver, monkeypatch):
    """simulate() on the card, exact and SOCS: every int8 chunk goes
    through the native loop, one loop call a pass or apply, and each
    kernel launches once a chunk of the loops' calls."""
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    _cuda()
    cfg = lt.OpticsConfig(pixel_number=128)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    extra = {"socs_rank": 18} if solver == "socs" else {}
    mask = lt.demo_bars(cfg, device="cuda")
    lt.simulate(mask, src, [0, 0, 0.01, 0, 50], device="cuda", solver=solver,
                **extra)  # builds the kernel set and the library
    calls = _count_native_loops(monkeypatch)
    launches = dict(ik.LAUNCHES)
    lt.simulate(mask, src, [0, 0, 0.01, 0, 50], device="cuda", solver=solver,
                **extra)
    assert len(calls) == 1 and calls[0] > 0
    if solver == "socs":
        assert calls == [5]  # rank 18: four chunks of 4, one of 2
    assert {k: ik.LAUNCHES[k] - launches[k] for k in launches} == dict.fromkeys(
        ik.CHUNK_KERNELS, sum(calls))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["gau23", "socs"])
def test_gradient_forward_runs_the_native_loop(solver, monkeypatch):
    """Under gradients the int8 pass on the card runs the same native loop
    (one call, four launches a chunk) into a fresh buffer: the image equals
    the no-grad image bit for bit, and the backward gives a finite, nonzero
    gradient. The exact image at 128^2 (quasar) and the SOCS apply at
    rank 18."""
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    cfg = lt.OpticsConfig(pixel_number=128)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    spectrum = lt.mask_spectrum(lt.demo_bars(cfg, device=dev).geometry, cfg)
    pupil = lt.pupil_function([0, 0, 0.01, 0, 50], cfg, device=dev)
    socs = (lt.randomized_socs(pupil, src, cfg, rank=18) if solver == "socs"
            else None)

    def image(s):
        if socs is not None:
            return lt.socs_image(s, socs, cfg, engine="int8")
        return lt.abbe_image(s, pupil, src, cfg, device=dev, engine="int8")

    with torch.no_grad():
        plain = image(spectrum)
    calls = _count_native_loops(monkeypatch)
    launches = dict(ik.LAUNCHES)
    s = spectrum.clone().requires_grad_()
    graded = image(s)
    assert graded.requires_grad and len(calls) == 1
    assert {k: ik.LAUNCHES[k] - launches[k] for k in launches} == dict.fromkeys(
        ik.CHUNK_KERNELS, calls[0])
    diff = graded.detach() - plain
    print(f"{solver}: gradient forward against no-grad, nRMS "
          f"{float(diff.pow(2).mean().sqrt() / plain.abs().max()):.3e}")
    assert torch.equal(graded.detach(), plain)
    graded.sum().backward()
    assert torch.isfinite(s.grad).all() and float(s.grad.abs().max()) > 0


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


@pytest.mark.cuda
def test_socs_path_end_to_end():
    """simulate(solver='socs') on the card builds on the device, applies
    through the int8 kernels and agrees with the f32 matmul apply of the
    same kernels (the JAX package's own bound for this pair,
    test_hopkins.py:164-172)."""
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    _cuda()
    cfg = lt.OpticsConfig(pixel_number=128)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    ik.reset_launch_counts()
    res = lt.simulate(lt.demo_bars(cfg, device="cuda"), src, [0, 0, 0.01, 0, 50],
                      device="cuda", solver="socs", socs_rank=16)
    assert min(ik.LAUNCHES.values()) > 0
    assert res.image.device.type == "cuda" and res.report["socs_rank"] == 16
    socs = lt.randomized_socs(res.pupil, src, cfg, rank=16)
    assert socs.kernels.device.type == "cuda"
    int8 = lt.socs_image(res.spectrum, socs, cfg)
    matmul = lt.socs_image(res.spectrum, socs, cfg, engine="matmul")
    assert _nrms(int8.cpu(), matmul.cpu()) < 1e-5
    assert _nrms(res.image.cpu(), int8.cpu()) < 1e-6


@pytest.mark.cuda
def test_warm_socs_call_uploads_nothing_and_reads_back_once():
    """A warm simulate(solver='socs', socs_rank=256) at the clip optics,
    1024^2: under torch.profiler no host-to-device copy and one
    device-to-host read-back (the bound's scalars, from the cache entry's
    terms); its image equals, by SHA-256, the public apply of the entry's
    kernels, and its bound the public socs_image_nrms_bound, which takes
    the kernel set's terms afresh."""
    import hashlib
    import importlib

    import lithographysimulator_tpu_torch as lt

    psim = importlib.import_module("lithographysimulator_tpu_torch.simulate")
    dev = _cuda()
    cfg = lt.OpticsConfig(pixel_number=1024)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    ab = np.asarray([0, 0, 0.01, 0, 100, 0.01, 0, 0.01, 0.01, 0.01], np.float32)
    x = np.arange(1024)
    geometry = (((x[:, None] // 8) % 4 == 0) | ((x[None, :] // 32) % 5 == 0))
    mask = lt.Mask(geometry=torch.as_tensor(geometry.astype(np.float32), device=dev),
                   config=cfg)

    def run():
        return lt.simulate(mask, src, ab, device=dev, solver="socs",
                           socs_rank=256)

    run()  # builds the kernel set, its terms and the library
    run()  # warms every shape
    before = psim.socs_cache_counts()
    out = []
    _, names, _, _ = _traced_device(lambda: out.append(run()))
    counts = psim.socs_cache_counts()
    assert counts["key_reuses"] == before["key_reuses"] + 1
    assert counts["bound_from_entry"] == before["bound_from_entry"] + 1
    copies = [n for n in names if n.startswith("Memcpy")]
    print(f"warm call's copies: {copies}")
    assert [n for n in copies if "HtoD" in n] == []
    assert len([n for n in copies if "DtoH" in n]) == 1
    (res,) = out
    socs = psim._socs_kernels_cached(cfg, np.asarray(src), ab, 256,
                                     device=dev).socs
    image = lt.socs_image(res.spectrum, socs, cfg)

    def sha(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()

    assert sha(res.image) == sha(image)
    bound = lt.socs_image_nrms_bound(socs, res.spectrum, image, pupil=res.pupil,
                                     source_map=src, config=cfg)
    print(f"bound from the entry {res.report['socs_image_nrms_bound']!r}, "
          f"public {bound!r}")
    assert abs(res.report["socs_image_nrms_bound"] - bound) <= 1e-5 * bound


@pytest.mark.cuda
def test_vector_exact_int8_matches_f32():
    """The unpolarized vector image on the card (six component passes
    through the int8 kernels) against the f32 matmul engine, TF32 off."""
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.ops.abbe import _pad_points, source_points
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    _cuda()
    cfg = lt.OpticsConfig(pixel_number=128, na=0.9)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    ik.reset_launch_counts()
    res = lt.simulate(lt.demo_bars(cfg, device="cuda"), src, [0, 0, 0.01, 0, 50],
                      device="cuda", polarization="unpolarized")
    assert min(ik.LAUNCHES.values()) > 0
    pts = source_points(src)
    shifts, weights = _pad_points(pts.shifts, pts.weights, 4)
    ref = lt.vector_abbe_image(res.spectrum, res.pupil, shifts, weights, cfg,
                               device="cuda", polarization="unpolarized",
                               engine="matmul")
    assert _nrms(res.image.cpu(), ref.cpu()) < TOL


@pytest.mark.cuda
def test_chromatic_socs_int8_apply_matches_complex128():
    """A polychromatic kernel set built on the card, applied through the
    int8 kernels, against a complex128 zoom-DFT apply of the same kernels."""
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.ops.abbe import (_zoom_dft_kernel,
                                                         postprocess_gau23)
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    cfg = lt.OpticsConfig(pixel_number=128)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    socs = lt.randomized_socs_chromatic(
        np.zeros(5, np.float32), src, cfg, device=dev, rank=32,
        spectrum=lt.LaserSpectrum(bandwidth_pm=0.3, samples=5))
    spectrum = lt.mask_spectrum(lt.demo_bars(cfg, device=dev).geometry, cfg)
    ik.reset_launch_counts()
    img = lt.socs_image(spectrum, socs, cfg)
    assert min(ik.LAUNCHES.values()) > 0
    t = torch.as_tensor(_zoom_dft_kernel(cfg.n, cfg.wavelength_scaling().fft_size),
                        dtype=torch.complex128, device=dev)
    fields = t @ (socs.kernels * spectrum).to(torch.complex128) @ t.T
    acc = torch.sum(socs.eigenvalues.double()[:, None, None] * fields.abs() ** 2, dim=0)
    assert _nrms(img.cpu(), postprocess_gau23(acc, cfg).cpu()) < TOL


@pytest.mark.cuda
def test_int8_gradient_matches_matmul_autograd():
    """The int8 engine's gradient on the card (the four kernels forward,
    the float32 recompute backward) against the matmul engine's autograd:
    atol 1e-6 * max|g| (the JAX package's class, test_pallas_kernel.py);
    the forward launches the kernels."""
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.ops.abbe import _pad_points, source_points
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    cfg = lt.OpticsConfig(pixel_number=128)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    pts = source_points(src)
    shifts, weights = _pad_points(pts.shifts, pts.weights, 4)
    spectrum = lt.mask_spectrum(lt.demo_bars(cfg, device=dev).geometry, cfg)
    pupil = lt.pupil_function([0, 0, 0.01, 0, 50], cfg, device=dev)
    m = 0.5 + torch.rand((cfg.n, cfg.n), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    grads = {}
    for engine in ("int8", "matmul"):
        ik.reset_launch_counts()
        s = spectrum.clone().requires_grad_()
        p = pupil.clone().requires_grad_()
        img = lt.abbe_image_points(s, p, shifts, weights, cfg, device=dev,
                                   engine=engine)
        (img * m).sum().backward()
        grads[engine] = (s.grad, p.grad)
        assert (min(ik.LAUNCHES.values()) > 0) == (engine == "int8")
    for g8, g32 in zip(grads["int8"], grads["matmul"]):
        scale = float(g32.abs().max())
        assert scale > 0 and float((g8 - g32).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
def test_fit_boundary_layer_runs_on_the_kernels():
    """A few Adam steps of the M3D fit on the auto engine (int8 on the
    card) launch the kernels and follow the matmul engine's fit."""
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.ops.abbe import _pad_points, source_points
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    cfg = lt.OpticsConfig(pixel_number=128)
    src = lt.LightSource(cfg, sigma_out=0.5).classical()
    pts = source_points(src)
    shifts, weights = _pad_points(pts.shifts, pts.weights, 8)
    mask = lt.demo_bars(cfg, device=dev)
    ab = np.array([0, 0, 0, 0, 50.0], np.float32)
    true = lt.BoundaryLayer(width_nm=8.0, beta_h=-0.25 + 0.15j, beta_v=0.1 - 0.2j)
    target = lt.simulate(mask, src, ab, device=dev, normalize=True,
                         mask3d=true).image
    fits = {}
    for engine in ("auto", "matmul"):
        ik.reset_launch_counts()
        fits[engine] = lt.fit_boundary_layer(
            target, mask.geometry, shifts, weights, cfg, device=dev, steps=4,
            aberrations=ab, engine=engine)
        assert (min(ik.LAUNCHES.values()) > 0) == (engine == "auto")
    (bl8, hist8), (bl32, hist32) = fits["auto"], fits["matmul"]
    assert hist8[-1] < hist8[0]
    np.testing.assert_allclose(hist8, hist32, rtol=1e-4)
    assert abs(bl8.beta_v - bl32.beta_v) < 1e-4


@pytest.mark.cuda
def test_tiled_chip_runs_on_the_kernels():
    """A 512^2 chip through 128^2 tiles on the card: every tile's apply
    launches the int8 kernels, one window_product_limbs a row_limb_gemm;
    the image equals the f32 matmul engine's within the SOCS pair bound
    (test_hopkins.py:164-172) and the streamed chip the array path's."""
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    dev = _cuda()
    cfg = lt.OpticsConfig(pixel_number=128)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    socs = lt.randomized_socs(lt.pupil_function(np.zeros(5), cfg, device=dev),
                              src, cfg, rank=32)
    x = np.arange(512)
    chip = np.broadcast_to(((x // 8) % 16 == 0).astype(np.float32),
                           (512, 512)).copy()
    chip[100:108, 90:140] = 1.0  # across a seam
    ik.reset_launch_counts()
    img = lt.tiled_socs_image(chip, socs, cfg, halo=24)
    tiles = (-(-512 // (128 - 48))) ** 2
    assert img.device.type == "cuda" and img.shape == (512, 512)
    assert ik.LAUNCHES["row_limb_gemm"] == tiles * 8  # rank 32: 8 chunks
    assert ik.LAUNCHES["window_product_limbs"] == ik.LAUNCHES["row_limb_gemm"]
    assert min(ik.LAUNCHES.values()) > 0
    matmul = lt.tiled_socs_image(chip, socs, cfg, halo=24, engine="matmul")
    assert _nrms(img.cpu(), matmul.cpu()) < 1e-5
    stream = lt.tiled_socs_image_stream(lt.array_window_fn(chip, 128), 512,
                                        socs, cfg, halo=24)
    assert float((stream - img).abs().max()) <= 1e-6 * float(img.max())


@pytest.mark.cuda
def test_sharded_exact_on_a_repeated_card_mesh():
    """parallel/abbe_sharded.py on a 4-entry mesh of cuda:0 at 256^2 (the
    windowed int8 path): the sharded image equals the single-device one to
    1e-6 and each shard launched its kernels (one launch of each kernel a
    chunk of 4)."""
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch import parallel
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    _cuda()
    cfg = lt.OpticsConfig(pixel_number=256)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    res = lt.simulate(lt.demo_bars(cfg, device="cuda"), src, device="cuda")
    mesh = parallel.source_mesh(devices=["cuda:0"] * 4)
    shifts, weights, _ = parallel.padded_source_arrays(src, 4 * 4)
    ik.reset_launch_counts()
    img = parallel.abbe_image_sharded(res.spectrum, res.pupil, shifts, weights,
                                      cfg, mesh)
    torch.cuda.synchronize()
    assert all(v == len(shifts) // 4 for v in ik.LAUNCHES.values())
    assert _nrms(img.cpu(), res.image.cpu()) < TOL


@pytest.mark.cuda
def test_every_kernel_launches_on_each_visible_card():
    """F9: the kernels' raised shared-memory limit is set for each device,
    so a process that launches on cuda:0 and then on cuda:1 (and on) runs
    every kernel on each card and matches the plain versions. Skips below
    two cards."""
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    for index in range(torch.cuda.device_count()):
        dev = torch.device("cuda", index)
        args, window, rng = _operands(ik, dev, 2, 328, 264)
        _assert_same_limbs(ik.window_product_limbs(*window), args[:2])
        yr, yi = ik.row_limb_gemm(*args)
        pr, pi = ik.row_limb_gemm_plain(*args)
        assert _nrms(torch.complex(yr, yi).cpu(), torch.complex(pr, pi).cpu()) < TOL
        kp = args[2].shape[-1]
        y = ik.row_requantize(pr, pi, kp)
        _assert_same_limbs(y, ik.row_requantize_plain(pr, pi, kp))
        weights = torch.as_tensor(rng.random(2).astype(np.float32), device=dev)
        img = ik.column_intensity_int8(*y, args[2], args[3], weights)
        ref = ik.column_intensity_int8_plain(*y, args[2], args[3], weights)
        assert img.device == dev
        assert _nrms(img.cpu(), ref.cpu()) < TOL


def _traced_device(call):
    """``call()`` under torch.profiler (host and card): the union of the
    card's operation intervals in ns, the names of the card's operations,
    the port's span names among the host's events, and the port's span
    recording."""
    from torch.profiler import ProfilerActivity, profile

    from lithographysimulator_tpu_torch.utils import profiling

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            host.append(ev.name())
        else:
            device.append((ev.start_ns(), ev.end_ns(), ev.name()))
    busy, end = 0, None
    for s, e, _ in sorted(device):
        if end is None or s > end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    return (busy, [name for _, _, name in device],
            [name for name in host if name.startswith("litho.")],
            profiling.recording()["spans"])


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["simulate", "tiled"])
def test_spans_cast_no_device_shadow(call, monkeypatch):
    """The port's spans enter a trace as host events only: with spans on,
    no card event bears a ``litho.`` name, and the union of the card's
    operation intervals of a 1024^2 simulate (rank 64) or a 2048^2 chip
    through 1024^2 tiles matches the same call traced with spans off
    (three runs each, in turns) within the runs' own spread."""
    import types

    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch import _spans

    dev = _cuda()
    cfg = lt.OpticsConfig(pixel_number=1024)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    x = np.arange(2048)
    chip = np.broadcast_to(((x // 8) % 16 == 0).astype(np.float32),
                           (2048, 2048)).copy()
    if call == "simulate":
        mask = lt.Mask(geometry=torch.as_tensor(chip[:1024, :1024], device=dev),
                       config=cfg)

        def run():
            lt.simulate(mask, src, device=dev, solver="socs", socs_rank=64)
        root = "litho.simulate"
    else:
        socs = lt.randomized_socs(
            lt.pupil_function(np.zeros(5), cfg, device=dev), src, cfg, rank=64)
        chip_dev = torch.as_tensor(chip, device=dev)

        def run():
            lt.tiled_socs_image(chip_dev, socs, cfg, halo=96)
        root = "litho.tiled"
    run()  # warm: the library, the kernel set, every shape
    on_busy, off_busy = [], []
    off = types.SimpleNamespace(_is_profiler_enabled=False)
    for _ in range(3):
        busy, device_names, host_spans, spans = _traced_device(run)
        assert not [n for n in device_names if n.startswith("litho.")]
        assert root in host_spans and root in {s["name"] for s in spans}
        on_busy.append(busy)
        with monkeypatch.context() as m:
            m.setattr(_spans, "_PROFILER", off)
            busy, _, host_spans, spans = _traced_device(run)
        assert not host_spans and not spans
        off_busy.append(busy)
    spread = max(max(on_busy) - min(on_busy), max(off_busy) - min(off_busy))
    print(f"{call}: device busy ns with spans {sorted(on_busy)}, "
          f"without {sorted(off_busy)}")
    assert abs(np.median(on_busy) - np.median(off_busy)) <= spread + 0.01 * np.median(off_busy)


def _edge_fields(dev, shape, seed):
    """Cut lines like the EUV cell's trials: a 36-px grating of random
    phase with noise, pixels set to the threshold's float32 neighbours, an
    empty line, a full one and runs at both ends."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    t, lines, n = shape
    x = torch.arange(n, device=dev, dtype=torch.float32)
    phase = 6.3 * torch.rand((t, lines, 1), generator=gen, device=dev)
    f = 0.45 + 0.3 * torch.cos(2 * np.pi * x / 36 + phase)
    f = f + 0.08 * torch.randn(shape, generator=gen, device=dev)
    thr = 0.45438371501111385
    near = torch.tensor(np.float32([thr, np.nextafter(np.float32(thr), 1),
                                    np.nextafter(np.float32(thr), 0)]), device=dev)
    pick = torch.randint(0, 40, shape, generator=gen, device=dev)
    f = torch.where(pick < 3, near[pick.clamp_max(2)], f)
    f[:, 0] = 0.1
    f[:, 1] = 0.9
    f[:, 2, :3] = 0.9
    f[:, 2, -3:] = 0.9
    return f.contiguous(), thr


@pytest.mark.cuda
@pytest.mark.parametrize("shape,row_step", [((16, 1024, 1024), 2), ((3, 40, 37), 3),
                                            ((2, 64, 130), 1)])
def test_edge_runs_kernel_matches_its_plain_twin(shape, row_step):
    """The ``edge_runs`` kernel's run counts, table counts and edges (the
    EUV cell's (16, 1024, 1024) at row_step 2; n = 37 and 130 take the
    4-byte loads) equal the plain twin's bit for bit, twice over."""
    from lithographysimulator_tpu_torch.ops.kernels import stochastic_edges as se

    dev = _cuda()
    fields, thr = _edge_fields(dev, shape, 11)
    before = se.LAUNCHES["edge_runs"]
    plain_runs, plain_counts = se.edge_runs_plain(fields, thr, row_step)
    k = int(plain_counts.max())
    plain = se.edge_runs_plain(fields, thr, row_step, k)
    valid = torch.arange(k, device=dev) < plain_counts[..., None]
    for _ in range(2):
        runs, counts = se.edge_runs(fields, thr, row_step)
        rise, fall = se.edge_runs(fields, thr, row_step, k)
        torch.cuda.synchronize()
        assert torch.equal(runs, plain_runs) and torch.equal(counts, plain_counts)
        for got, want in zip((rise, fall), plain):
            assert torch.equal(got[valid].view(torch.int64), want[valid].view(torch.int64))
            assert torch.isnan(got[~valid]).all()
    # into the trial rows of a wider batch's tables (out=), as the ensemble
    t = fields.shape[0]
    big = [torch.full((t + 2, *rise.shape[1:]), 7.0, dtype=torch.float64,
                      device=dev) for _ in range(2)]
    se.edge_runs(fields, thr, row_step, k, out=(big[0][1:t + 1], big[1][1:t + 1]))
    for whole, want in zip(big, (rise, fall)):
        assert torch.equal(whole[1:t + 1].view(torch.int64), want.view(torch.int64))
        assert (whole[0] == 7.0).all() and (whole[t + 1] == 7.0).all()
    assert se.LAUNCHES["edge_runs"] - before == 5
    assert int(plain_counts.sum()) > 0


@pytest.mark.cuda
def test_edge_statistics_on_the_card_are_the_cpus():
    """The statistics of the card's tables equal the same functions on the
    CPU: per-trial LER, LWR and CD and the traces bit for bit (fixed-order
    IEEE sums), the PSD within 1e-12 (cuFFT and the CPU's FFT)."""
    from lithographysimulator_tpu_torch.models import edge_stats as es
    from lithographysimulator_tpu_torch.ops.kernels import stochastic_edges as se

    dev = _cuda()
    fields, thr = _edge_fields(dev, (16, 1024, 1024), 12)
    anchors = torch.arange(18.0, 1024.0, 36.0, dtype=torch.float64)
    out = {}
    for where, f in (("cuda", fields), ("cpu", fields.cpu())):
        _, counts = se.edge_runs(f, thr, 2)
        rise, fall = se.edge_runs(f, thr, 2, int(counts.max()))
        a = anchors.to(f.device)
        out[where] = (es.trial_stats(rise, fall, counts, a, 1.0, 64),
                      *es.band_traces(rise[:, 100:400], fall[:, 100:400],
                                      counts[:, 100:400], a, 1.0),
                      *es.psd_partial(rise[:, 100:400], fall[:, 100:400],
                                      counts[:, 100:400], a, 1.0, 2.0))
    (s_c, x_c, ok_c, p_c, e_c), (s_h, x_h, ok_h, p_h, e_h) = (
        [t.cpu() for t in out[w]] for w in ("cuda", "cpu"))
    assert torch.equal(s_c.view(torch.int64), s_h.view(torch.int64))
    assert torch.equal(ok_c, ok_h) and torch.equal(e_c, e_h) and int(e_c.sum()) > 0
    assert torch.equal(x_c[ok_c], x_h[ok_h])
    torch.testing.assert_close(p_c, p_h, rtol=1e-12, atol=0)
