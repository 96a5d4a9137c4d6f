"""CPU checks of what surrounds the port's CUDA kernels: the ctypes
signatures against the C interface in ``csrc/intensity_int8.cu``, the build
log kept beside the library, and the parsers and bounds of ``chip_smoke.py``
phases 1, 2 and 7. No nvcc and no card needed."""

import ctypes
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lithographysimulator_tpu_torch.ops.kernels import build  # noqa: E402
from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _c_functions() -> dict:
    """{name: [parameter declarations]} of the extern "C" block."""
    src = build.SOURCE.read_text()
    block = src[src.index('extern "C" {'):]
    return {m.group(1): [p.strip() for p in m.group(2).split(",")]
            for m in re.finditer(r"^int (\w+)\(([^)]*)\)", block, re.M)}


def test_ctypes_signatures_match_c_interface():
    funcs = _c_functions()
    assert set(funcs) == set(build.SIGNATURES)
    for name, params in funcs.items():
        types = build.SIGNATURES[name]
        assert len(types) == len(params), name
        for decl, t in zip(params, types):
            assert (t is ctypes.c_void_p) == ("*" in decl), (name, decl)
            assert (t is ctypes.c_int) == decl.startswith("int "), (name, decl)


def test_build_keeps_its_log(tmp_path, monkeypatch):
    """A second build() returns the first one's ptxas log without nvcc."""
    calls = []

    def fake_run(cmd, **kwargs):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return type("Done", (), {"returncode": 0, "stdout": "ptxas info : Used 9 registers\n",
                                 "stderr": ""})()

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    lib, log = build.build()
    assert lib.is_file() and lib.parent == tmp_path and "Used 9 registers" in log
    assert build.build() == (lib, log)
    assert len(calls) == 1


def test_ptxas_spills_and_sass_counts():
    cs = _chip_smoke()
    log = ("ptxas info    : Function properties for _Z3fooILb0EEv\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Function properties for _Z3barv\n"
           "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n")
    assert cs.ptxas_spills(log) == {"_Z3fooILb0EEv": 0, "_Z3barv": 12}
    sass = ("\t\tFunction : _Z3fooILb0EEv\n"
            "        /*0090*/                   IGMMA.64x64x32.S8.S8 R24, gdesc[UR4], R24, gsb0 ;\n"
            "        /*00a0*/              @!P0 IDP.4A.S8.S8 R1, R2, R3, R4 ;\n"
            "\t\tFunction : _Z3barv\n"
            "        /*0010*/                   IMMA.16832.S8.S8 R4, R8, R12, R4 ;\n"
            "        /*0020*/                   IGMMA.64x64x32.S8.S8 R24, gdesc[UR4], R24 ;\n")
    assert cs.sass_counts(sass) == {"_Z3fooILb0EEv": {"IGMMA": 1, "IMMA": 0, "IDP": 1},
                                    "_Z3barv": {"IGMMA": 1, "IMMA": 1, "IDP": 0}}


@pytest.mark.parametrize("name,shape,fast,ms,by", [
    # 3 planes x 6 limb dots x 2*M*N*K int8 operations at 1,979 TOP/s
    ("row_limb_gemm", (4, 1024, 520, 544), False, 0.02015, "operations"),
    ("column_intensity", (4, 1024, 520, 544), False, 0.03968, "operations"),
    ("column_intensity", (4, 1024, 1024, 1024), False, 0.07813, "operations"),
    ("row_limb_gemm", (4, 1024, 1024, 1024), True, 0.03906, "operations"),
    # 33.5 MB read and 37.7 MB written at 3.35 TB/s
    ("row_requantize", (4, 1024, 1024, 1024), False, 0.02130, "bytes"),
])
def test_bound(name, shape, fast, ms, by):
    got, got_by = _chip_smoke().bound(name, *shape, fast)
    assert got == pytest.approx(ms, rel=1e-3) and got_by == by


def test_window_bound_counts_each_element_once():
    """window_product_limbs reads the union of its windows: overlapping
    windows of one shared array count once, a batch's arrays apart."""
    cs = _chip_smoke()
    starts = np.array([[0, 0, 0, 0], [1, 3, 2, 2]])
    # a: 16 + 16 - 3 shared elements; b: 16 + 16 - 4
    assert cs.window_read_bytes(starts, 4, (1, 8, 8), (6, 6)) == 8 * (29 + 28)
    assert cs.window_read_bytes(starts, 4, (2, 8, 8), (6, 6)) == 8 * (32 + 28)
    ms, by = cs.bound("window_product_limbs", 2, 8, 4, 32, False, 456)
    # + 16 bytes of starts a window; 9 limb planes and 3 f32 scales written
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (456 + 32 + 9 * 2 * 4 * 32 + 4 * 3 * 2 * 4) / 3.35e12)


@pytest.mark.parametrize("batch,n,w", [(4, 96, 40), (2, 328, 264), (2, 48, 48)])
def test_window_operands(batch, n, w):
    """phase 2 and 7 operands: exact-like windows at odd columns of a tiled
    2n x 2n array, SOCS-like whole arrays at zero starts; all valid."""
    a, b, starts = _chip_smoke().window_operands(np.random.default_rng(0), batch, n, w)
    ik.check_window_starts(starts, w, a.shape, b.shape)
    assert b.shape == (n, n) and starts.shape == (batch, 4)
    if w < n:
        assert a.shape == (1, 2 * n, 2 * n)
        assert (starts[:, 1] % 2 == 1).all() and (starts[:, 3] % 2 == 1).all()
    else:
        assert a.shape == (batch, n, n) and not starts.any()
