#!/usr/bin/env python3
"""Times versions of the port's int8 GEMM kernels against each other on one
CUDA card, in one process. Run from the repository root:

    PYTHONPATH=. python3 tools/bench_int8_kernels.py A.cu B.cu [...]

Each source is a version of lithographysimulator_tpu_torch/csrc/
intensity_int8.cu with the same C interface (for example the parent
commit's, unpacked with git archive into a directory that git ignores). All
are built in parallel with the package's nvcc flags. At each main-path shape
they are timed in turns, first to last and back (A, B, B, A), so drift of
the card shows as a gap between the two turns of one source. A turn times
row_limb_gemm and column_intensity, 3-limb, launched through ctypes: the
median of 5 CUDA-event samples of 10 back-to-back launches after a warm-up,
the same inputs for every source, each result held to its plain PyTorch
version (<= 1e-6 normalized RMS). It prints each time with its share of the
int8 bound (3 planes x 6 limb dots x 2*M*N*K operations at 1,979 TOP/s);
the last line holds the same as JSON. It exits with an error where there is
no CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SHAPES = ((4, 1024, 520), (4, 2048, 1032), (4, 1024, 1024), (4, 2048, 2048))
TOL = 1e-6


def build_all(sources: list[Path], build) -> list[ctypes.CDLL]:
    out_dir = build.BUILD_DIR / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        so = out_dir / f"{src.stem}-{digest}.so"
        procs.append((so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for (so, proc), src in zip(procs, sources):
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {src}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for name in ("row_limb_gemm", "column_intensity"):
            fn = getattr(lib, name)
            fn.argtypes = build.SIGNATURES[name]
            fn.restype = ctypes.c_int
        libs.append(lib)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", type=Path)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_int8_kernels.py: needs a CUDA device")
    from chip_smoke import bound, nrms, nvidia_smi, time_ms
    from lithographysimulator_tpu_torch.ops.kernels import build
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    smi = nvidia_smi()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    libs = build_all(args.sources, build)
    labels = [str(s) for s in args.sources]
    turns = list(range(len(libs))) + list(reversed(range(len(libs))))
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    for batch, n, w in SHAPES:
        rng = np.random.default_rng(n + w)
        x = torch.as_tensor((rng.normal(size=(batch, w, w))
                             + 1j * rng.normal(size=(batch, w, w))).astype(np.complex64),
                            device=dev)
        t0 = np.exp(1j * rng.normal(size=(n, w))).astype(np.complex64)
        tl, ts = ik.prepare_t0_limbs(torch.as_tensor(t0.real, device=dev),
                                     torch.as_tensor(t0.imag, device=dev))
        xl, xs = ik.quantize_x(x)
        kp = tl.shape[-1]
        yr_p, yi_p = ik.row_limb_gemm_plain(xl, xs, tl, ts)
        yl, ys = ik.row_requantize_plain(yr_p, yi_p, kp)
        wts = torch.as_tensor(rng.random(batch).astype(np.float32), device=dev)
        img_p = ik.column_intensity_int8_plain(yl, ys, tl, ts, wts)
        y_p = torch.complex(yr_p, yi_p).cpu().numpy()
        yr = torch.empty((batch, n, w), device=dev)
        yi = torch.empty_like(yr)
        out = torch.zeros((n, n), device=dev)
        b_row = bound("row_limb_gemm", batch, n, w, kp, False)[0]
        b_col = bound("column_intensity", batch, n, w, kp, False)[0]
        for turn, i in enumerate(turns):
            lib = libs[i]

            def row():
                err = lib.row_limb_gemm(tl.data_ptr(), ts.data_ptr(), xl.data_ptr(),
                                        xs.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                                        batch, n, w, kp, 0, stream)
                assert err == 0, f"row_limb_gemm launch error {err}"

            def col():
                err = lib.column_intensity(yl.data_ptr(), ys.data_ptr(), tl.data_ptr(),
                                           ts.data_ptr(), wts.data_ptr(), out.data_ptr(),
                                           batch, n, kp, 0, stream)
                assert err == 0, f"column_intensity launch error {err}"

            row()
            out.zero_()
            col()
            torch.cuda.synchronize()
            e_row = nrms(torch.complex(yr, yi).cpu().numpy(), y_p)
            e_col = nrms(out.cpu().numpy(), img_p.cpu().numpy())
            if not (e_row <= TOL and e_col <= TOL):
                raise SystemExit(f"{labels[i]} at {(batch, n, w)}: error row "
                                 f"{e_row:.3e}, column {e_col:.3e} > {TOL}")
            ms_row, ms_col = time_ms(torch, row), time_ms(torch, col)
            r = {"source": labels[i], "turn": turn, "shape": [batch, n, w],
                 "row_limb_gemm_ms": ms_row, "column_intensity_ms": ms_col,
                 "row_bound_ms": b_row, "column_bound_ms": b_col,
                 "row_nrms": e_row, "column_nrms": e_col}
            results.append(r)
            print(f"({batch}, {n}, {w}) {labels[i]}: row_limb_gemm {ms_row:.4f} ms "
                  f"({100 * b_row / ms_row:.1f}% of bound), column_intensity "
                  f"{ms_col:.4f} ms ({100 * b_col / ms_col:.1f}%), nRMS "
                  f"{e_row:.1e} / {e_col:.1e}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
