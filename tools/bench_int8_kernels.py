#!/usr/bin/env python3
"""Times versions of the port's int8 kernels against each other on one CUDA
card, in one process. Run from the repository root:

    PYTHONPATH=. python3 tools/bench_int8_kernels.py A.cu B.cu [...]

Each source is a version of lithographysimulator_tpu_torch/csrc/
intensity_int8.cu with the same C interface for the kernels it has (for
example the parent commit's, unpacked with git archive into a directory
that git ignores). All are built in parallel with the package's nvcc flags.
At each main-path shape they are timed in turns, first to last and back
(A, B, B, A), so drift of the card shows as a gap between the two turns of
one source. A turn times row_limb_gemm, column_intensity and row_requantize,
3-limb, and window_product_limbs where the source has it, launched through
ctypes: device time by chip_smoke.time_ms (a CUDA graph of 10 back-to-back
launches, replayed), the same inputs for every source, each result held to
its plain PyTorch version (<= 1e-6 normalized RMS, dequantized for the two
quantizers) and to the first source's output bit for bit (the two GEMM
kernels also in their FAST variant, untimed). Once per shape the chain that
window_product_limbs replaces (the gather and product, then quantize_x) is
timed in the same process. It prints each time with its share of the
kernel's bound (chip_smoke.bound) and whether its bits equal the first
source's; the last line holds the same as JSON. It exits with an error where
there is no CUDA device.
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


KERNELS = ("window_product_limbs", "row_limb_gemm", "row_requantize",
           "column_intensity")


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
        for name in KERNELS:
            fn = getattr(lib, name, None)
            if fn is not None:
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
    from chip_smoke import (bound, dequant, nrms, nvidia_smi, time_ms,
                            window_operands, window_read_bytes)
    from lithographysimulator_tpu_torch.ops.kernels import build
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    smi = nvidia_smi()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    libs = build_all(args.sources, build)
    labels = [str(s) for s in args.sources]
    turns = list(range(len(libs))) + list(reversed(range(len(libs))))
    dev = torch.device("cuda")
    results = []

    def stream():  # the capturing stream while time_ms records its graph
        return torch.cuda.current_stream().cuda_stream

    for batch, n, w in SHAPES:
        rng = np.random.default_rng(n + w)
        a_np, b_np, starts_np = window_operands(rng, batch, n, w)
        starts_np = ik.check_window_starts(starts_np, w, a_np.shape, b_np.shape)
        a, b = torch.as_tensor(a_np, device=dev), torch.as_tensor(b_np, device=dev)
        starts = torch.as_tensor(starts_np, device=dev)
        t0 = np.exp(1j * rng.normal(size=(n, w))).astype(np.complex64)
        tl, ts = ik.prepare_t0_limbs(torch.as_tensor(t0.real, device=dev),
                                     torch.as_tensor(t0.imag, device=dev))
        kp = tl.shape[-1]
        xl, xs = ik.window_product_limbs_plain(a, b, starts, w)
        yr_p, yi_p = ik.row_limb_gemm_plain(xl, xs, tl, ts)
        yl, ys = ik.row_requantize_plain(yr_p, yi_p, kp)
        wts = torch.as_tensor(rng.random(batch).astype(np.float32), device=dev)
        img_p = ik.column_intensity_int8_plain(yl, ys, tl, ts, wts)
        refs = {"window_product_limbs": dequant(xl, xs),
                "row_limb_gemm": torch.complex(yr_p, yi_p).cpu().numpy(),
                "row_requantize": dequant(yl, ys),
                "column_intensity": img_p.cpu().numpy()}
        x_bytes = window_read_bytes(starts_np, w, a_np.shape, b_np.shape)
        bounds = {k: bound(k, batch, n, w, kp, False, x_bytes)[0] for k in KERNELS}
        chain_ms = time_ms(torch, lambda: ik.window_product_limbs_plain(
            a, b, starts, w))
        print(f"({batch}, {n}, {w}) gather + product + quantize_x chain (plain "
              f"torch): {chain_ms:.4f} ms", flush=True)
        results.append({"source": "plain torch chain", "shape": [batch, n, w],
                        "window_product_limbs_ms": chain_ms})
        out = {"window_product_limbs": (torch.empty_like(xl), torch.empty_like(xs)),
               "row_limb_gemm": (torch.empty_like(yr_p), torch.empty_like(yi_p)),
               "row_requantize": (torch.empty_like(yl), torch.empty_like(ys)),
               "column_intensity": (torch.zeros((n, n), device=dev),)}
        calls = {
            "window_product_limbs": lambda lib: lib.window_product_limbs(
                a.data_ptr(), b.data_ptr(), starts.data_ptr(),
                out["window_product_limbs"][0].data_ptr(),
                out["window_product_limbs"][1].data_ptr(), batch, a.shape[0],
                a.shape[1], a.shape[2], b.shape[0], b.shape[1], w, kp, stream()),
            "row_limb_gemm": lambda lib, fast=0: lib.row_limb_gemm(
                tl.data_ptr(), ts.data_ptr(), xl.data_ptr(), xs.data_ptr(),
                out["row_limb_gemm"][0].data_ptr(), out["row_limb_gemm"][1].data_ptr(),
                batch, n, w, kp, fast, stream()),
            "row_requantize": lambda lib: lib.row_requantize(
                yr_p.data_ptr(), yi_p.data_ptr(), out["row_requantize"][0].data_ptr(),
                out["row_requantize"][1].data_ptr(), batch * n, w, kp, stream()),
            "column_intensity": lambda lib, fast=0: lib.column_intensity(
                yl.data_ptr(), ys.data_ptr(), tl.data_ptr(), ts.data_ptr(),
                wts.data_ptr(), out["column_intensity"][0].data_ptr(), batch, n,
                kp, fast, stream()),
        }

        def result(name):
            o = out[name]
            if name == "row_limb_gemm":
                return torch.complex(*o).cpu().numpy()
            if name == "column_intensity":
                return o[0].cpu().numpy()
            return dequant(*o)

        first_bits = {}  # (kernel, fast) -> the first source's outputs as bytes

        def same_bits(key, name):
            got = [t.contiguous().view(torch.uint8).clone() for t in out[name]]
            ref = first_bits.setdefault(key, got)
            return all(torch.equal(a, b) for a, b in zip(ref, got))

        for turn, i in enumerate(turns):
            lib = libs[i]
            r = {"source": labels[i], "turn": turn, "shape": [batch, n, w]}
            line = []
            for name in KERNELS:
                if getattr(lib, name, None) is None:
                    continue

                def call(name=name, fast=0):
                    err = calls[name](lib, fast) if fast else calls[name](lib)
                    assert err == 0, f"{name} launch error {err}"

                out["column_intensity"][0].zero_()
                call()
                torch.cuda.synchronize()
                e = nrms(result(name), refs[name])
                if not e <= TOL:
                    raise SystemExit(f"{labels[i]} at {(batch, n, w)}: {name} "
                                     f"error {e:.3e} > {TOL}")
                bits = {"3-limb": same_bits((name, 0), name)}
                if name in ("row_limb_gemm", "column_intensity"):
                    out["column_intensity"][0].zero_()
                    call(fast=1)
                    torch.cuda.synchronize()
                    bits["fast"] = same_bits((name, 1), name)
                ms = time_ms(torch, call)
                r[f"{name}_ms"], r[f"{name}_nrms"] = ms, e
                r[f"{name}_bound_ms"] = bounds[name]
                for k, v in bits.items():
                    r[f"{name}{'_fast' if k == 'fast' else ''}_bits_as_first"] = v
                same = ", ".join(f"{k} bits {'==' if v else '!='} first"
                                 for k, v in bits.items())
                line.append(f"{name} {ms:.4f} ms ({100 * bounds[name] / ms:.1f}% "
                            f"of bound, nRMS {e:.1e}; {same})")
            results.append(r)
            print(f"({batch}, {n}, {w}) {labels[i]}: " + "; ".join(line), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
