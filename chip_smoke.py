#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lithographysimulator_tpu_torch) on
one CUDA GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

It exits 0 only if every phase passes; each fails hard on a miss:

0. device: name, capability, torch/CUDA versions, nvidia-smi name and
   power limit;
1. build the int8 kernels from csrc/ with nvcc for sm_90a; print ptxas's
   registers and spills and, from cuobjdump -sass, each kernel's count of
   tensor-core integer MMA (IGMMA for wgmma, IMMA for mma.sync) and of
   IDP.4A (__dp4a). Fails if row_limb_gemm or column_intensity has no
   tensor-core MMA or any IDP.4A, or if any kernel spills;
2. each kernel against its plain PyTorch version on the card, at the
   exact-Abbe shapes (B=4, n=1024, w=520), (4, 2048, 1032), a ragged
   (3, 96, 40) and (2, 328, 264), which the 64 x 64 tiles and 64-byte K
   stages do not divide, 3-limb and 2-limb: normalized RMS <= 1e-6 on
   dequantized X and Y and on the image; the two quantizers' limbs and
   scales equal the plain versions' bit for bit (the count of differing
   limbs is printed); window_product_limbs reads windows of
   a tiled 2n x 2n array and an n x n one at odd columns, so its loads are
   only 8-byte aligned; a line a shape names its launch plan (TMA or
   per-thread loads, cluster size, rows a block); at each exact shape
   every window also at its last valid start, and at the first shape
   operands with odd row pitches (the per-thread loads), each bit for
   bit; median kernel, plain and library times (CUDA
   events) beside the kernel's bound and its share of the bound;
3. the 64^2 demo through simulate(device='cuda'): <= 2e-3 normalized RMS
   against tests/golden/demo_aerial_image_fft.npy and <= 1e-5 against the
   port's own fft engine on the card;
4. the 1024^2 headline (lines/spaces 64/128 px, quasar sigma 0.4/0.8)
   through simulate(device='cuda') against the f32 matmul engine (cuBLAS,
   TF32 off): <= 1e-6; wall clock and points/s of both. If the int8 kernels
   would need more than ~2 minutes for every point, every k-th point is used
   and the count is printed;
5. 2048^2, the 8-point sparse source, int8 engine against the complex128
   NumPy oracle (tests/numpy_oracle.py): <= 1e-6;
6. every kernel's launch count from phases 3-5 is > 0, and
   window_product_limbs launched as often as row_limb_gemm (an int8 chunk
   is those two, row_requantize and column_intensity).

The SOCS (Hopkins) path, its launches counted apart from phases 3-5:

7. each kernel against its plain version at the SOCS apply shapes, where
   the contraction is the whole chirp (w = n) and window_product_limbs
   multiplies a batch of whole kernels by the spectrum (zero starts):
   (4, 1024, 1024) and (4, 2048, 2048), and the ragged (2, 328, 264) with
   odd starts, 3-limb and 2-limb, <= 1e-6; the plan lines, the last
   valid starts and the odd row pitches as in phase 2; times as in phase 2;
8. the SOCS headline at 1024^2 (phase 4's mask and source, no
   aberrations): simulate(solver='socs', socs_rank=256) cold (build +
   apply), again on its cached kernels (apply) and with a new aberration
   (build + apply, warm libraries), with the report; the
   bench.py form (Nystrom, power_iters=1, rank 256, then socs_image) with
   build and apply timed apart, and the warm apply on the int8, matmul and
   fft engines; the exact f32 matmul image over every
   source point; the SOCS image within its reported socs_image_nrms_bound
   and within 2e-4 of the exact one (both builds); the int8 and the f32
   matmul applies each within 1e-6 of a complex128 apply of the same
   kernels, and within 1e-5 of each other (the JAX package's bound for
   that pair);
9. simulate(solver='socs') with the automatic rank at 1024^2: chosen rank,
   captured energy, bound (>= the measured error) and wall clock;
10. 2048^2 SOCS at w = 2048 with phase 5's 8-point source: rank(TCC) <= 8,
    so the rank-8 build is complete; the int8 image against phase 5's
    complex128 oracle: <= 1e-5;
11. the lean in-place build at 1024^2, rank 64: its image within 2e-4 of
    the standard build's; the build times and memory peaks of both;
12. as phase 6, for phases 8-11.

Vector (Jones-pupil), chromatic and through-focus imaging with scanner
perturbations, at phase 4's configuration, their launches counted apart
from phases 3-11:

13. simulate(polarization='unpolarized') over all 49,400 points on the
    int8 engine (six component passes), with its wall clock and points/s;
    on every 41st point the int8 and f32 matmul engines of
    vector_abbe_image, <= 1e-6; the same pair for x polarization at
    hyper-NA immersion (NA 1.35, water 1.437);
14. vector SOCS at rank 256: the bench.py form (randomized_socs_vector,
    power_iters=1, with the setup's channel rotation, then socs_image) with
    build, apply, channel count and the build's memory peak; its int8
    apply within 1e-6 of a complex128 apply of the same kernels and its
    image within the bound of its dropped trace; then
    simulate(solver='socs', polarization='unpolarized', socs_rank=256)
    cold and on its cached kernels, within its reported bound; each
    image's error against phase 13's exact image is printed;
15. chromatic, LaserSpectrum(bandwidth_pm=0.3, samples=5): the exact int8
    blend over all points, and on every 41st point int8 (simulate) against
    an f32 matmul blend, <= 1e-6; randomized_socs_chromatic at rank 256
    (power_iters=1, the channel rotation) and simulate(solver='socs',
    chromatic=..., socs_rank=256): each image within its bound and within
    5e-4 of the exact blend;
16. through_focus_images over 3 planes (-60, 0, 60 nm) on every 41st
    point, each plane within 1e-6 of simulate() with that plane's
    aberrations; through_focus_socs over the same planes at rank 96;
    simulate(solver='socs', socs_rank=256, perturb=ImagePerturbation(
    msd_x_nm=5, msd_y_nm=2, flare_tis=0.02)) on cached kernels, within
    1e-6 of a host float64 application of the same perturbation to the
    unperturbed image from the card;
17. as phase 6, for phases 13-16.

Thick-mask (M3D) imaging, gradients through the int8 engine, the M3D fits
and the in-film stack, at phase 4's configuration, their launches counted
apart from phases 3-16:

18. simulate(mask3d=BoundaryLayer(width_nm=8, beta_h, beta_v, beta_h_asym,
    beta_v_asym)) over all 49,400 points on the int8 engine, with its wall
    clock and points/s; on every 41st point int8 (simulate) against f32
    matmul on the same thick-mask spectrum, <= 1e-6, and the same pair for
    an EdgeKernelM3D with k = 1; simulate(solver='socs', socs_rank=256,
    mask3d=...) cold (the kernel cache emptied first) and on its cached
    kernels, within its reported bound and within 2e-4 of the exact M3D
    image;
19. on every 41st point, the gradient of sum(image * M) (M fixed, random,
    positive) for the spectrum and the pupil through the int8 engine
    against the matmul engine's autograd, atol 1e-6 * max|g|; the same for
    a rank-256 socs_image int8 apply (spectrum and eigenvalues); the
    forward and backward times of one step of each;
20. fit_boundary_layer (asymmetric) and fit_edge_kernel (k = 1), 10 Adam
    steps on the auto engine (int8) at 50 nm defocus on every 41st point,
    and the same fits on the f32 matmul engine: the loss must fall in each,
    and both fitted models are printed; boundary_layer_from_rcwa (m3dcal's
    calibration) at 256^2 and 50 steps: its fit must beat the thin mask;
    film_stack_images over 3 depths (all points, scalar), and
    film_socs_kernels with film_socs_stack at rank 96: each SOCS slab
    within its trace bound of the exact slab;
21. as phase 6, for phases 18-20, and each int8 fit of phase 20 by itself
    launched every kernel (no silent matmul fallback).

The resist over the int8-kernel aerial images, at phase 4's configuration;
each phase prints its wall time, its device-memory peak and its int8
launches, and fails if it launched a kernel where none was expected or
none where some were:

22. deterministic resist on the rank-256 SOCS image (int8 apply):
    ResistModel blur, develop and develop_binary, MackResist, the CD
    tables and exposure_latitude; the card's blurred field within 1e-6 of
    a float64 numpy FFT blur on the host, and its CDs equal to the host's
    (pixels that differ must lie within 1e-5 of the threshold);
23. the stochastic ensemble in bench.py's form (dose 20 photons/nm^2,
    diffusion 8 nm, threshold 0.3, PAG 5/nm^2), no int8 launch:
    exposure_trials (16 trials, trial_chunk 8, median of 3 seeds) as
    stochastic_device_trials_per_s, exposure_summary (16 trials, row_step
    2, read back) as stochastic_e2e_trials_per_s, stochastic_ensemble (64
    trials, psd=True) with LER, LWR, LCDU, defect rates and the PSD fit;
    the same seed gives the same fields and trial i the same field under
    trial_chunk 8 and 16, bit for bit; at 1e6 photons/nm^2 (no PAG) the
    mean field within 0.01 of deterministic_field; print probabilities in
    [0, 1]; the ensemble launches the edge_runs kernel
    (csrc/stochastic_edges.cu, built here: no spills) exactly twice a
    trial chunk, and on 16 of the card's trial fields at (16, 1024, 1024),
    row_step 2, its count pass equals edge_runs_plain's run counts exactly
    and its table pass the twin's edges bit for bit, twice over, with its
    device time against its byte bound (the kernels line's edge_runs
    entry);
24. film_socs_kernels (nz 8, rank 96) and film_socs_stack on resist over
    BARC on Si, then DepthResist.rigorous().develop_profile_binary (56
    eikonal sweeps at (8, 1024, 1024), no grad) with the sweep rate beside
    its bound (bytes a sweep, op by op, at 3.35 TB/s); with laterally
    uniform slowness the arrival times equal the cumulative vertical
    integral to 1e-6; an (8, 128, 128) crop solved on the card equals the
    float32 CPU solve to 1e-6; stochastic_volume_ensemble (8 trials); a
    one-slab deprotection_volume equals deprotection, bit for bit;
25. calibrate_resist on three 256^2 gauges the card imaged recovers the
    hidden threshold and diffusion (0.01, 1.5 nm: tests/test_calibrate.py);
    the focus, resist3d (with and without --film), stochastic and
    calibrate subcommands at 256^2 with --device cuda, in process, each
    exiting 0 with its JSON;
26. the launches of phases 22-25, summed (each phase checked in 22-25).

The tiled full chip (ops/tiled.py, metrology.py, models/mrc.py) at phase
4's optics through 1024^2 tiles, the default 96 px halo (an 832 px core
step), on a chip of phase 4's lines and spaces with 40 px contacts on
every crossing of the tile seams; each phase prints its wall time, memory
peak and launches, and fails if it launched no kernel:

27. tiled_socs_image of the 8192^2 chip, 100 tiles, rank 256, int8: wall
    clock, tiles/s, chip megapixels/s, the memory peak above the chip and
    the kernels, and the image's launches (exactly 64 of each kernel a
    tile); an interior tile's and the last corner tile's stitched cores
    equal the tile's window (cut from the chip by explicit indices) imaged
    as one field, within 1e-4 of its maximum; tiled_socs_image_stream
    through array_window_fn within 1e-6 of the array path, with its wall
    clock; the scan variant within 1e-5; the tiled int8 image within 1e-5
    (nrms) of the tiled f32 matmul engine's;
28. one tile's core 50 nm from focus, imaged with rank-128 kernels built
    warm (from the focal plane's basis, power_iters 0) and cold, each
    against the exact image: the warm error below max(2 x cold, 1e-5);
    then tiled_fem over the 8192^2 chip, 5 planes over -100..100 nm, the
    fem CLI's 5 doses, rank 128, warm starts: the CD matrix, DOF, exposure
    latitude, CDU, NILS and EPE, the wall clock split into builds, imaging
    and the develops with their CDs; the matrix finite and positive, the
    window non-empty, the CD monotone in dose at best focus;
29. at 4096^2 (25 tiles): tiled_film_stack (phase 24's stack, 8 slabs,
    rank 96) with two tiles' cores against film_socs_stack of their
    windows, 1e-4; resist3d --film --big-n 4096 through the CLI;
    tiled_socs_image_field at rank 64: 3 x 3 flat samples within 1e-5 of
    one, and under a field-edge defocus map (nearest) the center tile
    within 1e-6 of the flat image, the corners not;
    tiled_stochastic (16 trials) with its trials/s; orc_check with
    MaskRules (the layout passes its own rules); tiled_meef_map;
    defect_printability of a notch cut into one line (it must print);
    dose_correction_map of phase 28's FEM and apply_dose_map on the card
    equal to the float64 host product; the fem subcommand at --big-n 2048;
30. every kernel launched in phases 27-29, window_product_limbs as often
    as row_limb_gemm.

Optimization (optimize.py, models/sraf.py, models/multipatterning.py) at
phase 4's optics through the int8 kernels' gradient (the backward
recomputes in float32 and launches no int8 kernel); each phase prints its
wall time, memory peak and launches, and fails if it launched no kernel:

31. SMO at 1024^2: the target is the exact forward of the design over all
    49,400 points; optimize_socs, mask only, rank 64, 20 steps from a
    uniform 0.4 (the loss must fall by half), its first loss within 1e-5
    (relative) of the same loss formed through socs_image on the f32
    matmul engine with the same kernels, and one mask step's latent
    gradient on int8 within 1e-5 * max|g| of the matmul engine's; then on
    every 41st point optimize (exact Abbe, 5 steps) and the alternating
    optimize_socs (optimize_source, 2 x (a warm build, 5 mask steps, one
    exact source step)): the losses fall and the source logits move;
32. fit_aberrations through a 3-plane focal stack (-60, 0, 60 nm) on every
    41st point, 10 coefficients, 6 steps at learning rate 0.01 (0.05, the
    default, overshoots the 0.02-0.05 wave terms in so few steps), against
    images the port formed at known coefficients: the loss falls; the coefficient error against
    the truth is printed;
33. opc_correct on every 41st point, 5 steps, with the printed fidelity
    before and after; opc_correct_pw over 3 x 3 (defocus, dose) corners at
    rank 64, 5 steps, which with its fidelity (a rank-64 SOCS image on the
    matmul engine) must launch no int8 kernel; both losses fall;
34. opc_correct_tiled on a 2048^2 chip (phase 27's layout) through 3 x 3
    tiles of 1024^2 (96 px halo), rank 64, 10 steps, 1 sweep, with
    fidelity_before and fidelity_after as the opc subcommand forms them
    (the IoU must not fall) and the progress fractions; then the smo
    (--forward socs), opc (with the MRC flags), fitaberr (on images
    formed here) and lele subcommands at 256^2, the opc chip and lele at
    512^2, each with --device cuda;
35. every kernel launched in phases 31-34, window_product_limbs as often
    as row_limb_gemm.

Layouts in, contours out, and the HTTP server (io/*, serve.py) on the
card; each phase prints its wall time, memory peak and launches, and fails
if it launched a kernel where none was expected or none where some were:

36. the port's rasterizer (csrc/rasterizer.cpp, g++ into _build/); phase
    27's 8192^2 chip written as polygons through write_gds and write_oasis
    and read back: its full raster and mask_from_layout on the card equal
    the array phase 27 images, bit for bit, and a 1024^2 window of
    window_provider equals _rasterize_numpy and the chip's slice, bit for
    bit; the read and rasterize times (host);
37. the CLI on layouts: simulate --mask-file head.gds --gds-layer 1 at
    1024^2 (SOCS, rank 256) against the .npy path, <= 1e-6; fem --stream at
    --big-n 4096, rank 128, the same report as the array path (CD matrix,
    window); lele --gds at 512^2, its GDSII re-rasterized equal to the
    decomposed masks;
38. a worker on the card (make_server(device='cuda') in a thread): /health
    names the card; the exact 1024^2 headline through /simulate within
    1e-6 of a local simulate; solver socs, socs_rank 256: one cold request,
    then a burst of 8 concurrent same-signature requests with different
    masks, each within 1e-6 of a local simulate_batch on the same cached
    kernels, in fewer than 8 batches; each request's latency (median, max)
    and the burst's requests/s;
39. jobs on the card: a tiled job at 4096^2 (1024^2 tiles, rank 64) whose
    streamed artifact equals a local tiled_socs_image bit for bit, its
    progress rising; a fem job with the local tiled_fem's CD matrix; a
    running fem job cancelled; opc, stochastic, lele and film jobs at 512^2
    tiles, each done;
40. a router over two in-process workers on the card: same signature, same
    worker; failover past a dead URL; a job's polls pinned to its worker;
    its artifact relayed chunk by chunk, equal to phase 39's;
41. every kernel launched in phases 36-40 (phase 36 none),
    window_product_limbs as often as row_limb_gemm.

Multi-device (parallel/*) at full width on a 4-entry mesh of cuda:0 (one
card runs the shards one after another), and, where there are two or more
cards, phases 42 and 44 again over every card (the kernels' shared-memory
limit is set for each device: ROADMAP F9); each phase prints its wall
time, memory peak and launches, and fails if it launched no kernel:

42. the 1024^2 headline's 49,400 points padded to 49,408 through
    abbe_image_sharded: within 1e-6 of simulate(), exactly 12,352 launches
    of each kernel (3,088 a shard), points/s beside the single device's
    (abbe_image_points on the same list, warm); through_focus_sharded over
    2 planes on a (2, 2) mesh, the in-focus plane within 1e-6;
43. the rank-256 build of bench.py:102-115 (Nystrom, power_iters=1)
    through randomized_socs_sharded against the local build at the same
    seed (eigenvalues to rtol 1e-4, atol 1e-6 of the leading one; the
    image within 1e-5), with seconds and memory peaks of both;
    socs_image_sharded within 1e-6 of the local int8 apply, exactly 64
    launches of each kernel (16 a shard);
44. phase 27's 8192^2 chip through tiled_socs_image_sharded at rank 256:
    equal to tiled_socs_image bit for bit, exactly 6,400 launches;
45. print_probability_sharded (16 trials) and
    print_probability_volume_sharded (8 trials) equal to the
    single-device bands bit for bit; film_stack_sharded (3 slabs, every
    41st point) within 1e-5 of film_stack_images; fem_cd_matrix_sharded on
    a (2, 2) mesh, CDs within 1e-4 (relative) of the same math on the
    single-device focal stack, growing with dose;
46. one optimize(mesh=) step at 1024^2 on every 41st point (1,205): the
    loss within 1e-6 (relative) and the mask gradient within 1e-6 *
    max|g| of mesh=None; then dryrun_multichip(4), the seven patterns at
    64^2; the summed launches of phases 42-46 and device_count.

The production flow (examples/production_flow_torch.py: OPC, MRC repair,
ORC, the FEM, the dose map, the stochastic ensemble, printed contours to
GDS), its stages fed one into the next on the card; each phase prints its
wall time, memory peak and launches, and fails if it launched no kernel:

47. run_flow(4096, 1024, tmp, 'cuda'): 5 x 5 tiles of 1024^2 at the
    flow's 16 px halo, 10,404 contacts, rank 48; each stage's wall time
    (the device synchronized); every marker line present once and every
    number in it finite; the written GDS read back (io.gdsii.read_gds) and
    re-rasterized (io.contours.rasterize_loops) equal to the developed
    profile bit for bit; the ORC IoU after OPC at least that of the
    uncorrected layout imaged the same way;
48. the flow's stages called one by one at the JAX example's size (128^2
    chip, 64^2 tiles) on the card and on the CPU: the corrected masks
    equal, or each differing pixel's continuous CPU value within 1e-3 of
    the 0.5 threshold (listed); ORC, FEM and dose-map numbers to the
    tolerances written at TOL_FLOW_* (a few one-pixel flips: the card
    images on int8 with its own generator's probes); the stochastic
    ensemble in distribution (mean CD within 5 sampling errors, LER and
    LWR within 10%, the defect rates within 5 binomial errors); then every
    kernel launched in phases 47-48, window_product_limbs as often as
    row_limb_gemm.

Run time on one H100 is about 8 minutes, most of it phase 4's int8 run,
phase 5's host oracle, phase 8's exact image, phases 13 and 15's exact
images, phase 20's fits and film slabs, phases 27-29's full chips and
phase 47's flow.

Kernel, plain and library times are device times: medians of 5 CUDA-event
samples of one CUDA-graph replay of 10 back-to-back calls each, after a
warm-up (time_ms); the wrappers' host time is not in them. plain_ms of window_product_limbs is the
chain it replaces: the gather and product, then quantize_x. library_ms is
one PyTorch call of the same contraction, in complex64 with TF32 off:
torch.matmul(T0, X) for row_limb_gemm and torch.matmul(Y, T0^T) for
column_intensity (without the |E|^2 sum); none for the two quantizers.
bound_ms is the least time the card could take: the larger of the int8
tensor-core operations (3 planes x 6 limb dots x 2*M*N*K, 3 dots 2-limb)
over 1,979 TOP/s and the bytes read and written once over 3.35 TB/s; for
window_product_limbs the bytes read are the union of this run's windows.

The last stdout line is {"ok": true, "device": {...}}; the line before it
is nvidia-smi's name and power limit, and the one before that lists each
kernel with its launches, error, times and bound (launches on phases 3-5,
socs_launches on phases 8-11, vector_launches on phases 13-16,
m3d_launches on phases 18-20, resist_launches on phases 22-25,
tiled_launches on phases 27-29, optimize_launches on phases 31-34,
serve_launches on phases 36-40, parallel_launches on phases 42-46 and
flow_launches on phases 47-48; ms,
library_ms and bound_ms at the exact-Abbe shape, socs_ms, socs_library_ms
and socs_bound_ms at (4, 1024, 1024), the shapes phases 13-16 run at too;
and the edge_runs entry: launches in phase 23's ensemble, count_ms and
table_ms of its two passes (time_ms), plain_ms of the plain twin's two
passes (CUDA events around single calls: the table pass's nonzero syncs,
so no graph) and bound_ms, the bytes read and written once over 3.35
TB/s).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CU_SOURCE = "lithographysimulator_tpu_torch/csrc/intensity_int8.cu"
EDGES_SOURCE = "lithographysimulator_tpu_torch/csrc/stochastic_edges.cu"
EDGES_REPLACES = ("lithographysimulator_tpu/models/resist.py:feature_table and "
                  "the run counts of stochastic_ensemble, on the host (numpy)")
TPU_KERNELS = "lithographysimulator_tpu/ops/kernels/intensity_int8.py"
KERNELS = {
    "window_product_limbs": f"{TPU_KERNELS}:273-278 (quantize_cols of X in "
                            "row_transform_int8), "
                            f"{TPU_KERNELS}:402-407 (in row_transform_int8_splitk)",
    "row_limb_gemm": f"{TPU_KERNELS}:297 (row_transform_int8), "
                     f"{TPU_KERNELS}:431 (row_transform_int8_splitk)",
    "row_requantize": f"{TPU_KERNELS}:203 (_quant_rows_in_kernel, in the "
                      "row kernels at :297 and :431)",
    "column_intensity": f"{TPU_KERNELS}:161 (column_intensity_int8)",
}
RAGGED_SHAPE = (2, 328, 264)  # kp = 288: a half-full last K stage
KERNEL_SHAPES = ((4, 1024, 520), (4, 2048, 1032), (3, 96, 40), RAGGED_SHAPE)
SOCS_KERNEL_SHAPES = ((4, 1024, 1024), (4, 2048, 2048), RAGGED_SHAPE)
TENSOR_CORE_KERNELS = ("row_limb_gemm", "column_intensity")
INT8_TOPS = 1979e12  # H100 SXM dense int8 tensor-core peak, operations/s
HBM_BYTES_S = 3.35e12
TOL_KERNEL = 1e-6
TOL_GOLDEN = 2e-3
TOL_FFT = 1e-5
TOL_MATMUL = 1e-6
TOL_ORACLE = 1e-6
TOL_SOCS_EXACT = 2e-4
TOL_SOCS_PAIR = 1e-5  # int8 against matmul apply: tests/test_hopkins.py:164-172
TOL_SOCS_ORACLE = 1e-5
TOL_LEAN = 2e-4
INT8_BUDGET_S = 120.0
SOCS_RANK = 256
SUBSET_K = 41  # every k-th source point for the f32 references of 13-16
TOL_CHROMATIC_SOCS = 5e-4  # tests/test_chromatic.py:141-150
FOCUS_PLANES = (-60.0, 0.0, 60.0)
FOCUS_RANK = 96
FIT_STEPS = 10
M3DCAL_N = 256  # m3dcal's calibration grid in phase 20 (its CLI default is 64)
M3DCAL_STEPS = 50
FILM_RANK = 96
DEVICE = "cuda"  # of phases 27-29
TILE_N = 1024  # phases 27-29: the tile (one optical field)
TILED_BIG_N = 8192  # phase 27-28's chip: 10 x 10 tiles of 1024^2
SLICE_BIG_N = 4096  # phase 29's chip (the time limit)
CLI_FEM_BIG_N = 2048
FEM_RANK = 128
FEM_DOSES = (0.8, 0.9, 1.0, 1.1, 1.2)  # the fem CLI's default doses
TOL_TILE_CORE = 1e-4  # tests/test_tiled.py:81-103
TOL_STREAM = 1e-6  # tests/test_tiled_stream.py:24-30
TOL_SCAN = 1e-5  # tests/test_tiled.py:75-78
OPT_N = 1024  # phases 31-34: phase 4's optics, and phase 34's tile
OPT_RANK = 64  # optimize_socs' and the OPC functions' default rank
OPT_BIG_N = 2048  # phase 34's chip: 3 x 3 tiles of 1024^2 at the 96 px halo
CLI_OPT_N = 256  # phase 34's smo and fitaberr, and the opc tile
CLI_OPT_BIG_N = 512  # phase 34's opc chip and lele grid
SMO_STEPS = 20
TOL_SMO_LOSS = 1e-5  # the int8 history's first loss against the matmul one
TOL_OPT_GRAD = 1e-5  # * max|g|, the int8 mask-step gradient against matmul
SERVE_N = 1024  # phases 37-38: phase 4's headline, through the CLI and a worker
SERVE_BIG_N = 4096  # phases 37, 39: fem --stream and the jobs' chip (25 tiles)
JOB_RANK = 64  # phase 39's tiled, fem and 512^2-tile jobs
JOB_TILE_N = 512  # phase 39's opc, stochastic, lele and film tiles
JOB_BIG_N = 1024  # their chip
TOL_LAYOUT = 1e-6  # a layout or served image against the array path's
PARALLEL_ENTRIES = 4  # phases 42-46: a mesh of MESH_ENTRY x 4
MESH_ENTRY = "cuda:0"
FLOW_BIG_N = 4096  # phase 47's chip: 5 x 5 tiles of 1024^2 at the flow's halo
FLOW_SMALL = (128, 64)  # phase 48: the JAX example's own chip and tile
FLOW_HALO = 16  # examples/production_flow_torch.py's halo, rank and trials
FLOW_RANK = 48
FLOW_TRIALS = 8
FLOW_MARKERS = ("MRC:", "ORC:", "FEM:", "dose map", "stochastic:", "wrote")
# Phase 48, the card against the CPU. The card images on the int8 kernels
# (the CPU on fft) with builds from the card's own generator (other probes
# than the CPU's), so the two agree in the class of a few one-pixel flips
# of the develops, not bit for bit: a pixel where the corrected masks differ
# must have the CPU's continuous OPC value within TOL_FLOW_THRESHOLD of 0.5,
# and the continuous masks lie within TOL_FLOW_OPC (OPC moves them by up to
# about 0.34 at this size, and leaves every pixel on its side of 0.5);
# IoU within TOL_FLOW_IOU (one 25 nm pixel is 4.6e-4 of the 128^2 chip's);
# max |EPE| within one pixel; DOF, exposure latitude and ORC pass equal; FEM
# CDs (the mean over about 108 features: a one-pixel flip of one feature is
# 0.23 nm) and CDU within TOL_FLOW_CD_NM; mean NILS and the dose sensitivity
# within TOL_FLOW_REL relative; the dose map within TOL_FLOW_DOSE.
TOL_FLOW_THRESHOLD = 1e-3
TOL_FLOW_OPC = 1e-2
TOL_FLOW_IOU = 1e-3
TOL_FLOW_CD_NM = 1.0
TOL_FLOW_REL = 1e-2
TOL_FLOW_DOSE = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def nrms(a, b) -> float:
    a = np.asarray(a, np.complex128 if np.iscomplexobj(a) else np.float64)
    b = np.asarray(b, np.complex128 if np.iscomplexobj(b) else np.float64)
    return float(np.sqrt(np.mean(np.abs(a - b) ** 2)) / np.abs(b).max())


def check(name: str, value: float, tol: float) -> None:
    ok = np.isfinite(value) and value <= tol
    log(f"  {name}: {value:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} = {value:.3e} exceeds {tol:.0e}")


def check_image(img, n: int) -> np.ndarray:
    img = img.detach().cpu().numpy()
    if img.shape != (n, n) or not np.isfinite(img).all() or img.max() <= 0:
        raise AssertionError(f"bad image: shape {img.shape}, "
                             f"finite {np.isfinite(img).all()}, max {img.max()}")
    return img


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(torch, fn, reps: int = 5, calls: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` back-to-back calls are
    captured once into a CUDA graph (after a warm-up call on a side
    stream), and the median over ``reps`` replays between two CUDA events
    is divided by ``calls``. A replay launches the captured kernels with no
    Python in between, so the wrappers' host time (about 0.04 ms a call)
    is not counted, however short the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return float(np.median(times))


def phase_build(build) -> None:
    """Phase 1: build, then check registers, spills and machine code."""
    t0 = time.perf_counter()
    lib, nvcc_log = build.build()
    log(f"[phase 1] built {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in nvcc_log.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling",
                                   "wgmma", "Performance")):
            log(f"  ptxas: {line.strip()}")
    spills = ptxas_spills(nvcc_log)
    counts = sass_counts(build.sass(lib))
    for fn, c in sorted(counts.items()):
        log(f"  sass {fn}: IGMMA {c['IGMMA']}, IMMA {c['IMMA']}, "
            f"IDP.4A {c['IDP']}")
    for kernel in TENSOR_CORE_KERNELS:
        fns = [fn for fn in counts if f"{kernel}_kernel" in fn]
        if len(fns) != 2:
            raise AssertionError(f"{kernel}: expected 2 instantiations in the "
                                 f"SASS, found {fns}")
        for fn in fns:
            c = counts[fn]
            if c["IGMMA"] + c["IMMA"] == 0 or c["IDP"]:
                raise AssertionError(f"{fn}: no tensor-core MMA or IDP.4A left: {c}")
    for kernel in KERNELS:
        fns = [fn for fn in counts if f"{kernel}_kernel" in fn]
        if not fns or any(spills.get(fn) != 0 for fn in fns):
            raise AssertionError(f"{kernel}: kernels {fns}, ptxas spill bytes "
                                 f"{[spills.get(fn) for fn in fns]}")
    log("  tensor-core MMA in every GEMM kernel, no IDP.4A, no kernel spills: ok")
    build.load_library()


def ptxas_spills(nvcc_log: str) -> dict:
    """{mangled function name: spill store + load bytes} from ptxas -v."""
    spills, current = {}, None
    for line in nvcc_log.splitlines():
        if "Function properties for" in line:
            current = line.split("Function properties for")[-1].strip()
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            spills[current] = int(m.group(1)) + int(m.group(2))
    return spills


def sass_counts(sass: str) -> dict:
    """{mangled kernel name: counts of IGMMA, IMMA, IDP opcodes}."""
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = {"IGMMA": 0, "IMMA": 0, "IDP": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                      line)
        if m and current and m.group(1) in counts[current]:
            counts[current][m.group(1)] += 1
    return counts


def bound(name: str, batch: int, n: int, w: int, kp: int, fast: bool,
          read_bytes: int = 0):
    """(bound ms, 'operations' or 'bytes') of one kernel call: operations
    over the int8 peak or bytes (each input read once, each output written
    once) over the memory rate, whichever is larger. ``read_bytes`` is what
    window_product_limbs reads (window_read_bytes)."""
    limbs, dots = (2, 3) if fast else (3, 6)
    if name == "window_product_limbs":  # a few operations per element
        ops = 0
        nbytes = read_bytes + 16 * batch + 9 * batch * w * kp + 4 * 3 * batch * w
    elif name == "row_limb_gemm":
        ops = 3 * dots * 2 * batch * n * w * w
        nbytes = (3 * limbs * (batch * w + n) * kp + 4 * 3 * (batch * w + n)
                  + 2 * 4 * batch * n * w)
    elif name == "column_intensity":
        ops = 3 * dots * 2 * batch * n * n * w
        nbytes = (3 * limbs * (batch * n + n) * kp + 4 * 3 * (batch * n + n)
                  + 4 * batch + 2 * 4 * n * n)
    else:  # row_requantize: a few operations per element, bound by bytes
        ops = 0
        nbytes = 2 * 4 * batch * n * w + 9 * batch * n * kp + 4 * 3 * batch * n
    t_ops, t_bytes = ops / INT8_TOPS, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def window_read_bytes(starts: np.ndarray, w: int, a_shape, b_shape) -> int:
    """Bytes of the complex64 elements that the (w, w) windows at ``starts``
    (B, 4) cover, each counted once: the union of the windows in each array
    of ``a`` (one per batch entry, or one shared) and in ``b``."""
    a_cover = np.zeros(tuple(a_shape), bool)
    b_cover = np.zeros(tuple(b_shape), bool)
    for k, (ar, ac, br, bc) in enumerate(starts):
        a_cover[k if a_shape[0] > 1 else 0, ar:ar + w, ac:ac + w] = True
        b_cover[br:br + w, bc:bc + w] = True
    return 8 * int(a_cover.sum() + b_cover.sum())


def window_operands(rng, batch: int, n: int, w: int):
    """Operands of window_product_limbs as the main paths give them: for
    w < n (exact Abbe) one tiled 2n x 2n array and an n x n spectrum with
    windows at random starts, the columns odd (8-byte aligned rows); for
    w = n (SOCS) a batch of n x n kernels at zero starts."""
    def cplx(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)

    if w == n:
        return cplx(batch, n, n), cplx(n, n), np.zeros((batch, 4), np.int64)
    starts = np.stack([rng.integers(0, 2 * n - w + 1, batch),
                       rng.integers(0, (2 * n - w) // 2, batch) * 2 + 1,
                       rng.integers(0, n - w + 1, batch),
                       rng.integers(0, (n - w) // 2, batch) * 2 + 1], axis=1)
    return cplx(1, 2 * n, 2 * n), cplx(n, n), starts


def dequant(limbs, scales) -> np.ndarray:
    """(3, 3, B, n, kp) limbs + (3, B, n) scales -> (3, B, n, kp) f64."""
    l = limbs.double()
    v = (l[:, 0] + l[:, 1] / 256.0 + l[:, 2] / 65536.0) * scales.double()[..., None]
    return v.cpu().numpy()


def check_same_limbs(name: str, diff: int, scales_k, scales_p) -> None:
    """The quantizers' design gives the plain versions' limbs and scales
    bit for bit: any differing limb or scale fails the phase."""
    bits_k, bits_p = (s.cpu().numpy().view(np.int32) for s in (scales_k, scales_p))
    differ = int((bits_k != bits_p).sum())
    if diff or differ:
        raise AssertionError(f"{name}: {diff} limbs and {differ} scales differ "
                             f"from plain")
    log(f"  {name} limbs and scales equal plain's bit for bit: ok")


def log_window_plan(ik, tag: str, a, b, starts_np, w: int) -> dict:
    """Logs window_product_limbs' launch plan for these operands (load path,
    cluster size, rows a block) and how many window rows start at an odd
    column (TMA boxes that start a column early)."""
    plan = ik.window_product_limbs_plan(a, b, w)
    odd = int((starts_np[:, 1] % 2).sum() + (starts_np[:, 3] % 2).sum())
    log(f"  window_product_limbs {tag}: a {tuple(a.shape)}, b {tuple(b.shape)}, "
        f"w={w}: {plan['path']} loads, cluster {plan['cluster']}, "
        f"{plan['rows']} rows, {plan['threads']} threads, {plan['slots']} b "
        f"slots and {plan['smem']} bytes a block; {odd} of "
        f"{2 * len(starts_np)} window rows start at an odd column")
    return plan


def window_case(torch, ik, tag: str, a_np, b_np, starts_np, w: int,
                path: str) -> float:
    """window_product_limbs on one set of operands against its plain
    version, bit for bit, with its plan logged, which must load by
    ``path``; returns the kernel's time in ms."""
    dev = torch.device("cuda")
    starts_np = ik.check_window_starts(starts_np, w, a_np.shape, b_np.shape)
    args = (torch.as_tensor(a_np, device=dev), torch.as_tensor(b_np, device=dev),
            torch.as_tensor(starts_np, device=dev), w)
    plan = log_window_plan(ik, tag, args[0], args[1], starts_np, w)
    if plan["path"] != path:
        raise AssertionError(f"window_product_limbs {tag}: {plan['path']} "
                             f"loads, expected {path}")
    xl, xs = ik.window_product_limbs(*args)
    pl, ps = ik.window_product_limbs_plain(*args)
    check_same_limbs(f"window_product_limbs {tag}", int((xl != pl).sum()), xs, ps)
    return time_ms(torch, lambda: ik.window_product_limbs(*args))


def odd_pitch(x: np.ndarray) -> np.ndarray:
    """x with one more row and column (odd row pitches for even sides):
    the operands window_product_limbs loads per thread."""
    pad = ((0, 0),) * (x.ndim - 2) + ((0, 1), (0, 1))
    return np.ascontiguousarray(np.pad(x, pad))


def phase_kernels(torch, ik, phase: int, shapes) -> dict:
    """Phases 2 and 7: each kernel against its plain version at ``shapes``;
    returns the JSON fields measured at the first shape, 3-limb mode. Each
    kernel gets the plain version's output of the kernel before it, so
    both see the same input."""
    rng = np.random.default_rng(phase)
    dev = torch.device("cuda")
    stats = {}
    for batch, n, w in shapes:
        a_np, b_np, starts_np = window_operands(rng, batch, n, w)
        starts_np = ik.check_window_starts(starts_np, w, a_np.shape, b_np.shape)
        a, b = torch.as_tensor(a_np, device=dev), torch.as_tensor(b_np, device=dev)
        starts = torch.as_tensor(starts_np, device=dev)
        t0 = np.exp(1j * rng.normal(size=(n, w))).astype(np.complex64)
        t0_c = torch.as_tensor(t0, device=dev)
        t_limbs, t_scales = ik.prepare_t0_limbs(
            torch.as_tensor(t0.real, device=dev), torch.as_tensor(t0.imag, device=dev))
        weights = torch.as_tensor(rng.random(batch).astype(np.float32), device=dev)
        kp = t_limbs.shape[-1]
        log(f"[phase {phase}] B={batch} n={n} w={w}, window starts "
            f"{starts_np[0].tolist()}{' (odd columns)' if w < n else ''}")
        # window_product_limbs: X's column limbs straight from the operands
        log_window_plan(ik, "plan", a, b, starts_np, w)
        if w < n:  # every window at its last valid start
            last = np.tile([2 * n - w, 2 * n - w, n - w, n - w], (batch, 1))
            window_case(torch, ik, "at the last valid starts", a_np, b_np, last,
                        w, "tma")
        if (batch, n, w) == shapes[0]:  # odd row pitches: per-thread loads
            ms = window_case(torch, ik, "with odd row pitches", odd_pitch(a_np),
                             odd_pitch(b_np), starts_np, w, "per-thread")
            log(f"  window_product_limbs per-thread loads: {ms:.4f} ms")
        wargs = (a, b, starts, w)
        xl_k, xs_k = ik.window_product_limbs(*wargs)
        x_limbs, x_scales = ik.window_product_limbs_plain(*wargs)
        diff = int((xl_k != x_limbs).sum())
        log(f"  window_product_limbs limbs differing from plain: {diff} of "
            f"{x_limbs.numel()}")
        check_same_limbs("window_product_limbs", diff, xs_k, x_scales)
        dq_k, dq_p = dequant(xl_k, xs_k), dequant(x_limbs, x_scales)
        check("window_product_limbs dequantized X vs plain", nrms(dq_k, dq_p),
              TOL_KERNEL)
        x_err = float(np.abs(dq_k - dq_p).max())
        x_ms = (time_ms(torch, lambda: ik.window_product_limbs(*wargs)),
                time_ms(torch, lambda: ik.window_product_limbs_plain(*wargs)),
                None)
        x_bytes = window_read_bytes(starts_np, w, a_np.shape, b_np.shape)
        x = ik.window_products(a, b, starts, w)
        for fast in (False, True):
            tag = f"B={batch} n={n} w={w} {'2-limb' if fast else '3-limb'}"
            log(f"[phase {phase}] {tag}")
            # row_limb_gemm
            args = (x_limbs, x_scales, t_limbs, t_scales)
            yr_k, yi_k = ik.row_limb_gemm(*args, fast=fast)
            yr_p, yi_p = ik.row_limb_gemm_plain(*args, fast=fast)
            torch.cuda.synchronize()
            y_k = torch.complex(yr_k, yi_k).cpu().numpy()
            y_p = torch.complex(yr_p, yi_p).cpu().numpy()
            check("row_limb_gemm Y vs plain", nrms(y_k, y_p), TOL_KERNEL)
            err = {"window_product_limbs": x_err,
                   "row_limb_gemm": float(np.abs(y_k - y_p).max())}
            # row_requantize
            yl_k, ys_k = ik.row_requantize(yr_p, yi_p, kp)
            yl_p, ys_p = ik.row_requantize_plain(yr_p, yi_p, kp)
            dq_k, dq_p = dequant(yl_k, ys_k), dequant(yl_p, ys_p)
            diff = int((yl_k != yl_p).sum())
            log(f"  row_requantize limbs differing from plain: {diff} of "
                f"{yl_p.numel()}")
            check_same_limbs("row_requantize", diff, ys_k, ys_p)
            check("row_requantize dequantized Y vs plain", nrms(dq_k, dq_p),
                  TOL_KERNEL)
            err["row_requantize"] = float(np.abs(dq_k - dq_p).max())
            # column_intensity
            cargs = (yl_p, ys_p, t_limbs, t_scales, weights)
            img_k = ik.column_intensity_int8(*cargs, fast=fast).cpu().numpy()
            img_p = ik.column_intensity_int8_plain(*cargs, fast=fast).cpu().numpy()
            check("column_intensity image vs plain", nrms(img_k, img_p), TOL_KERNEL)
            err["column_intensity"] = float(np.abs(img_k - img_p).max())
            y_c = torch.complex(yr_p, yi_p)
            acc = torch.zeros((n, n), dtype=torch.float32, device=dev)
            ms = {
                "window_product_limbs": x_ms,
                "row_limb_gemm": (
                    time_ms(torch, lambda: ik.row_limb_gemm(*args, fast=fast)),
                    time_ms(torch, lambda: ik.row_limb_gemm_plain(*args, fast=fast)),
                    time_ms(torch, lambda: torch.matmul(t0_c, x))),
                "row_requantize": (
                    time_ms(torch, lambda: ik.row_requantize(yr_p, yi_p, kp)),
                    time_ms(torch, lambda: ik.row_requantize_plain(yr_p, yi_p, kp)),
                    None),
                "column_intensity": (
                    time_ms(torch, lambda: ik.column_intensity_int8(
                        *cargs, fast=fast, out=acc)),
                    time_ms(torch, lambda: ik.column_intensity_int8_plain(
                        *cargs, fast=fast, out=acc)),
                    time_ms(torch, lambda: torch.matmul(y_c, t0_c.T))),
            }
            entries = {}
            for name, (k_ms, p_ms, lib_ms) in ms.items():
                b_ms, b_by = bound(name, batch, n, w, kp, fast, x_bytes)
                lib = "-" if lib_ms is None else f"{lib_ms:.4f} ms"
                log(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                    f"library {lib}, bound {b_ms:.4f} ms ({b_by}), "
                    f"{100 * b_ms / k_ms:.1f}% of bound")
                entries[name] = {"max_abs_err": err[name], "ms": k_ms,
                                 "plain_ms": p_ms, "library_ms": lib_ms,
                                 "bound_ms": b_ms, "bound_by": b_by}
            if not stats:
                stats = entries
    return stats


def phase_demo(torch, lt) -> None:
    """Phase 3: the 64^2 demo through simulate() on the card."""
    from lithographysimulator_tpu_torch.ops.abbe import abbe_image

    cfg = lt.DEMO_CONFIG
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    aberr = np.array([0, 0, 0.01, 0, 100, 0.01, 0, 0.01, 0.01, 0.01], np.float32)
    res = lt.simulate(lt.demo_bars(cfg, device="cuda"), src, aberr, device="cuda")
    img = check_image(res.image, cfg.n)
    log(f"[phase 3] demo 64^2: {res.report['source_points']} points, "
        f"{res.report['wall_clock_s']:.3f} s, image max {img.max():.6e}")
    golden = np.load(REPO / "tests" / "golden" / "demo_aerial_image_fft.npy")
    check("demo int8 vs golden", nrms(img, golden), TOL_GOLDEN)
    fft = abbe_image(res.spectrum, res.pupil, src, cfg, device="cuda",
                     engine="fft")
    check("demo int8 vs fft engine (card)", nrms(img, check_image(fft, cfg.n)),
          TOL_FFT)


def phase_headline(torch, lt) -> None:
    """Phase 4: 1024^2 exact Abbe, int8 (simulate) against f32 matmul."""
    from lithographysimulator_tpu_torch.ops.abbe import (abbe_image_points,
                                                         source_points)

    n = 1024
    cfg = lt.OpticsConfig(pixel_number=n)
    mask = lt.lines_and_spaces(cfg, line_width_px=n // 16, pitch_px=n // 8,
                               device="cuda")
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    pts = source_points(src)
    # probe the int8 rate on 256 points to size the run
    probe = lt.simulate(mask, _subset(src, pts, 193), device="cuda")
    rate = probe.report["source_points"] / probe.report["wall_clock_s"]
    k = max(1, int(np.ceil(pts.live_count / rate / INT8_BUDGET_S)))
    sub = _subset(src, pts, k)
    res = lt.simulate(mask, sub, device="cuda")
    img = check_image(res.image, n)
    used = res.report["source_points"]
    t_int8 = res.report["wall_clock_s"]
    log(f"[phase 4] 1024^2: {pts.live_count} live points, every {k}-th used: "
        f"{used} points")
    log(f"  int8 (simulate): {t_int8:.3f} s, {used / t_int8:.1f} points/s")
    sp = source_points(sub)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = abbe_image_points(res.spectrum, res.pupil, *_padded(sp, 4), cfg,
                            device="cuda", engine="matmul")
    torch.cuda.synchronize()
    t_mm = time.perf_counter() - t0
    log(f"  matmul f32 (abbe_image_points): {t_mm:.3f} s, "
        f"{used / t_mm:.1f} points/s")
    check("1024^2 int8 vs f32 matmul", nrms(img, check_image(ref, n)), TOL_MATMUL)


def _subset(src: np.ndarray, pts, k: int) -> np.ndarray:
    """Source map keeping every k-th live point (row-major order)."""
    n = src.shape[0]
    keep = pts.shifts[::k] + n // 2
    out = np.zeros_like(src)
    out[keep[:, 0], keep[:, 1]] = src[keep[:, 0], keep[:, 1]]
    return out


def _padded(sp, chunk: int):
    from lithographysimulator_tpu_torch.ops.abbe import _pad_points

    return _pad_points(sp.shifts, sp.weights, chunk)


def phase_oracle(torch, lt):
    """Phase 5: 2048^2 sparse source, int8 engine vs complex128 oracle.
    Returns (mask, source map, oracle image) for phase 10."""
    from lithographysimulator_tpu_torch.ops.abbe import (abbe_image_points,
                                                         source_points)

    sys.path.insert(0, str(REPO))
    from tests import numpy_oracle as oracle

    n = 2048
    cfg = lt.OpticsConfig(pixel_number=n)
    mask = lt.lines_and_spaces(cfg, line_width_px=n // 16, pitch_px=n // 8,
                               device="cuda")
    src = np.zeros((n, n), np.float32)
    bnd = n // 4 - 2
    for dy, dx in [(0, 0), (bnd, 0), (0, -bnd), (-(bnd // 2), bnd // 2),
                   (bnd // 3, bnd // 3), (-bnd, -(bnd // 4)), (7, -29),
                   (-53, 11)]:
        src[n // 2 + dy, n // 2 + dx] = 1.0
    spectrum = lt.mask_spectrum(mask.geometry, cfg)
    pupil = lt.pupil_function(np.zeros(1, np.float32), cfg, device="cuda")
    sp = source_points(src)
    t0 = time.perf_counter()
    img = abbe_image_points(spectrum, pupil, *_padded(sp, 4), cfg,
                            device="cuda", engine="int8")
    img = check_image(img, n)
    log(f"[phase 5] 2048^2 int8, 8 points: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    ref = oracle.abbe64(mask.geometry.cpu().numpy(), src, np.zeros(1, np.float32),
                        pixel_size=cfg.pixel_size, wavelength=cfg.wavelength,
                        na=cfg.na)
    log(f"  complex128 oracle on the host: {time.perf_counter() - t0:.1f} s")
    check("2048^2 int8 vs float64 oracle", nrms(img, ref), TOL_ORACLE)
    return mask, src, ref


def _timed(torch, fn):
    """(result, wall seconds) of ``fn()`` with the device synchronized on
    both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _headline_setup(lt, n: int):
    cfg = lt.OpticsConfig(pixel_number=n)
    mask = lt.lines_and_spaces(cfg, line_width_px=n // 16, pitch_px=n // 8,
                               device="cuda")
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    return cfg, mask, src


def phase_socs_headline(torch, lt):
    """Phase 8: the 1024^2 SOCS headline against the exact f32 image.
    Returns the exact image for phase 9."""
    from lithographysimulator_tpu_torch.ops.abbe import (abbe_image_points,
                                                         source_points)

    n = 1024
    cfg, mask, src = _headline_setup(lt, n)
    res, t_cold = _timed(torch, lambda: lt.simulate(
        mask, src, solver="socs", socs_rank=SOCS_RANK, device="cuda"))
    img = check_image(res.image, n)
    warm, t_apply = _timed(torch, lambda: lt.simulate(
        mask, src, solver="socs", socs_rank=SOCS_RANK, device="cuda"))
    # new kernels (a 1e-3 nm defocus is another cache key), warm libraries
    _, t_warm = _timed(torch, lambda: lt.simulate(
        mask, src, [0, 0, 0, 0, 1e-3], solver="socs", socs_rank=SOCS_RANK,
        device="cuda"))
    log(f"[phase 8] 1024^2 SOCS rank {SOCS_RANK} via simulate(): "
        f"cold (build + apply, first use of cuFFT/cuSOLVER) {t_cold:.3f} s, "
        f"apply on cached kernels {t_apply:.3f} s, new kernels with warm "
        f"libraries (build + apply) {t_warm:.3f} s")
    log(f"  report: {json.dumps(res.report)}")
    check("cached-kernel rerun vs cold run", nrms(check_image(warm.image, n), img),
          TOL_MATMUL)

    pupil = lt.pupil_function(np.zeros(1, np.float32), cfg, device="cuda")
    socs, t_build = _timed(torch, lambda: lt.randomized_socs(
        pupil, src, cfg, rank=SOCS_RANK, power_iters=1, method="nystrom"))
    bench, t_bench_apply = _timed(
        torch, lambda: lt.socs_image(res.spectrum, socs, cfg))
    bench = check_image(bench, n)
    log(f"  bench.py form (Nystrom, power_iters=1): cold build {t_build:.3f} s, "
        f"apply {t_bench_apply:.3f} s")
    for engine in ("int8", "matmul", "fft"):
        lt.socs_image(res.spectrum, socs, cfg, engine=engine)  # warm-up
        _, t = _timed(torch, lambda: lt.socs_image(res.spectrum, socs, cfg,
                                                   engine=engine))
        log(f"  warm rank-{SOCS_RANK} apply, engine {engine}: {t:.4f} s")

    pts = source_points(src)
    exact, t_exact = _timed(torch, lambda: abbe_image_points(
        res.spectrum, res.pupil, *_padded(pts, 4), cfg, device="cuda",
        engine="matmul"))
    exact = check_image(exact, n)
    log(f"  exact f32 matmul image, {pts.live_count} points: {t_exact:.3f} s")
    bound = res.report["socs_image_nrms_bound"]
    measured = nrms(img, exact)
    check("SOCS (simulate) vs exact", measured, TOL_SOCS_EXACT)
    check("SOCS (simulate) vs exact, against its reported bound", measured, bound)
    check("SOCS (bench form) vs exact", nrms(bench, exact), TOL_SOCS_EXACT)
    # Both float32-class applies against a complex128 apply of the same
    # kernels; against each other they differ by the sum of two independent
    # errors of that class, held to the JAX package's bound for the pair.
    ref64 = _socs_image_f64(torch, res.spectrum, socs, cfg)
    matmul = check_image(lt.socs_image(res.spectrum, socs, cfg, engine="matmul"), n)
    check("SOCS int8 apply vs complex128 apply, same kernels", nrms(bench, ref64),
          TOL_MATMUL)
    check("SOCS matmul apply vs complex128 apply, same kernels",
          nrms(matmul, ref64), TOL_MATMUL)
    check("SOCS int8 apply vs matmul apply, same kernels", nrms(bench, matmul),
          TOL_SOCS_PAIR)
    return exact


def _socs_image_f64(torch, spectrum, socs, cfg) -> np.ndarray:
    """socs_image's zoom-DFT apply in complex128, post-processed in float64."""
    from lithographysimulator_tpu_torch.ops.abbe import (_zoom_dft_kernel,
                                                         postprocess_gau23)

    n = cfg.n
    t = torch.as_tensor(_zoom_dft_kernel(n, cfg.wavelength_scaling().fft_size),
                        dtype=torch.complex128, device=spectrum.device)
    acc = torch.zeros((n, n), dtype=torch.float64, device=spectrum.device)
    lams = socs.eigenvalues.double()
    for c in range(0, socs.rank, 4):
        fields = t @ (socs.kernels[c:c + 4] * spectrum).to(torch.complex128) @ t.T
        acc += torch.sum(lams[c:c + 4, None, None] * fields.abs() ** 2, dim=0)
    return check_image(postprocess_gau23(acc, cfg), n)


def phase_socs_auto(torch, lt, exact) -> None:
    """Phase 9: simulate(solver='socs') with the automatic rank at 1024^2."""
    cfg, mask, src = _headline_setup(lt, 1024)
    res, t = _timed(torch, lambda: lt.simulate(mask, src, solver="socs",
                                                device="cuda"))
    img = check_image(res.image, cfg.n)
    rep = res.report
    log(f"[phase 9] 1024^2 SOCS auto rank: rank {rep['socs_rank']}, energy "
        f"{rep['socs_energy_captured']}, bound {rep['socs_image_nrms_bound']:.3e}, "
        f"{t:.3f} s (builds + apply)")
    check("SOCS (auto rank) vs exact, against its reported bound",
          nrms(img, exact), rep["socs_image_nrms_bound"])


def phase_socs_2048(torch, lt, mask, src, oracle_img) -> None:
    """Phase 10: 2048^2 SOCS at w = 2048 against the complex128 oracle."""
    res, t = _timed(torch, lambda: lt.simulate(mask, src, solver="socs",
                                                socs_rank=8, device="cuda"))
    img = check_image(res.image, mask.config.n)
    log(f"[phase 10] 2048^2 SOCS rank 8 (8 source points) via simulate(): "
        f"{t:.3f} s, energy {res.report['socs_energy_captured']}")
    check("2048^2 SOCS int8 vs float64 oracle", nrms(img, oracle_img),
          TOL_SOCS_ORACLE)


def phase_socs_lean(torch, lt) -> None:
    """Phase 11: the lean in-place build against the standard build."""
    n = 1024
    cfg, mask, src = _headline_setup(lt, n)
    pupil = lt.pupil_function(np.zeros(1, np.float32), cfg, device="cuda")
    spectrum = lt.mask_spectrum(mask.geometry, cfg)
    peaks = {}

    def build(lean: bool):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        socs, t = _timed(torch, lambda: lt.randomized_socs(
            pupil, src, cfg, rank=64, lean=lean))
        peaks[lean] = (torch.cuda.max_memory_allocated() - base) / 1e9
        return socs, t

    lean, t_lean = build(True)
    std, t_std = build(False)
    log(f"[phase 11] 1024^2 rank 64: lean build {t_lean:.3f} s, peak "
        f"{peaks[True]:.3f} GB; standard build {t_std:.3f} s, peak "
        f"{peaks[False]:.3f} GB (probe block {80 * n * n * 8 / 1e9:.3f} GB)")
    check("lean vs standard build image",
          nrms(check_image(lt.socs_image(spectrum, lean, cfg), cfg.n),
               check_image(lt.socs_image(spectrum, std, cfg), cfg.n)),
          TOL_LEAN)


def _vector_pair(torch, lt, cfg, spectrum, pupil, src, polarization: str,
                 tag: str) -> None:
    """vector_abbe_image on every SUBSET_K-th point, int8 against the f32
    matmul engine (TF32 off): <= 1e-6, with both wall clocks."""
    from lithographysimulator_tpu_torch.ops.abbe import source_points

    sp = source_points(_subset(src, source_points(src), SUBSET_K))
    args = (spectrum, pupil, *_padded(sp, 4), cfg)
    imgs = {}
    for engine in ("int8", "matmul"):
        img, t = _timed(torch, lambda: lt.vector_abbe_image(
            *args, device="cuda", polarization=polarization, engine=engine))
        imgs[engine] = check_image(img, cfg.n)
        log(f"  {tag}, every {SUBSET_K}th point ({sp.live_count}), {engine}: "
            f"{t:.3f} s, {sp.live_count / t:.1f} source points/s")
    check(f"{tag} vector int8 vs f32 matmul", nrms(imgs["int8"], imgs["matmul"]),
          TOL_MATMUL)


def phase_vector_exact(torch, lt) -> np.ndarray:
    """Phase 13: the exact vector image at 1024^2, int8 against f32.
    Returns the unpolarized image for phase 14."""
    from lithographysimulator_tpu_torch.ops.abbe import source_points

    n = 1024
    cfg, mask, src = _headline_setup(lt, n)
    live = source_points(src).live_count
    res, t = _timed(torch, lambda: lt.simulate(
        mask, src, polarization="unpolarized", device="cuda"))
    img = check_image(res.image, n)
    log(f"[phase 13] 1024^2 vector exact, unpolarized, int8 (simulate): "
        f"{live} points x 6 component passes in {t:.3f} s, {live / t:.1f} "
        f"source points/s ({6 * live / t:.1f} component-points/s)")
    _vector_pair(torch, lt, cfg, res.spectrum, res.pupil, src, "unpolarized",
                 "NA 0.7 unpolarized")
    hyper = lt.OpticsConfig(pixel_number=n, na=1.35, immersion_index=1.437)
    hmask = lt.lines_and_spaces(hyper, line_width_px=n // 16, pitch_px=n // 8,
                                device="cuda")
    hsrc = lt.LightSource(hyper, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    _vector_pair(torch, lt, hyper, lt.mask_spectrum(hmask.geometry, hyper),
                 lt.pupil_function(np.zeros(1, np.float32), hyper, device="cuda"),
                 hsrc, "x", "NA 1.35 water x-polarized")
    return img


def _build_peak(torch, fn):
    """(result, seconds, GB) of a build: the peak of device memory above
    what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, t = _timed(torch, fn)
    return out, t, (torch.cuda.max_memory_allocated() - base) / 1e9


def phase_vector_socs(torch, lt, exact_vec) -> None:
    """Phase 14: vector SOCS at rank 256, bench.py form and simulate()."""
    from lithographysimulator_tpu_torch.ops.hopkins import (
        dedup_polarization_factors, tcc_total_trace)
    from lithographysimulator_tpu_torch.simulate import _channel_rotation_cached

    n = 1024
    cfg, mask, src = _headline_setup(lt, n)
    rot = _channel_rotation_cached(cfg, "unpolarized", True, None, "cuda")
    comps = len(dedup_polarization_factors(cfg, "unpolarized"))
    channels = comps if rot is None else rot.shape[2]
    pupil = lt.pupil_function(np.zeros(1, np.float32), cfg, device="cuda")
    spectrum = lt.mask_spectrum(mask.geometry, cfg)
    socs, t_build, peak = _build_peak(torch, lambda: lt.randomized_socs_vector(
        pupil, src, cfg, rank=SOCS_RANK, polarization="unpolarized",
        power_iters=1, channel_rotation=rot))
    img_t, t_apply = _timed(torch, lambda: lt.socs_image(spectrum, socs, cfg))
    img = check_image(img_t, n)
    log(f"[phase 14] 1024^2 vector SOCS rank {SOCS_RANK}, bench.py form "
        f"(power_iters=1): {comps} deduped components, {channels} channels; "
        f"cold build {t_build:.3f} s, peak {peak:.3f} GB above the base; "
        f"apply {t_apply:.4f} s")
    check("vector SOCS int8 apply vs complex128 apply, same kernels",
          nrms(img, _socs_image_f64(torch, spectrum, socs, cfg)), TOL_MATMUL)
    trace = tcc_total_trace(pupil, src, polarization="unpolarized", config=cfg)
    bound = lt.socs_image_nrms_bound(socs, spectrum, img_t, trace=trace)
    err = nrms(img, exact_vec)
    log(f"  bench form vs phase 13's exact image: {err:.3e} (expected class "
        f"1e-3), energy {float(socs.eigenvalues.sum(dtype=torch.float64)) / trace:.6f}")
    check("vector SOCS (bench form) vs exact, against its trace bound", err, bound)
    del socs
    res, t_cold = _timed(torch, lambda: lt.simulate(
        mask, src, solver="socs", polarization="unpolarized",
        socs_rank=SOCS_RANK, device="cuda"))
    warm, t_cached = _timed(torch, lambda: lt.simulate(
        mask, src, solver="socs", polarization="unpolarized",
        socs_rank=SOCS_RANK, device="cuda"))
    sim = check_image(res.image, n)
    log(f"  simulate(solver='socs', polarization='unpolarized'): cold "
        f"{t_cold:.3f} s, on cached kernels {t_cached:.4f} s")
    log(f"  report: {json.dumps(res.report)}")
    check("vector SOCS cached rerun vs cold run",
          nrms(check_image(warm.image, n), sim), TOL_MATMUL)
    err = nrms(sim, exact_vec)
    log(f"  simulate vs phase 13's exact image: {err:.3e} (expected class 1e-3)")
    check("vector SOCS (simulate) vs exact, against its reported bound", err,
          res.report["socs_image_nrms_bound"])


def phase_chromatic(torch, lt) -> None:
    """Phase 15: chromatic exact blend and polychromatic SOCS at 1024^2."""
    from lithographysimulator_tpu_torch.ops.abbe import (abbe_image_points,
                                                         source_points)
    from lithographysimulator_tpu_torch.ops.hopkins import tcc_total_trace
    from lithographysimulator_tpu_torch.simulate import _channel_rotation_cached

    n = 1024
    cfg, mask, src = _headline_setup(lt, n)
    spec = lt.LaserSpectrum(bandwidth_pm=0.3, samples=5)
    live = source_points(src).live_count
    res, t = _timed(torch, lambda: lt.simulate(mask, src, chromatic=spec,
                                                device="cuda"))
    exact = check_image(res.image, n)
    log(f"[phase 15] 1024^2 chromatic exact ({res.report['chromatic']}), int8 "
        f"(simulate): {live} points x {spec.samples} planes in {t:.3f} s, "
        f"{live / t:.1f} source points/s")
    sub = _subset(src, source_points(src), SUBSET_K)
    sp = source_points(sub)
    int8, t8 = _timed(torch, lambda: lt.simulate(mask, sub, chromatic=spec,
                                                  device="cuda").image)
    stack, q = lt.chromatic_aberrations(np.zeros(1, np.float32), spec)

    def f32_blend():
        return sum(float(qf) * abbe_image_points(
            res.spectrum, lt.pupil_function(ab, cfg, device="cuda"),
            *_padded(sp, 4), cfg, device="cuda", engine="matmul")
            for ab, qf in zip(stack, q))

    f32, t32 = _timed(torch, f32_blend)
    log(f"  every {SUBSET_K}th point ({sp.live_count}): int8 {t8:.3f} s, "
        f"f32 matmul {t32:.3f} s")
    check("chromatic exact int8 vs f32 matmul blend",
          nrms(check_image(int8, n), check_image(f32, n)), TOL_MATMUL)

    rot = _channel_rotation_cached(cfg, None, True, spec, "cuda")
    channels = spec.samples if rot is None else rot.shape[2]
    socs, t_build, peak = _build_peak(torch, lambda: lt.randomized_socs_chromatic(
        np.zeros(1, np.float32), src, cfg, spectrum=spec, rank=SOCS_RANK,
        power_iters=1, channel_rotation=rot, device="cuda"))
    img_t, t_apply = _timed(torch, lambda: lt.socs_image(res.spectrum, socs, cfg))
    img = check_image(img_t, n)
    log(f"  randomized_socs_chromatic rank {SOCS_RANK} (power_iters=1): "
        f"{spec.samples} planes, {channels} channels; cold build {t_build:.3f} s, "
        f"peak {peak:.3f} GB above the base; apply {t_apply:.4f} s")
    pupil = lt.pupil_function(np.zeros(1, np.float32), cfg, device="cuda")
    bound = lt.socs_image_nrms_bound(socs, res.spectrum, img_t,
                                     trace=tcc_total_trace(pupil, src))
    err = nrms(img, exact)
    check("chromatic SOCS (bench form) vs exact blend, against its trace bound",
          err, bound)
    check("chromatic SOCS (bench form) vs exact blend", err, TOL_CHROMATIC_SOCS)
    del socs
    sim, t_sim = _timed(torch, lambda: lt.simulate(
        mask, src, solver="socs", chromatic=spec, socs_rank=SOCS_RANK,
        device="cuda"))
    log(f"  simulate(solver='socs', chromatic=...): cold {t_sim:.3f} s, "
        f"report {json.dumps(sim.report)}")
    err = nrms(check_image(sim.image, n), exact)
    check("chromatic SOCS (simulate) vs exact blend, against its reported bound",
          err, sim.report["socs_image_nrms_bound"])
    check("chromatic SOCS (simulate) vs exact blend", err, TOL_CHROMATIC_SOCS)


def _perturb_f64(img: np.ndarray, p, pixel_size: float) -> np.ndarray:
    """The stage blur and flare of ImagePerturbation in float64 NumPy."""
    freqs = np.fft.fftfreq(img.shape[-1], d=pixel_size)

    def blur(x, sx, sy):
        t = np.exp(-2.0 * np.pi ** 2 * (sx ** 2 * freqs[None, :] ** 2
                                        + sy ** 2 * freqs[:, None] ** 2))
        return np.real(np.fft.ifft2(np.fft.fft2(x) * t))

    img = np.asarray(img, np.float64)
    if p.msd_x_nm > 0 or p.msd_y_nm > 0:
        img = blur(img, p.msd_x_nm, p.msd_y_nm)
    if p.flare_tis > 0:
        background = (blur(img, p.flare_kernel_nm, p.flare_kernel_nm)
                      if p.flare_kernel_nm > 0 else img.mean())
        img = (1.0 - p.flare_tis) * img + p.flare_tis * background
    return img


def phase_focus_perturb(torch, lt) -> None:
    """Phase 16: through-focus stacks and the perturbed SOCS image."""
    from lithographysimulator_tpu_torch.ops.abbe import source_points
    from lithographysimulator_tpu_torch.ops.focus import through_focus_socs

    n = 1024
    cfg, mask, src = _headline_setup(lt, n)
    sub = _subset(src, source_points(src), SUBSET_K)
    sp = source_points(sub)
    spectrum = lt.mask_spectrum(mask.geometry, cfg)
    stack = lt.focus_stack_aberrations(np.zeros(1, np.float32), FOCUS_PLANES)
    planes, t = _timed(torch, lambda: lt.through_focus_images(
        spectrum, stack, *_padded(sp, 4), cfg, device="cuda"))
    log(f"[phase 16] through_focus_images, {len(FOCUS_PLANES)} planes x "
        f"{sp.live_count} points: {t:.3f} s")
    for f, ab in enumerate(stack):
        ref = lt.simulate(mask, sub, ab, device="cuda").image
        check(f"focus plane {FOCUS_PLANES[f]:+.0f} nm vs simulate",
              nrms(check_image(planes[f], n), check_image(ref, n)), TOL_MATMUL)
    socs_planes, t = _timed(torch, lambda: through_focus_socs(
        spectrum, np.zeros(1, np.float32), FOCUS_PLANES, src, cfg,
        rank=FOCUS_RANK))
    for f in range(len(FOCUS_PLANES)):
        check_image(socs_planes[f], n)
    log(f"  through_focus_socs, {len(FOCUS_PLANES)} planes at rank {FOCUS_RANK} "
        f"(one build and one apply a plane): {t:.3f} s")
    perturb = lt.ImagePerturbation(msd_x_nm=5.0, msd_y_nm=2.0, flare_tis=0.02)
    clean = lt.simulate(mask, src, solver="socs", socs_rank=SOCS_RANK,
                        device="cuda")
    res, t = _timed(torch, lambda: lt.simulate(
        mask, src, solver="socs", socs_rank=SOCS_RANK, perturb=perturb,
        device="cuda"))
    log(f"  simulate(solver='socs', perturb=...) on cached kernels: {t:.4f} s, "
        f"{res.report['perturbation']}")
    check("perturbed SOCS image vs float64 host perturbation of the card image",
          nrms(check_image(res.image, n),
               _perturb_f64(clean.image.cpu().numpy(), perturb, cfg.pixel_size)),
          TOL_MATMUL)


# ---------------------------------------------------------------------------
# Thick mask (M3D), the int8 gradient, the fits and the film stack
# ---------------------------------------------------------------------------

def _m3d_models(lt):
    """Phase 18's models: an asymmetric boundary layer and a k = 1 edge
    kernel."""
    bl = lt.BoundaryLayer(width_nm=8.0, beta_h=-0.2 + 0.1j, beta_v=-0.3,
                          beta_h_asym=0.03j, beta_v_asym=0.05 - 0.02j)
    ek = lt.EdgeKernelM3D(width_nm=8.0,
                          taps_h_rise=(0.05j, -0.2 + 0.1j, 0.1),
                          taps_h_fall=(0.1, -0.2 - 0.05j, 0.05j),
                          taps_v_rise=(0.02, -0.3, 0.15),
                          taps_v_fall=(0.15, -0.25, 0.02))
    return bl, ek


def _m3d_pair(torch, lt, cfg, mask, src, model, tag: str) -> None:
    """simulate(mask3d=model) on every SUBSET_K-th point (int8) against the
    f32 matmul engine on the same thick-mask spectrum: <= 1e-6."""
    from lithographysimulator_tpu_torch.ops.abbe import (abbe_image_points,
                                                         source_points)

    sub = _subset(src, source_points(src), SUBSET_K)
    sp = source_points(sub)
    res, t8 = _timed(torch, lambda: lt.simulate(mask, sub, mask3d=model,
                                                 device="cuda"))
    ref, t32 = _timed(torch, lambda: abbe_image_points(
        res.spectrum, res.pupil, *_padded(sp, 4), cfg, device="cuda",
        engine="matmul"))
    log(f"  {tag}, every {SUBSET_K}th point ({sp.live_count}): int8 "
        f"(simulate) {t8:.3f} s, f32 matmul {t32:.3f} s")
    check(f"{tag} int8 vs f32 matmul", nrms(check_image(res.image, cfg.n),
                                            check_image(ref, cfg.n)), TOL_MATMUL)


def phase_m3d(torch, lt) -> None:
    """Phase 18: thick-mask imaging at phase 4's configuration."""
    from lithographysimulator_tpu_torch.ops.abbe import source_points

    n = 1024
    cfg, mask, src = _headline_setup(lt, n)
    bl, ek = _m3d_models(lt)
    live = source_points(src).live_count
    res, t = _timed(torch, lambda: lt.simulate(mask, src, mask3d=bl,
                                                device="cuda"))
    exact = check_image(res.image, n)
    log(f"[phase 18] 1024^2 {res.report['mask3d']}, int8 (simulate): {live} "
        f"points in {t:.3f} s, {live / t:.1f} points/s (report "
        f"{res.report['wall_clock_s']:.3f} s)")
    _m3d_pair(torch, lt, cfg, mask, src, bl, "boundary layer")
    _m3d_pair(torch, lt, cfg, mask, src, ek, "edge kernel k=1")
    # a cold call builds its kernels: drop phase 8's (the TCC does not see
    # the mask, so they would serve)
    importlib.import_module("lithographysimulator_tpu_torch.simulate")._SOCS_BUILD_CACHE.clear()
    cold, t_cold = _timed(torch, lambda: lt.simulate(
        mask, src, solver="socs", socs_rank=SOCS_RANK, mask3d=bl, device="cuda"))
    warm, t_warm = _timed(torch, lambda: lt.simulate(
        mask, src, solver="socs", socs_rank=SOCS_RANK, mask3d=bl, device="cuda"))
    img = check_image(cold.image, n)
    log(f"  simulate(solver='socs', socs_rank={SOCS_RANK}, mask3d=BL): cold "
        f"(build + apply) {t_cold:.3f} s, on cached kernels {t_warm:.4f} s; report "
        f"{json.dumps(cold.report)}")
    check("M3D SOCS cached rerun vs cold run",
          nrms(check_image(warm.image, n), img), TOL_MATMUL)
    err = nrms(img, exact)
    check("M3D SOCS vs exact M3D image, against its reported bound", err,
          cold.report["socs_image_nrms_bound"])
    check("M3D SOCS vs exact M3D image", err, TOL_SOCS_EXACT)


def _grad_pair(torch, fn, tensors, tag: str) -> None:
    """Gradients of fn(engine) over ``tensors`` (made leaves anew for each
    step), the int8 engine's against the matmul engine's autograd:
    atol 1e-6 * max|g| (tests/test_pallas_kernel.py:200-202). Each engine
    takes two steps in turns (int8, matmul, int8, matmul); the first
    backward of a process pays a one-time set-up of its device thread and
    kernels, so both steps' forward and backward times are printed and the
    second step's gradients are compared."""
    grads = {}
    for turn in range(2):
        for engine in ("int8", "matmul"):
            leaves = [t.detach().clone().requires_grad_() for t in tensors]
            loss, t_fwd = _timed(torch, lambda: fn(engine, *leaves))
            _, t_bwd = _timed(torch, loss.backward)
            grads[engine] = [x.grad for x in leaves]
            log(f"  {tag}, step {turn + 1}, {engine}: forward {t_fwd:.4f} s, "
                f"backward {t_bwd:.4f} s")
    for k, (g8, g32) in enumerate(zip(grads["int8"], grads["matmul"])):
        scale = float(g32.abs().max())
        err = float((g8 - g32).abs().max()) / scale if scale > 0 else np.inf
        check(f"{tag} gradient {k} (int8 vs matmul autograd), max|dg|/max|g|",
              err, 1e-6)


def phase_grads(torch, lt) -> None:
    """Phase 19: gradients through the int8 engine on the card."""
    from lithographysimulator_tpu_torch.ops.abbe import (abbe_image_points,
                                                         source_points)

    n = 1024
    cfg, mask, src = _headline_setup(lt, n)
    sp = source_points(_subset(src, source_points(src), SUBSET_K))
    shifts, weights = _padded(sp, 4)
    gen = torch.Generator(device="cuda").manual_seed(19)
    m = 0.5 + torch.rand((n, n), generator=gen, device="cuda")
    spectrum = lt.mask_spectrum(mask.geometry, cfg)
    pupil = lt.pupil_function(np.array([0, 0, 0.05, 0.03, 30], np.float32),
                              cfg, device="cuda")
    log(f"[phase 19] 1024^2 gradients of sum(image * M), every {SUBSET_K}th "
        f"point ({sp.live_count}, {len(weights) // 4} chunks)")

    def exact_loss(engine, s, p):
        return (abbe_image_points(s, p, shifts, weights, cfg, device="cuda",
                                  engine=engine) * m).sum()

    _grad_pair(torch, exact_loss, (spectrum, pupil),
               "exact engine (spectrum, pupil)")
    socs = lt.randomized_socs(pupil, src, cfg, rank=SOCS_RANK, power_iters=1)

    def socs_loss(engine, s, lams):
        k = lt.SOCSKernels(kernels=socs.kernels, eigenvalues=lams,
                           total_rank=socs.total_rank)
        return (lt.socs_image(s, k, cfg, engine=engine) * m).sum()

    _grad_pair(torch, socs_loss, (spectrum, socs.eigenvalues),
               f"rank-{SOCS_RANK} socs_image apply (spectrum, eigenvalues)")


def _fit_pair(torch, lt, fit, tag: str, **kw) -> dict:
    """One fit of FIT_STEPS Adam steps on the auto engine (int8) and one on
    the f32 matmul engine; the loss must fall in both. Returns the launch
    counts of the int8 fit alone."""
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    before = dict(ik.LAUNCHES)
    (model, hist), t8 = _timed(torch, lambda: fit(device="cuda", **kw))
    launched = {k: ik.LAUNCHES[k] - before[k] for k in KERNELS}
    (model32, hist32), t32 = _timed(torch, lambda: fit(
        device="cuda", engine="matmul", **kw))
    for name, h in (("auto (int8)", hist), ("matmul", hist32)):
        if not (np.isfinite(h).all() and h[-1] < h[0]):
            raise AssertionError(f"{tag} {name}: loss did not fall: {h}")
    log(f"  {tag}, {FIT_STEPS} steps: auto (int8) {t8:.3f} s, loss "
        f"{hist[0]:.4e} -> {hist[-1]:.4e}; matmul {t32:.3f} s, loss "
        f"{hist32[0]:.4e} -> {hist32[-1]:.4e}")
    log(f"    int8 fit: {model}")
    log(f"    matmul fit: {model32}")
    log(f"    launches of the int8 fit: {launched}")
    return launched


def phase_fits_film(torch, lt) -> list:
    """Phase 20: the M3D fits, m3dcal's calibration and the film stack.
    Returns the launch counts of the two int8 fits for phase 21."""
    from lithographysimulator_tpu_torch.ops.abbe import source_points
    from lithographysimulator_tpu_torch.ops.hopkins import _field_power
    from lithographysimulator_tpu_torch.ops.mask3d import (
        boundary_layer_from_rcwa, fit_boundary_layer, fit_edge_kernel)

    n = 1024
    cfg, mask, src = _headline_setup(lt, n)
    bl, ek = _m3d_models(lt)
    sub = _subset(src, source_points(src), SUBSET_K)
    sp = source_points(sub)
    shifts, weights = _padded(sp, 8)
    defocus = np.array([0, 0, 0, 0, 50.0], np.float32)
    log(f"[phase 20] 1024^2 M3D fits on every {SUBSET_K}th point "
        f"({sp.live_count}), 50 nm defocus")
    fit_launches = []
    for fit, model, tag in ((fit_boundary_layer, bl, "fit_boundary_layer"),
                            (fit_edge_kernel, ek, "fit_edge_kernel k=1")):
        target = lt.simulate(mask, sub, defocus, normalize=True, mask3d=model,
                             device="cuda").image
        extra = dict(fit_asym=True) if fit is fit_boundary_layer else dict(k=1)
        fit_launches.append(_fit_pair(
            torch, lt, fit, tag, target_image=target, geometry=mask.geometry,
            shifts=shifts, weights=weights, config=cfg, steps=FIT_STEPS,
            aberrations=defocus, **extra))

    m3d_cfg = lt.OpticsConfig(pixel_number=M3DCAL_N)
    (model, report), t = _timed(torch, lambda: boundary_layer_from_rcwa(
        m3d_cfg, device="cuda", pitch_px=16, duty=9 / 16, steps=M3DCAL_STEPS))
    hist = report["history"]["avg"]
    log(f"  boundary_layer_from_rcwa at {M3DCAL_N}^2 (m3dcal defaults, "
        f"{M3DCAL_STEPS} steps): {t:.3f} s; {model}; thin nrms "
        f"{report['thin_nrms']['avg']:.4e}, fit nrms {report['fit_nrms']['avg']:.4e}")
    if not (hist[-1] < hist[0] and report["fit_nrms"]["avg"]
            < report["thin_nrms"]["avg"]):
        raise AssertionError(f"m3dcal calibration did not improve: {report}")

    wafer = lt.WaferStack(n_resist=1.71 + 0.0077j, thickness_nm=150.0,
                          under_layers=((37.0, 1.82 + 0.39j),))
    depths = (25.0, 75.0, 125.0)
    stack, t = _timed(torch, lambda: lt.film_stack_images(
        mask, src, device="cuda", wafer_stack=wafer, depths_nm=depths,
        normalize=False))
    log(f"  film_stack_images, {len(depths)} depths x {source_points(src).live_count} "
        f"points, int8: {t:.3f} s")
    kernels, t_build = _timed(torch, lambda: lt.film_socs_kernels(
        src, device="cuda", config=cfg, wafer_stack=wafer, depths_nm=depths,
        rank=FILM_RANK))
    fast, t_apply = _timed(torch, lambda: lt.film_socs_stack(
        mask, kernels, normalize=False))
    log(f"  film_socs_kernels rank {FILM_RANK}: {t_build:.3f} s; "
        f"film_socs_stack: {t_apply:.4f} s")
    from lithographysimulator_tpu_torch.ops.filmstack import (
        film_component_multipliers)

    mult = film_component_multipliers(cfg, wafer, depths)
    pupil = lt.pupil_function(np.zeros(1, np.float32), cfg, device="cuda")
    spectrum = lt.mask_spectrum(mask.geometry, cfg)
    w_sum = float(src.sum(dtype=np.float64))
    for z, socs in enumerate(kernels):
        comp = torch.as_tensor(mult[z, 0], dtype=torch.complex64,
                               device="cuda") * pupil
        bound = lt.socs_image_nrms_bound(socs, spectrum, fast[z],
                                         trace=w_sum * _field_power(comp))
        check(f"film SOCS slab {z} ({depths[z]:.0f} nm) vs exact slab, "
              "against its bound", nrms(check_image(fast[z], n),
                                        check_image(stack[z], n)), bound)
    return fit_launches


# ---------------------------------------------------------------------------
# Resist, the eikonal develop, stochastic ensembles and calibration
# ---------------------------------------------------------------------------

def _phase_start(torch, ik) -> float:
    """Reset the launch counts and the memory peak; the phase's start."""
    ik.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def _phase_end(torch, ik, phase: int, t0: float, launches: dict,
               expect_launches: bool) -> None:
    """Print the phase's wall time and memory peak, add its launches to
    ``launches`` and fail if it launched int8 kernels where none were
    expected, or none where some were."""
    torch.cuda.synchronize()
    counts = dict(ik.LAUNCHES)
    log(f"  phase {phase}: wall {time.perf_counter() - t0:.3f} s, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, int8 "
        f"launches {counts}")
    if expect_launches and min(counts.values()) <= 0:
        raise AssertionError(f"phase {phase} should run the int8 kernels: {counts}")
    if not expect_launches and max(counts.values()) > 0:
        raise AssertionError(f"phase {phase} should launch no int8 kernel: {counts}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v


def _same_cds(tag: str, ours: np.ndarray, ref: np.ndarray, field: np.ndarray,
              threshold: float, cfg, resist) -> None:
    """The CD tables of two binary profiles are equal, unless the pixels
    where they differ all lie within 1e-5 of the threshold in ``field``."""
    a = resist.feature_table(ours, cfg)
    b = resist.feature_table(ref, cfg)
    same = (len(a["row"]) == len(b["row"])
            and np.array_equal(a["width_nm"], b["width_nm"]))
    differ = ours != ref
    near = np.abs(field - threshold) <= 1e-5
    log(f"  {tag}: {len(a['row'])} features, CD tables "
        f"{'equal' if same else 'differ'}; {int(differ.sum())} pixels differ, "
        f"{int((differ & ~near).sum())} of them farther than 1e-5 from the "
        "threshold")
    if (differ & ~near).any() or (not same and not differ.any()):
        raise AssertionError(f"{tag}: CDs differ from the host's")


def phase_resist(torch, lt, ik, launches: dict):
    """Phase 22: deterministic resist on the rank-256 SOCS image. Returns
    the image for phase 23."""
    from lithographysimulator_tpu_torch.models import resist
    from lithographysimulator_tpu_torch.models.calibrate import _blur_np

    n = 1024
    cfg, mask, src = _headline_setup(lt, n)
    t0 = _phase_start(torch, ik)
    res = lt.simulate(mask, src, solver="socs", socs_rank=SOCS_RANK,
                      device="cuda")
    image = res.image / res.image.max()
    model = lt.ResistModel(threshold=0.3, steepness=50.0, diffusion_nm=10.0)
    (blurred, soft, hard), t = _timed(torch, lambda: (
        model.blur(image, cfg), model.develop(image, cfg),
        model.develop_binary(image, cfg)))
    log(f"[phase 22] 1024^2 resist on the rank-{SOCS_RANK} SOCS image (int8 "
        f"apply): ResistModel blur + develop + develop_binary {t:.4f} s")
    host = image.cpu().numpy()
    ref = _blur_np(host.astype(np.float64), model.diffusion_nm, cfg.pixel_size)
    check("ResistModel.blur on the card vs float64 numpy blur on the host",
          nrms(blurred.cpu().numpy(), ref), TOL_MATMUL)
    field = ref / ref.max()
    if not 0.0 < float(soft.mean()) < 1.0:
        raise AssertionError(f"sigmoid develop out of range: {float(soft.mean())}")
    _same_cds("ResistModel.develop_binary vs float64 host threshold",
              hard.cpu().numpy(), (field > model.threshold).astype(np.float32),
              field, model.threshold, cfg, resist)
    cd_card = lt.feature_table(blurred / blurred.max(), cfg,
                               threshold=model.threshold)
    cd_host = lt.feature_table(field, cfg, threshold=model.threshold)
    if len(cd_card["row"]) != len(cd_host["row"]):
        raise AssertionError("subpixel feature tables differ in length")
    dcd = float(np.abs(cd_card["width_nm"] - cd_host["width_nm"]).max())
    check("subpixel CDs of the card field vs the float64 host field (nm)",
          dcd, 1e-3)
    log(f"  CD at the center row: {lt.critical_dimension(hard, cfg):.3f} nm; "
        f"{len(cd_card['row'])} features, mean subpixel CD "
        f"{cd_card['width_nm'].mean():.4f} nm")
    mack = lt.MackResist()
    (mdev, mbin), t = _timed(torch, lambda: (mack.develop(image),
                                             mack.develop_binary(image)))
    log(f"  MackResist develop + develop_binary: {t:.4f} s, cleared fraction "
        f"{float(mbin.mean()):.4f}")
    doses = [0.8, 0.9, 1.0, 1.1, 1.25]
    lat, t = _timed(torch, lambda: lt.exposure_latitude(image, cfg, model, doses))
    log(f"  exposure_latitude over doses {doses}: CDs {lat} nm ({t:.3f} s)")
    if not all(np.diff(lat) >= 0) or lat[-1] <= lat[0]:
        raise AssertionError(f"CD does not grow with dose: {lat}")
    _phase_end(torch, ik, 22, t0, launches, True)
    return image, cfg


def _median_rate(torch, fn, trials: int) -> tuple:
    times = []
    for seed in (1, 2, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(seed)
        times.append(time.perf_counter() - t0)
    return trials / float(np.median(times)), times


def _event_ms(torch, fn, reps: int = 5) -> float:
    """Median device time of single calls of ``fn`` between two CUDA
    events, after a warm-up call (for code that syncs, so no graph)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _edge_kernel(torch, lt, se, image, cfg, model, ensemble_launches) -> dict:
    """Phase 23's check of the edge_runs kernel against its plain twin on
    the card's trial fields at (16, 1024, 1024), row_step 2; returns the
    kernels line's edge_runs entry."""
    from lithographysimulator_tpu_torch.models import stochastic as sto

    thr, row_step = model.threshold, 2
    fields = lt.exposure_trials(image, cfg, model, trials=16, seed=7,
                                binary=False).contiguous()
    runs_p, counts_p = se.edge_runs_plain(fields, thr, row_step)
    k = int(counts_p.max())
    rise_p, fall_p = se.edge_runs_plain(fields, thr, row_step, k)
    valid = torch.arange(k, device=fields.device) < counts_p[..., None]
    if not torch.equal(runs_p, sto._run_counts(fields > thr)):
        raise AssertionError("edge_runs_plain's run counts are not _run_counts'")
    for call in range(2):
        runs, counts = se.edge_runs(fields, thr, row_step)
        rise, fall = se.edge_runs(fields, thr, row_step, k)
        torch.cuda.synchronize()
        same = (torch.equal(runs, runs_p) and torch.equal(counts, counts_p)
                and all(torch.equal(got[valid].view(torch.int64),
                                    want[valid].view(torch.int64))
                        and bool(torch.isnan(got[~valid]).all())
                        for got, want in ((rise, rise_p), (fall, fall_p))))
        if not same:
            raise AssertionError(f"edge_runs differs from edge_runs_plain (call {call})")
    t, lines, n = fields.shape
    sampled = -(-lines // row_step)
    log(f"  edge_runs on 16 card fields (16, 1024, 1024), row_step 2: "
        f"{int(counts_p.sum())} runs tabulated, k {k}; run counts equal, "
        "table counts equal, edges bit for bit, twice: ok")
    count_ms = time_ms(torch, lambda: se.edge_runs(fields, thr, row_step))
    table_ms = time_ms(torch, lambda: se.edge_runs(fields, thr, row_step, k))
    plain_ms = (_event_ms(torch, lambda: se.edge_runs_plain(fields, thr, row_step))
                + _event_ms(torch, lambda: se.edge_runs_plain(fields, thr,
                                                              row_step, k)))
    moved = (4 * t * lines * n + 4 * t * (lines + sampled)  # count pass
             + 4 * t * sampled * n + 16 * t * sampled * k)  # table pass
    bound_ms = moved / 3.35e12 * 1e3
    log(f"  edge_runs: count pass {count_ms:.4f} ms, table pass {table_ms:.4f} "
        f"ms, plain twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes "
        f"{moved}), {100 * bound_ms / (count_ms + table_ms):.1f}% of bound")
    return {"name": "edge_runs", "route": "cuda", "source": EDGES_SOURCE,
            "replaces": EDGES_REPLACES, "launches": ensemble_launches,
            "shape": [t, lines, n], "row_step": row_step, "k": k,
            "ms": count_ms + table_ms, "count_ms": count_ms,
            "table_ms": table_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes"}


def phase_stochastic(torch, lt, ik, launches: dict, image, cfg) -> dict:
    """Phase 23: the stochastic ensemble in bench.py's form. Returns the
    kernels line's edge_runs entry."""
    import dataclasses

    from lithographysimulator_tpu_torch.models import stochastic as sto
    from lithographysimulator_tpu_torch.ops.kernels import build
    from lithographysimulator_tpu_torch.ops.kernels import stochastic_edges as se

    _, edge_log = build.build(build.EDGES)
    spills = {fn: b for fn, b in ptxas_spills(edge_log).items()
              if "edge_runs_kernel" in fn}
    for line in edge_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas (edges): {line.strip()}")
    if len(spills) != 4 or any(spills.values()):
        raise AssertionError(f"edge_runs: ptxas spill bytes {spills}")
    t0 = _phase_start(torch, ik)
    model = lt.StochasticResist(dose_photons_per_nm2=20.0, diffusion_nm=8.0,
                                threshold=0.3, pag_per_nm2=5.0)
    lt.exposure_trials(image, cfg, model, trials=2, seed=0)  # warm-up
    device_rate, dev_times = _median_rate(torch, lambda s: lt.exposure_trials(
        image, cfg, model, trials=16, seed=s, trial_chunk=8).mean(
            dim=(1, 2)).cpu(), 16)
    log(f"[phase 23] 1024^2 stochastic (dose 20/nm^2, diffusion 8 nm, PAG "
        f"5/nm^2), 16 trials, trial_chunk 8: stochastic_device_trials_per_s "
        f"{device_rate:.1f} (samples {[round(x, 4) for x in dev_times]} s)")

    def summary(seed):
        rows, runs, band = lt.exposure_summary(image, cfg, model, trials=16,
                                               seed=seed, trial_chunk=8,
                                               row_step=2)
        return rows.cpu(), runs.cpu(), band.cpu()

    e2e_rate, e2e_times = _median_rate(torch, summary, 16)
    log(f"  exposure_summary, 16 trials, row_step 2, read back: "
        f"stochastic_e2e_trials_per_s {e2e_rate:.1f} (samples "
        f"{[round(x, 4) for x in e2e_times]} s)")
    se.reset_launch_counts()
    out, t = _timed(torch, lambda: lt.stochastic_ensemble(
        image, cfg, model, trials=64, seed=0, psd=True))
    edge_launches = se.LAUNCHES["edge_runs"]
    if edge_launches != 2 * 4:  # two passes in each of 4 trial chunks of 16
        raise AssertionError(f"stochastic_ensemble launched edge_runs "
                             f"{edge_launches} times, not 8")
    log(f"  stochastic_ensemble launched edge_runs {edge_launches} times")
    psd = out["psd"]
    log(f"  stochastic_ensemble, 64 trials, psd=True: {t:.3f} s ({64 / t:.1f} "
        f"trials/s): LER {out['ler_nm']:.4f} nm, LWR {out['lwr_nm']:.4f} nm, "
        f"LCDU {out['lcdu_nm']:.4f} nm, mean CD {out['mean_cd_nm']:.4f} nm "
        f"(deterministic {out['deterministic_cd_nm']:.4f}), break rate "
        f"{out['break_rate']:.3e}, bridge rate {out['bridge_rate']:.3e}; PSD "
        f"{psd['n_edges']} edges, LER(3s) {psd['ler_3s_nm']:.4f} nm, xi "
        f"{psd['corr_length_nm']:.3f} nm, alpha {psd['alpha']:.3f}, ACF length "
        f"{psd['acf_corr_length_nm']:.3f} nm")
    _, t_rows = _timed(torch, lambda: summary(0))
    log(f"  of which the device summary of 16 trials with its read-back takes "
        f"{t_rows:.3f} s")
    prob = out["print_probability"]
    if not (prob.shape == (cfg.n, cfg.n) and 0.0 <= prob.min()
            and prob.max() <= 1.0):
        raise AssertionError("print_probability outside [0, 1]")
    log("  print_probability in [0, 1]: ok")
    a = lt.exposure_trials(image, cfg, model, trials=4, seed=5, binary=False)
    b = lt.exposure_trials(image, cfg, model, trials=4, seed=5, binary=False)
    if not torch.equal(a, b) or torch.equal(a[0], a[1]):
        raise AssertionError("the same seed did not give the same fields")
    log("  same seed, same fields, bit for bit: ok")
    c8 = lt.exposure_trials(image, cfg, model, trials=16, seed=5, binary=False,
                            trial_chunk=8)
    c16 = lt.exposure_trials(image, cfg, model, trials=16, seed=5, binary=False,
                             trial_chunk=16)
    if not torch.equal(c8, c16) or not torch.equal(c8[:4], a):
        raise AssertionError("trial fields depend on trial_chunk")
    log("  trial i equal under trial_chunk 8 and 16, bit for bit: ok")
    del a, b, c8, c16
    hi = dataclasses.replace(model, dose_photons_per_nm2=1e6, pag_per_nm2=0.0)
    fields = lt.exposure_trials(image, cfg, hi, trials=4, seed=1, binary=False)
    det = hi.deterministic_field(image, cfg)
    check("1e6 photons/nm^2 (no PAG): max |mean field - deterministic_field|",
          float((fields.mean(dim=0) - det).abs().max()), 0.01)
    contours = (fields > hi.threshold).float()
    check("1e6 photons/nm^2: mean |contour - deterministic contour|",
          float((contours - (det > hi.threshold).float()).abs().mean()), 0.01)
    del fields, contours
    log(f"  trial streams: torch.Generator per trial, seeded from "
        f"SeedSequence((seed, i)) ({sto.trial_generator.__name__})")
    entry = _edge_kernel(torch, lt, se, image, cfg, model, edge_launches)
    _phase_end(torch, ik, 23, t0, launches, False)
    return entry


def _sweep_bytes(torch, fn) -> int:
    """Bytes one call of ``fn`` moves through memory, op by op: every
    input of an operation that allocates an output read once and every
    new output written once (views move nothing; a broadcast input counts
    its storage)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    def size(t):
        return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [x for x in tree_flatten((args, kwargs))[0]
                   if isinstance(x, torch.Tensor)]
            ptrs = {x.untyped_storage().data_ptr() for x in ins}
            new = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)
                   and o.untyped_storage().data_ptr() not in ptrs]
            if new:
                Count.total += sum(map(size, ins)) + sum(map(size, new))
            return out

    with torch.no_grad(), Count():
        fn()
    return Count.total


def phase_resist3d(torch, lt, ik, launches: dict) -> None:
    """Phase 24: 3-D resist on the film-SOCS stack: the eikonal develop,
    its invariants and the volumetric ensemble."""
    from lithographysimulator_tpu_torch.ops import eikonal
    from lithographysimulator_tpu_torch.ops.filmstack import MATERIALS_193

    n = 1024
    cfg, mask, src = _headline_setup(lt, n)
    t0 = _phase_start(torch, ik)
    dr = lt.DepthResist(mack=lt.MackResist(thickness_nm=150.0), nz=8,
                        absorbance_per_um=0.5, n_resist=1.71)
    wafer = lt.WaferStack.from_resist(
        dr, under_layers=((37.0, MATERIALS_193["barc"]),))
    kernels, t_build = _timed(torch, lambda: lt.film_socs_kernels(
        src, device="cuda", config=cfg, wafer_stack=wafer, resist=dr,
        rank=FILM_RANK))
    stack, t_apply = _timed(torch, lambda: lt.film_socs_stack(
        mask, kernels, source_total=float(src.sum(dtype=np.float64))))
    del kernels
    log(f"[phase 24] film_socs_kernels, nz {dr.nz}, rank {FILM_RANK} (resist "
        f"{wafer.n_resist} {wafer.thickness_nm} nm over 37 nm BARC on Si): "
        f"{t_build:.3f} s; film_socs_stack (int8 applies): {t_apply:.4f} s")
    rig = dr.rigorous()
    sweeps = rig.nz + 48
    profile, t = _timed(torch, lambda: rig.develop_profile_binary(
        stack, pixel_size_nm=cfg.pixel_size))
    log(f"  develop_profile_binary ({sweeps} sweeps at {tuple(stack.shape)}, "
        f"no grad): {t:.3f} s; cleared fraction {float(profile.mean()):.4f}, "
        f"through-print {float(profile.min(dim=0).values.mean()):.4f}")
    rate = rig._rate(rig.latent(stack, pixel_size_nm=cfg.pixel_size))
    slow = 1.0 / rate
    spacing = (rig.mack.thickness_nm / rig.nz, cfg.pixel_size, cfg.pixel_size)
    eikonal.arrival_times(slow, spacing, iterations=2)  # warm-up
    arrival, t = _timed(torch, lambda: eikonal.arrival_times(
        slow, spacing, iterations=sweeps))
    per_sweep = _sweep_bytes(torch, lambda: eikonal.godunov_update(
        arrival, slow, spacing))
    fused = 3 * slow.numel() * 4
    log(f"  eikonal arrival_times alone: {t:.4f} s, {sweeps / t:.1f} sweeps/s; "
        f"one sweep moves {per_sweep / 1e9:.3f} GB op by op "
        f"({per_sweep / slow.numel():.1f} B a voxel): bound "
        f"{HBM_BYTES_S / per_sweep:.1f} sweeps/s at 3.35 TB/s, "
        f"{100 * (sweeps / t) / (HBM_BYTES_S / per_sweep):.1f}% of it; a fused "
        f"sweep (t and s read, t written) {HBM_BYTES_S / fused:.1f} sweeps/s")
    uniform = slow.mean(dim=(1, 2), keepdim=True).expand_as(slow).contiguous()
    t_unif = eikonal.arrival_times(uniform, spacing, iterations=sweeps,
                                   lateral_factor=0.6)
    expect = torch.cumsum(uniform[:, :1, :1].double() * spacing[0], dim=0)
    check("vertical limit: uniform slowness vs cumulative integral (rel)",
          float(((t_unif.double() - expect) / expect).abs().max()), 1e-6)
    crop = slow[:, 448:576, 448:576].contiguous()
    on_card = eikonal.arrival_times(crop, spacing, iterations=sweeps).cpu()
    on_cpu = eikonal.arrival_times(crop.cpu(), spacing, iterations=sweeps)
    check("(8, 128, 128) crop: card vs float32 CPU solve (rel to max)",
          float((on_card - on_cpu).abs().max() / on_cpu.abs().max()), 1e-6)
    del rate, slow, uniform, arrival, t_unif
    model = lt.StochasticResist(dose_photons_per_nm2=20.0, diffusion_nm=8.0,
                                threshold=0.3)
    dz = dr.mack.thickness_nm / dr.nz
    vol, t = _timed(torch, lambda: lt.stochastic_volume_ensemble(
        stack, cfg, model, dz_nm=dz, trials=8, seed=0))
    log(f"  stochastic_volume_ensemble, 8 trials on the (8, 1024, 1024) stack: "
        f"{t:.3f} s; LER top {vol['ler_top_nm']:.4f} nm, bottom "
        f"{vol['ler_bottom_nm']:.4f} nm, bottom bridge rate "
        f"{vol['bridge_rate_bottom']:.3e}")
    p = vol["print_probability"]
    if not (p.shape == tuple(stack.shape) and 0.0 <= p.min() and p.max() <= 1.0):
        raise AssertionError("volumetric print probability outside [0, 1]")
    from lithographysimulator_tpu_torch.models.stochastic import trial_generator

    flat = model.deprotection(trial_generator(0, 3, "cuda"), stack[3], cfg)
    one = model.deprotection_volume(trial_generator(0, 3, "cuda"), stack[3:4],
                                    cfg, dz_nm=dz)
    if not torch.equal(one[0], flat):
        raise AssertionError("one-slab deprotection_volume != deprotection")
    log("  nz = 1 volume equals deprotection, bit for bit: ok")
    _phase_end(torch, ik, 24, t0, launches, True)


def _cli_report(cli, argv) -> dict:
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"CLI {argv[0]} exited {rc}")
    return json.loads(out.getvalue().splitlines()[0])


def phase_calibrate_cli(torch, lt, ik, launches: dict) -> None:
    """Phase 25: calibration on gauges the card imaged, and the CLI."""
    import tempfile

    from lithographysimulator_tpu_torch import cli

    t0 = _phase_start(torch, ik)
    n = 256
    cfg = lt.OpticsConfig(pixel_number=n)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    truth = lt.ResistModel(threshold=0.42, diffusion_nm=12.0)
    gauges, t = _timed(torch, lambda: [lt.simulate(
        lt.lines_and_spaces(cfg, line_width_px=p // 2, pitch_px=p,
                            device="cuda"), src, device="cuda").image
        for p in (8, 12, 24)])
    measured = [lt.gauge_cd(truth, g, cfg) for g in gauges]
    fit, t_fit = _timed(torch, lambda: lt.calibrate_resist(
        gauges, measured, cfg, model=lt.ResistModel(threshold=0.3)))
    log(f"[phase 25] 3 gauges imaged at {n}^2 (exact, int8): {t:.3f} s; "
        f"calibrate_resist: {t_fit:.3f} s, {fit['evals']} evaluations, params "
        f"{fit['params']}, rms {fit['rms_nm']:.5f} nm (hidden threshold 0.42, "
        "diffusion 12 nm)")
    if not (abs(fit["params"]["threshold"] - 0.42) <= 0.01
            and abs(fit["params"]["diffusion_nm"] - 12.0) <= 1.5):
        raise AssertionError(f"calibration missed the hidden model: {fit['params']}")
    common = ["--device", "cuda", "--pixel-number", str(n), "--mask", "lines"]
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, g in enumerate(gauges):
            paths.append(f"{tmp}/g{i}.npy")
            np.save(paths[-1], g.cpu().numpy())
        runs = {
            "focus": ["focus", *common],
            "resist3d": ["resist3d", *common, "--nz", "8"],
            "resist3d --film": ["resist3d", *common, "--nz", "8", "--film",
                                "--barc", "37", "--trials", "4"],
            "stochastic": ["stochastic", *common, "--trials", "16", "--psd"],
            "calibrate": ["calibrate", "--device", "cuda", "--pixel-number",
                          str(n), "--images", *paths,
                          "--cds", *[f"{c:.4f}" for c in measured]],
        }
        for tag, argv in runs.items():
            report, t = _timed(torch, lambda: _cli_report(cli, argv))
            log(f"  CLI {tag} ({t:.3f} s): {json.dumps(report)}")
    _phase_end(torch, ik, 25, t0, launches, True)


# ---------------------------------------------------------------------------
# The tiled full chip: ops/tiled.py, metrology.py, models/mrc.py
# ---------------------------------------------------------------------------

def _chip_layout(lt, torch, big_n: int, n: int, step: int) -> "torch.Tensor":
    """Phase 4's lines and spaces (n/16 px lines on an n/8 px pitch) over a
    big_n^2 chip, with 40 px contacts on every crossing of the tile seams
    (multiples of ``step``), so features straddle the cores' edges."""
    big_cfg = lt.OpticsConfig(pixel_number=big_n)
    chip = lt.lines_and_spaces(big_cfg, line_width_px=n // 16,
                               pitch_px=n // 8, device=DEVICE).geometry.clone()
    for r in range(step, big_n, step):
        for c in range(step, big_n, step):
            chip[r - 20:r + 20, c - 20:c + 20] = 1.0
    return chip


def _window(chip: np.ndarray, row0: int, col0: int, n: int) -> np.ndarray:
    """The (n, n) window of ``chip`` at (row0, col0), zero outside it, by
    explicit index arithmetic (not the tiled module's padding)."""
    big_n = chip.shape[0]
    out = np.zeros((n, n), np.float32)
    r0, r1 = max(row0, 0), min(row0 + n, big_n)
    c0, c1 = max(col0, 0), min(col0 + n, big_n)
    out[r0 - row0:r1 - row0, c0 - col0:c1 - col0] = chip[r0:r1, c0:c1]
    return out


def _check_tile_cores(lt, torch, tiled, chip_np, image_fn, cfg, halo, step,
                      tiles, tag: str) -> None:
    """An interior tile and the last corner: the stitched core equals the
    core of the tile's window imaged as one field, within 1e-4 of its
    maximum (tests/test_tiled.py:81-103). ``tiled`` is (..., M, M) on the
    host."""
    n = cfg.n
    for ti, tj in ((tiles // 2 - 1, tiles // 2), (tiles - 1, tiles - 1)):
        field = _window(chip_np, ti * step - halo, tj * step - halo, n)
        single = image_fn(torch.as_tensor(field, device=DEVICE)).cpu().numpy()
        core = single[..., halo:halo + step, halo:halo + step]
        got = tiled[..., ti * step:(ti + 1) * step, tj * step:(tj + 1) * step]
        core = core[..., :got.shape[-2], :got.shape[-1]]  # chip-edge crop
        check(f"{tag}: tile ({ti}, {tj}) core vs its window as one field "
              "(max abs, rel)",
              float(np.abs(got - core).max() / np.abs(core).max()),
              TOL_TILE_CORE)


def phase_tiled(torch, lt, ik, launches: dict) -> dict:
    """Phase 27: the 8192^2 chip through 1024^2 tiles, rank 256, int8.
    Returns the array path's launch counts."""
    from lithographysimulator_tpu_torch.ops.tiled import tile_layout

    n = TILE_N
    cfg, _, src = _headline_setup(lt, n)
    halo = lt.default_halo(cfg)
    tiles, step = tile_layout(TILED_BIG_N, n, halo)
    t0 = _phase_start(torch, ik)
    chip = _chip_layout(lt, torch, TILED_BIG_N, n, step)
    chip_np = chip.cpu().numpy()
    pupil = lt.pupil_function(np.zeros(1, np.float32), cfg, device=DEVICE)
    socs, t_build = _timed(torch, lambda: lt.randomized_socs(
        pupil, src, cfg, rank=SOCS_RANK))
    lt.tiled_socs_image(chip[:2 * step, :2 * step], socs, cfg)  # warm-up
    base = dict(ik.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    img, t_array = _timed(torch, lambda: lt.tiled_socs_image(chip, socs, cfg))
    peak = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    per_image = {k: v - base[k] for k, v in ik.LAUNCHES.items()}
    img_np = check_image(img, TILED_BIG_N)
    mpx = TILED_BIG_N ** 2 / 1e6
    log(f"[phase 27] {TILED_BIG_N}^2 chip through {n}^2 tiles: halo {halo}, "
        f"step {step}, {tiles} x {tiles} = {tiles * tiles} tiles, rank "
        f"{SOCS_RANK} (build {t_build:.3f} s), int8")
    log(f"  tiled_socs_image: {t_array:.3f} s, {tiles * tiles / t_array:.2f} "
        f"tiles/s, {mpx / t_array:.2f} chip megapixels/s, {1e3 * t_array / tiles ** 2:.2f} "
        f"ms a tile; peak device memory above the chip and kernels {peak:.3f} GB; "
        f"launches {per_image} (predicted {tiles * tiles * SOCS_RANK // 4} of each)")
    if any(v != tiles * tiles * SOCS_RANK // 4 for v in per_image.values()):
        raise AssertionError(f"one 8192^2 image should launch each kernel "
                             f"{tiles * tiles * SOCS_RANK // 4} times: {per_image}")
    _check_tile_cores(lt, torch, img_np, chip_np, lambda f: lt.socs_image(
        lt.mask_spectrum(f, cfg), socs, cfg), cfg, halo, step, tiles,
        "tiled_socs_image")
    stream, t_stream = _timed(torch, lambda: lt.tiled_socs_image_stream(
        lt.array_window_fn(chip_np, n), TILED_BIG_N, socs, cfg))
    log(f"  tiled_socs_image_stream (array_window_fn, windows from the host): "
        f"{t_stream:.3f} s, {tiles * tiles / t_stream:.2f} tiles/s")
    check("stream vs array path (max abs, rel)",
          float((stream - img).abs().max() / img.abs().max()), TOL_STREAM)
    del stream
    scan, t_scan = _timed(torch, lambda: lt.tiled_socs_image_scan(chip, socs, cfg))
    log(f"  tiled_socs_image_scan: {t_scan:.3f} s")
    check("scan variant vs loop (max abs, rel)",
          float((scan - img).abs().max() / img.abs().max()), TOL_SCAN)
    del scan
    matmul, t_matmul = _timed(torch, lambda: lt.tiled_socs_image(
        chip, socs, cfg, engine="matmul"))
    log(f"  tiled matmul engine (cuBLAS f32, TF32 off): {t_matmul:.3f} s")
    check("tiled int8 vs tiled f32 matmul engine (nrms)",
          nrms(img_np, check_image(matmul, TILED_BIG_N)), TOL_SOCS_PAIR)
    del matmul, img, socs
    _phase_end(torch, ik, 27, t0, launches, True)
    return per_image


def phase_tiled_fem(torch, lt, ik, launches: dict) -> dict:
    """Phase 28: tiled_fem over the 8192^2 chip, and the warm-start check.
    Returns the FEM result for phase 29's dose map."""
    from lithographysimulator_tpu_torch import metrology
    from lithographysimulator_tpu_torch.ops.abbe import (abbe_image_points,
                                                         source_points)
    from lithographysimulator_tpu_torch.ops.tiled import tile_layout

    n = TILE_N
    cfg, _, src = _headline_setup(lt, n)
    halo = lt.default_halo(cfg)
    tiles, step = tile_layout(TILED_BIG_N, n, halo)
    # Warm against cold on one tile, both against the exact image (int8,
    # within 1e-6 of f32), 50 nm from the basis's plane
    chip = _chip_layout(lt, torch, TILED_BIG_N, n, step)
    field = torch.as_tensor(_window(chip.cpu().numpy(), 4 * step - halo,
                                    5 * step - halo, n), device=DEVICE)
    spectrum = lt.mask_spectrum(field, cfg)
    ab = np.array([0, 0, 0, 0, 50.0], np.float32)
    pts = source_points(src)
    exact = abbe_image_points(spectrum, lt.pupil_function(ab, cfg, device=DEVICE),
                              *_padded(pts, 4), cfg, device=DEVICE)
    exact = check_image(exact, n)[halo:halo + step, halo:halo + step]
    build = metrology._builder(cfg, FEM_RANK, src, torch.device(DEVICE),
                               polarization=None, apodize=True, chromatic=None)
    _, basis = build(np.zeros(5, np.float32), return_basis=True)
    warm, t_warm = _timed(torch, lambda: build(ab, power_iters=0,
                                               init_basis=basis,
                                               return_basis=True)[0])
    cold, t_cold = _timed(torch, lambda: build(ab))
    del basis
    err = {k: nrms(check_image(lt.socs_image(spectrum, s, cfg), n)[
        halo:halo + step, halo:halo + step], exact)
        for k, s in (("warm", warm), ("cold", cold))}
    del warm, cold
    log(f"[phase 28] warm start at rank {FEM_RANK}, 50 nm from the basis's "
        f"plane, one tile's core against the exact image: warm (power_iters 0) "
        f"{err['warm']:.3e} in {t_warm:.3f} s, cold (power_iters 2) "
        f"{err['cold']:.3e} in {t_cold:.3f} s")
    check("warm-built tile error, against max(2 x cold error, 1e-5)",
          err["warm"], max(2.0 * err["cold"], 1e-5))

    t0 = _phase_start(torch, ik)
    builds = []
    make_builder = metrology._builder

    def timed_builder(*args, **kw):
        inner = make_builder(*args, **kw)

        def timed(aberrations, **kw2):
            out, t = _timed(torch, lambda: inner(aberrations, **kw2))
            builds.append(t)
            return out

        return timed

    marks = []  # (fraction, time): the stack is done at 0.8, synchronized
    metrology._builder = timed_builder
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        fem = lt.tiled_fem(
            chip, cfg, src, defocus_nm=np.linspace(-100, 100, 5),
            doses=FEM_DOSES, rank=FEM_RANK, resist=lt.ResistModel(threshold=0.4),
            progress_cb=lambda f: marks.append((f, time.perf_counter())))
        torch.cuda.synchronize()
        t_fem = time.perf_counter() - start
    finally:
        metrology._builder = make_builder
    t_stack = next(t for f, t in marks if f >= 0.8 - 1e-9) - start
    t_builds = sum(builds)
    log(f"  tiled_fem {TILED_BIG_N}^2, 5 focus planes -100..100 nm, doses "
        f"{list(FEM_DOSES)}, rank {FEM_RANK}, warm starts: {t_fem:.3f} s = "
        f"builds {t_builds:.3f} s ({', '.join(f'{b:.3f}' for b in builds)}) + "
        f"imaging {t_stack - t_builds:.3f} s ({5 * tiles * tiles} tiles) + "
        f"develop and CDs {t_fem - t_stack:.3f} s (25 cells)")
    log(f"  CD matrix (nm, focus x dose): {np.round(fem['cd_nm'], 3).tolist()}")
    log(f"  target CD {fem['target_cd_nm']:.3f} nm, DOF "
        f"{fem['depth_of_focus_nm']:.3f} nm, exposure latitude "
        f"{fem['exposure_latitude']:.4f}, in spec {fem['in_spec_fraction']:.3f}; "
        f"CDU 3 sigma {fem['cdu']['cdu_3sigma_nm']:.4f} nm over "
        f"{fem['cdu']['count']} features; NILS mean {fem['nils']['mean_nils']:.4f}; "
        f"EPE max {fem['epe']['max_abs_epe_nm']:.3f} nm, missing "
        f"{fem['epe']['missing']}")
    cds = np.asarray(fem["cd_nm"])
    if cds.shape != (5, 5) or not np.isfinite(cds).all() or cds.min() <= 0:
        raise AssertionError(f"bad CD matrix {cds}")
    if not fem["depth_of_focus_nm"] > 0 or not fem["exposure_latitude"] > 0:
        raise AssertionError("empty process window at the nominal CD")
    if not (np.diff(cds[2]) >= 0).all() and not (np.diff(cds[2]) <= 0).all():
        raise AssertionError(f"CD not monotone in dose at best focus: {cds[2]}")
    _phase_end(torch, ik, 28, t0, launches, True)
    return fem


def phase_tiled_rest(torch, lt, ik, launches: dict, fem: dict) -> None:
    """Phase 29: the film stack, resist3d --big-n, the ensemble, ORC, MEEF,
    defect printability, the dose map and the fem CLI, at 4096^2."""
    import tempfile

    from lithographysimulator_tpu_torch import cli
    from lithographysimulator_tpu_torch.ops.filmstack import MATERIALS_193
    from lithographysimulator_tpu_torch.ops.tiled import tile_layout

    n = TILE_N
    cfg, _, src = _headline_setup(lt, n)
    halo = lt.default_halo(cfg)
    tiles, step = tile_layout(SLICE_BIG_N, n, halo)
    t0 = _phase_start(torch, ik)
    chip = _chip_layout(lt, torch, SLICE_BIG_N, n, step)
    chip_np = chip.cpu().numpy()
    dr = lt.DepthResist(mack=lt.MackResist(thickness_nm=150.0), nz=8,
                        absorbance_per_um=0.5, n_resist=1.71)
    wafer = lt.WaferStack.from_resist(
        dr, under_layers=((37.0, MATERIALS_193["barc"]),))
    kernels, t_build = _timed(torch, lambda: lt.film_socs_kernels(
        src, device=DEVICE, config=cfg, wafer_stack=wafer, resist=dr,
        rank=FILM_RANK))
    total = float(src.sum(dtype=np.float64))
    stack, t = _timed(torch, lambda: lt.tiled_film_stack(
        chip, kernels, cfg, source_total=total))
    log(f"[phase 29] {SLICE_BIG_N}^2 chip ({tiles * tiles} tiles): film kernels "
        f"nz {dr.nz} rank {FILM_RANK} {t_build:.3f} s; tiled_film_stack "
        f"{t:.3f} s ({tiles * tiles * dr.nz / t:.2f} tile-slabs/s), shape "
        f"{tuple(stack.shape)}")
    _check_tile_cores(lt, torch, stack.cpu().numpy(), chip_np,
                      lambda f: lt.film_socs_stack(f, kernels, config=cfg,
                                                   source_total=total),
                      cfg, halo, step, tiles, "tiled_film_stack")
    del kernels, stack
    common = ["--device", DEVICE, "--pixel-number", str(n), "--mask", "lines"]
    report, t = _timed(torch, lambda: _cli_report(cli, [
        "resist3d", *common, "--big-n", str(SLICE_BIG_N), "--film", "--barc",
        "37"]))
    log(f"  CLI resist3d --film --big-n {SLICE_BIG_N} ({t:.3f} s): "
        f"{json.dumps(report)}")
    if not 0.0 < report["cleared_fraction"] < 1.0:
        raise AssertionError("resist3d --big-n cleared nothing or everything")

    model = lt.StochasticResist(dose_photons_per_nm2=20.0, diffusion_nm=8.0,
                                threshold=0.3)
    out, t = _timed(torch, lambda: lt.tiled_stochastic(
        chip, cfg, src, model=model, trials=16, seed=0, rank=64))
    log(f"  tiled_stochastic, 16 trials, rank 64: {t:.3f} s ({16 / t:.2f} "
        f"trials/s with the image): LER {out['ler_nm']:.4f} nm, LWR "
        f"{out['lwr_nm']:.4f} nm, LCDU {out['lcdu_nm']:.4f} nm, mean CD "
        f"{out['mean_cd_nm']:.3f} nm, break {out['break_rate']:.3e}, bridge "
        f"{out['bridge_rate']:.3e}")
    p = out["print_probability"]
    if (out["big_n"] != SLICE_BIG_N or not 0.0 <= p.min() <= p.max() <= 1.0
            or not out["ler_nm"] > 0):
        raise AssertionError("tiled_stochastic: bad ensemble")

    flat = lambda fx, fy: np.zeros(5, np.float32)
    one, t1 = _timed(torch, lambda: lt.tiled_socs_image_field(
        chip, cfg, src, flat, field_points=1, rank=64))
    three, t3 = _timed(torch, lambda: lt.tiled_socs_image_field(
        chip, cfg, src, flat, field_points=3, rank=64))
    log(f"  tiled_socs_image_field, rank 64, a flat field: 1 sample {t1:.3f} "
        f"s, 3 x 3 samples (linear blend) {t3:.3f} s")
    check("field path: 3 x 3 flat samples vs 1 (max abs, rel)",
          float((three - one).abs().max() / one.abs().max()), TOL_SCAN)
    slit = lambda fx, fy: np.array([0, 0, 0, 0, 120.0 * (fx * fx + fy * fy)],
                                   np.float32)
    varying = lt.tiled_socs_image_field(chip, cfg, src, slit, field_points=3,
                                        rank=64, blend="nearest")
    # the tile nearest the chip's center takes the center (unaberrated) sample
    i0 = int(np.argmin(np.abs((np.arange(tiles) + 0.5) * step / SLICE_BIG_N - 0.5)))
    mid = slice(i0 * step, (i0 + 1) * step)
    check(f"field path, nearest: tile ({i0}, {i0}) (the center sample) vs a "
          "flat field (max abs, rel)",
          float((varying[mid, mid] - one[mid, mid]).abs().max()
                / one[mid, mid].abs().max()), TOL_STREAM)
    corner = float((varying[:step, :step] - one[:step, :step]).abs().max())
    if not corner > 1e-3 * float(one[:step, :step].max()):
        raise AssertionError("field path: the edge tiles ignore the field map")
    del one, three, varying

    rules = lt.MaskRules(min_width_nm=100.0, min_space_nm=100.0,
                         min_area_nm2=1e5)
    orc, t = _timed(torch, lambda: lt.orc_check(
        chip, chip, cfg, src, mrc_rules=rules, resist=lt.ResistModel(
            threshold=0.4)))
    log(f"  orc_check with MaskRules: {t:.3f} s: pass {orc['pass_']}, "
        f"fidelity {orc['fidelity']}, EPE {orc['epe']}, NILS {orc['nils']}, "
        f"MRC {orc['mrc']}")
    if not orc["mrc"]["clean"] or orc["epe"]["matched"] <= 0:
        raise AssertionError("orc_check: the layout fails its own rules")

    table, t = _timed(torch, lambda: lt.tiled_meef_map(
        chip, cfg, src, resist=lt.ResistModel(threshold=0.4), rank=64))
    log(f"  tiled_meef_map, rank 64: {t:.3f} s: {table['count']} features, "
        f"mean MEEF {table['mean_meef']:.4f}, sigma {table['sigma_meef']:.4f}")
    if not table["count"] > 0 or not 0.2 < table["mean_meef"] < 5.0:
        raise AssertionError("tiled_meef_map: no sane MEEF")
    bad = chip.clone()
    mid = SLICE_BIG_N // 2  # a cut line of the defect tables (row_step 16)
    starts = np.flatnonzero(np.diff(chip_np[mid]) > 0) + 1
    col = int(starts[len(starts) // 2]) + 20
    bad[mid - 4:mid + 4, col:col + 24] = 0.0  # a notch inside one 64 px line
    defect, t = _timed(torch, lambda: lt.defect_printability(
        chip, bad, cfg, src, resist=lt.ResistModel(threshold=0.4,
                                                   diffusion_nm=10.0), rank=64))
    log(f"  defect_printability (a 24 px notch at ({mid}, {col})): {t:.3f} s: "
        f"prints {defect['prints']}, max |CD delta| "
        f"{defect['max_abs_cd_delta_nm']:.3f} nm (spec "
        f"{defect['cd_spec_nm']:.3f}), at {defect['per_focus'][0]['cd_delta_location_nm']}")
    if not defect["prints"]:
        raise AssertionError("defect_printability missed a 24 px notch")

    dc = lt.dose_correction_map(fem)
    image = lt.tiled_socs_image(chip, lt.randomized_socs(
        lt.pupil_function(np.zeros(1, np.float32), cfg, device=DEVICE), src,
        cfg, rank=64), cfg)
    scaled = lt.apply_dose_map(image, dc["dose_map"])
    dm = np.asarray(dc["dose_map"], np.float64)
    up = np.kron(dm, np.ones((-(-SLICE_BIG_N // dm.shape[0]),) * 2))
    ref = (image.cpu().numpy() * up[:SLICE_BIG_N, :SLICE_BIG_N]).astype(np.float32)
    log(f"  dose_correction_map of phase 28's FEM: sensitivity "
        f"{dc['sensitivity_nm_per_dose']:.3f} nm per dose, dose map "
        f"{dm.min():.4f}..{dm.max():.4f}, predicted residual "
        f"{dc['predicted_residual_nm']:.3f} nm")
    if not np.array_equal(scaled.cpu().numpy(), ref):
        raise AssertionError("apply_dose_map differs from the float64 host product")
    log("  apply_dose_map on the card equals the float64 host product: ok")
    del image, scaled
    with tempfile.TemporaryDirectory() as tmp:
        report, t = _timed(torch, lambda: _cli_report(cli, [
            "fem", *common, "--big-n", str(CLI_FEM_BIG_N), "--cdu-map",
            f"{tmp}/cdu.npy"]))
    log(f"  CLI fem --big-n {CLI_FEM_BIG_N} ({t:.3f} s): {json.dumps(report)}")
    if np.asarray(report["cd_nm"]).shape != (5, 5):
        raise AssertionError("fem CLI: bad CD matrix")
    _phase_end(torch, ik, 29, t0, launches, True)


# ---------------------------------------------------------------------------
# Optimization: optimize.py, models/sraf.py, models/multipatterning.py
# ---------------------------------------------------------------------------

def _opt_setup(lt, n: int):
    """Phase 4's optics at n^2 on DEVICE: lines and spaces n/16 on n/8 px,
    the quasar sigma 0.4/0.8."""
    cfg = lt.OpticsConfig(pixel_number=n)
    mask = lt.lines_and_spaces(cfg, line_width_px=n // 16, pitch_px=n // 8,
                               device=DEVICE)
    src = lt.LightSource(cfg, sigma_in=0.4, sigma_out=0.8).quasar(4, -np.pi / 8)
    return cfg, mask, src


def _fell(tag: str, hist, factor: float = 1.0) -> None:
    """The loss history is finite and its last value below ``factor`` times
    its first."""
    ok = np.isfinite(hist).all() and hist[-1] < factor * hist[0]
    log(f"  {tag}: loss {hist[0]:.6e} -> {hist[-1]:.6e} over {len(hist)} "
        f"values (must fall below {factor:g}x) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: loss did not fall: {hist}")


def phase_smo(torch, lt, ik, launches: dict) -> None:
    """Phase 31: SMO at 1024^2 through the int8 kernels' gradient."""
    from lithographysimulator_tpu_torch import optimize as opt
    from lithographysimulator_tpu_torch.ops.abbe import source_points

    t0 = _phase_start(torch, ik)
    cfg, mask, src = _opt_setup(lt, OPT_N)
    pts = source_points(src)
    shifts, weights = _padded(pts, 4)
    problem = opt.SMOProblem(config=cfg)
    ab = np.zeros(1, np.float32)
    with torch.no_grad():
        target, t = _timed(torch, lambda: opt.forward(
            opt.init_params(problem, mask.geometry), ab, shifts, weights,
            problem))
    log(f"[phase 31] {OPT_N}^2 SMO, {pts.live_count} points; the target "
        f"(the exact forward of the design, int8): {t:.3f} s")
    start = np.full((cfg.n, cfg.n), 0.4, np.float32)
    (params, hist), t = _timed(torch, lambda: opt.optimize_socs(
        problem, target, start, ab, shifts, weights, steps=SMO_STEPS,
        learning_rate=0.2, rank=OPT_RANK))
    log(f"  optimize_socs, mask only, rank {OPT_RANK}, {SMO_STEPS} steps: "
        f"{t:.3f} s with the build ({t / SMO_STEPS:.4f} s a step)")
    _fell("optimize_socs (mask only)", hist, 0.5)
    # the same kernels again (the build is seeded), and the first loss
    # formed here on the f32 matmul engine
    from lithographysimulator_tpu_torch.metrology import _builder

    w = torch.as_tensor(weights, device=DEVICE)
    socs, _ = _builder(cfg, OPT_RANK, opt._source_map_from_points(
        shifts, w, cfg.n), DEVICE, polarization=None, apodize=True,
        chromatic=None)(ab, return_basis=True)
    latent0 = opt.latent_from_mask(
        torch.as_tensor(start, device=DEVICE), problem.mask_steepness)

    def socs_loss(latent, engine):
        image = lt.socs_image(lt.mask_spectrum(opt.mask_from_latent(
            latent, problem.mask_steepness), cfg), socs, cfg, engine=engine)
        return torch.mean((image / w.sum() - target) ** 2)

    with torch.no_grad():
        first = float(socs_loss(latent0, "matmul"))
    check("first optimize_socs loss (int8) against the matmul engine's, "
          "relative", abs(hist[0] - first) / abs(first), TOL_SMO_LOSS)
    grads = {}
    for engine in ("int8", "matmul"):
        leaf = latent0.clone().requires_grad_()
        loss, t_f = _timed(torch, lambda: socs_loss(leaf, engine))
        _, t_b = _timed(torch, loss.backward)
        grads[engine] = leaf.grad
        log(f"  a rank-{OPT_RANK} SOCS mask step on {engine}: forward "
            f"{t_f:.4f} s, backward {t_b:.4f} s")
    scale = float(grads["matmul"].abs().max())
    check("mask-latent gradient, int8 against matmul, max|dg|/max|g|",
          float((grads["int8"] - grads["matmul"]).abs().max()) / scale,
          TOL_OPT_GRAD)
    g = grads["int8"]
    log(f"  max|g| {scale:.3e}; share of the gradient's squares that overflow "
        f"float32 (why Adam steps float64 copies, ROADMAP D10): "
        f"{float(torch.isinf(g * g).float().mean()):.4f}")
    del socs, grads

    sub = source_points(_subset(src, pts, SUBSET_K))
    s_shifts, s_weights = _padded(sub, 4)
    with torch.no_grad():
        s_target = opt.forward(opt.init_params(problem, mask.geometry), ab,
                               s_shifts, s_weights, problem)
    (params, hist), t = _timed(torch, lambda: opt.optimize(
        problem, s_target, start, ab, s_shifts, s_weights, steps=5,
        learning_rate=0.2))
    log(f"  optimize (exact Abbe), every {SUBSET_K}th point ({sub.live_count}, "
        f"{len(s_weights) // 4} chunks), 5 steps: {t:.3f} s ({t / 5:.4f} s a "
        "step)")
    _fell("optimize", hist)
    src_problem = opt.SMOProblem(config=cfg, optimize_source=True)
    w0 = np.maximum(s_weights, 1e-3)
    (params, hist), t = _timed(torch, lambda: opt.optimize_socs(
        src_problem, s_target, start, ab, s_shifts, s_weights, steps=10,
        learning_rate=0.2, rank=OPT_RANK, mask_steps_per_build=5,
        source_weights_init=w0))
    moved = float((params["source_logits"].cpu()
                   - torch.log(torch.as_tensor(w0))).abs().max())
    log(f"  optimize_socs, alternating, 2 x (a warm build, 5 mask steps, one "
        f"source step): {t:.3f} s; the source logits moved {moved:.3e}")
    _fell("optimize_socs (alternating)", hist)
    if not moved > 1e-4:
        raise AssertionError("the alternating SMO left the source where it was")
    _phase_end(torch, ik, 31, t0, launches, True)


def phase_fit(torch, lt, ik, launches: dict) -> None:
    """Phase 32: aberration retrieval through a 3-plane focal stack."""
    from lithographysimulator_tpu_torch import optimize as opt
    from lithographysimulator_tpu_torch.ops.abbe import source_points

    t0 = _phase_start(torch, ik)
    cfg, mask, src = _opt_setup(lt, OPT_N)
    sub = source_points(_subset(src, source_points(src), SUBSET_K))
    shifts, weights = _padded(sub, 4)
    spectrum = lt.mask_spectrum(mask.geometry, cfg)
    truth = np.array([0, 0, 0.02, 0.05, 25.0, 0, 0, 0.04, 0, 0], np.float32)
    planes = []
    with torch.no_grad():
        for off in FOCUS_PLANES:
            ab = truth.copy()
            ab[4] += off
            planes.append(lt.abbe_image_points(
                spectrum, lt.pupil_function(ab, cfg, device=DEVICE), shifts,
                weights, cfg, device=DEVICE, normalize=True))
    (coeffs, hist), t = _timed(torch, lambda: opt.fit_aberrations(
        torch.stack(planes), spectrum, shifts, weights, cfg, n_coeffs=10,
        steps=6, learning_rate=0.01, defocus_nm=FOCUS_PLANES))
    log(f"[phase 32] fit_aberrations at {OPT_N}^2, {len(FOCUS_PLANES)} planes "
        f"{FOCUS_PLANES} nm, every {SUBSET_K}th point ({sub.live_count}), 10 "
        f"coefficients, 6 steps at learning rate 0.01: {t:.3f} s "
        f"({t / 6:.4f} s a step of 3 planes)")
    _fell("fit_aberrations", hist)
    err = coeffs.cpu().numpy() - truth
    log(f"  fitted {np.round(coeffs.cpu().numpy(), 5).tolist()}; truth "
        f"{truth.tolist()}; error {np.round(err, 5).tolist()} (6 steps from 0)")
    _phase_end(torch, ik, 32, t0, launches, True)


def _fidelity(lt, profile, target, cfg) -> dict:
    """pattern_fidelity with the EPE keys cmd_opc reports."""
    out = lt.pattern_fidelity(profile, target, cfg)
    epe = lt.edge_placement_errors(profile, target, cfg)
    out.update({k: epe[k] for k in ("mean_abs_epe_nm", "max_abs_epe_nm",
                                    "matched", "missing")})
    return out


def phase_opc(torch, lt, ik, launches: dict) -> None:
    """Phase 33: resist-aware OPC on the int8 gradient, and the
    process-window OPC on the f32 matmul engine (no int8 launch)."""
    from lithographysimulator_tpu_torch import optimize as opt
    from lithographysimulator_tpu_torch.ops.abbe import source_points

    t0 = _phase_start(torch, ik)
    cfg, mask, src = _opt_setup(lt, OPT_N)
    sub = source_points(_subset(src, source_points(src), SUBSET_K))
    shifts, weights = _padded(sub, 4)
    ab = np.zeros(1, np.float32)
    resist = lt.ResistModel(threshold=0.35, steepness=30.0)
    design = mask.geometry

    def printed(geom):
        with torch.no_grad():
            img = lt.abbe_image_points(
                lt.mask_spectrum(geom, cfg),
                lt.pupil_function(ab, cfg, device=DEVICE), shifts, weights,
                cfg, device=DEVICE, normalize=True)
        return _fidelity(lt, resist.develop_binary(img, cfg), design, cfg)

    before = printed(design)
    (corrected, hist), t = _timed(torch, lambda: opt.opc_correct(
        design, ab, shifts, weights, opt.SMOProblem(config=cfg),
        resist=resist, steps=5))
    log(f"[phase 33] opc_correct at {OPT_N}^2, every {SUBSET_K}th point, 5 "
        f"steps: {t:.3f} s ({t / 5:.4f} s a step)")
    _fell("opc_correct", hist)
    log(f"  fidelity before {json.dumps(before)}")
    log(f"  fidelity after  {json.dumps(printed(corrected))}")

    before_pw = dict(ik.LAUNCHES)
    nominal = lt.randomized_socs(lt.pupil_function(ab, cfg, device=DEVICE),
                                 src, cfg, rank=OPT_RANK)

    def printed_pw(geom):
        with torch.no_grad():
            img = lt.socs_image(lt.mask_spectrum(geom, cfg), nominal, cfg,
                                engine="matmul")
        return _fidelity(lt, resist.develop_binary(img, cfg), design, cfg)

    before = printed_pw(design)
    (corrected, rep), t = _timed(torch, lambda: opt.opc_correct_pw(
        design, cfg, src, resist=resist, steps=5, rank=OPT_RANK))
    after = printed_pw(corrected)
    pw_launches = {k: ik.LAUNCHES[k] - before_pw[k] for k in KERNELS}
    log(f"  opc_correct_pw, 3 x 3 corners, rank {OPT_RANK}, 5 steps: {t:.3f} "
        f"s with the three builds; corner losses "
        f"{np.round(rep['corner_losses'], 6).tolist()}")
    _fell("opc_correct_pw", rep["loss_history"])
    log(f"  nominal fidelity (rank-{OPT_RANK} SOCS, matmul) before "
        f"{json.dumps(before)}")
    log(f"  nominal fidelity after  {json.dumps(after)}")
    log(f"  int8 launches of opc_correct_pw and its fidelity: {pw_launches}")
    if any(pw_launches.values()):
        raise AssertionError(f"opc_correct_pw launched int8 kernels: {pw_launches}")
    _phase_end(torch, ik, 33, t0, launches, True)


def phase_opc_tiled_cli(torch, lt, ik, launches: dict) -> None:
    """Phase 34: full-chip OPC through 1024^2 tiles, and the smo, opc,
    fitaberr and lele subcommands."""
    import tempfile

    from lithographysimulator_tpu_torch import cli
    from lithographysimulator_tpu_torch import optimize as opt
    from lithographysimulator_tpu_torch.ops.tiled import tile_layout

    t0 = _phase_start(torch, ik)
    cfg, _, src = _opt_setup(lt, OPT_N)
    halo = lt.default_halo(cfg)
    tiles, step = tile_layout(OPT_BIG_N, OPT_N, halo)
    chip = _chip_layout(lt, torch, OPT_BIG_N, OPT_N, step)
    resist = lt.ResistModel(threshold=0.35, steepness=30.0)

    def fidelity(mask_big):  # as cmd_opc forms it
        img = lt.tiled_focus_images(mask_big, cfg, src, [0.0], rank=OPT_RANK,
                                    halo=halo, device=DEVICE)[0]
        return _fidelity(lt, ((img / img.max()) > resist.threshold).float(),
                         chip, cfg)

    before = fidelity(chip)
    seen = []
    corrected, t = _timed(torch, lambda: opt.opc_correct_tiled(
        chip, cfg, src, resist=resist, halo=halo, steps=10, rank=OPT_RANK,
        progress_cb=seen.append))
    after = fidelity(corrected)
    log(f"[phase 34] opc_correct_tiled, {OPT_BIG_N}^2 through {tiles * tiles} "
        f"tiles of {OPT_N}^2 (halo {halo}), rank {OPT_RANK}, 10 steps, 1 sweep: "
        f"{t:.3f} s with the build ({t / (10 * tiles * tiles):.4f} s a tile "
        f"step); progress {np.round(seen, 4).tolist()}")
    log(f"  fidelity_before {json.dumps(before)}")
    log(f"  fidelity_after  {json.dumps(after)}")
    if not (corrected.shape == (OPT_BIG_N, OPT_BIG_N)
            and np.isfinite(corrected).all()
            and len(seen) == tiles * tiles and seen[-1] == 1.0
            and after["iou"] >= before["iou"]):
        raise AssertionError("opc_correct_tiled: bad mask, progress or IoU fell")
    n, m = CLI_OPT_N, CLI_OPT_BIG_N
    with tempfile.TemporaryDirectory() as tmp:
        fit_cfg = lt.OpticsConfig(pixel_number=n)
        fit_src = lt.LightSource(fit_cfg, sigma_out=0.2).classical()
        paths = []
        for off in FOCUS_PLANES:
            ab = np.array([0, 0, 0.02, 0.05, 25.0 + off, 0, 0, 0.04], np.float32)
            img = lt.simulate(lt.demo_bars(fit_cfg, device=DEVICE), fit_src,
                              ab, device=DEVICE).image
            paths.append(f"{tmp}/plane{len(paths)}.npy")
            np.save(paths[-1], img.cpu().numpy())
        common = ["--device", DEVICE, "--pixel-number", str(n)]
        runs = {
            "smo --forward socs": ["smo", *common, "--forward", "socs",
                                   "--steps", "20"],
            "opc": ["opc", *common, "--big-n", str(m), "--mask", "contacts",
                    "--steps", "5", "--mrc-min-width", "50",
                    "--mrc-min-area", "5000", "--mrc-repair"],
            "fitaberr": ["fitaberr", *common, "--source", "classical",
                         "--sigma-out", "0.2", "--images", *paths,
                         "--defocus", *[str(d) for d in FOCUS_PLANES],
                         "--steps", "4", "--lr", "0.01"],
            "lele": ["lele", "--device", DEVICE, "--pixel-number", str(m),
                     "--mask", "lines", "--source", "classical",
                     "--sigma-out", "0.3", "--min-pitch", "200"],
        }
        for tag, argv in runs.items():
            report, t = _timed(torch, lambda: _cli_report(cli, argv))
            log(f"  CLI {tag} ({t:.3f} s): {json.dumps(report)}")
    _phase_end(torch, ik, 34, t0, launches, True)


# ---------------------------------------------------------------------------
# Phases 36-41: layouts in, contours out, and the HTTP server on the card
# ---------------------------------------------------------------------------


def _rect(c0, r0, c1, r1, px: float) -> np.ndarray:
    """Pixels [r0, r1) x [c0, c1) as a rectangle in nm: pixel (r, c) spans
    x in [c px, (c+1) px], y in [r px, (r+1) px], so a centre-sampled
    raster at origin (0, 0) reproduces them exactly."""
    return np.array([[c0 * px, r0 * px], [c1 * px, r0 * px],
                     [c1 * px, r1 * px], [c0 * px, r1 * px]], np.float64)


def _chip_polygons(lt, big_n: int, n: int, step: int) -> list:
    """_chip_layout's chip as polygons (nm): its lines as full-height
    rectangles and its contacts as 40 px squares, on layer 1, plus a decoy
    on layer 2 that a --gds-layer 1 read must drop."""
    px = lt.OpticsConfig(pixel_number=big_n).pixel_size
    row = lt.lines_and_spaces(lt.OpticsConfig(pixel_number=big_n),
                              line_width_px=n // 16, pitch_px=n // 8,
                              device="cpu").geometry[0].numpy()
    edges = np.flatnonzero(np.diff(np.r_[0.0, row, 0.0]))
    polys = [(1, _rect(c0, 0, c1, big_n, px))
             for c0, c1 in zip(edges[::2], edges[1::2])]
    polys += [(1, _rect(c - 20, r - 20, c + 20, r + 20, px))
              for r in range(step, big_n, step) for c in range(step, big_n, step)]
    return polys + [(2, _rect(0, 0, big_n // 2, big_n // 2, px))]


def phase_rasterizer(torch, lt, ik, launches: dict) -> None:
    """Phase 36: the port's C++ rasterizer (g++ into _build/), phase 27's
    chip written as GDSII and OASIS and read back, rasterized whole and as
    one tile window."""
    import tempfile

    from lithographysimulator_tpu_torch.io import gdsii, layout, native, oasis
    from lithographysimulator_tpu_torch.ops.tiled import tile_layout

    t0 = _phase_start(torch, ik)
    lib, t_build = _timed(torch, native.build)
    log(f"[phase 36] rasterizer built with g++ in {t_build:.2f} s: "
        f"{lib.relative_to(REPO)}")
    cfg = lt.OpticsConfig(pixel_number=TILE_N)
    halo = lt.default_halo(cfg)
    tiles, step = tile_layout(TILED_BIG_N, TILE_N, halo)
    big_cfg = lt.OpticsConfig(pixel_number=TILED_BIG_N)
    chip = _chip_layout(lt, torch, TILED_BIG_N, TILE_N, step)
    polys = _chip_polygons(lt, TILED_BIG_N, TILE_N, step)
    px = big_cfg.pixel_size
    with tempfile.TemporaryDirectory() as tmp:
        for fmt, write, read in (("gds", gdsii.write_gds, gdsii.read_gds),
                                 ("oas", oasis.write_oasis, oasis.read_oasis)):
            path = f"{tmp}/chip.{fmt}"
            write(path, {"CHIP": polys})
            t1 = time.perf_counter()
            layer1 = [p.xy_nm for p in read(path).flatten() if p.layer == 1]
            t_read = time.perf_counter() - t1
            t1 = time.perf_counter()
            raster = native.rasterize(layer1, pixel_size=px, n=TILED_BIG_N)
            t_raster = time.perf_counter() - t1
            mask = layout.mask_from_layout(path, big_cfg, layer=1,
                                           origin=(0.0, 0.0), device=DEVICE)
            same = bool(torch.equal(mask.geometry, chip))
            log(f"  {fmt}: {Path(path).stat().st_size} bytes, {len(layer1)} "
                f"polygons on layer 1; read {1e3 * t_read:.2f} ms, rasterize "
                f"{TILED_BIG_N}^2 {1e3 * t_raster:.2f} ms (host); "
                f"mask_from_layout equals phase 27's chip bit for bit: {same}")
            if not (same and np.array_equal(raster, chip.cpu().numpy())):
                raise AssertionError(f"{fmt}: the layout raster differs from "
                                     "phase 27's chip")
        window_fn = layout.window_provider(layer1, cfg, TILED_BIG_N,
                                           origin=(0.0, 0.0))
        row0, col0 = step - halo, 2 * step - halo
        t1 = time.perf_counter()
        window = window_fn(row0, col0)
        t_window = time.perf_counter() - t1
        x_lo, y_lo = col0 * px, row0 * px
        hit = [p for p in layer1
               if p[:, 0].min() < x_lo + TILE_N * px and p[:, 0].max() > x_lo
               and p[:, 1].min() < y_lo + TILE_N * px and p[:, 1].max() > y_lo]
        t1 = time.perf_counter()
        plain = native._rasterize_numpy(hit, (x_lo, y_lo), px, TILE_N, 0)
        t_plain = time.perf_counter() - t1
        log(f"  {TILE_N}^2 window at ({row0}, {col0}): library {1e3 * t_window:.2f} "
            f"ms, plain numpy {1e3 * t_plain:.2f} ms ({len(hit)} polygons)")
        if not (np.array_equal(window, plain) and np.array_equal(
                window, _window(chip.cpu().numpy(), row0, col0, TILE_N))):
            raise AssertionError("the streamed window differs from "
                                 "_rasterize_numpy or from the chip's slice")
        log("  window equals _rasterize_numpy and the chip's slice, bit for bit")
    _phase_end(torch, ik, 36, t0, launches, False)


def phase_layout_cli(torch, lt, ik, launches: dict) -> None:
    """Phase 37: simulate --mask-file chip.gds, fem --stream, lele --gds."""
    import tempfile

    from lithographysimulator_tpu_torch import cli
    from lithographysimulator_tpu_torch.io.contours import rasterize_loops
    from lithographysimulator_tpu_torch.io.gdsii import read_gds, write_gds
    from lithographysimulator_tpu_torch.ops.tiled import tile_layout

    t0 = _phase_start(torch, ik)
    n = SERVE_N
    cfg, mask, _ = _headline_setup(lt, n)
    step = tile_layout(SERVE_BIG_N, TILE_N, lt.default_halo(
        lt.OpticsConfig(pixel_number=TILE_N)))[1]
    with tempfile.TemporaryDirectory() as tmp:
        # phase 4's lines as GDSII on layer 1; the decoy on layer 2
        write_gds(f"{tmp}/head.gds", {"TOP": _chip_polygons(lt, n, n, 2 * n)})
        np.save(f"{tmp}/head.npy", mask.geometry.cpu().numpy())
        base = ["simulate", "--device", DEVICE, "--pixel-number", str(n),
                "--solver", "socs", "--socs-rank", str(SOCS_RANK)]
        images = {}
        for tag, extra in (("gds", ["--mask-file", f"{tmp}/head.gds",
                                    "--gds-layer", "1"]),
                           ("npy", ["--mask-file", f"{tmp}/head.npy"])):
            report, t = _timed(torch, lambda: _cli_report(
                cli, base + extra + ["--out", f"{tmp}/{tag}_image.npy"]))
            images[tag] = np.load(f"{tmp}/{tag}_image.npy")
            log(f"[phase 37] simulate --mask-file head.{tag} ({t:.3f} s, "
                f"rank {report['socs_rank']}, wall {report['wall_clock_s']:.3f} s)")
        check("simulate: .gds mask file vs .npy (nrms)",
              nrms(images["gds"], images["npy"]), TOL_LAYOUT)
        write_gds(f"{tmp}/chip.gds", {"CHIP": _chip_polygons(
            lt, SERVE_BIG_N, TILE_N, step)})
        fem = ["fem", "--device", DEVICE, "--pixel-number", str(TILE_N),
               "--big-n", str(SERVE_BIG_N), "--mask-file", f"{tmp}/chip.gds",
               "--gds-layer", "1", "--rank", str(FEM_RANK)]
        stream, t_stream = _timed(torch, lambda: _cli_report(cli, fem + ["--stream"]))
        whole, t_whole = _timed(torch, lambda: _cli_report(cli, fem))
        log(f"  fem --stream at --big-n {SERVE_BIG_N}: {t_stream:.3f} s "
            f"(report {stream['wall_clock_s']} s); the array path "
            f"{t_whole:.3f} s (report {whole['wall_clock_s']} s); CD matrix "
            f"{stream['cd_nm']}")
        for r in (stream, whole):
            r.pop("wall_clock_s")
        whole.pop("epe", None)  # only the array path holds the target
        if stream["cd_nm"] != whole["cd_nm"] or stream != whole:
            raise AssertionError("fem --stream differs from the array path")
        log("  fem --stream report equals the array path's (CD matrix, window)")
        m = CLI_OPT_BIG_N
        report, t = _timed(torch, lambda: _cli_report(cli, [
            "lele", "--device", DEVICE, "--pixel-number", str(m), "--mask",
            "lines", "--source", "classical", "--sigma-out", "0.3",
            "--min-pitch", "200", "--out", f"{tmp}/lele.npz",
            "--gds", f"{tmp}/lele.gds"]))
        masks = np.load(f"{tmp}/lele.npz")
        polys = read_gds(f"{tmp}/lele.gds").flatten("LELE")
        for layer, key in ((1, "mask_a"), (2, "mask_b")):
            loops = [p.xy_nm for p in polys if p.layer == layer]
            back = rasterize_loops(loops, pixel_size=cfg.pixel_size, n=m)
            if not np.array_equal(back > 0.5, masks[key] > 0.5):
                raise AssertionError(f"lele --gds layer {layer} does not "
                                     f"re-rasterize to {key}")
        log(f"  lele --gds at {m}^2 ({t:.3f} s): {len(polys)} loops; layers 1 "
            "and 2 re-rasterize to mask_a and mask_b")
    _phase_end(torch, ik, 37, t0, launches, True)


def _http(url: str, body=None, timeout: float = 600.0):
    """(status, JSON payload) of a GET (``body`` None) or a JSON POST."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None
                                 else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _start_server(srv) -> str:
    import threading

    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _poll(url: str, job_id: str, timeout: float = 600.0, every: float = 0.02):
    """A job's final status and the progress fractions seen on the way."""
    seen = []
    deadline = time.time() + timeout
    while time.time() < deadline:
        status, payload = _http(f"{url}/jobs/{job_id}")
        if status != 200:
            raise AssertionError(f"job {job_id}: {status} {payload}")
        seen.append(payload["progress"])
        if payload["status"] in ("done", "error", "cancelled"):
            return payload, seen
        time.sleep(every)
    raise AssertionError(f"job {job_id} did not finish in {timeout} s")


def _wire_s(serve, body: dict, image: np.ndarray | None = None) -> float:
    """Host seconds to move one request over the wire format: its body
    encoded to JSON and parsed back with its mask decoded, and, for a
    /simulate response, its ``image`` encoded and decoded the same way (a
    job's large result streams raw instead); median of 3."""
    def once():
        t1 = time.perf_counter()
        blob = json.dumps(body).encode()
        serve._decode_array(json.loads(blob)["mask"])
        if image is not None:
            out = json.dumps({"image": serve._encode_array(image)}).encode()
            serve._decode_array(json.loads(out)["image"])
        return time.perf_counter() - t1

    return float(np.median([once() for _ in range(3)]))


def _quasar_spec() -> dict:
    return {"kind": "quasar", "sigma_in": 0.4, "sigma_out": 0.8, "poles": 4,
            "rotation": -np.pi / 8}


def phase_worker(torch, lt, ik, launches: dict, serve) -> tuple:
    """Phase 38: a worker on the card: /health, the exact headline, and
    SOCS requests (cold, then a burst of 8). Returns (server, url)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = _phase_start(torch, ik)
    srv = serve.make_server("127.0.0.1", 0, device=DEVICE)
    url = _start_server(srv)
    _, health = _http(f"{url}/health")
    log(f"[phase 38] worker at {url}: /health {json.dumps(health)}")
    if health["device"] != torch.cuda.get_device_name(0) or health["platform"] != "gpu":
        raise AssertionError(f"/health does not name the card: {health}")
    n = SERVE_N
    cfg, mask, src = _headline_setup(lt, n)
    mask_np = mask.geometry.cpu().numpy()
    body = {"pixel_number": n, "mask": serve._encode_array(mask_np),
            "source": _quasar_spec()}
    (status, payload), t_req = _timed(torch, lambda: _http(f"{url}/simulate", body))
    if status != 200:
        raise AssertionError(f"/simulate: {status} {payload}")
    local, t_local = _timed(torch, lambda: lt.simulate(mask, src, device=DEVICE))
    log(f"  exact /simulate at {n}^2 ({payload['report']['source_points']} "
        f"points): request {t_req:.3f} s (server wall "
        f"{payload['report']['wall_clock_s']} s), local simulate {t_local:.3f} s")
    check("exact /simulate vs local simulate (nrms)",
          nrms(serve._decode_array(payload["image"]), check_image(local.image, n)),
          TOL_LAYOUT)
    socs = dict(body, solver="socs", socs_rank=SOCS_RANK)
    psim = importlib.import_module("lithographysimulator_tpu_torch.simulate")
    with psim._SOCS_BUILD_CACHE_LOCK:  # phase 37 cached this setup's kernels
        psim._SOCS_BUILD_CACHE.clear()
    (status, payload), t_cold = _timed(torch, lambda: _http(f"{url}/simulate", socs))
    if status != 200:
        raise AssertionError(f"/simulate socs: {status} {payload}")
    log(f"  SOCS /simulate, rank {SOCS_RANK}, cold (build + apply): {t_cold:.3f} s")
    masks = [np.roll(mask_np, 16 * i, axis=1) for i in range(8)]
    for i, m in enumerate(masks):
        m[64 * i:64 * i + 40, 100:140] = 1.0  # a distinct contact each
    _, before = _http(f"{url}/health")

    def one(m):
        t1 = time.perf_counter()
        out = _http(f"{url}/simulate", dict(socs, mask=serve._encode_array(m)))
        return out, time.perf_counter() - t1

    t1 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(one, masks))
    t_burst = time.perf_counter() - t1
    _, after = _http(f"{url}/health")
    batches = after["batches_run"] - before["batches_run"]
    lat = np.array([t for _, t in results])
    log(f"  burst of 8 same-signature SOCS requests: {t_burst:.3f} s, "
        f"{8 / t_burst:.2f} requests/s; latency median {np.median(lat):.3f} s, "
        f"max {lat.max():.3f} s; {batches} batch(es), "
        f"{after['batched_requests'] - before['batched_requests']} batched requests")
    ref, t_ref = _timed(torch, lambda: lt.simulate_batch(
        np.stack(masks), cfg, src, device=DEVICE, solver="socs",
        socs_rank=SOCS_RANK).cpu().numpy())
    t_wire = _wire_s(serve, dict(socs, mask=serve._encode_array(masks[0])),
                     ref[0])
    log(f"  the burst's 8 images by a local simulate_batch on the cached "
        f"kernels, read back: {t_ref:.3f} s; one request's wire work on the "
        f"host (the body's JSON and base64 both ways, the image's too): "
        f"{1e3 * t_wire:.1f} ms")
    worst = 0.0
    for ((status, payload), _), r in zip(results, ref):
        if status != 200:
            raise AssertionError(f"burst request: {status} {payload}")
        worst = max(worst, nrms(serve._decode_array(payload["image"]), r))
    check("burst responses vs local simulate_batch on the cached kernels "
          "(worst nrms)", worst, TOL_LAYOUT)
    if not batches < 8:
        raise AssertionError(f"the burst ran {batches} batches: none coalesced")
    log(f"  /health after: socs_cache_entries {after['socs_cache_entries']}, "
        f"socs_cache_bytes {after['socs_cache_bytes']}")
    _phase_end(torch, ik, 38, t0, launches, True)
    return srv, url


def phase_jobs(torch, lt, ik, launches: dict, serve, url: str) -> tuple:
    """Phase 39: tiled, fem (and a cancel), opc, stochastic, lele and film
    jobs. Returns the tiled job's body and artifact for phase 40."""
    from lithographysimulator_tpu_torch.models.resist import ResistModel
    from lithographysimulator_tpu_torch.ops.tiled import tile_layout
    from lithographysimulator_tpu_torch.simulate import _socs_kernels_cached

    t0 = _phase_start(torch, ik)
    cfg, _, src = _headline_setup(lt, TILE_N)
    tiles, step = tile_layout(SERVE_BIG_N, TILE_N, lt.default_halo(cfg))
    chip = _chip_layout(lt, torch, SERVE_BIG_N, TILE_N, step)
    chip_b64 = serve._encode_array(chip.cpu().numpy())
    tiled = {"kind": "tiled", "mask": chip_b64, "pixel_number": TILE_N,
             "rank": JOB_RANK, "source": _quasar_spec(),
             "tiles_per_dispatch": 4}
    t1 = time.perf_counter()
    _, sub = _http(f"{url}/jobs", tiled)
    final, seen = _poll(url, sub["job_id"])
    t_job = time.perf_counter() - t1
    if final["status"] != "done":
        raise AssertionError(f"tiled job: {final}")
    t1 = time.perf_counter()
    artifact = serve.fetch_artifact(url, final["image"]["stream_path"])
    t_fetch = time.perf_counter() - t1
    socs = _socs_kernels_cached(cfg, src, np.zeros(1, np.float32), JOB_RANK,
                                device=DEVICE)[0]
    local, t_local = _timed(torch, lambda: lt.tiled_socs_image(
        chip, socs, cfg, tiles_per_dispatch=4))
    rising = all(b >= a for a, b in zip(seen, seen[1:])) and seen[-1] == 1.0
    t_wire = _wire_s(serve, tiled)
    log(f"[phase 39] tiled job, {SERVE_BIG_N}^2 through {tiles * tiles} tiles "
        f"of {TILE_N}^2, rank {JOB_RANK}: submit to done {t_job:.3f} s, "
        f"artifact ({final['image']['nbytes']} bytes) fetched in {t_fetch:.3f} s; "
        f"local tiled_socs_image {t_local:.3f} s; the body's JSON and "
        f"base64 both ways on the host {t_wire:.3f} s; progress seen "
        f"{sorted(set(seen))}")
    if not (np.array_equal(artifact, local.cpu().numpy()) and rising
            and len(set(seen)) > 1):
        raise AssertionError("tiled job: artifact differs from the local "
                             "image, or progress did not rise")
    log("  streamed artifact equals local tiled_socs_image bit for bit; "
        "progress rose to 1")
    fem = {"kind": "fem", "mask": chip_b64, "pixel_number": TILE_N,
           "rank": JOB_RANK, "source": _quasar_spec(),
           "defocus_nm": [-60.0, 0.0, 60.0], "doses": [0.9, 1.0, 1.1],
           "threshold": 0.3}
    (final, _), t_job = _timed(torch, lambda: _poll(
        url, _http(f"{url}/jobs", fem)[1]["job_id"]))
    ref, t_local = _timed(torch, lambda: lt.tiled_fem(
        chip, cfg, src, defocus_nm=fem["defocus_nm"], doses=fem["doses"],
        resist=ResistModel(threshold=0.3), rank=JOB_RANK, device=DEVICE))
    log(f"  fem job: {t_job:.3f} s (local tiled_fem {t_local:.3f} s); CD "
        f"matrix {final.get('cd_nm')}")
    if final["status"] != "done" or not np.array_equal(
            np.asarray(final["cd_nm"], float), np.asarray(ref["cd_nm"], float),
            equal_nan=True):
        raise AssertionError(f"fem job differs from the local tiled_fem: {final}")
    long_fem = dict(fem, defocus_nm=np.linspace(-100, 100, 9).tolist())
    _, sub = _http(f"{url}/jobs", long_fem)
    while _http(f"{url}/jobs/{sub['job_id']}")[1]["status"] == "queued":
        time.sleep(0.01)
    status, cancel = _http(f"{url}/jobs/{sub['job_id']}/cancel", {})
    final, _ = _poll(url, sub["job_id"])
    log(f"  cancel a running fem job: {status} {cancel['status']} -> "
        f"{final['status']} at progress {final['progress']}")
    if final["status"] != "cancelled":
        raise AssertionError(f"the cancelled fem job ended {final['status']}")
    small = lt.lines_and_spaces(lt.OpticsConfig(pixel_number=JOB_BIG_N),
                                line_width_px=JOB_TILE_N // 16,
                                pitch_px=JOB_TILE_N // 8, device="cpu")
    common = {"mask": serve._encode_array(small.geometry.numpy()),
              "pixel_number": JOB_TILE_N, "rank": JOB_RANK,
              "source": _quasar_spec()}
    for kind, extra in (("opc", {"steps": 3}),
                        ("stochastic", {"trials": 8}),
                        ("lele", {"min_pitch_nm": 200.0}),
                        ("film", {"nz": 4})):
        (final, _), t = _timed(torch, lambda: _poll(
            url, _http(f"{url}/jobs", dict(common, kind=kind, **extra))[1]["job_id"]))
        log(f"  {kind} job, {JOB_BIG_N}^2 through {JOB_TILE_N}^2 tiles: "
            f"{final['status']} in {t:.3f} s")
        if final["status"] != "done":
            raise AssertionError(f"{kind} job: {final}")
    _phase_end(torch, ik, 39, t0, launches, True)
    return tiled, artifact


def phase_router(torch, lt, ik, launches: dict, serve, srv, url: str,
                 tiled: dict, artifact: np.ndarray) -> None:
    """Phase 40: a router over two in-process workers on the card."""
    t0 = _phase_start(torch, ik)
    srv2 = serve.make_server("127.0.0.1", 0, device=DEVICE)
    url2 = _start_server(srv2)
    router = serve.make_router([url, url2], "127.0.0.1", 0)
    rurl = _start_server(router)
    dead = serve.make_router(["http://127.0.0.1:9", url], "127.0.0.1", 0)
    durl = _start_server(dead)
    try:
        n = SERVE_N
        _, mask, _ = _headline_setup(lt, n)
        body = {"pixel_number": n, "source": _quasar_spec(), "solver": "socs",
                "socs_rank": SOCS_RANK,
                "mask": serve._encode_array(mask.geometry.cpu().numpy())}
        before = [s.service.requests_served for s in (srv, srv2)]
        for _ in range(3):
            status, _ = _http(f"{rurl}/simulate", body)
            if status != 200:
                raise AssertionError(f"router /simulate: {status}")
        served = [s.service.requests_served - b
                  for s, b in zip((srv, srv2), before)]
        log(f"[phase 40] router over 2 workers: 3 same-signature requests "
            f"served {served} (affinity)")
        if sorted(served) != [0, 3]:
            raise AssertionError(f"affinity broken: {served}")
        for _ in range(2):
            status, _ = _http(f"{durl}/simulate", body)
            if status != 200:
                raise AssertionError(f"failover past a dead URL: {status}")
        log("  failover past a dead backend URL: 2 requests, 200 each")
        _, sub = _http(f"{rurl}/jobs", tiled)
        final, _ = _poll(rurl, sub["job_id"])
        if final["status"] != "done":
            raise AssertionError(f"job through the router: {final}")
        t1 = time.perf_counter()
        relayed = serve.fetch_artifact(rurl, final["image"]["stream_path"])
        t_fetch = time.perf_counter() - t1
        log(f"  tiled job through the router, polls pinned to its worker: "
            f"done; artifact relayed chunk by chunk in {t_fetch:.3f} s")
        if not np.array_equal(relayed, artifact):
            raise AssertionError("the relayed artifact differs from phase 39's")
        log("  relayed artifact equals phase 39's bit for bit")
    finally:
        for s in (dead, router, srv2):
            s.shutdown()
            s.server_close()
    _phase_end(torch, ik, 40, t0, launches, True)


# ---------------------------------------------------------------------------
# Phases 42-46: multi-device (parallel/*) on a mesh of cuda:0 entries
# ---------------------------------------------------------------------------

def _card_meshes(torch) -> list:
    """(tag, device list) of the meshes phases 42 and 44 run on: 4 entries
    of cuda:0 (one card), and every visible card when there are two or
    more (F9's witness: the kernels launch on a second card's context)."""
    meshes = [(f"{MESH_ENTRY} x {PARALLEL_ENTRIES}",
               [MESH_ENTRY] * PARALLEL_ENTRIES)]
    count = torch.cuda.device_count()
    if count >= 2:
        meshes.append((f"{count} cards", [f"cuda:{i}" for i in range(count)]))
    return meshes


def _per_call(ik, base: dict) -> dict:
    return {k: v - base[k] for k, v in ik.LAUNCHES.items()}


def _same_launches(tag: str, got: dict, expect: int) -> None:
    log(f"  {tag}: launches {got} (expected {expect} of each)")
    if any(v != expect for v in got.values()):
        raise AssertionError(f"{tag}: each kernel should launch {expect} "
                             f"times: {got}")


def phase_sharded_exact(torch, lt, ik, launches: dict):
    """Phase 42: the 1024^2 exact headline through abbe_image_sharded.
    Returns (cfg, single-device image) for phase 45."""
    from lithographysimulator_tpu_torch import parallel

    from lithographysimulator_tpu_torch.ops.abbe import abbe_image_points

    t0 = _phase_start(torch, ik)
    cfg, mask, src = _headline_setup(lt, 1024)
    res, t_sim = _timed(torch, lambda: lt.simulate(mask, src, device=DEVICE))
    single = check_image(res.image, cfg.n)
    points = res.report["source_points"]
    # the single device on the same padded list as the 4-entry mesh, warm
    shifts, weights, _ = parallel.padded_source_arrays(src, PARALLEL_ENTRIES * 4)
    _, t_single = _timed(torch, lambda: abbe_image_points(
        res.spectrum, res.pupil, shifts, weights, cfg, device=DEVICE))
    log(f"[phase 42] {cfg.n}^2 exact headline, {points} points; simulate() "
        f"{t_sim:.3f} s; abbe_image_points on one device, warm: "
        f"{t_single:.3f} s, {points / t_single:.1f} points/s")
    for tag, devices in _card_meshes(torch):
        mesh = parallel.source_mesh(devices=devices)
        shifts, weights, _ = parallel.padded_source_arrays(
            src, len(devices) * 4)
        base = dict(ik.LAUNCHES)
        img, t = _timed(torch, lambda: parallel.abbe_image_sharded(
            res.spectrum, res.pupil, shifts, weights, cfg, mesh))
        log(f"  abbe_image_sharded on {tag} ({len(shifts)} padded points, "
            f"{len(shifts) // 4 // len(devices)} chunks a shard): {t:.3f} s, "
            f"{points / t:.1f} points/s ({t_single / t:.3f}x the single "
            f"device's rate)")
        _same_launches(f"abbe_image_sharded on {tag}", _per_call(ik, base),
                       len(shifts) // 4)
        check(f"sharded exact on {tag} vs simulate (nrms)",
              nrms(check_image(img, cfg.n), single), TOL_MATMUL)
        del img
    mesh2 = parallel.focus_source_mesh(2, 2, devices=[MESH_ENTRY] * 4)
    shifts, weights, _ = parallel.padded_source_arrays(src, 2 * 4)
    stack_ab = lt.focus_stack_aberrations(np.zeros(5, np.float32),
                                          np.array(FOCUS_PLANES[1:], np.float32))
    stack, t = _timed(torch, lambda: parallel.through_focus_sharded(
        res.spectrum, stack_ab, shifts, weights, cfg, mesh2))
    log(f"  through_focus_sharded, planes {FOCUS_PLANES[1:]} nm on the (2, 2) "
        f"mesh: {t:.3f} s")
    check("through_focus_sharded in-focus plane vs simulate (nrms)",
          nrms(check_image(stack[0], cfg.n), single), TOL_MATMUL)
    planes = stack.cpu().numpy()
    if not (np.isfinite(planes).all() and planes[1].max() < planes[0].max()):
        raise AssertionError("the defocused plane should lose peak intensity")
    del stack
    _phase_end(torch, ik, 42, t0, launches, True)
    return cfg, res.image


def phase_sharded_socs(torch, lt, ik, launches: dict) -> None:
    """Phase 43: the rank-256 build sharded against the local build, and
    the rank-sharded int8 apply."""
    from lithographysimulator_tpu_torch import parallel

    t0 = _phase_start(torch, ik)
    cfg, mask, src = _headline_setup(lt, 1024)
    spectrum = lt.mask_spectrum(mask.geometry, cfg)
    pupil = lt.pupil_function(np.zeros(1, np.float32), cfg, device=DEVICE)
    mesh = parallel.source_mesh(devices=[MESH_ENTRY] * PARALLEL_ENTRIES)
    kw = dict(rank=SOCS_RANK, power_iters=1, method="nystrom", seed=0)
    lt.randomized_socs(pupil, src, cfg, **kw)  # warm libraries
    local, t_l, peak_l = _build_peak(torch, lambda: lt.randomized_socs(
        pupil, src, cfg, **kw))
    sharded, t_s, peak_s = _build_peak(torch, lambda: parallel.randomized_socs_sharded(
        pupil, src, cfg, mesh, **kw))
    log(f"[phase 43] {cfg.n}^2 rank-{SOCS_RANK} build (Nystrom, power_iters=1, "
        f"bench.py's): local {t_l:.4f} s, peak {peak_l:.3f} GB; sharded over "
        f"{MESH_ENTRY} x {PARALLEL_ENTRIES} {t_s:.4f} s, peak {peak_s:.3f} GB")
    vals_l = local.eigenvalues.double().cpu().numpy()
    vals_s = sharded.eigenvalues.double().cpu().numpy()
    worst = float(np.max(np.abs(vals_s - vals_l)
                         / (1e-4 * np.abs(vals_l) + 1e-6 * vals_l[0])))
    check("sharded eigenvalues vs local, |d| / (1e-4 |l| + 1e-6 l0)", worst, 1.0)
    img_l = check_image(lt.socs_image(spectrum, local, cfg), cfg.n)
    check("sharded build's image vs the local build's (nrms)",
          nrms(check_image(lt.socs_image(spectrum, sharded, cfg), cfg.n), img_l),
          TOL_SOCS_PAIR)
    del sharded
    parallel.socs_image_sharded(spectrum, local, cfg, mesh)  # warm-up
    base = dict(ik.LAUNCHES)
    img, t = _timed(torch, lambda: parallel.socs_image_sharded(
        spectrum, local, cfg, mesh))
    log(f"  socs_image_sharded over {MESH_ENTRY} x {PARALLEL_ENTRIES}: {t:.4f} s")
    _same_launches("socs_image_sharded", _per_call(ik, base), SOCS_RANK // 4)
    check("rank-sharded int8 apply vs the local int8 apply (nrms)",
          nrms(check_image(img, cfg.n), img_l), TOL_MATMUL)
    del local, img
    _phase_end(torch, ik, 43, t0, launches, True)


def phase_sharded_tiled(torch, lt, ik, launches: dict) -> None:
    """Phase 44: phase 27's 8192^2 chip through tiled_socs_image_sharded."""
    from lithographysimulator_tpu_torch import parallel
    from lithographysimulator_tpu_torch.ops.tiled import tile_layout

    t0 = _phase_start(torch, ik)
    n = TILE_N
    cfg, _, src = _headline_setup(lt, n)
    halo = lt.default_halo(cfg)
    tiles, step = tile_layout(TILED_BIG_N, n, halo)
    chip = _chip_layout(lt, torch, TILED_BIG_N, n, step)
    pupil = lt.pupil_function(np.zeros(1, np.float32), cfg, device=DEVICE)
    socs = lt.randomized_socs(pupil, src, cfg, rank=SOCS_RANK)
    ref, t_ref = _timed(torch, lambda: lt.tiled_socs_image(chip, socs, cfg))
    log(f"[phase 44] {TILED_BIG_N}^2 chip, {tiles * tiles} tiles of {n}^2, "
        f"rank {SOCS_RANK}: tiled_socs_image {t_ref:.3f} s")
    for tag, devices in _card_meshes(torch):
        mesh = parallel.source_mesh(devices=devices)
        base = dict(ik.LAUNCHES)
        img, t = _timed(torch, lambda: parallel.tiled_socs_image_sharded(
            chip, socs, cfg, mesh))
        padded = -(-tiles * tiles // len(devices)) * len(devices)
        log(f"  tiled_socs_image_sharded on {tag}: {t:.3f} s, "
            f"{tiles * tiles / t:.2f} tiles/s ({padded - tiles * tiles} dummy "
            f"tiles)")
        _same_launches(f"tiled_socs_image_sharded on {tag}", _per_call(ik, base),
                       padded * SOCS_RANK // 4)
        same = bool(torch.equal(img, ref))
        log(f"  stitched image equal to tiled_socs_image bit for bit: {same}")
        if devices[0] == devices[-1] and not same:
            raise AssertionError("on a repeated-cuda:0 mesh the sharded chip "
                                 "must equal tiled_socs_image bit for bit")
        check(f"sharded chip on {tag} vs tiled_socs_image (max abs, rel)",
              float((img - ref).abs().max() / ref.abs().max()), TOL_STREAM)
        del img
    del ref, socs, chip
    _phase_end(torch, ik, 44, t0, launches, True)


def phase_sharded_resist(torch, lt, ik, launches: dict, cfg, image) -> None:
    """Phase 45: the stochastic bands bit for bit, the film stack and the
    FEM on the mesh against their single-device twins."""
    from lithographysimulator_tpu_torch import parallel
    from lithographysimulator_tpu_torch.ops.abbe import source_points

    t0 = _phase_start(torch, ik)
    mesh = parallel.source_mesh(devices=[MESH_ENTRY] * PARALLEL_ENTRIES)
    model = lt.StochasticResist(dose_photons_per_nm2=20.0, diffusion_nm=8.0,
                                threshold=0.3, pag_per_nm2=5.0)
    trials = PARALLEL_ENTRIES * 4
    band, t = _timed(torch, lambda: parallel.print_probability_sharded(
        image, cfg, model, mesh, trials_per_device=4, seed=0))
    host = lt.exposure_trials(image, cfg, model, trials=trials, seed=0,
                              trial_chunk=8).sum(0).cpu().numpy()
    band = band.cpu().numpy()
    same = np.array_equal(band, host / np.float32(trials))
    log(f"[phase 45] print_probability_sharded, {trials} trials over "
        f"{MESH_ENTRY} x {PARALLEL_ENTRIES}: {t:.3f} s; equal to the single-device "
        f"band bit for bit: {same}; mean {band.mean():.6f}")
    if not same:
        raise AssertionError("the sharded band differs from the single-device band")

    _, mask, src = _headline_setup(lt, cfg.n)
    sub = _subset(src, source_points(src), SUBSET_K)
    wafer = lt.WaferStack(n_resist=1.71 + 0.01j, thickness_nm=120.0,
                          under_layers=((37.0, 1.82 + 0.39j),))
    depths = [20.0, 60.0, 100.0]
    lt.film_stack_images(mask, sub, device=DEVICE, config=cfg,
                         wafer_stack=wafer, depths_nm=depths)  # warm-up
    film_local, t_l = _timed(torch, lambda: lt.film_stack_images(
        mask, sub, device=DEVICE, config=cfg, wafer_stack=wafer,
        depths_nm=depths))
    film, t_s = _timed(torch, lambda: parallel.film_stack_sharded(
        mask, sub, config=cfg, wafer_stack=wafer, mesh=mesh, depths_nm=depths))
    log(f"  film stack, 3 slabs, every {SUBSET_K}th point: "
        f"film_stack_images {t_l:.3f} s, film_stack_sharded {t_s:.3f} s")
    check("film_stack_sharded vs film_stack_images (nrms)",
          nrms(film.cpu().numpy(), film_local.cpu().numpy()), TOL_SOCS_PAIR)
    vol, t = _timed(torch, lambda: parallel.print_probability_volume_sharded(
        film_local, cfg, model, mesh, dz_nm=40.0, trials_per_device=2, seed=0))
    ens = lt.stochastic_volume_ensemble(film_local, cfg, model, dz_nm=40.0,
                                        trials=2 * PARALLEL_ENTRIES, seed=0)
    same = np.array_equal(vol.cpu().numpy(), ens["print_probability"])
    log(f"  print_probability_volume_sharded, {2 * PARALLEL_ENTRIES} trials: "
        f"{t:.3f} s; equal to stochastic_volume_ensemble's band bit for bit: "
        f"{same}")
    if not same:
        raise AssertionError("the sharded volume band differs from the ensemble's")

    mesh2 = parallel.focus_source_mesh(2, 2, devices=[MESH_ENTRY] * 4)
    shifts, weights, _ = parallel.padded_source_arrays(sub, 2 * 4)
    spectrum = lt.mask_spectrum(mask.geometry, cfg)
    defocus = np.array([0.0, 60.0], np.float32)
    doses = np.array([0.9, 1.0, 1.1], np.float32)
    resist = lt.ResistModel(threshold=0.3, diffusion_nm=10.0)
    cds, t = _timed(torch, lambda: parallel.fem_cd_matrix_sharded(
        spectrum, np.zeros(5, np.float32), defocus, doses, shifts, weights, cfg,
        mesh2, resist=resist))
    stack = lt.through_focus_images(
        spectrum, lt.focus_stack_aberrations(np.zeros(5, np.float32), defocus),
        shifts, weights, cfg, device=DEVICE)
    cut = resist.blur(stack / stack.max(), cfg)[:, cfg.n // 2].double()
    twin = torch.stack([torch.sigmoid(resist.steepness * (cut * float(d)
                                                          - resist.threshold))
                        .sum(-1) * cfg.pixel_size for d in doses], dim=1)
    cds = cds.double().cpu().numpy()
    twin = twin.cpu().numpy()
    log(f"  fem_cd_matrix_sharded on the (2, 2) mesh: {t:.3f} s; CDs (nm) "
        f"{np.round(cds, 4).tolist()}")
    check("FEM CDs vs the single-device focal stack's, max relative",
          float(np.max(np.abs(cds - twin) / np.abs(twin))), 1e-4)
    if not (np.diff(cds, axis=1) > 0).all():
        raise AssertionError("the FEM CD should grow with dose")
    _phase_end(torch, ik, 45, t0, launches, True)


def phase_sharded_smo_dryrun(torch, lt, ik, launches: dict) -> None:
    """Phase 46: an optimize(mesh=) step against the mesh=None step, and
    the seven-pattern dry run on the card."""
    from lithographysimulator_tpu_torch import optimize as opt
    from lithographysimulator_tpu_torch import parallel
    from lithographysimulator_tpu_torch.ops.abbe import source_points

    t0 = _phase_start(torch, ik)
    cfg, mask, src = _opt_setup(lt, OPT_N)
    sub = _subset(src, source_points(src), SUBSET_K)
    mesh = parallel.source_mesh(devices=[MESH_ENTRY] * PARALLEL_ENTRIES)
    shifts, weights, live = parallel.padded_source_arrays(sub, PARALLEL_ENTRIES * 4)
    problem = opt.SMOProblem(config=cfg)
    ab = np.zeros(1, np.float32)
    with torch.no_grad():
        target = opt.forward(opt.init_params(problem, mask.geometry), ab, shifts,
                             weights, problem)
    start = np.full((cfg.n, cfg.n), 0.4, np.float32)
    log(f"[phase 46] {OPT_N}^2 SMO on every {SUBSET_K}th point ({live} points)")
    hist = {}
    for tag, m in (("mesh=None", None), ("mesh", mesh)):
        (_, hist[tag]), t = _timed(torch, lambda: opt.optimize(
            problem, target, start, ab, shifts, weights, steps=1,
            learning_rate=0.2, mesh=m))
        log(f"  optimize, one step, {tag}: {t:.3f} s, loss {hist[tag][0]:.9e}")
    check("optimize(mesh=) loss vs mesh=None, relative",
          abs(hist["mesh"][0] - hist["mesh=None"][0]) / abs(hist["mesh=None"][0]),
          1e-6)
    grads = {}
    for tag, m in (("mesh=None", None), ("mesh", mesh)):
        params = {k: v.requires_grad_() for k, v in opt.init_params(
            problem, start, device=DEVICE).items()}
        opt.loss_fn(params, target, ab, shifts, weights, problem, m).backward()
        grads[tag] = params["mask_latent"].grad
    scale = float(grads["mesh=None"].abs().max())
    check("optimize(mesh=) mask gradient vs mesh=None, max|dg|/max|g|",
          float((grads["mesh"] - grads["mesh=None"]).abs().max()) / scale, 1e-6)
    del grads, target
    _, t = _timed(torch, lambda: parallel.dryrun_multichip(PARALLEL_ENTRIES, device=DEVICE))
    log(f"  dryrun_multichip({PARALLEL_ENTRIES}) on the card: {t:.3f} s; "
        f"torch.cuda.device_count() = {torch.cuda.device_count()}")
    _phase_end(torch, ik, 46, t0, launches, True)


def _flow_module():
    """examples/production_flow_torch.py, loaded from its file."""
    path = REPO / "examples" / "production_flow_torch.py"
    spec = importlib.util.spec_from_file_location("production_flow_torch", path)
    flow = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(flow)
    return flow


def _flow_lines(text: str) -> dict:
    """Each marker's line of the flow's output, with its numbers: every
    marker present once, every number finite."""
    found = {}
    for marker in FLOW_MARKERS:
        lines = [ln for ln in text.splitlines() if ln.startswith(marker)]
        if len(lines) != 1:
            raise AssertionError(f"flow output has {len(lines)} '{marker}' "
                                 f"lines:\n{text}")
        found[marker] = lines[0]
    numbers = [float(v) for marker in ("MRC:", "ORC:", "FEM:", "stochastic:")
               for v in json.loads(found[marker].split(":", 1)[1]).values()
               if isinstance(v, (int, float))]
    numbers += [float(v) for v in re.findall(r"-?\d+\.\d+", found["dose map"])]
    if not numbers or not np.isfinite(numbers).all():
        raise AssertionError(f"flow numbers not finite: {numbers}")
    log(f"  markers {', '.join(FLOW_MARKERS)} present; {len(numbers)} numbers, "
        "all finite")
    return found


def phase_flow(torch, lt, ik, launches: dict) -> None:
    """Phase 47: examples/production_flow_torch.run_flow at full width."""
    import contextlib
    import io
    import tempfile

    from lithographysimulator_tpu_torch.io.contours import rasterize_loops
    from lithographysimulator_tpu_torch.io.gdsii import read_gds
    from lithographysimulator_tpu_torch.ops.tiled import tile_layout

    flow = _flow_module()
    tiles, step = tile_layout(FLOW_BIG_N, TILE_N, FLOW_HALO)
    contacts = len(range(16, FLOW_BIG_N - 16, 40)) ** 2
    log(f"[phase 47] the production flow at {FLOW_BIG_N}^2: {tiles} x {tiles} "
        f"tiles of {TILE_N}^2 (halo {FLOW_HALO}, step {step}), {contacts:,} "
        "contacts")
    t0 = _phase_start(torch, ik)
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = flow.run_flow(FLOW_BIG_N, TILE_N, tmp, DEVICE)
        for line in out.getvalue().splitlines():
            log(f"  | {line}")
        log(f"  run_flow's int8 launches: {dict(ik.LAUNCHES)}")
        for stage, seconds in res["stage_s"].items():
            log(f"  stage {stage}: {seconds:.3f} s")
        log(f"  run_flow: {sum(res['stage_s'].values()):.3f} s")
        _flow_lines(out.getvalue())
        cfg, layout, source, resist, rules = flow.design(FLOW_BIG_N, TILE_N,
                                                         DEVICE)
        t1 = time.perf_counter()
        loops = [p.xy_nm for p in read_gds(res["gds"]).flatten("CONTOUR")
                 if p.layer == 1]
        raster = rasterize_loops(loops, pixel_size=cfg.pixel_size,
                                 n=FLOW_BIG_N)
        profile = res["profile"].cpu().numpy()
        differ = int((raster != profile).sum())
        log(f"  GDS round trip: {len(loops):,} loops read back and rasterized "
            f"in {time.perf_counter() - t1:.3f} s; {int(profile.sum()):,} "
            f"printed pixels; {differ} pixels differ from the developed profile")
        if differ or not profile.any():
            raise AssertionError("the printed contours' GDS does not "
                                 "re-rasterize to the developed profile")
    before, t = _timed(torch, lambda: lt.orc_check(
        layout, layout, cfg, source, resist=resist, rank=FLOW_RANK,
        halo=FLOW_HALO, mrc_rules=rules, epe_spec_nm=90.0, device=DEVICE))
    iou_before = before["fidelity"]["iou"]
    iou_after = res["orc"]["fidelity"]["iou"]
    log(f"  ORC IoU: uncorrected layout {iou_before:.6f} ({t:.3f} s), after "
        f"OPC and MRC {iou_after:.6f}")
    if not iou_after >= iou_before:
        raise AssertionError("OPC lowered the ORC IoU")
    _phase_end(torch, ik, 47, t0, launches, True)


def _flow_stages(torch, lt, flow, device) -> dict:
    """examples/production_flow_torch.run_flow's calls with its parameters,
    one by one at the JAX example's size, the continuous OPC mask kept."""
    from lithographysimulator_tpu_torch.optimize import opc_correct_tiled

    cfg, layout, source, resist, rules = flow.design(*FLOW_SMALL, device)
    kw = dict(rank=FLOW_RANK, halo=FLOW_HALO, device=device)
    continuous = opc_correct_tiled(layout, cfg, source, resist=resist,
                                   steps=12, learning_rate=0.2, **kw)
    corrected = lt.mrc_clean(continuous, cfg, rules)
    mask = torch.as_tensor(corrected, device=device)
    deck = lt.orc_check(mask, layout, cfg, source, resist=resist,
                        mrc_rules=rules, epe_spec_nm=90.0, **kw)
    fem = lt.tiled_fem(mask, cfg, source, defocus_nm=[-80.0, 0.0, 80.0],
                       doses=[0.85, 1.0, 1.15], resist=resist, cd_stat="mean",
                       **kw)
    sto = lt.tiled_stochastic(
        mask, cfg, source, model=lt.StochasticResist(
            dose_photons_per_nm2=20.0, diffusion_nm=8.0, threshold=0.3),
        trials=FLOW_TRIALS, **kw)
    return {"cfg": cfg, "continuous": continuous, "corrected": corrected,
            "orc": deck, "fem": fem, "dose_map": lt.dose_correction_map(fem),
            "stochastic": sto}


def _near(tag: str, ours: float, ref: float, tol: float) -> None:
    ours, ref = float(ours), float(ref)
    ok = np.isfinite(ours) and abs(ours - ref) <= tol
    log(f"  {tag}: card {ours:.9g}, CPU {ref:.9g}, |diff| {abs(ours - ref):.3e} "
        f"(tol {tol:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: card {ours} against CPU {ref}")


def phase_flow_cpu(torch, lt, ik, launches: dict) -> None:
    """Phase 48: the flow's stages on the card against the port on the CPU."""
    flow = _flow_module()
    log(f"[phase 48] the flow's stages at {FLOW_SMALL[0]}^2 ({FLOW_SMALL[1]}^2 "
        "tiles) on the card and on the CPU")
    ref, t_cpu = _timed(torch, lambda: _flow_stages(torch, lt, flow, "cpu"))
    t0 = _phase_start(torch, ik)
    ours, t_card = _timed(torch, lambda: _flow_stages(torch, lt, flow, DEVICE))
    log(f"  stages: card {t_card:.3f} s, CPU {t_cpu:.3f} s")
    cont_card, cont_cpu = ours["continuous"], ref["continuous"]
    check("continuous OPC masks, max |card - CPU|",
          float(np.abs(cont_card - cont_cpu).max()), TOL_FLOW_OPC)
    log(f"  OPC moved the CPU's continuous mask by up to "
        f"{float(np.abs(cont_cpu - flow.design(*FLOW_SMALL, 'cpu')[1].numpy()).max()):.4f}; "
        f"its pixel nearest the threshold lies "
        f"{float(np.abs(cont_cpu - 0.5).min()):.4f} from 0.5")
    differ = np.argwhere(ours["corrected"] != ref["corrected"])
    log(f"  corrected masks: {len(differ)} of {cont_cpu.size} pixels differ")
    for i, j in differ:
        log(f"    ({i}, {j}): card {ours['corrected'][i, j]:.0f}, CPU "
            f"{ref['corrected'][i, j]:.0f}, CPU continuous "
            f"{cont_cpu[i, j]:.7f}, card continuous {cont_card[i, j]:.7f}")
    if any(abs(cont_cpu[i, j] - 0.5) > TOL_FLOW_THRESHOLD for i, j in differ):
        raise AssertionError("the card's corrected mask differs from the "
                             "CPU's away from the 0.5 threshold")
    px = ours["cfg"].pixel_size
    a, b = ours["orc"], ref["orc"]
    if a["pass_"] != b["pass_"]:
        raise AssertionError(f"ORC pass: card {a['pass_']}, CPU {b['pass_']}")
    _near("ORC IoU", a["fidelity"]["iou"], b["fidelity"]["iou"], TOL_FLOW_IOU)
    _near("ORC mean NILS (relative)", a["nils"]["mean_nils"]
          / b["nils"]["mean_nils"], 1.0, TOL_FLOW_REL)
    _near("ORC max |EPE| nm", a["epe"]["max_abs_epe_nm"],
          b["epe"]["max_abs_epe_nm"], px)
    a, b = ours["fem"], ref["fem"]
    _near("FEM DOF nm", a["depth_of_focus_nm"], b["depth_of_focus_nm"], 0.0)
    _near("FEM exposure latitude", a["exposure_latitude"],
          b["exposure_latitude"], 1e-12)
    _near("FEM CD matrix, max |diff| nm", float(np.abs(
        a["cd_nm"] - b["cd_nm"]).max()), 0.0, TOL_FLOW_CD_NM)
    _near("FEM CDU 3 sigma nm", a["cdu"]["cdu_3sigma_nm"],
          b["cdu"]["cdu_3sigma_nm"], TOL_FLOW_CD_NM)
    a, b = ours["dose_map"], ref["dose_map"]
    _near("dose map sensitivity (relative)", a["sensitivity_nm_per_dose"]
          / b["sensitivity_nm_per_dose"], 1.0, TOL_FLOW_REL)
    _near("dose map max residual nm", a["predicted_residual_nm"],
          b["predicted_residual_nm"], TOL_FLOW_CD_NM)
    _near("dose map, max |diff|", float(np.abs(
        a["dose_map"] - b["dose_map"]).max()), 0.0, TOL_FLOW_DOSE)
    # the ensembles in distribution (per-trial generators: ROADMAP D2), as
    # tests/test_torch_metrology.py:232-247 holds tiled_stochastic
    a, b = ours["stochastic"], ref["stochastic"]
    sigma = float(np.hypot(a["lcdu_nm"], b["lcdu_nm"])) / 3.0 / np.sqrt(FLOW_TRIALS)
    _near("stochastic mean CD nm (5 sampling errors)", a["mean_cd_nm"],
          b["mean_cd_nm"], 5.0 * sigma + 1e-3)
    for key in ("ler_nm", "lwr_nm"):
        _near(f"stochastic {key} (relative)", a[key] / b[key], 1.0, 0.1)
    for key in ("break_rate", "bridge_rate"):
        p = 0.5 * (a[key] + b[key])
        _near(f"stochastic {key} (5 binomial errors)", a[key], b[key],
              5.0 * float(np.sqrt(2.0 * p * (1.0 - p) / FLOW_TRIALS)))
    _phase_end(torch, ik, 48, t0, launches, True)


def _fits_launched(fit_launches) -> None:
    """Phase 21's check of the fits alone: each int8 fit launched every
    kernel, one window_product_limbs a row_limb_gemm (no matmul fallback)."""
    for tag, launched in zip(("fit_boundary_layer", "fit_edge_kernel"),
                             fit_launches):
        if min(launched.values()) <= 0 or (launched["window_product_limbs"]
                                           != launched["row_limb_gemm"]):
            raise AssertionError(f"{tag} did not run on the int8 kernels: "
                                 f"{launched}")
    log("  both int8 fits launched every kernel (no matmul fallback): ok")


def _launched(ik, phases: str) -> dict:
    """The launch counts since the last reset: every kernel of the path ran,
    and one window_product_limbs launch fed each row_limb_gemm launch."""
    launches = dict(ik.LAUNCHES)
    log(f"  launches in phases {phases}: {launches}")
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in phases {phases}: "
                             f"{missing}")
    if launches["window_product_limbs"] != launches["row_limb_gemm"]:
        raise AssertionError(f"phases {phases}: window_product_limbs launched "
                             f"{launches['window_product_limbs']} times, "
                             f"row_limb_gemm {launches['row_limb_gemm']}")
    return launches


def main() -> int:
    if not (REPO / "lithographysimulator_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py: the lithographysimulator_tpu_torch "
                         "package is not beside this script")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    sys.path.insert(0, str(REPO))
    import lithographysimulator_tpu_torch as lt
    from lithographysimulator_tpu_torch.ops.kernels import build
    from lithographysimulator_tpu_torch.ops.kernels import intensity_int8 as ik

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[phase 0] {name}, capability {torch.cuda.get_device_capability(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[phase 0] nvidia-smi: {smi}")

    phase_build(build)

    stats = phase_kernels(torch, ik, 2, KERNEL_SHAPES)

    ik.reset_launch_counts()  # count only the exact-Abbe path's launches below
    phase_demo(torch, lt)
    phase_headline(torch, lt)
    mask_2048, src_2048, oracle_2048 = phase_oracle(torch, lt)
    log("[phase 6]")
    launches = _launched(ik, "3-5")

    socs_stats = phase_kernels(torch, ik, 7, SOCS_KERNEL_SHAPES)

    ik.reset_launch_counts()  # count only the SOCS path's launches below
    exact_1024 = phase_socs_headline(torch, lt)
    phase_socs_auto(torch, lt, exact_1024)
    phase_socs_2048(torch, lt, mask_2048, src_2048, oracle_2048)
    phase_socs_lean(torch, lt)
    log("[phase 12]")
    socs_launches = _launched(ik, "8-11")

    ik.reset_launch_counts()  # count only the vector/chromatic/focus paths below
    exact_vec = phase_vector_exact(torch, lt)
    phase_vector_socs(torch, lt, exact_vec)
    phase_chromatic(torch, lt)
    phase_focus_perturb(torch, lt)
    log("[phase 17]")
    vector_launches = _launched(ik, "13-16")

    ik.reset_launch_counts()  # count only the thick-mask, gradient, fit and film paths
    phase_m3d(torch, lt)
    phase_grads(torch, lt)
    fit_launches = phase_fits_film(torch, lt)
    log("[phase 21]")
    m3d_launches = _launched(ik, "18-20")
    _fits_launched(fit_launches)

    resist_launches = {}  # phases 22-25, each counted and checked apart
    image, cfg = phase_resist(torch, lt, ik, resist_launches)
    edge_entry = phase_stochastic(torch, lt, ik, resist_launches, image, cfg)
    del image
    phase_resist3d(torch, lt, ik, resist_launches)
    phase_calibrate_cli(torch, lt, ik, resist_launches)
    log("[phase 26]")
    log(f"  launches in phases 22-25: {resist_launches}")
    if resist_launches["window_product_limbs"] != resist_launches["row_limb_gemm"]:
        raise AssertionError("phases 22-25: window_product_limbs and "
                             "row_limb_gemm launched unequally")

    tiled_launches = {}  # phases 27-29, each counted and checked apart
    per_image = phase_tiled(torch, lt, ik, tiled_launches)
    fem = phase_tiled_fem(torch, lt, ik, tiled_launches)
    phase_tiled_rest(torch, lt, ik, tiled_launches, fem)
    log("[phase 30]")
    log(f"  launches in phases 27-29: {tiled_launches}; one {TILED_BIG_N}^2 "
        f"rank-{SOCS_RANK} image: {per_image}")
    missing = [k for k in KERNELS if tiled_launches.get(k, 0) <= 0]
    if missing or (tiled_launches["window_product_limbs"]
                   != tiled_launches["row_limb_gemm"]):
        raise AssertionError(f"phases 27-29: kernels never launched {missing}, "
                             f"or window_product_limbs != row_limb_gemm: "
                             f"{tiled_launches}")

    optimize_launches = {}  # phases 31-34, each counted and checked apart
    phase_smo(torch, lt, ik, optimize_launches)
    phase_fit(torch, lt, ik, optimize_launches)
    phase_opc(torch, lt, ik, optimize_launches)
    phase_opc_tiled_cli(torch, lt, ik, optimize_launches)
    log("[phase 35]")
    log(f"  launches in phases 31-34: {optimize_launches}")
    missing = [k for k in KERNELS if optimize_launches.get(k, 0) <= 0]
    if missing or (optimize_launches["window_product_limbs"]
                   != optimize_launches["row_limb_gemm"]):
        raise AssertionError(f"phases 31-34: kernels never launched {missing}, "
                             f"or window_product_limbs != row_limb_gemm: "
                             f"{optimize_launches}")

    from lithographysimulator_tpu_torch import serve

    serve_launches = {}  # phases 36-40, each counted and checked apart
    phase_rasterizer(torch, lt, ik, serve_launches)
    phase_layout_cli(torch, lt, ik, serve_launches)
    srv, url = phase_worker(torch, lt, ik, serve_launches, serve)
    try:
        tiled, artifact = phase_jobs(torch, lt, ik, serve_launches, serve, url)
        phase_router(torch, lt, ik, serve_launches, serve, srv, url, tiled,
                     artifact)
    finally:
        srv.shutdown()
        srv.server_close()
    log("[phase 41]")
    log(f"  launches in phases 36-40: {serve_launches}")
    missing = [k for k in KERNELS if serve_launches.get(k, 0) <= 0]
    if missing or (serve_launches["window_product_limbs"]
                   != serve_launches["row_limb_gemm"]):
        raise AssertionError(f"phases 36-40: kernels never launched {missing}, "
                             f"or window_product_limbs != row_limb_gemm: "
                             f"{serve_launches}")

    parallel_launches = {}  # phases 42-46, each counted and checked apart
    cfg, image = phase_sharded_exact(torch, lt, ik, parallel_launches)
    phase_sharded_socs(torch, lt, ik, parallel_launches)
    phase_sharded_tiled(torch, lt, ik, parallel_launches)
    phase_sharded_resist(torch, lt, ik, parallel_launches, cfg, image)
    del image
    phase_sharded_smo_dryrun(torch, lt, ik, parallel_launches)
    log("[phase 46 done]")
    log(f"  launches in phases 42-46: {parallel_launches}; "
        f"torch.cuda.device_count() = {torch.cuda.device_count()}")
    missing = [k for k in KERNELS if parallel_launches.get(k, 0) <= 0]
    if missing or (parallel_launches["window_product_limbs"]
                   != parallel_launches["row_limb_gemm"]):
        raise AssertionError(f"phases 42-46: kernels never launched {missing}, "
                             f"or window_product_limbs != row_limb_gemm: "
                             f"{parallel_launches}")

    flow_launches = {}  # phases 47-48, each counted and checked apart
    phase_flow(torch, lt, ik, flow_launches)
    phase_flow_cpu(torch, lt, ik, flow_launches)
    log("[phase 48 done]")
    log(f"  launches in phases 47-48: {flow_launches}")
    missing = [k for k in KERNELS if flow_launches.get(k, 0) <= 0]
    if missing or (flow_launches["window_product_limbs"]
                   != flow_launches["row_limb_gemm"]):
        raise AssertionError(f"phases 47-48: kernels never launched {missing}, "
                             f"or window_product_limbs != row_limb_gemm: "
                             f"{flow_launches}")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": CU_SOURCE, "replaces": KERNELS[k],
         "launches": launches[k], **stats[k],
         "socs_launches": socs_launches[k],
         **{f"socs_{key}": v for key, v in socs_stats[k].items()},
         "vector_launches": vector_launches[k],
         "m3d_launches": m3d_launches[k],
         "resist_launches": resist_launches[k],
         "tiled_launches": tiled_launches[k],
         "optimize_launches": optimize_launches[k],
         "serve_launches": serve_launches[k],
         "parallel_launches": parallel_launches[k],
         "flow_launches": flow_launches[k]}
        for k in KERNELS] + [edge_entry]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
