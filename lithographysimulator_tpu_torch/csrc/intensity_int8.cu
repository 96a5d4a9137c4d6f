// Int8 limb-emulated fp32 contractions of the exact-Abbe windowed zoom-DFT
// E_b = T0 @ X_b @ T0^T and its weighted intensity sum_b w_b |E_b|^2, on
// Hopper's int8 tensor cores (wgmma, sm_90a).
//
// Hopper port of the three Pallas TPU kernels in
// lithographysimulator_tpu/ops/kernels/intensity_int8.py:
//
//   column_intensity  <- column_intensity_int8 (_kernel, :74-182).
//   row_limb_gemm     <- row_transform_int8 (_row_kernel, :220-315) and
//                        row_transform_int8_splitk (_row_kernel_splitk,
//                        :318-454). The TPU needed two kernels because a
//                        square X block overflows 16 MB of VMEM past
//                        w ~ 800; here one kernel loops over K inside the block.
//   row_requantize    <- the in-kernel row requantization of both row kernels
//                        (_quant_rows_in_kernel, :203-217): a separate launch,
//                        because the row max needs the whole row, which spans
//                        several output tiles of row_limb_gemm.
//
// Limb math (shared with the plain PyTorch versions beside the wrappers): an
// f32 row (or column) is split into 3 signed radix-256 int8 limbs with one
// scale, a ~ s * (l0 + l1/256 + l2/65536). A product needs the 6 limb pairs
// of weight >= 2^-16, S0 = l0.m0, S1 = l0.m1 + l1.m0, S2 = l0.m2 + l1.m1 +
// l2.m0, each an EXACT int8 x int8 -> int32 dot (|S| <= 3 * K * 127^2 < 2^31
// for K < 44000), dequantized as sA * sB * (S0 + S1/256 + S2/65536). FAST
// drops the S2 group. Complex products use the 3M planes r, i and r+i:
// m1 = r.r, m2 = i.i, m3 = (r+i).(r+i); real = m1 - m2, imag = m3 - m1 - m2.
//
// Layouts (all row-major, contiguous, 16-byte aligned):
//   limb stacks  int8 (3 planes [r, i, r+i], 3 limbs, [B,] rows, kp), where
//                kp = K rounded up to a multiple of 32 and the padding holds
//                zero limbs, which add nothing to the dots (exact);
//   scales       f32 (3 planes, [B,] rows).
// Both operands of every dot are contiguous along the contraction: exactly
// the K-major operands that wgmma demands for 8-bit types.
//
// What bounds the two GEMM kernels on the H100: int8 tensor-core operations.
// Each 3-limb contraction is 3 planes x 6 limb dots x 2*M*N*K operations (3
// dots in FAST), M*N*K = n*w*w per batch entry for row_limb_gemm and n*n*w
// for column_intensity; at 1,979 int8 TOP/s that outweighs the bytes moved
// (at most ~81 MB at 3.35 TB/s) at every shape the main path uses. The
// design feeds the tensor cores:
//   * dots: wgmma.mma_async m64n64k32 s8.s8 -> s32 from shared memory, 6 per
//     32-deep K step into three int32 accumulators S0, S1, S2 (3 into two in
//     FAST); the int32 sums are exact, so the kernels match their plain
//     versions up to f32 rounding order in the epilogue. No branch surrounds
//     the wgmma (ptxas would serialize them), so the last slab also runs its
//     zero-filled steps past kp;
//   * registers: the 3M epilogue carries only d = m1 - m2 and s = m1 + m2
//     across the planes (imag = m3 - s), beside the f32 image accumulator in
//     column_intensity: 3 f32 + 3 int32 tiles of 64 x 64 are 192 registers a
//     thread, so one warpgroup owns one 64 x 64 tile and two warpgroups
//     (255 registers each, no spills) fill an SM's register file;
//   * copies: the limit after the dots is the traffic from L2 into shared
//     memory and the cost of issuing it (per-thread cp.async copies with a
//     block-wide barrier per slab left the tensor cores waiting). So the two
//     warpgroups of a block share one 128 x 64 tile (they read the same B
//     slab), and one thread keeps a ring of 3 K slabs (128 bytes deep, all
//     limbs of both operands, 72 KB each) in flight with TMA: one box per
//     operand per slab, 128-byte swizzled as wgmma reads it, zero-filled past
//     the rows and past kp (zero limbs are exact), completion counted on an
//     mbarrier; consumers release a slot on a second mbarrier. No
//     per-thread address math and no block-wide barrier per slab. The slab
//     sequence runs on across the 3M planes (and, in column_intensity, the
//     batch entries), so a plane's epilogue overlaps the next slabs' loads;
//   * occupancy: 221 KB of shared memory and 256 threads make one block an
//     SM; at n = 1024 the 128 x 64 tiles of column_intensity are 128 blocks
//     for 132 SMs. The b loop of column_intensity stays in the block, in
//     order and without atomics: the image is deterministic.
// row_requantize is bound by bytes (one read of Y, one write of its limbs)
// and stays a plain warp-per-row pass. No kernel allocates device memory:
// the Python wrappers allocate every output; the TMA maps are built on the
// host per launch and passed as kernel parameters.
//
// Rounding: the limb split uses rintf (round half to even, as torch.round
// and jnp.round), never roundf. The file is built with nvcc's default
// --fmad=true; the requantization multiplies only by powers of two and
// subtracts exactly representable values, so contraction cannot change its
// results, and the dequantize/3M epilogues differ from the plain versions
// only in f32 rounding order (compared by tolerance, not bit for bit).

#include <cuda.h>  // CUtensorMap types; the encoder is found via the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                   // warpgroup tile rows and columns
constexpr int WGS = 2;                     // consumer warpgroups per block
constexpr int BM = WGS * TILE;             // block tile rows (A operand)
constexpr int BN = TILE;                   // block tile columns (B operand)
constexpr int THREADS = WGS * 128;
constexpr int KSTEP = 32;                  // wgmma int8 depth (bytes)
constexpr int KS = 128;                    // K bytes a slab: one swizzle span
constexpr int STAGES = 3;
constexpr int ACC = TILE * TILE / 128;     // accumulator registers a thread
constexpr int A_LIMB = BM * KS;            // bytes of one limb of the A slab
constexpr int B_LIMB = BN * KS;
constexpr int STAGE_BYTES = 3 * (A_LIMB + B_LIMB);
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8;  // + barriers
constexpr int REQ_THREADS = 256;           // row_requantize: 8 rows a block

// Dynamic shared memory a launch asks for; 0 means SMEM_BYTES. Tests set it
// above the device limit to see a refused launch reported.
int g_smem_override = 0;

int smem_bytes() { return g_smem_override ? g_smem_override : SMEM_BYTES; }

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that outlasts
// ~10 s of clocks traps (a launch error) instead of hanging the device.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// TMA: the box at coordinates {c0..c4} of `map` into shared memory at dst;
// completion adds the box's bytes to barrier `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of wgmma accumulators across the
// asynchronous wgmma issue and wait.
__device__ __forceinline__ void fence_operand(int (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand as TMA wrote it: rows
// of KS = 128 bytes in the 128-byte swizzle (layout type 1), 8-row groups
// 1024 bytes apart (stride byte offset); the leading byte offset is unused
// for swizzled K-major operands. Tiles start on 1024-byte boundaries, so the
// base offset is 0; a K step inside the span adds its byte offset to the
// start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (uint64_t(1) << 16) | (uint64_t(8 * KS >> 4) << 32) |
         (uint64_t(1) << 62);
}

// d (+)= A (64 x 32, K-major) . B (64 x 32, K-major)^T in int32; `accumulate`
// 0 overwrites d.
__device__ __forceinline__ void wgmma_s8(int (&d)[ACC], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// The shared mainloop
// ---------------------------------------------------------------------------

// Where one pass (one 3M plane of one batch entry) finds its operands in the
// 5-D limb maps (kp, rows, batch, limb, plane): the batch entry of A and of B
// and the plane.
struct Pass {
  int a_batch;
  int b_batch;
  int plane;
};

// For pass = 0 .. passes-1, the exact int32 limb sums S0, S1 (, S2) of this
// warpgroup's 64 x 64 tile (A rows row0 + 64 * warpgroup.., B rows col0..)
// over the whole kp, handed to epilogue(pass, s0, s1, s2) in the wgmma
// accumulator layout (acc_row, acc_col).
//
// Thread 0 produces: it keeps STAGES slabs in flight, one TMA box per operand
// holding all limbs of a KS-deep slab (zero-filled past the rows and past kp:
// zero limbs are exact), and refills a slot once every warp has released it
// on the slot's `empty` barrier. Both warpgroups consume: they wait on the
// slot's `full` barrier, run 6 wgmma per 32-deep step (3 in FAST) and
// release the slot.
template <bool FAST, class Passes, class Epilogue>
__device__ __forceinline__ void limb_mainloop(const CUtensorMap& map_a,
                                              const CUtensorMap& map_b,
                                              uint8_t* smem, int passes, int kp,
                                              int row0, int col0,
                                              Passes pass_of,
                                              Epilogue epilogue) {
  constexpr int NL = FAST ? 2 : 3;
  const int ksteps = (kp + KS - 1) / KS;
  const int total = passes * ksteps;
  const int wg = threadIdx.x / 128;
  const uint32_t stages = smem_addr(smem);
  const uint32_t full = stages + STAGES * STAGE_BYTES;
  const uint32_t empty = full + STAGES * 8;
  auto slab_a = [&](int s) { return stages + s * STAGE_BYTES; };
  auto slab_b = [&](int s) { return stages + s * STAGE_BYTES + 3 * A_LIMB; };
  auto produce = [&](int t) {
    const int s = t % STAGES;
    const Pass p = pass_of(t / ksteps);
    const int k0 = (t % ksteps) * KS;
    mbar_expect_tx(full + 8 * s, NL * (A_LIMB + B_LIMB));
    tma_load(slab_a(s), &map_a, k0, row0, p.a_batch, 0, p.plane, full + 8 * s);
    tma_load(slab_b(s), &map_b, k0, col0, p.b_batch, 0, p.plane, full + 8 * s);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < STAGES && t < total; ++t) produce(t);
  }
  __syncthreads();

  int s0[ACC], s1[ACC], s2[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) s0[i] = s1[i] = s2[i] = 0;

  for (int t = 0; t < total; ++t) {
    const int s = t % STAGES;
    const int parity = (t / STAGES) & 1;
    const int kk = t % ksteps;
    mbar_wait(full + 8 * s, parity);
    const uint64_t a0 = smem_desc(slab_a(s) + wg * TILE * KS);
    const uint64_t b0 = smem_desc(slab_b(s));
    constexpr uint64_t LA = A_LIMB >> 4, LB = B_LIMB >> 4;  // 16-byte units
    // Every K step of the slab runs, the zero-filled tail past kp included
    // (it adds exact zeros): a branch around the wgmma makes ptxas serialize
    // them (C7520).
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KS / KSTEP; ++j) {
      const uint64_t off = j * (KSTEP >> 4);
      const int acc = kk > 0 || j > 0;
      const uint64_t a[3] = {a0 + off, a0 + off + LA, a0 + off + 2 * LA};
      const uint64_t b[3] = {b0 + off, b0 + off + LB, b0 + off + 2 * LB};
      wgmma_s8(s0, a[0], b[0], acc);
      wgmma_s8(s1, a[0], b[1], acc);
      if (!FAST) wgmma_s8(s2, a[0], b[2], acc);
      wgmma_s8(s1, a[1], b[0], 1);
      if (!FAST) {
        wgmma_s8(s2, a[1], b[1], 1);
        wgmma_s8(s2, a[2], b[0], 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(s0);
    fence_operand(s1);
    if (!FAST) fence_operand(s2);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + 8 * s);
    if (threadIdx.x == 0 && t + STAGES < total) {
      mbar_wait(empty + 8 * s, parity);
      produce(t + STAGES);
    }
    if (kk == ksteps - 1) epilogue(t / ksteps, s0, s1, s2);
  }
}

// Row and column of accumulator register i within the block tile: register i
// of warpgroup thread u holds row 16 * (u / 32) + (u % 32) / 4 + 8 * ((i / 2)
// % 2) and column 8 * (i / 4) + 2 * (u % 4) + i % 2 of its warpgroup's tile.
__device__ __forceinline__ int acc_row(int i) {
  const int u = threadIdx.x % 128;
  return TILE * (threadIdx.x / 128) + 16 * (u / 32) + (u % 32) / 4 +
         8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2;
}

// sA[row] * sB[col] * (S0 + S1/256 (+ S2/65536)) for register i.
template <bool FAST>
__device__ __forceinline__ float dequant(const int (&s0)[ACC],
                                         const int (&s1)[ACC],
                                         const int (&s2)[ACC], int i, float sa,
                                         float sb) {
  float v = (float)s0[i] + (float)s1[i] * (1.0f / 256.0f);
  if (!FAST) v += (float)s2[i] * (1.0f / 65536.0f);
  return v * (sa * sb);
}

// Folds plane p's m into the carried tiles: d = m1 - m2 and s = m1 + m2;
// at p == 2 returns imag = m3 - s (and real is d).
__device__ __forceinline__ float fold_plane(int p, float m, float& d,
                                            float& s) {
  if (p == 0) {
    d = m;
  } else if (p == 1) {
    s = d + m;
    d = d - m;
  } else {
    return m - s;
  }
  return 0.0f;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// Y_b = T0 @ X_b for one 128 x 64 tile of one batch entry b:
//   map_t over t_limbs (3, 3, n, kp), t_scales (3, n): T0 quantized per row;
//   map_x over x_limbs (3, 3, B, w, kp), x_scales (3, B, w): X_b TRANSPOSED
//     (row v holds column v of X_b, contiguous along the contraction) and
//     quantized per column of X_b;
//   yr, yi (B, n, w) f32: real and imaginary planes of Y.
// grid (ceil(w / 64), ceil(n / 128), B).
template <bool FAST>
__global__ void __launch_bounds__(THREADS, 1)
row_limb_gemm_kernel(const __grid_constant__ CUtensorMap map_t,
                     const float* __restrict__ t_scales,
                     const __grid_constant__ CUtensorMap map_x,
                     const float* __restrict__ x_scales, float* __restrict__ yr,
                     float* __restrict__ yi, int batch, int n, int w, int kp) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float d[ACC], s[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) d[i] = s[i] = 0.0f;
  auto pass_of = [&](int p) { return Pass{0, b, p}; };
  auto epilogue = [&](int p, const int(&s0)[ACC], const int(&s1)[ACC],
                      const int(&s2)[ACC]) {
    const float* sa = t_scales + (long)p * n;
    const float* sb = x_scales + ((long)p * batch + b) * w;
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int row = row0 + acc_row(i);
      const int col = col0 + acc_col(i);
      const float m = dequant<FAST>(s0, s1, s2, i, row < n ? sa[row] : 0.0f,
                                    col < w ? sb[col] : 0.0f);
      const float imag = fold_plane(p, m, d[i], s[i]);
      if (p == 2 && row < n && col < w) {
        const long o = ((long)b * n + row) * w + col;
        yr[o] = d[i];
        yi[o] = imag;
      }
    }
  };
  limb_mainloop<FAST>(map_t, map_x, smem, 3, kp, row0, col0, pass_of,
                      epilogue);
}

// out[i, j] += sum_b w_b (er^2 + ei^2), E_b = Y_b @ T0^T from limb dots:
//   map_y over y_limbs (3, 3, B, n, kp), y_scales (3, B, n): Y rows quantized
//     per row;
//   map_t over t_limbs (3, 3, n, kp), t_scales (3, n); weights (B,) f32;
//   out (n, n) f32, ADDED TO IN PLACE: the caller's running accumulator.
// One block per 128 x 64 output tile walks the passes (b, plane) in order;
// the field stack never reaches device memory. grid (ceil(n/64), ceil(n/128)).
template <bool FAST>
__global__ void __launch_bounds__(THREADS, 1)
column_intensity_kernel(const __grid_constant__ CUtensorMap map_y,
                        const float* __restrict__ y_scales,
                        const __grid_constant__ CUtensorMap map_t,
                        const float* __restrict__ t_scales,
                        const float* __restrict__ weights,
                        float* __restrict__ out, int batch, int n, int kp) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[ACC], d[ACC], s[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = d[i] = s[i] = 0.0f;
  auto pass_of = [&](int pass) { return Pass{pass / 3, 0, pass % 3}; };
  auto epilogue = [&](int pass, const int(&s0)[ACC], const int(&s1)[ACC],
                      const int(&s2)[ACC]) {
    const int b = pass / 3, p = pass % 3;
    const float* sa = y_scales + ((long)p * batch + b) * n;
    const float* sb = t_scales + (long)p * n;
    const float wb = weights[b];
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int row = row0 + acc_row(i);
      const int col = col0 + acc_col(i);
      const float m = dequant<FAST>(s0, s1, s2, i, row < n ? sa[row] : 0.0f,
                                    col < n ? sb[col] : 0.0f);
      const float ei = fold_plane(p, m, d[i], s[i]);
      if (p == 2) acc[i] += wb * (d[i] * d[i] + ei * ei);
    }
  };
  limb_mainloop<FAST>(map_y, map_t, smem, 3 * batch, kp, row0, col0, pass_of,
                      epilogue);
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int row = row0 + acc_row(i);
    const int col = col0 + acc_col(i);
    if (row < n && col < n) out[(long)row * n + col] += acc[i];
  }
}

// Limb split of one value, exactly as quantize_rows (intensity_int8.py:52-71).
__device__ __forceinline__ void split_limbs(float q, int8_t& o0, int8_t& o1,
                                            int8_t& o2) {
  float l0 = rintf(q * (1.0f / 65536.0f));  // |l0| <= 127 by the scale
  float r = q - l0 * 65536.0f;              // |r| <= 2^15
  float l1 = rintf(r * (1.0f / 256.0f));    // in [-128, 128]
  if (l1 > 127.0f) {                        // +128 carries; -128 fits int8
    l0 += 1.0f;
    l1 -= 256.0f;
  }
  r = q - l0 * 65536.0f - l1 * 256.0f;      // |r| <= 128
  const float l2 = fminf(fmaxf(rintf(r), -128.0f), 127.0f);
  o0 = (int8_t)(int)l0;
  o1 = (int8_t)(int)l1;
  o2 = (int8_t)(int)l2;
}

__device__ __forceinline__ float plane_value(const float* yr, const float* yi,
                                             int p, long o) {
  return p == 0 ? yr[o] : p == 1 ? yi[o] : yr[o] + yi[o];
}

// Per-row limb split of the planes yr, yi and yr + yi:
//   yr, yi (rows, w) f32 -> y_limbs (3, 3, rows, kp) int8 (zero past w),
//   y_scales (3, rows) f32. One warp per row; grid ceil(rows / 8).
__global__ void __launch_bounds__(REQ_THREADS)
row_requantize_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                      int8_t* __restrict__ y_limbs, float* __restrict__ y_scales,
                      int rows, int w, int kp) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (REQ_THREADS / 32) + warp;
  if (row >= rows) return;
  const long in = (long)row * w;
  const long limb = (long)rows * kp;
  for (int p = 0; p < 3; ++p) {
    float amax = 0.0f;
    for (int v = lane; v < w; v += 32)
      amax = fmaxf(amax, fabsf(plane_value(yr, yi, p, in + v)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = amax > 0.0f ? amax / (127.0f * 65536.0f) : 1.0f;
    int8_t* out = y_limbs + p * 3 * limb + (long)row * kp;
    for (int v = lane; v < kp; v += 32) {
      int8_t l0 = 0, l1 = 0, l2 = 0;
      if (v < w) split_limbs(plane_value(yr, yi, p, in + v) / scale, l0, l1, l2);
      out[v] = l0;
      out[limb + v] = l1;
      out[2 * limb + v] = l2;
    }
    if (lane == 0) y_scales[(long)p * rows + row] = scale * 65536.0f;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, found through the runtime,
// so the library needs no link against libcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// 5-D TMA map (kp, rows, batch, limb, plane) of a limb stack (3 planes,
// 3 limbs, batch, rows, kp) int8, box {KS, box_rows, 1, nl, 1}: one KS-deep
// slab of nl limbs of box_rows rows; rows past `rows` and bytes past kp read
// as zero. Returns 0 or a CUDA error code.
int limb_map(CUtensorMap* map, const void* limbs, int batch, int rows, int kp,
             int box_rows, int nl) {
  const EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[5] = {(cuuint64_t)kp, (cuuint64_t)rows,
                              (cuuint64_t)batch, 3, 3};
  const cuuint64_t plane = (cuuint64_t)rows * kp;
  const cuuint64_t strides[4] = {(cuuint64_t)kp, plane, plane * batch,
                                 plane * batch * 3};
  const cuuint32_t box[5] = {KS, (cuuint32_t)box_rows, 1, (cuuint32_t)nl, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(limbs), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline dim3 tiles(int rows, int cols, int batch = 1) {
  return dim3((cols + BN - 1) / BN, (rows + BM - 1) / BM, batch);
}

// Raises the kernel's dynamic shared-memory limit to SMEM_BYTES once, then
// launches it with smem_bytes(); returns the first error (0 = launched).
template <auto Kernel, class... Args>
int launch_tiles(dim3 grid, cudaStream_t stream, Args... args) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  Kernel<<<grid, THREADS, smem_bytes(), stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: pointers and the stream as void*, sizes as
// int; each returns cudaGetLastError() after its launch (0 = launched).
extern "C" {

int row_limb_gemm(const void* t_limbs, const void* t_scales,
                  const void* x_limbs, const void* x_scales, void* yr,
                  void* yi, int batch, int n, int w, int kp, int fast,
                  void* stream) {
  const int nl = fast ? 2 : 3;
  CUtensorMap map_t, map_x;
  if (int e = limb_map(&map_t, t_limbs, 1, n, kp, BM, nl)) return e;
  if (int e = limb_map(&map_x, x_limbs, batch, w, kp, BN, nl)) return e;
  auto s = static_cast<cudaStream_t>(stream);
  auto ts = static_cast<const float*>(t_scales);
  auto xs = static_cast<const float*>(x_scales);
  auto o_r = static_cast<float*>(yr);
  auto o_i = static_cast<float*>(yi);
  const dim3 grid = tiles(n, w, batch);
  if (fast)
    return launch_tiles<row_limb_gemm_kernel<true>>(
        grid, s, map_t, ts, map_x, xs, o_r, o_i, batch, n, w, kp);
  return launch_tiles<row_limb_gemm_kernel<false>>(
      grid, s, map_t, ts, map_x, xs, o_r, o_i, batch, n, w, kp);
}

int row_requantize(const void* yr, const void* yi, void* y_limbs,
                   void* y_scales, int rows, int w, int kp, void* stream) {
  const int per_block = REQ_THREADS / 32;
  row_requantize_kernel<<<(rows + per_block - 1) / per_block, REQ_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(yr), static_cast<const float*>(yi),
      static_cast<int8_t*>(y_limbs), static_cast<float*>(y_scales), rows, w,
      kp);
  return (int)cudaGetLastError();
}

int column_intensity(const void* y_limbs, const void* y_scales,
                     const void* t_limbs, const void* t_scales,
                     const void* weights, void* out, int batch, int n, int kp,
                     int fast, void* stream) {
  const int nl = fast ? 2 : 3;
  CUtensorMap map_y, map_t;
  if (int e = limb_map(&map_y, y_limbs, batch, n, kp, BM, nl)) return e;
  if (int e = limb_map(&map_t, t_limbs, 1, n, kp, BN, nl)) return e;
  auto s = static_cast<cudaStream_t>(stream);
  auto ys = static_cast<const float*>(y_scales);
  auto ts = static_cast<const float*>(t_scales);
  auto wt = static_cast<const float*>(weights);
  auto o = static_cast<float*>(out);
  const dim3 grid = tiles(n, n);
  if (fast)
    return launch_tiles<column_intensity_kernel<true>>(
        grid, s, map_y, ys, map_t, ts, wt, o, batch, n, kp);
  return launch_tiles<column_intensity_kernel<false>>(
      grid, s, map_y, ys, map_t, ts, wt, o, batch, n, kp);
}

// Overrides the dynamic shared memory that row_limb_gemm and
// column_intensity launches ask for (0 restores their own size), so a test
// can check that a refused launch is reported.
int set_dynamic_smem(int bytes) {
  g_smem_override = bytes;
  return 0;
}

}  // extern "C"
