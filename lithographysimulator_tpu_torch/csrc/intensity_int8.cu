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
//   window_product_limbs <- the X side of both row kernels: the per-column
//                        split of X (quantize_cols at :273-278 and :402-407),
//                        with the windowed products X_b (abbe.py's
//                        _windowed_products) that XLA fused into it, formed
//                        on load; X itself never reaches device memory.
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
//     FAST); the int32 sums are exact. No branch surrounds the wgmma (ptxas
//     would serialize them), so the last slab also runs its zero-filled
//     steps past kp. A slab's 24 wgmma are one commit group, waited for
//     whole. Shared-memory bytes: a wgmma reads 2 KB of A and 2 KB of B for
//     262,144 operations, 128 bytes a clock at the peak (8,192 operations a
//     clock an SM), beside the ring's TMA writes (72 KB a slab, 47 bytes a
//     clock at the peak). Measured on the H100, that is not the limit:
//     wgmma alone, both operands from shared memory, runs at 100% of the
//     peak a clock, and A from registers (ldmatrix once a limb and step, 96
//     bytes a clock) times the same in these kernels. Nor is the wait for a
//     slab's group: keeping the last step in flight across slabs
//     (wait_group 1) makes ptxas insert waits of its own (C7517);
//   * registers: the 3M epilogue carries only d = m1 - m2 and s = m1 + m2
//     across the planes (imag = m3 - s), beside the f32 image accumulator in
//     column_intensity: 3 f32 + 3 int32 tiles of 64 x 64 are 192 registers a
//     thread, so one warpgroup owns one 64 x 64 tile and two warpgroups
//     (255 registers each, no spills) fill an SM's register file;
//   * copies: the two warpgroups of a block share one 128 x 64 tile (they
//     read the same B slab), and a ring of 3 K slabs (128 bytes deep, all
//     limbs of both operands, 72 KB each) is kept in flight with TMA: one
//     box per operand per slab, 128-byte swizzled as wgmma reads it,
//     zero-filled past the rows and past kp (zero limbs are exact),
//     completion counted on an mbarrier. With the wgmma removed the same
//     loads take 80-87% of a kernel's time (9 TB/s from L2 at n = 1024):
//     delivering the slabs, not the tensor cores, sets the pace. So no
//     thread ever waits for a slot to be released: each warp counts itself
//     on the slot's release count once its wgmma on the slab have retired,
//     and the warp that completes the count refills the slot at once. No
//     per-thread address math and no block-wide barrier per slab. The slab
//     sequence runs on across the 3M planes (and, in column_intensity, the
//     batch entries), so a plane's epilogue overlaps the next slabs' loads;
//   * epilogue: each thread reads its 2 row and 16 column scales once a
//     plane, and row_limb_gemm writes its two planes as 8-byte pairs of
//     columns where w is even, so a quad of threads fills a 32-byte sector
//     of a row (single floats fill half-sectors: about 10% of the kernel);
//   * occupancy: 221 KB of shared memory and 256 threads make one block an
//     SM; at n = 1024 the 128 x 64 tiles of column_intensity are 128 blocks
//     for 132 SMs. The b loop of column_intensity stays in the block, in
//     order and without atomics: the image is deterministic. A launch is one
//     block a tile: blocks that each walk a fixed share of the tiles ran
//     slower than the hardware's own handing out of blocks to free SMs.
// The two limb quantizers, row_requantize and window_product_limbs, are
// bound by bytes (one read of their f32 or complex input, one write of 9
// limb planes) and share the split: a thread splits 16 consecutive values
// of a row (or column) held in registers, so each plane's limbs leave as
// one 16-byte store per limb, on full-rate adds only (see MAGIC and
// div_rn). row_requantize reads its rows once into registers and takes the
// three maxima (r, i, r+i) as it reads. window_product_limbs must see a
// whole column of products before it can split any of it, so it keeps the
// products in shared memory: a block (or a cluster of up to 8 blocks
// past about 290 rows, its maxima reduced through distributed shared
// memory) owns a strip of 16 columns, loads each operand row of the strip
// once (TMA boxes, or per-thread cp.async where a row pitch is not a
// multiple of 16 bytes), forms the products and maxima as the rows arrive,
// and splits from shared memory. No kernel
// allocates device memory: the Python wrappers allocate every output; the
// TMA maps are built on the host per launch and passed as kernel
// parameters.
//
// Rounding: the limb split rounds half to even (as torch.round and
// jnp.round), never half away from zero, and divides as IEEE division
// does. The file is built with nvcc's default --fmad=true; the split
// multiplies only by powers of two and subtracts exactly representable
// values, so contraction cannot change it, and the complex product is
// written with explicit roundings: the quantizers give the plain versions'
// limbs bit for bit. The dequantize/3M epilogues are written with explicit
// roundings too (limb_sum and the plane folds), so their results do not
// depend on the compiler's contraction choices; they differ from the plain
// versions only in f32 rounding order (compared by tolerance).

#include <cuda.h>  // CUtensorMap types; the encoder is found via the runtime
#include <cuda_runtime.h>
#include <atomic>
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
// + a full barrier and a release count (8 bytes each) a slot
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr int SEG = 16;                    // values one quantizer thread splits
constexpr int REQ_THREADS = 256;           // row_requantize: least block size
constexpr int REQ_MAX_THREADS = 512;       // one thread per SEG of a row
// window_product_limbs (see its kernel for the design and the cluster rule)
constexpr int WPL_COLS = 16;               // columns a strip: one 128-byte row
constexpr int WPL_PITCH = WPL_COLS + 2;    // complex a shared row: a box that
constexpr int WPL_ROW_BYTES = 8 * WPL_PITCH;  // starts a column early fits
constexpr int WPL_BOX = 32;                // rows a load (TMA box, ring slot)
constexpr int WPL_BOX_BYTES = WPL_BOX * WPL_ROW_BYTES;
constexpr int WPL_MAX_THREADS = 288;       // a split task a thread at 18 segments
constexpr int WPL_TARGET_BYTES = 84 * 1024;  // strip + b rows: 2 blocks an SM
constexpr int WPL_LOAD_BYTES = 224 * 1024;   // strip + b ring at most
constexpr int WPL_MAX_CLUSTER = 8;           // the portable cluster size
constexpr int WPL_MAX_SLOTS = WPL_LOAD_BYTES / WPL_BOX_BYTES;
// after the strip and the ring: slot barriers, the block's maxima, each
// cluster block's maxima, the column scales
constexpr int WPL_TAIL_BYTES =
    8 * WPL_MAX_SLOTS + 4 * 3 * WPL_COLS * (WPL_MAX_CLUSTER + 2);

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

// TMA: the box at coordinates {c0, c1, c2} of a 3-D `map` into shared
// memory at dst, completion counted on barrier `bar` as tma_load.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// An asynchronous 8-byte copy from global to shared memory (cp.async).
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// One arrival on barrier `bar` once this thread's earlier cp.async copies
// have landed (counted in the barrier's expected arrivals: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// The thread block cluster's barrier, split: arrive (release, or relaxed:
// no memory ordering) and wait (acquire); every thread of every block of
// the cluster takes part.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Stores v at p in the shared memory of block `rank` of this cluster.
__device__ __forceinline__ void st_cluster(int* p, int rank, int v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(remote), "r"(v)
               : "memory");
}

// Orders this thread's earlier accesses of shared memory before its later
// asynchronous-proxy ones (TMA writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// A ring of STAGES slots keeps slabs in flight, one TMA box per operand
// holding all limbs of a KS-deep slab (zero-filled past the rows and past kp:
// zero limbs are exact); thread 0 fills it first. Both warpgroups consume:
// they wait on the slot's `full` barrier, run 6 wgmma per 32-deep step (3 in
// FAST), and each warp, once its wgmma have retired, counts itself on the
// slot's release count; the warp whose count completes it (the block's
// last) refills the slot with the slab STAGES later. No thread waits for a
// release, nor for its own count's result, so neither warpgroup's next
// wgmma waits on the other's progress.
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
  int* released =
      reinterpret_cast<int*>(smem + STAGES * STAGE_BYTES + 8 * STAGES);
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
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < STAGES && t < total; ++t) produce(t);
  }
  __syncthreads();

  int s0[ACC], s1[ACC], s2[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) s0[i] = s1[i] = s2[i] = 0;

  // A warp's lane 0 counts itself on a slot without waiting for the count:
  // it reads the old count back one slab later, once the next slab's wgmma
  // are issued, and refills the slot if its count was the last.
  int counted = -1, old_count = 0;  // the slab counted, the count before
  auto settle = [&]() {
    if (counted >= 0 && old_count % (THREADS / 32) == THREADS / 32 - 1 &&
        counted + STAGES < total) {
      fence_proxy_async();
      produce(counted + STAGES);
    }
    counted = -1;
  };
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
    if (threadIdx.x % 32 == 0) settle();  // the slab before's count
    wgmma_wait_all();
    fence_operand(s0);
    fence_operand(s1);
    if (!FAST) fence_operand(s2);
    // The wait above returned once this warp's wgmma had read the slot, so
    // its count comes after its reads; the refill is issued after all counts.
    __syncwarp();
    if (threadIdx.x % 32 == 0) {
      old_count = atomicAdd(released + s, 1);
      counted = t;
    }
    if (kk == ksteps - 1) epilogue(t / ksteps, s0, s1, s2);
  }
  if (threadIdx.x % 32 == 0) settle();
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

// S0 + S1/256 (+ S2/65536) of register i as fma(S1, 2^-8, S0) (then
// fma(S2, 2^-16, .)); the plane's value is m = that times sA[row] sB[col].
template <bool FAST>
__device__ __forceinline__ float limb_sum(const int (&s0)[ACC],
                                          const int (&s1)[ACC],
                                          const int (&s2)[ACC], int i) {
  float v = __fmaf_rn((float)s1[i], 1.0f / 256.0f, (float)s0[i]);
  if (!FAST) v = __fmaf_rn((float)s2[i], 1.0f / 65536.0f, v);
  return v;
}

// Folds plane 0 or 1's m = v k into the carried tiles: d = m1 after plane
// 0; s = m1 + m2 and d = m1 - m2 after plane 1, each with one rounding of
// the exact v k.
__device__ __forceinline__ void fold_plane(int p, float v, float k, float& d,
                                           float& s) {
  if (p == 0) {
    d = __fmul_rn(v, k);
  } else {
    s = __fmaf_rn(v, k, d);
    d = __fmaf_rn(-v, k, d);
  }
}

// The scales of this thread's accumulator rows (ra[h]: register i has row
// h = (i / 2) % 2) and columns (cb[c]: c = 2 (i / 4) + i % 2) of the tile at
// (row0, col0), 0 past nr rows and nc columns.
__device__ __forceinline__ void tile_scales(const float* sa, int nr,
                                            const float* sb, int nc, int row0,
                                            int col0, float (&ra)[2],
                                            float (&cb)[ACC / 2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + acc_row(2 * h);
    ra[h] = row < nr ? sa[row] : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < ACC / 2; ++c) {
    const int col = col0 + acc_col(4 * (c / 2) + c % 2);
    cb[c] = col < nc ? sb[col] : 0.0f;
  }
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
    float ra[2], cb[ACC / 2];
    tile_scales(t_scales + (long)p * n, n, x_scales + ((long)p * batch + b) * w,
                w, row0, col0, ra, cb);
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const float v = limb_sum<FAST>(s0, s1, s2, i);
      const float k = __fmul_rn(ra[i / 2 % 2], cb[2 * (i / 4) + i % 2]);
      if (p < 2)
        fold_plane(p, v, k, d[i], s[i]);
      else
        s[i] = __fsub_rn(__fmul_rn(v, k), s[i]);  // imag = m3 - s, kept in s
    }
    if (p < 2) return;
    // yr = d, yi = imag. Where w is even, registers i and i + 1 (columns col,
    // col + 1) leave as one 8-byte store each, and a quad of threads writes
    // a whole 32-byte sector of a row.
    const bool pairs = w % 2 == 0;
#pragma unroll
    for (int i = 0; i < ACC; i += 2) {
      const int row = row0 + acc_row(i);
      const int col = col0 + acc_col(i);
      const long o = ((long)b * n + row) * w + col;
      if (row >= n) continue;
      if (pairs) {
        if (col < w) {
          *reinterpret_cast<float2*>(yr + o) = make_float2(d[i], d[i + 1]);
          *reinterpret_cast<float2*>(yi + o) = make_float2(s[i], s[i + 1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (col + j < w) {
            yr[o + j] = d[i + j];
            yi[o + j] = s[i + j];
          }
        }
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
    float ra[2], cb[ACC / 2];
    tile_scales(y_scales + ((long)p * batch + b) * n, n, t_scales + (long)p * n,
                n, row0, col0, ra, cb);
    const float wb = weights[b];
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const float v = limb_sum<FAST>(s0, s1, s2, i);
      const float k = __fmul_rn(ra[i / 2 % 2], cb[2 * (i / 4) + i % 2]);
      if (p < 2) {
        fold_plane(p, v, k, d[i], s[i]);
      } else {  // acc += wb (er^2 + ei^2), er = d, ei = m3 - s
        const float ei = __fmaf_rn(v, k, -s[i]);
        const float e2 = __fmaf_rn(ei, ei, __fmul_rn(d[i], d[i]));
        acc[i] = __fmaf_rn(wb, e2, acc[i]);
      }
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

// ---------------------------------------------------------------------------
// The limb quantizers
// ---------------------------------------------------------------------------

// x + MAGIC rounds x (|x| < 2^22) to an integer k, half to even as rintf,
// and leaves k in the low mantissa bits: bits(x + MAGIC) = 0x4B400000 + k,
// whose low byte is k as an int8. The limb split runs on these sums, so it
// needs no rounding or conversion instructions (CUDA's throughput table
// gives float-to-int conversions 16 a clock an SM on the H100, FP32 adds
// 128), only adds and byte permutes.
constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23

// Limb split of one value, exactly as quantize_rows (intensity_int8.py:52-71):
// rint (half to even), the +128 carry and the l2 clip, on q = a / scale.
// Returns MAGIC + l for each limb l. Every product and difference below is
// exact (powers of two, and Sterbenz), so FMA contraction cannot change it.
__device__ __forceinline__ void split_limbs(float q, float& t0, float& t1,
                                            float& t2) {
  t0 = __fadd_rn(q * (1.0f / 65536.0f), MAGIC);   // |l0| <= 127 by the scale
  float r = q - (t0 - MAGIC) * 65536.0f;          // |r| <= 2^15
  t1 = __fadd_rn(r * (1.0f / 256.0f), MAGIC);     // l1 in [-128, 128]
  if (t1 > MAGIC + 127.0f) {                      // +128 carries; -128 fits
    t0 += 1.0f;
    t1 -= 256.0f;
  }
  r = q - (t0 - MAGIC) * 65536.0f - (t1 - MAGIC) * 256.0f;  // |r| <= 128
  t2 = fminf(fmaxf(__fadd_rn(r, MAGIC), MAGIC - 128.0f), MAGIC + 127.0f);
}

// a / s rounded as IEEE division, given y = 1 / s rounded (one true
// division per row): two Markstein corrections q + (a - s q) y, the
// remainder exact by FMA; the second starts from a faithful quotient, so
// it rounds correctly (a quotient in the subnormal range may not, but
// its limbs are 0 either way).
__device__ __forceinline__ float div_rn(float a, float s, float y) {
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-q, s, a), y, q);
  return __fmaf_rn(__fmaf_rn(-q, s, a), y, q);
}

// The int8 low bytes of four MAGIC sums, packed little-endian.
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  return __byte_perm(__byte_perm(__float_as_uint(a), __float_as_uint(b), 0x0040),
                     __byte_perm(__float_as_uint(c), __float_as_uint(d), 0x0040),
                     0x5410);
}

// max(m, |x|) on the float bits: non-negative floats order as their bits,
// and a NaN wins, as in torch.amax.
__device__ __forceinline__ float absmax(float m, float x) {
  return __int_as_float(max(__float_as_int(m), __float_as_int(fabsf(x))));
}

// Scale of a row or column from its max |value| (intensity_int8.py's
// _quantize): amax / (127 * 2^16), and 1 for an all-zero one.
__device__ __forceinline__ float limb_scale(float amax) {
  return amax > 0.0f ? amax / (127.0f * 65536.0f) : 1.0f;
}

// The three maxima (|r|, |i|, |r + i|) of SEG values.
__device__ __forceinline__ void plane_maxima(const float (&re)[SEG],
                                             const float (&im)[SEG],
                                             float (&m)[3]) {
#pragma unroll
  for (int i = 0; i < SEG; ++i) {
    m[0] = absmax(m[0], re[i]);
    m[1] = absmax(m[1], im[i]);
    m[2] = absmax(m[2], re[i] + im[i]);
  }
}

// Splits SEG consecutive values of the planes r, i and r + i with their
// scales and stores each plane's 3 limbs as one 16-byte word each, limb
// (p, j) at dst + (3 p + j) * limb_stride. dst is 16-byte aligned.
__device__ __forceinline__ void store_limbs(const float (&re)[SEG],
                                            const float (&im)[SEG],
                                            const float (&scale)[3],
                                            int8_t* dst, long limb_stride) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float s = scale[p];
    const float y = 1.0f / s;
    uint32_t word[3][SEG / 4];
#pragma unroll
    for (int k = 0; k < SEG / 4; ++k) {
      float t[3][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = 4 * k + i;
        const float a = p == 0 ? re[v] : p == 1 ? im[v] : re[v] + im[v];
        split_limbs(div_rn(a, s, y), t[0][i], t[1][i], t[2][i]);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) word[j][k] = pack4(t[j][0], t[j][1], t[j][2], t[j][3]);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
      *reinterpret_cast<uint4*>(dst + (3 * p + j) * limb_stride) =
          make_uint4(word[j][0], word[j][1], word[j][2], word[j][3]);
  }
}

// row[v0 .. v0 + SEG) with zeros past w. VEC: w % 4 == 0 and row 16-byte
// aligned, so each float4 lies wholly inside or wholly past w.
template <bool VEC>
__device__ __forceinline__ void load_seg(const float* __restrict__ row, int v0,
                                         int w, float (&x)[SEG]) {
#pragma unroll
  for (int q = 0; q < SEG / 4; ++q) {
    const int v = v0 + 4 * q;
    if (VEC) {
      const float4 f = v < w ? *reinterpret_cast<const float4*>(row + v)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[4 * q + i] = v + i < w ? row[v + i] : 0.0f;
    }
  }
}

// Per-row limb split of the planes yr, yi and yr + yi:
//   yr, yi (rows, w) f32 -> y_limbs (3, 3, rows, kp) int8 (zero past w),
//   y_scales (3, rows) f32.
// Bound by bytes: rows * w * 8 read, 9 * rows * kp + 12 * rows written.
// Thread t of a block owns segment s = t % segs (segs = kp / SEG) of row
// t / segs, so a block packs rows_per_block whole rows and wastes few lanes
// at any kp (34 segments at w = 520). The thread reads its 2 x 16 floats
// once (four float4 loads each where w % 4 == 0; a warp's loads cover
// contiguous 2 KB), keeps them in registers, takes the three maxima in that
// pass, reduces them per row (a segmented shuffle within the warp, then one
// shared-memory atomicMax per row and warp), and writes its 9 limb words
// with 16-byte stores: a warp writes 512 contiguous bytes a store. The zero
// tail up to kp is split from zeros, so it needs no branch.
// grid ceil(rows / rows_per_block), block rows_per_block * segs rounded up
// to a warp (at least REQ_THREADS).
// WIDE (segs > REQ_MAX_THREADS, kp > 8192): one row a block of
// REQ_MAX_THREADS threads, thread t owning segments t, t + blockDim.x, ...;
// it takes their maxima in a first pass and reads them again (from L2) to
// split them.
template <bool VEC, bool WIDE>
__global__ void __launch_bounds__(REQ_MAX_THREADS)
row_requantize_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                      int8_t* __restrict__ y_limbs, float* __restrict__ y_scales,
                      int rows, int w, int kp, int rows_per_block) {
  __shared__ int row_max[3 * REQ_THREADS];  // rows_per_block <= REQ_THREADS / 2
  const int segs = kp / SEG;
  const int per_row = WIDE ? blockDim.x : segs;  // threads a row
  const int passes = WIDE ? (segs + per_row - 1) / per_row : 1;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int r = t / per_row;
  const int row = blockIdx.x * rows_per_block + r;
  const bool live = r < rows_per_block && row < rows;
  for (int i = t; i < 3 * rows_per_block; i += blockDim.x) row_max[i] = 0;
  const int v0 = (t % per_row) * SEG;
  float re[SEG], im[SEG];
  const long in = (long)(live ? row : 0) * w;
  float m[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < passes; ++k) {
    const int v = v0 + k * per_row * SEG;
    load_seg<VEC>(yr + in, live ? v : w, w, re);
    load_seg<VEC>(yi + in, live ? v : w, w, im);
    plane_maxima(re, im, m);
  }
  // Segmented max over the warp's lanes of one row: after the loop the
  // first lane of each row in the warp holds the max of its row's lanes.
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool same = lane + off < 32 && (t + off) / per_row == r;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const float o = __shfl_down_sync(0xffffffffu, m[p], off);
      if (same) m[p] = absmax(m[p], o);
    }
  }
  __syncthreads();  // row_max zeroed
  if (live && (lane == 0 || (t - 1) / per_row != r)) {
#pragma unroll
    for (int p = 0; p < 3; ++p) atomicMax(&row_max[3 * r + p], __float_as_int(m[p]));
  }
  __syncthreads();
  if (!live) return;
  float scale[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) scale[p] = limb_scale(__int_as_float(row_max[3 * r + p]));
  for (int k = 0; k < passes; ++k) {
    const int v = v0 + k * per_row * SEG;
    if (WIDE) {  // else the one segment is still in registers
      if (v >= kp) break;
      load_seg<VEC>(yr + in, v, w, re);
      load_seg<VEC>(yi + in, v, w, im);
    }
    store_limbs(re, im, scale, y_limbs + (long)row * kp + v, (long)rows * kp);
  }
  if (v0 == 0) {
#pragma unroll
    for (int p = 0; p < 3; ++p) y_scales[(long)p * rows + row] = scale[p] * 65536.0f;
  }
}

// The complex product as c10::complex<float> computes it on the card
// (a.x b.x - a.y b.y, a.x b.y + a.y b.x, each contracted into one FMA by
// nvcc), written with explicit roundings so that this file's build cannot
// contract it otherwise.
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

// X_b[u, v] = a[ba, ar + u, ac + v] * b[br + u, bc + v] for u, v < w
// (ba = b when a holds a batch, else 0; (ar, ac, br, bc) = starts[b]),
// split per COLUMN v and stored transposed, as quantize_x(X):
//   a (a_batch, ha, wa), b (hb, wb) complex64 as float2; starts (batch, 4);
//   x_limbs (3, 3, batch, w, kp) int8, row v = column v of X_b along u,
//   zero past w; x_scales (3, batch, w) f32.
// Bound by bytes: the union of the windows read (8 bytes an element, once),
// 9 * batch * w * kp limbs and 12 * batch * w scales written.
//
// Design. A cluster of `ranks` blocks (blockIdx.x is the rank) owns a strip
// of WPL_COLS = 16 columns of one window (blockIdx.y = b, blockIdx.z = the
// strip): each operand row of the strip is one 128-byte span. Block `rank`
// owns the 16-row segments [rank * spb, (rank + 1) * spb) of the kp rows
// (spb = segs_per_block, even) and
//   1. loads its rows of both windows into shared memory in boxes of
//      WPL_BOX = 32 rows: a's rows into the strip buffer, b's into a ring of
//      `slots` boxes. With TMA (3-D maps of 8-byte elements) one thread puts
//      every box in flight at once, and each box's bytes complete on its
//      slot's mbarrier. A TMA box must start on 16 bytes (the card faults
//      with an illegal instruction on an odd column start), so where a
//      window starts at an odd column its boxes are 18 columns wide and
//      start a column early: rows of WPL_PITCH = 18 complex, the window
//      one column in. On the per-thread path (a row pitch that is not a
//      multiple of 16 bytes) every thread issues 8-byte cp.async copies and
//      arrives on the same barrier when they land. Where the ring holds
//      fewer slots than boxes (kp past 6,144), a slot is refilled after a
//      block barrier;
//   2. forms the products as the boxes arrive, thread t those of column
//      t % 16 in rows t / 16, t / 16 + threads / 16, ... of each box, in
//      place in the strip buffer, keeping its column's three maxima; rows
//      past w become zeros. The operands are read once, and the products
//      never leave the chip;
//   3. reduces the maxima over the block (warp shuffles, shared atomics),
//      stores them into every block of the cluster (distributed shared
//      memory) and meets the cluster at one barrier, after which each block
//      reduces the cluster's maxima from its own shared memory (no block
//      reads a peer's, so none waits for its peers to leave); rank 0 writes
//      the scales;
//   4. splits its own segments from shared memory: a thread a (column,
//      segment) task reads the 16 products of its column (a half-warp reads
//      16 neighbouring complex of one row: no bank conflict) and stores
//      each plane's 3 limbs as 16-byte words with store_limbs, the limbs bit
//      for bit the plain version's.
// A window outside its operand (the callers validate starts on the host)
// reads nothing and gets NaN scales, which poison every product.
// grid (ranks, batch, ceil(w / 16)), cluster (ranks, 1, 1),
// threads = 16 * segs_per_block (a split task each) up to WPL_MAX_THREADS,
// at most 72 registers a thread (3 blocks of 288 threads an SM where
// shared memory allows: 256 rows a block and fewer). map_a and map_b
// have 16-column boxes, wide_a and wide_b 18-column ones.
// What bounds it on the H100 (PERF.md, PR 13): the two phases of a block,
// loads then split, run one after the other; at (4, 1024, 1024) the loads
// and products alone take 58% of the kernel's time and the split with its
// stores alone 70%, each below the memory rate, and they overlap only
// across the blocks of an SM. A persistent cluster that loaded the next
// strip while splitting one was slower: its second strip buffer cost a
// block an SM.
template <bool TMA>
__global__ void __launch_bounds__(WPL_MAX_THREADS, 3)
window_product_limbs_kernel(const __grid_constant__ CUtensorMap map_a,
                            const __grid_constant__ CUtensorMap wide_a,
                            const __grid_constant__ CUtensorMap map_b,
                            const __grid_constant__ CUtensorMap wide_b,
                            const float2* __restrict__ a,
                            const float2* __restrict__ b,
                            const int* __restrict__ starts,
                            int8_t* __restrict__ x_limbs,
                            float* __restrict__ x_scales, int batch,
                            int a_batch, int ha, int wa, int hb, int wb, int w,
                            int kp, int segs_per_block, int slots) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int rank = blockIdx.x, ranks = gridDim.x;
  const int bi = blockIdx.y;
  const int v0 = blockIdx.z * WPL_COLS;
  const int t = threadIdx.x, threads = blockDim.x;
  const int ar = starts[4 * bi], ac = starts[4 * bi + 1];
  const int br = starts[4 * bi + 2], bc = starts[4 * bi + 3];
  if (ar < 0 || ac < 0 || br < 0 || bc < 0 || ar > ha - w || ac > wa - w ||
      br > hb - w || bc > wb - w) {  // every block of the cluster leaves here
    const int p = t / WPL_COLS, v = v0 + t % WPL_COLS;
    if (rank == 0 && p < 3 && v < w)
      x_scales[((long)p * batch + bi) * w + v] = __int_as_float(0x7fc00000);
    return;
  }
  const int strip_rows = segs_per_block * SEG;
  float2* strip = reinterpret_cast<float2*>(smem);
  float2* ring = strip + strip_rows * WPL_PITCH;
  uint8_t* tail = smem + (strip_rows + slots * WPL_BOX) * WPL_ROW_BYTES;
  const uint32_t bar0 = smem_addr(tail);
  int(*block_max)[3][WPL_COLS] =
      reinterpret_cast<int(*)[3][WPL_COLS]>(tail + 8 * WPL_MAX_SLOTS);
  int(*rank_max)[3][WPL_COLS] = block_max + 1;
  float(*col_scale)[WPL_COLS] =
      reinterpret_cast<float(*)[WPL_COLS]>(rank_max + WPL_MAX_CLUSTER);

  const int seg0 = rank * segs_per_block;
  const int segs = max(0, min(segs_per_block, kp / SEG - seg0));
  const int u0 = seg0 * SEG;  // the block's first row
  const int boxes = (segs * SEG + WPL_BOX - 1) / WPL_BOX;
  const int loads = u0 < w ? min(boxes, (w - u0 + WPL_BOX - 1) / WPL_BOX) : 0;
  const int ab = a_batch == 1 ? 0 : bi;
  // Element (row r, column v) of an operand's box rows lies at r * pitch +
  // shift + v: pitch 18 and shift 1 for a TMA box that starts a column
  // early, else pitch 16 and shift 0.
  const int sa = TMA ? ac % 2 : 0, sb = TMA ? bc % 2 : 0;
  const int pa = WPL_COLS + 2 * sa, pb = WPL_COLS + 2 * sb;
  const int tx = TMA ? WPL_BOX * 8 * (pa + pb) : 0;
  // Box g: rows u0 + 32 g .. of a into the strip, of b into slot g % slots.
  auto issue = [&](int g) {
    const int s = g % slots;
    const int row = u0 + g * WPL_BOX;
    float2* dst_a = strip + g * WPL_BOX * pa;
    float2* dst_b = ring + s * WPL_BOX * pb;
    if (TMA) {
      if (t == 0) {
        mbar_expect_tx(bar0 + 8 * s, tx);
        tma_load_3d(smem_addr(dst_a), sa ? &wide_a : &map_a, ac + v0 - sa,
                    ar + row, ab, bar0 + 8 * s);
        tma_load_3d(smem_addr(dst_b), sb ? &wide_b : &map_b, bc + v0 - sb,
                    br + row, 0, bar0 + 8 * s);
      }
    } else {
      for (int e = t; e < WPL_BOX * WPL_COLS; e += threads) {
        const int u = row + e / WPL_COLS, v = v0 + e % WPL_COLS;
        if (u < w && v < w) {
          cp_async_8(smem_addr(dst_a + e), a + ((long)ab * ha + ar + u) * wa + ac + v);
          cp_async_8(smem_addr(dst_b + e), b + (long)(br + u) * wb + bc + v);
        }
      }
      cp_async_arrive(bar0 + 8 * s);
    }
  };
  if (t < 3 * WPL_COLS) (&block_max[0][0][0])[t] = 0;
  if (t == 0) {
    for (int s = 0; s < slots; ++s) mbar_init(bar0 + 8 * s, TMA ? 1 : threads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int g = 0; g < loads && g < slots; ++g) issue(g);
  cluster_arrive_relaxed();  // this block has started: peers may store here

  // Products, in place, and the maxima of column v: a thread takes rows
  // t / 16, t / 16 + threads / 16, ... of each box.
  const int v = t % WPL_COLS;
  float m[3] = {0.0f, 0.0f, 0.0f};
  for (int g = 0; g < boxes; ++g) {
    const int s = g % slots;
    if (g < loads) mbar_wait(bar0 + 8 * s, (g / slots) & 1);
    for (int r_box = t / WPL_COLS; r_box < WPL_BOX; r_box += threads / WPL_COLS) {
      const int r = g * WPL_BOX + r_box;
      float2* xa = strip + r * pa + sa + v;
      float2 x = make_float2(0.0f, 0.0f);
      if (g < loads && u0 + r < w) {
        x = cmul(*xa, ring[(s * WPL_BOX + r_box) * pb + sb + v]);
        m[0] = absmax(m[0], x.x);
        m[1] = absmax(m[1], x.y);
        m[2] = absmax(m[2], x.x + x.y);
      }
      *xa = x;
    }
    if (g + slots < loads) {  // the same for every thread of the block
      __syncthreads();        // slot s read by all
      issue(g + slots);
    }
  }
  // The column maxima: over the two half-warps, the warps, the cluster.
#pragma unroll
  for (int p = 0; p < 3; ++p)
    m[p] = absmax(m[p], __shfl_xor_sync(0xffffffffu, m[p], WPL_COLS));
  if (t % 32 < WPL_COLS) {
#pragma unroll
    for (int p = 0; p < 3; ++p) atomicMax(&block_max[0][p][v], __float_as_int(m[p]));
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  const int mp = t / WPL_COLS;
  if (t < 3 * WPL_COLS) {  // this block's maxima into every block's rank_max
    const int best = block_max[0][mp][v];
    for (int k = 0; k < ranks; ++k) st_cluster(&rank_max[rank][mp][v], k, best);
  }
  cluster_arrive();  // every block's maxima stored in every block
  cluster_wait();
  if (t < 3 * WPL_COLS) {
    int best = 0;
    for (int k = 0; k < ranks; ++k) best = max(best, rank_max[k][mp][v]);
    const float scale = limb_scale(__int_as_float(best));
    col_scale[mp][v] = scale;
    if (rank == 0 && v0 + v < w)
      x_scales[((long)mp * batch + bi) * w + v0 + v] = scale * 65536.0f;
  }
  __syncthreads();

  // The split of this block's segments.
  const long limb_stride = (long)batch * w * kp;
  for (int task = t; task < segs * WPL_COLS; task += threads) {
    const int col = task % WPL_COLS, seg = task / WPL_COLS;
    if (v0 + col >= w) continue;
    float re[SEG], im[SEG];
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      const float2 x = strip[(seg * SEG + i) * pa + sa + col];
      re[i] = x.x;
      im[i] = x.y;
    }
    const float scale[3] = {col_scale[0][col], col_scale[1][col], col_scale[2][col]};
    store_limbs(re, im, scale,
                x_limbs + ((long)bi * w + v0 + col) * kp + (seg0 + seg) * SEG,
                limb_stride);
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

// 3-D TMA map (cols, rows, arrays) of complex64 arrays (arrays, rows, cols)
// as 8-byte elements, box {box_cols, WPL_BOX, 1}: 32 rows of a strip;
// elements past the arrays read as zero. The row pitch (8 * cols bytes)
// must be a multiple of 16. Returns 0 or a CUDA error code.
int window_map(CUtensorMap* map, const void* base, int arrays, int rows,
               int cols, int box_cols) {
  const EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)arrays};
  const cuuint64_t strides[2] = {8ull * cols, 8ull * cols * rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, WPL_BOX, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The launch of window_product_limbs for a window of w columns (kp rows
// with the zero tail), chosen from w alone:
//   * the load path: TMA where both row pitches are multiples of 16 bytes
//     (wa and wb even), both bases 16-byte aligned and w >= WPL_BOX, else
//     per-thread 8-byte cp.async copies into the same buffers;
//   * the cluster: the least of 1, 2, 4, 8 blocks for which a block's rows
//     (segs_per_block = 2 * ceil(kp / 32 / ranks) segments of 16, so whole
//     boxes) hold both operands in WPL_TARGET_BYTES (2 blocks an SM at
//     288 rows, 3 at 256 and fewer); past
//     8 (kp > 2,304), 8 blocks with the rows of b in a ring of what
//     WPL_LOAD_BYTES leaves (every box in flight while it holds them all,
//     kp <= 6,144; at least two slots, kp <= 12,032; wider is refused).
// At the main-path shapes (B, n, w): (4, 1024, 520) 2 blocks of 288 rows,
// 264 blocks, 1.0 wave of 264 (2 an SM on 132 SMs); (4, 2048, 1032) 4 of
// 288, 1,040, 3.9 waves of 264; (4, 1024, 1024) 4 of 256, 1,024, 2.6
// waves of 396 (3 an SM); (4, 2048, 2048) 8 of 256, 4,096, 10.3 waves.
struct WplPlan {
  int tma, cluster, segs_per_block, slots, smem, threads;
};

int wpl_plan(const void* a, const void* b, int wa, int wb, int w, int kp,
             WplPlan* plan) {
  const int segs = kp / SEG;
  auto per_block = [&](int ranks) {
    return 2 * ((segs + 2 * ranks - 1) / (2 * ranks));
  };
  int ranks = 1;
  while (ranks < WPL_MAX_CLUSTER &&
         2 * per_block(ranks) * SEG * WPL_ROW_BYTES > WPL_TARGET_BYTES)
    ranks *= 2;
  const int spb = per_block(ranks);
  const int strip = spb * SEG * WPL_ROW_BYTES;
  const int boxes = spb * SEG / WPL_BOX;
  const int room = (WPL_LOAD_BYTES - strip) / WPL_BOX_BYTES;
  const int slots = boxes < room ? boxes : room;
  if (slots < 2) return (int)cudaErrorInvalidValue;
  plan->tma = w >= WPL_BOX && wa % 2 == 0 && wb % 2 == 0 &&
              reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(b) % 16 == 0;
  plan->cluster = ranks;
  plan->segs_per_block = spb;
  plan->slots = slots;
  plan->smem = strip + slots * WPL_BOX_BYTES + WPL_TAIL_BYTES;
  plan->threads = spb * WPL_COLS < WPL_MAX_THREADS ? spb * WPL_COLS : WPL_MAX_THREADS;
  return 0;
}

// Raises window_product_limbs_kernel<TMA>'s dynamic shared-memory limit to
// the most a launch asks for, once on each device (as launch_tiles).
template <class Kernel>
int raise_smem(Kernel kernel, bool tma) {
  static std::atomic<unsigned long long> raised[2];
  int device = 0;
  if (cudaError_t e = cudaGetDevice(&device)) return (int)e;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << device;
  if (!(raised[tma].load(std::memory_order_acquire) & bit)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WPL_LOAD_BYTES + WPL_TAIL_BYTES);
    if (attr != cudaSuccess) return (int)attr;
    raised[tma].fetch_or(bit, std::memory_order_release);
  }
  return 0;
}

inline dim3 tiles(int rows, int cols, int batch = 1) {
  return dim3((cols + BN - 1) / BN, (rows + BM - 1) / BM, batch);
}

// Raises the kernel's dynamic shared-memory limit to SMEM_BYTES once on
// each device, then launches it with smem_bytes() on the current device;
// returns the first error (0 = launched). The limit belongs to a device's
// context, so a process that launches on two cards sets it on each: one
// bit a device (ids below 64), set only after the attribute call succeeded.
template <auto Kernel, class... Args>
int launch_tiles(dim3 grid, cudaStream_t stream, Args... args) {
  static std::atomic<unsigned long long> raised{0};
  int device = 0;
  if (cudaError_t e = cudaGetDevice(&device)) return (int)e;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << device;
  if (!(raised.load(std::memory_order_acquire) & bit)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (attr != cudaSuccess) return (int)attr;
    raised.fetch_or(bit, std::memory_order_release);
  }
  Kernel<<<grid, THREADS, smem_bytes(), stream>>>(args...);
  return (int)cudaGetLastError();
}

// The launches themselves, from encoded maps. The single-launch entries
// below and int8_chunk_loop issue every kernel through these, so a chunk of
// the loop makes the very launches that the four entries make.
int issue_row_limb_gemm(const CUtensorMap& map_t, const void* t_scales,
                        const CUtensorMap& map_x, const void* x_scales,
                        void* yr, void* yi, int batch, int n, int w, int kp,
                        int fast, cudaStream_t s) {
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

// kp must be a multiple of 32. Up to SEG * REQ_MAX_THREADS = 8192 a thread
// keeps its one segment in registers (a 512-thread bound leaves 128
// registers a thread; at 1024 threads the 64-register cap spilled); wider
// rows take the WIDE kernel.
int issue_row_requantize(const void* yr, const void* yi, void* y_limbs,
                         void* y_scales, int rows, int w, int kp,
                         cudaStream_t s) {
  if (kp % 32 || kp < w) return (int)cudaErrorInvalidValue;
  const int segs = kp / SEG;
  const bool wide = segs > REQ_MAX_THREADS;
  const int threads = wide              ? REQ_MAX_THREADS
                      : segs <= REQ_THREADS ? REQ_THREADS
                                            : (segs + 31) / 32 * 32;
  const int per_block = wide ? 1 : threads / segs;
  const int grid = (rows + per_block - 1) / per_block;
  auto r = static_cast<const float*>(yr);
  auto i = static_cast<const float*>(yi);
  auto l = static_cast<int8_t*>(y_limbs);
  auto sc = static_cast<float*>(y_scales);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(yr) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(yi) % 16 == 0;
  auto kernel = vec ? (wide ? row_requantize_kernel<true, true>
                            : row_requantize_kernel<true, false>)
                    : (wide ? row_requantize_kernel<false, true>
                            : row_requantize_kernel<false, false>);
  kernel<<<grid, threads, 0, s>>>(r, i, l, sc, rows, w, kp, per_block);
  return (int)cudaGetLastError();
}

// The TMA maps of window_product_limbs' operands, narrow and wide boxes of
// each; on the per-thread path they stay zero and are never read.
struct WplMaps {
  CUtensorMap map_a{}, wide_a{}, map_b{}, wide_b{};
};

int wpl_map_pair(CUtensorMap* narrow, CUtensorMap* wide, const void* base,
                 int arrays, int rows, int cols) {
  if (int e = window_map(narrow, base, arrays, rows, cols, WPL_COLS)) return e;
  return window_map(wide, base, arrays, rows, cols, WPL_PITCH);
}

int issue_window_product_limbs(const WplPlan& plan, const WplMaps& maps,
                               const void* a, const void* b,
                               const void* starts, void* x_limbs,
                               void* x_scales, int batch, int a_batch, int ha,
                               int wa, int hb, int wb, int w, int kp,
                               cudaStream_t s) {
  auto kernel = plan.tma ? window_product_limbs_kernel<true>
                         : window_product_limbs_kernel<false>;
  if (int e = raise_smem(kernel, plan.tma)) return e;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(plan.cluster, batch, (w + WPL_COLS - 1) / WPL_COLS);
  config.blockDim = dim3(plan.threads);
  config.dynamicSmemBytes = plan.smem;
  config.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = plan.cluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &config, kernel, maps.map_a, maps.wide_a, maps.map_b, maps.wide_b,
      static_cast<const float2*>(a), static_cast<const float2*>(b),
      static_cast<const int*>(starts), static_cast<int8_t*>(x_limbs),
      static_cast<float*>(x_scales), batch, a_batch, ha, wa, hb, wb, w, kp,
      plan.segs_per_block, plan.slots);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

int issue_column_intensity(const CUtensorMap& map_y, const void* y_scales,
                           const CUtensorMap& map_t, const void* t_scales,
                           const void* weights, void* out, int batch, int n,
                           int kp, int fast, cudaStream_t s) {
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

// One chunk of int8_chunk_loop, as its caller writes the table: the address
// of the chunk's first array of a and how many arrays the chunk reads there
// (1: every window reads the one array; else one array a window), the
// addresses of its window starts (batch, 4) and weights (batch,), and its
// batch.
struct ChunkRow {
  long long a, a_batch, starts, weights, batch;
};

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
  return issue_row_limb_gemm(map_t, t_scales, map_x, x_scales, yr, yi, batch,
                             n, w, kp, fast, static_cast<cudaStream_t>(stream));
}

int row_requantize(const void* yr, const void* yi, void* y_limbs,
                   void* y_scales, int rows, int w, int kp, void* stream) {
  return issue_row_requantize(yr, yi, y_limbs, y_scales, rows, w, kp,
                              static_cast<cudaStream_t>(stream));
}

int window_product_limbs(const void* a, const void* b, const void* starts,
                         void* x_limbs, void* x_scales, int batch, int a_batch,
                         int ha, int wa, int hb, int wb, int w, int kp,
                         void* stream) {
  if (kp % 32 || kp < w || w < 1 || (a_batch != 1 && a_batch != batch))
    return (int)cudaErrorInvalidValue;
  WplPlan plan;
  if (int e = wpl_plan(a, b, wa, wb, w, kp, &plan)) return e;
  WplMaps maps;
  if (plan.tma) {
    if (int e = wpl_map_pair(&maps.map_a, &maps.wide_a, a, a_batch, ha, wa))
      return e;
    if (int e = wpl_map_pair(&maps.map_b, &maps.wide_b, b, 1, hb, wb))
      return e;
  }
  return issue_window_product_limbs(plan, maps, a, b, starts, x_limbs,
                                    x_scales, batch, a_batch, ha, wa, hb, wb,
                                    w, kp, static_cast<cudaStream_t>(stream));
}

// How window_product_limbs runs for these operands: plan[0..5] = TMA (1) or
// per-thread loads (0), the cluster size, rows a block, b ring slots,
// dynamic shared memory bytes and threads a block. Returns 0 or a CUDA error code (a
// window too wide for a cluster's shared memory).
int window_product_limbs_plan(const void* a, const void* b, int wa, int wb,
                              int w, int kp, void* plan) {
  if (kp % 32 || kp < w || w < 1) return (int)cudaErrorInvalidValue;
  WplPlan p;
  if (int e = wpl_plan(a, b, wa, wb, w, kp, &p)) return e;
  int* out = static_cast<int*>(plan);
  out[0] = p.tma;
  out[1] = p.cluster;
  out[2] = p.segs_per_block * SEG;
  out[3] = p.slots;
  out[4] = p.smem;
  out[5] = p.threads;
  return 0;
}

int column_intensity(const void* y_limbs, const void* y_scales,
                     const void* t_limbs, const void* t_scales,
                     const void* weights, void* out, int batch, int n, int kp,
                     int fast, void* stream) {
  const int nl = fast ? 2 : 3;
  CUtensorMap map_y, map_t;
  if (int e = limb_map(&map_y, y_limbs, batch, n, kp, BM, nl)) return e;
  if (int e = limb_map(&map_t, t_limbs, 1, n, kp, BN, nl)) return e;
  return issue_column_intensity(map_y, y_scales, map_t, t_scales, weights, out,
                                batch, n, kp, fast,
                                static_cast<cudaStream_t>(stream));
}

// The int8 chunk loop of an apply or an exact pass, issued from here: for
// each of `chunks` rows of `table` (ChunkRow), the four kernels in the
// order and with the launches of the four entries above, window_product_limbs,
// row_limb_gemm, row_requantize, column_intensity, the last adding the
// chunk's image into `out`. One chunk's workspace (x_limbs, x_scales, yr,
// yi, y_limbs, y_scales, sized for the largest batch) serves every chunk:
// the kernels run in stream order. T0's maps and b's are encoded once a
// loop, a's when the chunk's a changes, the workspace's when the batch
// changes (a short last chunk). Returns 0, or the first error with
// where[0..1] = the chunk and the kernel (0-3, in the order above) it came
// from; every launch before that one was issued.
int int8_chunk_loop(const void* table, int chunks, const void* b,
                    const void* t_limbs, const void* t_scales, void* x_limbs,
                    void* x_scales, void* yr, void* yi, void* y_limbs,
                    void* y_scales, void* out, int ha, int wa, int hb, int wb,
                    int n, int w, int kp, int fast, void* where, void* stream) {
  auto rows = static_cast<const ChunkRow*>(table);
  auto s = static_cast<cudaStream_t>(stream);
  int* at = static_cast<int*>(where);
  at[0] = at[1] = 0;
  auto fail = [&](int chunk, int kernel, int e) {
    at[0] = chunk;
    at[1] = kernel;
    return e;
  };
  if (kp % 32 || kp < w || w < 1) return fail(0, 0, cudaErrorInvalidValue);
  const int nl = fast ? 2 : 3;
  CUtensorMap row_t{}, col_t{}, row_x{}, col_y{};
  WplPlan plan{};
  WplMaps maps;
  bool b_mapped = false;
  const ChunkRow* last = nullptr;
  for (int c = 0; c < chunks; ++c) {
    const ChunkRow& r = rows[c];
    const int batch = (int)r.batch, a_batch = (int)r.a_batch;
    const void* a = reinterpret_cast<const void*>(r.a);
    const void* starts = reinterpret_cast<const void*>(r.starts);
    const void* weights = reinterpret_cast<const void*>(r.weights);
    if (batch < 1 || (a_batch != 1 && a_batch != batch))
      return fail(c, 0, cudaErrorInvalidValue);
    if (!last || r.a != last->a || r.a_batch != last->a_batch) {
      if (int e = wpl_plan(a, b, wa, wb, w, kp, &plan)) return fail(c, 0, e);
      if (plan.tma && !b_mapped) {
        if (int e = wpl_map_pair(&maps.map_b, &maps.wide_b, b, 1, hb, wb))
          return fail(c, 0, e);
        b_mapped = true;
      }
      if (plan.tma) {
        if (int e = wpl_map_pair(&maps.map_a, &maps.wide_a, a, a_batch, ha, wa))
          return fail(c, 0, e);
      }
    }
    if (int e = issue_window_product_limbs(plan, maps, a, b, starts, x_limbs,
                                           x_scales, batch, a_batch, ha, wa,
                                           hb, wb, w, kp, s))
      return fail(c, 0, e);
    const bool new_batch = !last || r.batch != last->batch;
    if (!last) {
      if (int e = limb_map(&row_t, t_limbs, 1, n, kp, BM, nl))
        return fail(c, 1, e);
    }
    if (new_batch) {
      if (int e = limb_map(&row_x, x_limbs, batch, w, kp, BN, nl))
        return fail(c, 1, e);
    }
    if (int e = issue_row_limb_gemm(row_t, t_scales, row_x, x_scales, yr, yi,
                                    batch, n, w, kp, fast, s))
      return fail(c, 1, e);
    if (int e = issue_row_requantize(yr, yi, y_limbs, y_scales, batch * n, w,
                                     kp, s))
      return fail(c, 2, e);
    if (!last) {
      if (int e = limb_map(&col_t, t_limbs, 1, n, kp, BN, nl))
        return fail(c, 3, e);
    }
    if (new_batch) {
      if (int e = limb_map(&col_y, y_limbs, batch, n, kp, BM, nl))
        return fail(c, 3, e);
    }
    if (int e = issue_column_intensity(col_y, y_scales, col_t, t_scales,
                                       weights, out, batch, n, kp, fast, s))
      return fail(c, 3, e);
    last = &r;
  }
  return 0;
}

// Overrides the dynamic shared memory that row_limb_gemm and
// column_intensity launches ask for (0 restores their own size), so a test
// can check that a refused launch is reported.
int set_dynamic_smem(int bytes) {
  g_smem_override = bytes;
  return 0;
}

}  // extern "C"
