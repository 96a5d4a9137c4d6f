// Int8 limb-emulated fp32 contractions of the exact-Abbe windowed zoom-DFT
// E_b = T0 @ X_b @ T0^T and its weighted intensity sum_b w_b |E_b|^2.
//
// Hopper port of the three Pallas TPU kernels in
// lithographysimulator_tpu/ops/kernels/intensity_int8.py:
//
//   row_limb_gemm     <- row_transform_int8 (_row_kernel, :220-315) and
//                        row_transform_int8_splitk (_row_kernel_splitk,
//                        :318-454). The TPU needed two kernels because a
//                        square X block overflows 16 MB of VMEM past
//                        w ~ 800; here one kernel loops over K inside the block.
//   row_requantize    <- the in-kernel row requantization of both row kernels
//                        (_quant_rows_in_kernel, :203-217): a separate launch,
//                        because the row max needs the whole row, which spans
//                        several output tiles of row_limb_gemm.
//   column_intensity  <- column_intensity_int8 (_kernel, :74-182).
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
//                kp = K rounded up to a multiple of KT (32) and the padding
//                holds zero limbs, which add nothing to the dots (exact);
//   scales       f32 (3 planes, [B,] rows).
// Both operands of every dot are contiguous along the contraction, so the
// dots run on __dp4a over 4 packed int8.
//
// What bounds these kernels on the H100: the integer ALU. __dp4a issues on
// the INT32 pipe (64 lanes per SM), so a 64x64 output tile spends 6 dp4a per
// 4-deep k-step per output (3 in FAST) against 24 shared-memory loads per
// thread; the int8 tensor cores (mma / wgmma) are the next step and are not
// used yet. No kernel allocates memory: the Python wrappers allocate every
// output and scratch buffer with torch.empty / torch.zeros.
//
// Rounding: the limb split uses rintf (round half to even, as torch.round
// and jnp.round), never roundf. The file is built with nvcc's default
// --fmad=true; the requantization multiplies only by powers of two and
// subtracts exactly representable values, so contraction cannot change its
// results, and the dequantize/3M epilogues differ from the plain versions
// only in f32 rounding order (compared by tolerance, not bit for bit).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;           // output tile rows
constexpr int BN = 64;           // output tile columns
constexpr int KT = 32;           // K slab per shared-memory stage (bytes)
constexpr int KW = KT / 4;       // 32-bit words per slab row
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int TM = BM / 16;
constexpr int TN = BN / 16;
constexpr int PAD = 4;           // spreads the transposed stores over banks

struct Slab {
  int a[3][KW][BM + PAD];        // [limb][k-word][row]
  int b[3][KW][BN + PAD];
};

// One KT-deep slab of `nl` limbs of a ROWS-row tile into shared memory,
// transposed to [limb][k-word][row]. Rows at or past `rows` read as zero.
template <int ROWS>
__device__ __forceinline__ void load_slab(int (*dst)[KW][ROWS + PAD],
                                          const int8_t* src, long limb_stride,
                                          int kp, int row0, int rows, int k0,
                                          int nl) {
  constexpr int CHUNKS = KT / 16;  // int4 loads per slab row
  for (int idx = threadIdx.x; idx < nl * ROWS * CHUNKS; idx += THREADS) {
    const int c = idx % CHUNKS;
    const int r = (idx / CHUNKS) % ROWS;
    const int l = idx / (CHUNKS * ROWS);
    int4 v = make_int4(0, 0, 0, 0);
    const int row = row0 + r;
    if (row < rows) {
      v = *reinterpret_cast<const int4*>(src + l * limb_stride +
                                         (long)row * kp + k0 + c * 16);
    }
    dst[l][c * 4 + 0][r] = v.x;
    dst[l][c * 4 + 1][r] = v.y;
    dst[l][c * 4 + 2][r] = v.z;
    dst[l][c * 4 + 3][r] = v.w;
  }
}

// m[i][j] = sA[row] * sB[col] * (S0 + S1/256 + S2/65536) for one 3M plane:
// A rows row0.., B rows col0.., contraction over kp. `a` and `b` point at
// limb 0 of the plane; the limbs are `*_limb_stride` elements apart.
template <bool FAST>
__device__ __forceinline__ void plane_product(
    Slab& sm, const int8_t* a, long a_limb_stride, int a_rows, const float* sa,
    const int8_t* b, long b_limb_stride, int b_rows, const float* sb, int kp,
    int row0, int col0, float (&m)[TM][TN]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int nl = FAST ? 2 : 3;
  int s0[TM][TN], s1[TM][TN], s2[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s0[i][j] = s1[i][j] = s2[i][j] = 0;

  for (int k0 = 0; k0 < kp; k0 += KT) {
    __syncthreads();  // the previous slab's readers are done
    load_slab<BM>(sm.a, a, a_limb_stride, kp, row0, a_rows, k0, nl);
    load_slab<BN>(sm.b, b, b_limb_stride, kp, col0, b_rows, k0, nl);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int a0[TM], a1[TM], a2[TM], b0[TN], b1[TN], b2[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a0[i] = sm.a[0][kw][ty + 16 * i];
        a1[i] = sm.a[1][kw][ty + 16 * i];
        a2[i] = FAST ? 0 : sm.a[2][kw][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b0[j] = sm.b[0][kw][tx + 16 * j];
        b1[j] = sm.b[1][kw][tx + 16 * j];
        b2[j] = FAST ? 0 : sm.b[2][kw][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s0[i][j] = __dp4a(a0[i], b0[j], s0[i][j]);
          s1[i][j] = __dp4a(a0[i], b1[j], s1[i][j]);
          s1[i][j] = __dp4a(a1[i], b0[j], s1[i][j]);
          if (!FAST) {
            s2[i][j] = __dp4a(a0[i], b2[j], s2[i][j]);
            s2[i][j] = __dp4a(a1[i], b1[j], s2[i][j]);
            s2[i][j] = __dp4a(a2[i], b0[j], s2[i][j]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + 16 * i;
    const float ra = row < a_rows ? sa[row] : 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + 16 * j;
      const float cb = col < b_rows ? sb[col] : 0.0f;
      float v = (float)s0[i][j] + (float)s1[i][j] * (1.0f / 256.0f);
      if (!FAST) v += (float)s2[i][j] * (1.0f / 65536.0f);
      m[i][j] = v * (ra * cb);
    }
  }
}

// Y_b = T0 @ X_b for one (64 x 64) tile of one batch entry b:
//   t_limbs (3, 3, n, kp), t_scales (3, n): T0 quantized per row;
//   x_limbs (3, 3, B, w, kp), x_scales (3, B, w): X_b TRANSPOSED (row v holds
//     column v of X_b, contiguous along the contraction) and quantized per
//     column of X_b;
//   yr, yi (B, n, w) f32: real and imaginary planes of Y.
// grid (ceil(w / BN), ceil(n / BM), B).
template <bool FAST>
__global__ void __launch_bounds__(THREADS)
row_limb_gemm_kernel(const int8_t* __restrict__ t_limbs,
                     const float* __restrict__ t_scales,
                     const int8_t* __restrict__ x_limbs,
                     const float* __restrict__ x_scales, float* __restrict__ yr,
                     float* __restrict__ yi, int batch, int n, int w, int kp) {
  __shared__ Slab sm;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long t_limb = (long)n * kp;
  const long x_limb = (long)batch * w * kp;
  float m[3][TM][TN];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    plane_product<FAST>(sm, t_limbs + p * 3 * t_limb, t_limb, n, t_scales + p * n,
                        x_limbs + p * 3 * x_limb + (long)b * w * kp, x_limb, w,
                        x_scales + ((long)p * batch + b) * w, kp, row0, col0,
                        m[p]);
  }
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= w) continue;
      const long o = ((long)b * n + row) * w + col;
      yr[o] = m[0][i][j] - m[1][i][j];
      yi[o] = m[2][i][j] - m[0][i][j] - m[1][i][j];
    }
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
__global__ void __launch_bounds__(THREADS)
row_requantize_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                      int8_t* __restrict__ y_limbs, float* __restrict__ y_scales,
                      int rows, int w, int kp) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (THREADS / 32) + warp;
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

// out[i, j] += sum_b w_b (er^2 + ei^2), E_b = Y_b @ T0^T from limb dots:
//   y_limbs (3, 3, B, n, kp), y_scales (3, B, n): Y rows quantized per row;
//   t_limbs (3, 3, n, kp), t_scales (3, n); weights (B,) f32;
//   out (n, n) f32, ADDED TO IN PLACE: the caller's running accumulator.
// One block per 64 x 64 output tile; the loop over b stays in the block and
// the field stack never reaches device memory. grid (ceil(n/BN), ceil(n/BM)).
template <bool FAST>
__global__ void __launch_bounds__(THREADS)
column_intensity_kernel(const int8_t* __restrict__ y_limbs,
                        const float* __restrict__ y_scales,
                        const int8_t* __restrict__ t_limbs,
                        const float* __restrict__ t_scales,
                        const float* __restrict__ weights,
                        float* __restrict__ out, int batch, int n, int kp) {
  __shared__ Slab sm;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long y_limb = (long)batch * n * kp;
  const long t_limb = (long)n * kp;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int b = 0; b < batch; ++b) {
    float m[3][TM][TN];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      plane_product<FAST>(sm, y_limbs + p * 3 * y_limb + (long)b * n * kp,
                          y_limb, n, y_scales + ((long)p * batch + b) * n,
                          t_limbs + p * 3 * t_limb, t_limb, n, t_scales + p * n,
                          kp, row0, col0, m[p]);
    }
    const float wb = weights[b];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float er = m[0][i][j] - m[1][i][j];
        const float ei = m[2][i][j] - m[0][i][j] - m[1][i][j];
        acc[i][j] += wb * (er * er + ei * ei);
      }
  }
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < n) out[(long)row * n + col] += acc[i][j];
    }
  }
}

inline dim3 tiles(int rows, int cols, int batch = 1) {
  return dim3((cols + BN - 1) / BN, (rows + BM - 1) / BM, batch);
}

}  // namespace

// Plain C interface for ctypes: pointers and the stream as void*, sizes as
// int; each returns cudaGetLastError() after its launch (0 = launched).
extern "C" {

int row_limb_gemm(const void* t_limbs, const void* t_scales,
                  const void* x_limbs, const void* x_scales, void* yr,
                  void* yi, int batch, int n, int w, int kp, int fast,
                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto tl = static_cast<const int8_t*>(t_limbs);
  auto ts = static_cast<const float*>(t_scales);
  auto xl = static_cast<const int8_t*>(x_limbs);
  auto xs = static_cast<const float*>(x_scales);
  auto o_r = static_cast<float*>(yr);
  auto o_i = static_cast<float*>(yi);
  if (fast)
    row_limb_gemm_kernel<true><<<tiles(n, w, batch), THREADS, 0, s>>>(
        tl, ts, xl, xs, o_r, o_i, batch, n, w, kp);
  else
    row_limb_gemm_kernel<false><<<tiles(n, w, batch), THREADS, 0, s>>>(
        tl, ts, xl, xs, o_r, o_i, batch, n, w, kp);
  return (int)cudaGetLastError();
}

int row_requantize(const void* yr, const void* yi, void* y_limbs,
                   void* y_scales, int rows, int w, int kp, void* stream) {
  const int per_block = THREADS / 32;
  row_requantize_kernel<<<(rows + per_block - 1) / per_block, THREADS, 0,
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
  auto s = static_cast<cudaStream_t>(stream);
  auto yl = static_cast<const int8_t*>(y_limbs);
  auto ys = static_cast<const float*>(y_scales);
  auto tl = static_cast<const int8_t*>(t_limbs);
  auto ts = static_cast<const float*>(t_scales);
  auto wt = static_cast<const float*>(weights);
  auto o = static_cast<float*>(out);
  if (fast)
    column_intensity_kernel<true><<<tiles(n, n), THREADS, 0, s>>>(
        yl, ys, tl, ts, wt, o, batch, n, kp);
  else
    column_intensity_kernel<false><<<tiles(n, n), THREADS, 0, s>>>(
        yl, ys, tl, ts, wt, o, batch, n, kp);
  return (int)cudaGetLastError();
}

}  // extern "C"
