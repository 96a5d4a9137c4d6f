// Edge runs of a stochastic ensemble's cut lines: for each trial's field,
// the above-threshold runs of every cut line, counted, and on the lines of
// the row_step grid their subpixel rising and falling edges in float64.
//
// Replaces no TPU kernel. The JAX package (and the port before this file)
// copied every sampled cut line to the host and built the edge tables there
// with numpy (models/resist.py:feature_table). This kernel builds the same
// tables where the trials' fields are, so that the ensemble's statistics
// follow on the device and only per-trial numbers come back.
//
// Arithmetic: feature_table's, operation for operation in IEEE double
// (built with --fmad=false, so no product and sum contract into an fma):
//   rise = s > 0 ? (s - 1) + clip((thr - v[s-1]) / max(v[s] - v[s-1], 1e-30), 0, 1)
//                : s - 0.5
//   fall = e < n ? (e - 1) + clip((v[e-1] - thr) / max(v[e-1] - v[e], 1e-30), 0, 1)
//                : e - 0.5
// for a run [s, e) of pixels v > thr compared in float64, so every edge is
// the host's bit for bit. The run counts of every line compare in float32
// against the threshold rounded to nearest, as PyTorch's `fields > thr`
// does (models/stochastic.py:_run_counts), and equal its counts exactly.
//
// What bounds it on the H100: bytes. Each field is read once (the count
// pass reads every line, the table pass the sampled ones) and the table
// written once; the arithmetic is a compare a pixel and a few double
// operations an edge. Design: one warp a (trial, cut line); the line
// streams through in segments of 32 x 4 pixels, one 16-byte coalesced load
// a lane (4-byte loads when n is not a multiple of 4); each lane's first
// pixel takes its left neighbour from the lane before it by a shuffle (from
// the last segment for lane 0); the runs' slots come from a warp prefix
// sum of the lanes' rising edges. No shared memory, no atomics.
//
// Layouts (row-major, contiguous): fields float32 (trials, lines, n); runs
// int32 (trials, lines); counts int32 (trials, sampled); rise and fall
// float64 (trials, sampled, k), a line's slots past its count set to NaN;
// sampled = ceil(lines / row_step), sampled line r being line r * row_step.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__device__ __forceinline__ double clip01(double x) {
  return fmin(fmax(x, 0.0), 1.0);
}

// TABLE false: every line, its run count (float32 compare) into runs and,
// on the sampled lines, its float64 run count into counts.
// TABLE true: the sampled lines only, their first k runs' edges into rise
// and fall.
template <int V, bool TABLE>
__global__ void __launch_bounds__(kThreads)
edge_runs_kernel(const float* __restrict__ fields, int warps, int lines,
                 int n, int row_step, int sampled, double thr,
                 int* __restrict__ runs, int* __restrict__ counts,
                 double* __restrict__ rise, double* __restrict__ fall, int k) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= warps) return;  // uniform over the warp
  int t, l, r;
  if (TABLE) {
    t = warp / sampled;
    r = warp % sampled;
    l = r * row_step;
  } else {
    t = warp / lines;
    l = warp % lines;
    r = l / row_step;
  }
  const float* line = fields + ((size_t)t * lines + l) * n;
  const float thr32 = __double2float_rn(thr);
  double* rise_line = TABLE ? rise + ((size_t)t * sampled + r) * k : nullptr;
  double* fall_line = TABLE ? fall + ((size_t)t * sampled + r) * k : nullptr;

  // the pixel left of the segment: its value and whether it is above
  float carry_v = 0.0f;
  int carry32 = 0, carry64 = 0;
  int total32 = 0, total64 = 0;
  for (int c0 = lane * V; c0 - lane * V < n; c0 += 32 * V) {
    float v[V];
    const bool in = c0 < n;  // whole: V = 4 needs n % 4 == 0
    if constexpr (V == 4) {
      const float4 q = in ? *reinterpret_cast<const float4*>(line + c0)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      v[0] = in ? line[c0] : 0.0f;
    }
    int a32 = 0, a64 = 0;  // bit j: pixel c0 + j is above
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (in) {
        a32 |= (v[j] > thr32) << j;
        a64 |= ((double)v[j] > thr) << j;
      }
    }
    // left neighbours of this lane's first pixel
    float pv = __shfl_up_sync(kFull, v[V - 1], 1);
    int p32 = __shfl_up_sync(kFull, (a32 >> (V - 1)) & 1, 1);
    int p64 = __shfl_up_sync(kFull, (a64 >> (V - 1)) & 1, 1);
    if (lane == 0) { pv = carry_v; p32 = carry32; p64 = carry64; }
    const int starts64 = a64 & ~((a64 << 1) | p64);
    const int s64 = __popc(starts64);
    if (TABLE) {
      int incl = s64;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      int slot = total64 + incl - s64;  // this lane's first run
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = c0 + j;
        const double cur = v[j];
        const double prev = j == 0 ? (double)pv : (double)v[j - 1];
        const int above = (a64 >> j) & 1;
        const int left = j == 0 ? p64 : (a64 >> (j - 1)) & 1;
        if (in && above && !left) {
          const double edge =
              c > 0 ? (double)(c - 1) +
                          clip01((thr - prev) / fmax(cur - prev, 1e-30))
                    : (double)c - 0.5;
          if (slot < k) rise_line[slot] = edge;
          ++slot;
        } else if (in && !above && left) {  // a run ends at e = c
          const double edge =
              (double)(c - 1) + clip01((prev - thr) / fmax(prev - cur, 1e-30));
          if (slot - 1 < k) fall_line[slot - 1] = edge;
        }
      }
      total64 += __shfl_sync(kFull, incl, 31);
    } else {
      const int starts32 = a32 & ~((a32 << 1) | p32);
      total32 += __reduce_add_sync(kFull, __popc(starts32));
      total64 += __reduce_add_sync(kFull, s64);
    }
    carry_v = __shfl_sync(kFull, v[V - 1], 31);
    carry32 = __shfl_sync(kFull, (a32 >> (V - 1)) & 1, 31);
    carry64 = __shfl_sync(kFull, (a64 >> (V - 1)) & 1, 31);
  }
  if (TABLE) {
    // a run that reaches the line's end falls at e = n
    if (lane == 0 && n > 0 && (double)line[n - 1] > thr && total64 - 1 < k)
      fall_line[total64 - 1] = (double)n - 0.5;
    for (int s = total64 + lane; s < k; s += 32) {
      rise_line[s] = NAN;
      fall_line[s] = NAN;
    }
  } else if (lane == 0) {
    runs[(size_t)t * lines + l] = total32;
    if (l % row_step == 0) counts[(size_t)t * sampled + r] = total64;
  }
}

template <bool TABLE>
int issue(const float* fields, int trials, int lines, int n, int row_step,
          double thr, int* runs, int* counts, double* rise, double* fall,
          int k, cudaStream_t stream) {
  const int sampled = (lines + row_step - 1) / row_step;
  const long long warps = (long long)trials * (TABLE ? sampled : lines);
  if (warps <= 0) return 0;
  if (warps > (1LL << 31) / 32) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((warps * 32 + kThreads - 1) / kThreads);
  const bool vec = n % 4 == 0 && reinterpret_cast<size_t>(fields) % 16 == 0;
  if (vec)
    edge_runs_kernel<4, TABLE><<<blocks, kThreads, 0, stream>>>(
        fields, (int)warps, lines, n, row_step, sampled, thr, runs, counts,
        rise, fall, k);
  else
    edge_runs_kernel<1, TABLE><<<blocks, kThreads, 0, stream>>>(
        fields, (int)warps, lines, n, row_step, sampled, thr, runs, counts,
        rise, fall, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// k == 0: the count pass (runs of every line, counts of the sampled lines);
// k > 0: the table pass (rise and fall of the sampled lines, k slots each).
int edge_runs(const void* fields, int trials, int lines, int n, int row_step,
              double threshold, void* runs, void* counts, void* rise,
              void* fall, int k, void* stream) {
  if (trials < 0 || lines < 0 || n < 1 || row_step < 1 || k < 0)
    return (int)cudaErrorInvalidValue;
  auto* f = static_cast<const float*>(fields);
  auto s = static_cast<cudaStream_t>(stream);
  if (k == 0)
    return issue<false>(f, trials, lines, n, row_step, threshold,
                        static_cast<int*>(runs), static_cast<int*>(counts),
                        nullptr, nullptr, 0, s);
  return issue<true>(f, trials, lines, n, row_step, threshold, nullptr,
                     nullptr, static_cast<double*>(rise),
                     static_cast<double*>(fall), k, s);
}

}  // extern "C"
