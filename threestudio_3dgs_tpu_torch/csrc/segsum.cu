// Monotone segmented sum (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernel segsum_monotone_pallas
// (threestudio_3dgs_tpu/ops/rasterizer/segsum_pallas.py): the per-Gaussian
// sum of per-pair gradient rows that arrive sorted by Gaussian id, with the
// segment offsets known.
//
// Design.  A block owns a run of consecutive segments (1024 / F of them,
// rounded down to a multiple of 4: 100 at F = 10), so its (segments x F)
// outputs are one contiguous run and its input rows one contiguous run of
// vals.  It streams those rows through shared memory in chunks of 4096
// floats with 16-byte loads, all threads of the block loading side by
// side; then one thread per (segment, column) adds its segment's rows of
// the chunk in row order onto its running sum in shared memory, so a long
// segment is summed across chunks in row order.  No atomics: the result is
// deterministic and a rerun is bitwise identical.  The block writes its
// sums as one run of 16-byte stores.  A block whose segments hold no rows
// (the dead capacity of a training view) reads three numbers and writes
// zeros.  Index arithmetic inside a block is 32-bit.  (Runs twice as long
// are 9% faster at a million Gaussians of about 1.5 rows each, but 1.8x
// slower at a training view, whose live Gaussians hold about 7 rows: its
// few live blocks then take 4 chunks one after another.)
//
// Bound on the H100: bytes (each row read once, each sum written once).
// A very long segment still serialises on its F threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 1024;     // (segment, column) sums a block owns at most
constexpr int kMaxSegs = 512;    // segments a block owns at most
constexpr int kChunk = 4096;     // floats of rows staged at a time

// Stage vals[a, b) into rows (16-byte aligned), with 16-byte loads when
// vals is 16-byte aligned (then from a rounded down to a multiple of 4);
// returns where vals[a] landed.  Nothing at or past `total` is read.
__device__ __forceinline__ int stage_rows(float* __restrict__ rows,
                                          const float* __restrict__ vals, long long a,
                                          long long b, long long total) {
  const bool vec = ((uintptr_t)vals & 15u) == 0u;
  const long long base = vec ? (a & ~3LL) : a;
  const int n = (int)(b - base);
  if (vec) {
    const float4* src = reinterpret_cast<const float4*>(vals + base);
    float4* dst = reinterpret_cast<float4*>(rows);
    const int n4 = (n + 3) >> 2;
    for (int k = threadIdx.x; k < n4; k += kThreads) {
      const long long e = base + 4LL * k;
      if (e + 4 <= total) {
        dst[k] = __ldg(src + k);
      } else {
        for (int c = 0; c < 4 && e + c < total; ++c) rows[4 * k + c] = __ldg(vals + e + c);
      }
    }
  } else {
    for (int k = threadIdx.x; k < n; k += kThreads) rows[k] = __ldg(vals + base + k);
  }
  return (int)(a - base);
}

// Write `n` floats to dst: acc's (16-byte aligned) or zeros when acc is
// null, in 16-byte stores where dst is 16-byte aligned.
__device__ __forceinline__ void store_run(float* __restrict__ dst, const float* acc, int n) {
  int head = 0;
  if (((uintptr_t)dst & 15u) == 0u) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const float4* acc4 = reinterpret_cast<const float4*>(acc);
    for (int k = threadIdx.x; k < (n >> 2); k += kThreads) {
      dst4[k] = acc != nullptr ? acc4[k] : zero;
    }
    head = n & ~3;
  }
  for (int k = head + threadIdx.x; k < n; k += kThreads) {
    dst[k] = acc != nullptr ? acc[k] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads) segsum_kernel(
    const float* __restrict__ vals, const long long* __restrict__ offsets,
    const long long* __restrict__ counts, float* __restrict__ out, long long n_segments,
    int f, int segs_per_block, long long total_floats) {
  __shared__ __align__(16) float s_acc[kItems];
  __shared__ __align__(16) float s_rows[kChunk + 8];
  __shared__ int s_start[kMaxSegs];  // segment rows [start, end), block-relative
  __shared__ int s_end[kMaxSegs];

  const long long s0 = (long long)blockIdx.x * segs_per_block;
  const int nseg = (int)min((long long)segs_per_block, n_segments - s0);
  const int items = nseg * f;
  float* dst = out + s0 * f;
  const long long r0 = offsets[s0];
  const long long r1 = offsets[s0 + nseg - 1] + counts[s0 + nseg - 1];
  if (r1 <= r0) {  // every segment empty
    store_run(dst, nullptr, items);
    return;
  }
  for (int j = threadIdx.x; j < nseg; j += kThreads) {
    const int start = (int)(offsets[s0 + j] - r0);
    s_start[j] = start;
    s_end[j] = start + (int)counts[s0 + j];
  }
  for (int k = threadIdx.x; k < items; k += kThreads) s_acc[k] = 0.0f;

  const int rows = (int)(r1 - r0);
  const int chunk_rows = kChunk / f;
  for (int c0 = 0; c0 < rows; c0 += chunk_rows) {
    const int c1 = min(rows, c0 + chunk_rows);
    __syncthreads();  // the previous chunk is summed; the set-up is visible
    const int shift = stage_rows(s_rows, vals, (r0 + c0) * f, (r0 + c1) * f, total_floats);
    __syncthreads();
    for (int k = threadIdx.x; k < items; k += kThreads) {
      const int seg = k / f;
      const int col = k - seg * f;
      const int a = max(s_start[seg], c0);
      const int b = min(s_end[seg], c1);
      if (a >= b) continue;
      const float* src = s_rows + shift + (a - c0) * f + col;
      float s = s_acc[k];
      for (int r = a; r < b; ++r, src += f) s += *src;
      s_acc[k] = s;
    }
  }
  __syncthreads();
  store_run(dst, s_acc, items);
}

}  // namespace

extern "C" {

// Segments a block owns at F columns (1 <= F <= 1024): 1024 / F, at most
// 512, rounded down to a multiple of 4 so that each block's output run is
// 16-byte aligned.
int segsum_block_segments(int f) {
  const int segs = min(kItems / f, kMaxSegs);
  return segs >= 4 ? (segs & ~3) : segs;
}

// vals (P, F) f32, F <= 1024; offsets, counts (N,) i64 with segment i the
// rows [offsets[i], offsets[i] + counts[i]) and offsets[i + 1] =
// offsets[i] + counts[i]; out (N, F) f32.
int segsum_monotone(const void* vals, const void* offsets, const void* counts, void* out,
                    long long n_segments, int f, long long n_rows, void* stream) {
  if (n_segments == 0 || f == 0) return 0;
  if (f < 0 || f > kItems) return (int)cudaErrorInvalidValue;
  const int segs_per_block = segsum_block_segments(f);
  const long long blocks = (n_segments + segs_per_block - 1) / segs_per_block;
  segsum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const long long*)offsets, (const long long*)counts, (float*)out,
      n_segments, f, segs_per_block, n_rows * f);
  return (int)cudaGetLastError();
}

}  // extern "C"
