// Flash-attention forward (K5) for Hopper (sm_90a).
//
// Replaces the TPU kernel _flash_bhnd (threestudio_3dgs_tpu/ops/flash_attention.py,
// kernel _kernel): O = softmax(Q K^T * scale) V for each (batch * head), forward
// only (the SDS denoiser is never differentiated), for the UNet's long
// self-attention: n = 4096 and 1024 tokens, head dimension 64.
//
// Design.  The TPU kernel keeps all of one head's K and V resident in VMEM
// and takes an exact row softmax.  At n = 4096, d = 64 that is 1 MB in bf16,
// far more than a block's shared memory, so this kernel walks K and V in
// tiles of 64 keys with an online softmax: a running max m and sum l in f32
// and an f32 output accumulator, rescaled by exp(m_old - m_new) when the max
// grows.  One block of 64 threads per (bh, 64 query rows); each thread owns
// one query row, whose q, 64 scores and 64 output columns live in registers,
// so the softmax needs no exchange between threads.  Each K and V tile is
// staged in shared memory as f32 and read as float4 broadcasts: every thread
// of the block reads the same key row at the same time, so one shared-memory
// wavefront feeds four FMAs per thread.
//
// Arithmetic of the TPU kernel: s = (q . k) * scale in f32; p = exp(s - m);
// l sums the unrounded p; p is rounded to the input type before p . v; the
// output o / l is written in the input type.  Only the max that shifts p
// differs (the running max instead of the row's final max), which moves the
// rounding of p by at most one unit in the last place of the input type.
//
// Bound on the H100: operations.  The function does 4 bh n^2 d FLOPs on
// 4 bh n d elements of input and output (43 FLOP per byte at n = 4096 in
// bf16), so its bound is the tensor cores' 989 TFLOP/s.  This simple kernel
// runs on the CUDA cores in f32 (67 TFLOP/s peak) and cannot come within 15x
// of that bound; moving both products onto wgmma with TMA-fed tiles is the
// redesign that closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;  // query rows per block, one per thread
constexpr int BN = 64;  // keys per K/V tile
constexpr int D = 64;   // head dimension
constexpr int D4 = D / 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(BM)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int n, float scale) {
  __shared__ float4 k_s[BN][D4];
  __shared__ float4 v_s[BN][D4];
  const int tid = threadIdx.x;
  const long long head = (long long)blockIdx.y * n * D;
  const int row = blockIdx.x * BM + tid;
  const bool live = row < n;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = live ? to_f32(q[head + (long long)row * D + d]) : 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int t0 = 0; t0 < n; t0 += BN) {
    __syncthreads();  // every thread is done with the previous tile
    float* ks = reinterpret_cast<float*>(k_s);
    float* vs = reinterpret_cast<float*>(v_s);
    for (int i = tid; i < BN * D; i += BM) {
      const int key = t0 + i / D;
      const long long src = head + (long long)t0 * D + i;
      ks[i] = key < n ? to_f32(k[src]) : 0.f;
      vs[i] = key < n ? to_f32(v[src]) : 0.f;
    }
    __syncthreads();

    float s[BN];
#pragma unroll
    for (int j = 0; j < BN; ++j) s[j] = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < D4; ++d4) {
#pragma unroll
      for (int j = 0; j < BN; ++j) {
        const float4 kk = k_s[j][d4];
        s[j] = fmaf(qr[4 * d4 + 0], kk.x, s[j]);
        s[j] = fmaf(qr[4 * d4 + 1], kk.y, s[j]);
        s[j] = fmaf(qr[4 * d4 + 2], kk.z, s[j]);
        s[j] = fmaf(qr[4 * d4 + 3], kk.w, s[j]);
      }
    }

    const int valid = min(BN, n - t0);
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      s[j] *= scale;
      if (j < valid) m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);  // 0 on the first tile, where m = -inf
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float p = j < valid ? expf(s[j] - m_new) : 0.f;
      l += p;
      s[j] = to_f32(from_f32<T>(p));  // p . v in the input type
    }
#pragma unroll
    for (int j = 0; j < BN; ++j) {
#pragma unroll
      for (int d4 = 0; d4 < D4; ++d4) {
        const float4 vv = v_s[j][d4];
        acc[4 * d4 + 0] = fmaf(s[j], vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(s[j], vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(s[j], vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(s[j], vv.w, acc[4 * d4 + 3]);
      }
    }
    m = m_new;
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < D; ++d) o[head + (long long)row * D + d] = from_f32<T>(acc[d] / l);
}

}  // namespace

extern "C" {

// q, k, v, o: (bh, n, d) contiguous, all bf16 (is_bf16 = 1) or all f32.
// Only d = 64 is built; bh <= 65535 (the grid's y extent).
int flash_attention_forward(const void* q, const void* k, const void* v, void* o, int bh, int n,
                            int d, float scale, int is_bf16, void* stream) {
  if (d != D || bh > 65535) return (int)cudaErrorInvalidValue;
  if (bh == 0 || n == 0) return 0;
  const dim3 grid((n + BM - 1) / BM, bh);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    flash_fwd_kernel<__nv_bfloat16><<<grid, BM, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (__nv_bfloat16*)o, n, scale);
  } else {
    flash_fwd_kernel<float><<<grid, BM, 0, s>>>((const float*)q, (const float*)k,
                                                (const float*)v, (float*)o, n, scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
