// Pair expansion (K4) and the slot-only expand (K6, below) for Hopper
// (sm_90a).
//
// Replaces the TPU kernels expand_bin_pallas and expand_bin_pallas_packed
// (threestudio_3dgs_tpu/ops/rasterizer/expand_pallas.py).  For every
// (Gaussian, covered tile) pair it writes the depth slot, the Gaussian id,
// the tile id and the int64 tile-sort key (tile << 32) | slot:
//   * a Gaussian with a reachable-tile bitmask (rects of <= 24 tiles) maps
//     its r-th pair to the r-th set bit of the mask;
//   * otherwise pair r is tile (y0 + r / w, x0 + r % w) of the rect, and
//     with culling on it becomes tile `num_tiles` (sorted past every tile
//     range) when alpha cannot reach 1/255 anywhere inside that tile.
//
// Design.  One thread per depth-ranked Gaussian writes its pairs from
// offsets[i] on, the shape of the CUDA 3DGS duplicateWithKeys stage; the
// TPU's windowed merge scan and one-hot field select do not carry over.
// The file is compiled with -fmad=false so the reachability test rounds
// exactly as the plain torch version does.
//
// Bound on the H100: bytes (20 bytes written per pair); pair counts vary
// per Gaussian, so a thread with a large rect writes many pairs alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaMin = 0.003921568859368563f;  // float32(1 / 255)
constexpr int kMaskNone = 1 << 24;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Can alpha = opa * exp(-Q/2) reach 1/255 inside the pixel rect
// [x0, x0+ts-1] x [y0, y0+ts-1]?  Same operation order as the JAX
// _tile_reachable and the plain torch version.
__device__ __forceinline__ bool tile_reachable(float x0, float y0, float ts, float mx,
                                               float my, float ca, float cb, float cc,
                                               float opa) {
  const float x1 = x0 + (ts - 1.0f);
  const float y1 = y0 + (ts - 1.0f);
  const float dxe = clampf(mx, x0, x1) - mx;
  const float dye = clampf(my, y0, y1) - my;
  const float sa = fmaxf(ca, 1e-12f);
  const float sc = fmaxf(cc, 1e-12f);
  const float dy1 = clampf(-cb * dxe / sc, y0 - my, y1 - my);
  const float q1 = ca * dxe * dxe + 2.0f * cb * dxe * dy1 + cc * dy1 * dy1;
  const float dx2 = clampf(-cb * dye / sa, x0 - mx, x1 - mx);
  const float q2 = ca * dx2 * dx2 + 2.0f * cb * dx2 * dye + cc * dye * dye;
  const float qmin = fminf(q1, q2);
  return opa * expf(-0.5f * qmin) >= kAlphaMin;
}

__global__ void expand_kernel(const long long* __restrict__ offsets,
                              const long long* __restrict__ counts,
                              const long long* __restrict__ depth_order,
                              const int* __restrict__ x0s, const int* __restrict__ y0s,
                              const int* __restrict__ rect_w,
                              const float* __restrict__ cull,  // (N, 6) or null
                              const int* __restrict__ masks,   // (N,) or null
                              int* __restrict__ slot_out, int* __restrict__ gauss_out,
                              int* __restrict__ tile_out, long long* __restrict__ key_out,
                              long long n, int grid_x, int tile_size, int num_tiles) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long c = counts[i];
  if (c <= 0) return;
  const long long base = offsets[i];
  const long long g = depth_order[i];
  const int x0 = x0s[g];
  const int y0 = y0s[g];
  const int w = max(rect_w[g], 1);
  const int m = masks != nullptr ? masks[g] : kMaskNone;
  if (m != kMaskNone) {
    unsigned bits = (unsigned)m;
    for (long long r = 0; r < c; ++r) {
      int tile = num_tiles;
      if (bits != 0u) {
        const int j = __ffs(bits) - 1;
        bits &= bits - 1u;
        tile = (y0 + j / w) * grid_x + x0 + j % w;
      }
      const long long p = base + r;
      slot_out[p] = (int)i;
      gauss_out[p] = (int)g;
      tile_out[p] = tile;
      key_out[p] = ((long long)tile << 32) | i;
    }
    return;
  }
  float mx = 0.f, my = 0.f, ca = 0.f, cb = 0.f, cc = 0.f, opa = 0.f;
  if (cull != nullptr) {
    const float* cf = cull + g * 6;
    mx = cf[0];
    my = cf[1];
    ca = cf[2];
    cb = cf[3];
    cc = cf[4];
    opa = cf[5];
  }
  const float tsf = (float)tile_size;
  for (long long r = 0; r < c; ++r) {
    const int q = (int)(r / w);
    const int rem = (int)(r % w);
    const int tx = x0 + rem;
    const int ty = y0 + q;
    int tile = ty * grid_x + tx;
    if (cull != nullptr &&
        !tile_reachable((float)(tx * tile_size), (float)(ty * tile_size), tsf, mx, my, ca,
                        cb, cc, opa)) {
      tile = num_tiles;
    }
    const long long p = base + r;
    slot_out[p] = (int)i;
    gauss_out[p] = (int)g;
    tile_out[p] = tile;
    key_out[p] = ((long long)tile << 32) | i;
  }
}

// Slot-only monotone expand (K6).
//
// Replaces the TPU kernel expand_slots_pallas
// (threestudio_3dgs_tpu/ops/rasterizer/expand_pallas.py, kernel _kernel):
// for every pair position p < max_pairs, the last i with offsets[i] <= p
// (0 when there is none, N == 0 included), for monotone offsets.
//
// Design.  One thread per pair position binary-searches the offsets.  The
// TPU kernel counts offsets <= p inside a 768-entry window per 512-pair
// program on its vector unit; a search has no window, so it is right for
// every monotone input, runs of empty Gaussians of any length included.
//
// Bound on the H100: bytes (the offsets read once, 4 B per output); the
// search's ~log2(N) dependent loads per thread hit the L2 cache.
__global__ void expand_slots_kernel(const int* __restrict__ offsets, int* __restrict__ slot_out,
                                    long long n, long long max_pairs) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= max_pairs) return;
  // invariant: offsets[lo] <= p or lo == 0; offsets[hi] > p or hi == n
  long long lo = 0;
  long long hi = n;
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if ((long long)__ldg(offsets + mid) <= p) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  slot_out[p] = (int)lo;
}

}  // namespace

extern "C" {

// offsets (N,) i32, monotone exclusive prefix; slot (max_pairs,) i32.
int expand_slots(const void* offsets, void* slot, long long n, long long max_pairs,
                 void* stream) {
  if (max_pairs == 0) return 0;
  const int threads = 256;
  const long long blocks = (max_pairs + threads - 1) / threads;
  expand_slots_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)offsets, (int*)slot, n, max_pairs);
  return (int)cudaGetLastError();
}

// offsets, counts, depth_order (N,) i64 in depth order (counts already
// clipped to the pair capacity); x0, y0, rect_w, masks (N,) i32 and cull
// (N, 6) f32 [mx, my, ca, cb, cc, opa] in ORIGINAL Gaussian order; cull and
// masks may be null.  Outputs (P,): slot/gauss/tile i32, key i64.
int expand_bin(const void* offsets, const void* counts, const void* depth_order,
               const void* x0, const void* y0, const void* rect_w, const void* cull,
               const void* masks, void* slot, void* gauss, void* tile, void* key,
               long long n, int grid_x, int tile_size, int num_tiles, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  expand_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)offsets, (const long long*)counts, (const long long*)depth_order,
      (const int*)x0, (const int*)y0, (const int*)rect_w, (const float*)cull,
      (const int*)masks, (int*)slot, (int*)gauss, (int*)tile, (long long*)key, n, grid_x,
      tile_size, num_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
