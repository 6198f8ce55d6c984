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
// With view_grid_y > 0 (the batched render's grid of views stacked as
// tile rows, the means view-local) that test takes the tile's row in its
// view, ty % view_grid_y; the tile id stays the stacked one.
//
// Design: pair-parallel and load-balanced, the "expand" pattern of CUB
// and moderngpu.  The grid spans the pairs, never the slot capacity: block
// b owns pairs [512 b, 512 (b + 1)), one per thread twice over, so
// consecutive threads write consecutive pairs of every output.  (Two pairs
// a thread are as fast as four at a million pairs and spread a training
// view's 26k pairs over twice the SMs; one a thread is 9% slower at a
// million.)  Two warps find the block's first and last slot in the
// monotone offsets with a 32-way search (4 rounds of one load per lane
// over a million slots).  The block then stages the slots its range spans
// in shared memory, one coalesced offset and id and one 16-byte (x0, y0,
// w, mask) row per live Gaussian, and each thread binary-searches the
// staged offsets for its pair's slot.  The r-th set bit of a mask comes
// from five popcount halvings, not a walk over the earlier pairs.  The
// cull fields are read only for a rect with no mask.  Offsets whose span
// exceeds the stage (runs of empty slots inside the pair range, which
// binning never makes) are searched in device memory instead; the result
// is the same.
//
// The file is compiled with -fmad=false so the reachability test rounds
// exactly as the plain torch version does.
//
// Bound on the H100: bytes (each live slot's offset, id and fields read
// once, 20 bytes written per pair); the searches' dependent loads set the
// floor of a small launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaMin = 0.003921568859368563f;  // float32(1 / 255)
constexpr int kMaskNone = 1 << 24;
constexpr unsigned kMaskBits = (1u << 24) - 1u;  // bits a mask may set (MASK_K = 24)
constexpr int kExpandThreads = 256;
constexpr int kPairsPerThread = 2;
constexpr int kPairsPerBlock = kExpandThreads * kPairsPerThread;
constexpr unsigned kFull = 0xffffffffu;

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

// The last i in [lo, hi) with a[i] <= p, or lo when there is none: the
// slot that owns pair p in monotone exclusive offsets.  K4 and K6 search
// their staged offsets with it (and device memory for an oversized span).
template <typename T, typename I, typename V>
__device__ __forceinline__ I last_at_most(const T* a, I lo, I hi, V p) {
  while (hi - lo > 1) {
    const I mid = lo + (hi - lo) / 2;
    if ((V)a[mid] <= p) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The same search by a whole warp, 32 ways a round: every lane loads one
// candidate and the ballot keeps the last interval whose first offset is
// <= p.  All lanes return the result.
template <typename T>
__device__ __forceinline__ long long warp_last_at_most(const T* __restrict__ a, long long n,
                                                       long long p) {
  const int lane = threadIdx.x & 31;
  long long lo = 0;
  long long hi = n;  // the answer lies in [lo, hi); a[lo] <= p or lo == 0
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) / 32;
    const long long idx = lo + lane * step;
    const bool le = lane == 0 || (idx < hi && (long long)__ldg(a + idx) <= p);
    const unsigned votes = __ballot_sync(kFull, le);
    lo += (31 - __clz(votes)) * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

// Position of the (r+1)-th set bit of m, or -1 when m has fewer bits.
__device__ __forceinline__ int nth_set_bit(unsigned m, int r) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const unsigned low = m & ((1u << width) - 1u);
    const int c = __popc(low);
    if (r >= c) {
      r -= c;
      m >>= width;
      pos += width;
    } else {
      m = low;
    }
  }
  return ((m & 1u) != 0u && r == 0) ? pos : -1;
}

__global__ void __launch_bounds__(kExpandThreads) expand_kernel(
    const long long* __restrict__ offsets, const long long* __restrict__ depth_order,
    const int4* __restrict__ rect,     // (N,) [x0, y0, w, mask]
    const float* __restrict__ cull,    // (N, 6) or null
    int* __restrict__ slot_out, int* __restrict__ gauss_out, int* __restrict__ tile_out,
    long long* __restrict__ key_out, long long n, long long n_pairs, int grid_x,
    int view_grid_y, int tile_size, int num_tiles) {
  __shared__ long long s_bounds[2];
  __shared__ int s_rel[kPairsPerBlock];    // offsets[s0 + j] - p0
  __shared__ int s_gauss[kPairsPerBlock];  // depth_order[s0 + j]
  __shared__ int4 s_rect[kPairsPerBlock];  // rect[depth_order[s0 + j]]

  const long long p0 = (long long)blockIdx.x * kPairsPerBlock;
  const long long p_last = min(p0 + kPairsPerBlock, n_pairs) - 1;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long s = warp_last_at_most(offsets, n, warp == 0 ? p0 : p_last);
    if ((threadIdx.x & 31) == 0) s_bounds[warp] = s;
  }
  __syncthreads();
  const long long s0 = s_bounds[0];
  const long long s1 = s_bounds[1];
  const long long span = s1 - s0 + 1;
  const bool staged = span <= kPairsPerBlock;
  if (staged) {
    for (int j = threadIdx.x; j < (int)span; j += kExpandThreads) {
      const long long g = __ldg(depth_order + s0 + j);
      s_rel[j] = (int)(__ldg(offsets + s0 + j) - p0);
      s_gauss[j] = (int)g;
      s_rect[j] = __ldg(rect + g);
    }
  }
  __syncthreads();

  const float tsf = (float)tile_size;
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    const int q = k * kExpandThreads + threadIdx.x;  // pair p0 + q
    const long long p = p0 + q;
    if (p > p_last) break;
    long long i;
    int r, g;
    int4 rc;
    if (staged) {
      const int j = last_at_most(s_rel, 0, (int)span, q);
      i = s0 + j;
      r = q - s_rel[j];
      g = s_gauss[j];
      rc = s_rect[j];
    } else {
      i = last_at_most(offsets, s0, s1 + 1, p);
      r = (int)(p - offsets[i]);
      g = (int)depth_order[i];
      rc = __ldg(rect + g);
    }
    const int w = max(rc.z, 1);
    int tile;
    if (rc.w != kMaskNone) {
      const int bit = nth_set_bit((unsigned)rc.w & kMaskBits, r);
      tile = bit < 0 ? num_tiles : (rc.y + bit / w) * grid_x + rc.x + bit % w;
    } else {
      const int tx = rc.x + r % w;
      const int ty = rc.y + r / w;
      tile = ty * grid_x + tx;
      if (cull != nullptr) {
        const float2* cf = reinterpret_cast<const float2*>(cull + (long long)g * 6);
        const float2 m = __ldg(cf);
        const float2 ab = __ldg(cf + 1);
        const float2 co = __ldg(cf + 2);
        const int ty_view = view_grid_y > 0 ? ty % view_grid_y : ty;
        if (!tile_reachable((float)(tx * tile_size), (float)(ty_view * tile_size), tsf, m.x,
                            m.y, ab.x, ab.y, co.x, co.y)) {
          tile = num_tiles;
        }
      }
    }
    slot_out[p] = (int)i;
    gauss_out[p] = g;
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
// Bound on the H100: bytes (the offsets read once, 4 B per output).  A
// search of all N offsets per position is ceil(log2(N + 1)) dependent
// loads (20 at a million), so the design resolves positions against a
// window of the offsets in shared memory instead.
//
// Design: the block-range search of K4.  Block b owns positions
// [2048 b, 2048 (b + 1)).  Two warps find the block's first and last slot
// with the 32-way search, and the block stages the offsets between them
// (about 1,400 at the bench scene's 1.49 pairs a Gaussian; at most
// kSlotWindow) with coalesced loads.  Then each thread takes staged slots
// and writes slot j into the block's positions [offsets[j], offsets[j + 1])
// in shared memory (the expand pattern: no search; an empty slot, whose
// offsets are equal, writes nothing, so a run of them leaves each
// position to the last), and the block stores its 2048 slots, eight
// consecutive ones a thread as two 16-byte stores.  A window wider than
// the stage (a long run of empty Gaussians inside the block's range) is
// resolved by a binary search per position in device memory between the
// same two slots instead: the same answer, as for any monotone input.
constexpr int kSlotThreads = 256;
constexpr int kSlotsPerThread = 8;
constexpr int kSlotsPerBlock = kSlotThreads * kSlotsPerThread;
constexpr int kSlotWindow = 4096;  // staged offsets, 16 KB

__global__ void __launch_bounds__(kSlotThreads) expand_slots_kernel(
    const int* __restrict__ offsets, int* __restrict__ slot_out, long long n,
    long long max_pairs) {
  __shared__ long long s_bounds[2];
  __shared__ int s_win[kSlotWindow];       // offsets[s0 + j]
  __shared__ int s_out[kSlotsPerBlock];    // the slot of position p0 + q

  const long long p0 = (long long)blockIdx.x * kSlotsPerBlock;
  const long long p_last = min(p0 + kSlotsPerBlock, max_pairs) - 1;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long s = warp_last_at_most(offsets, n, warp == 0 ? p0 : p_last);
    if ((threadIdx.x & 31) == 0) s_bounds[warp] = s;
  }
  __syncthreads();
  const long long s0 = s_bounds[0];
  const long long span = n > 0 ? s_bounds[1] - s0 + 1 : 0;  // the slots of the block
  const bool staged = span <= kSlotWindow;
  const int count = (int)(p_last - p0 + 1);  // positions of the block
  if (staged) {
    for (int j = threadIdx.x; j < (int)span; j += kSlotThreads) s_win[j] = __ldg(offsets + s0 + j);
    if (span == 0) {  // no offsets: every position takes slot 0
      for (int q = threadIdx.x; q < count; q += kSlotThreads) s_out[q] = 0;
    }
    __syncthreads();
    // slot s0 + j owns [offsets[j], offsets[j + 1]) clipped to the block;
    // s0 also owns the positions before its offset (none before any offset)
    for (int j = threadIdx.x; j < (int)span; j += kSlotThreads) {
      const int lo = j == 0 ? 0 : (int)(s_win[j] - p0);
      const int hi = j + 1 < (int)span ? (int)(s_win[j + 1] - p0) : count;
      for (int q = lo; q < hi; ++q) s_out[q] = (int)(s0 + j);
    }
    __syncthreads();
  }

  const int q0 = threadIdx.x * kSlotsPerThread;
  if (q0 >= count) return;
  int out[kSlotsPerThread];
  long long j = 0;  // the previous position's slot, relative to s0 (device-memory search)
#pragma unroll
  for (int r = 0; r < kSlotsPerThread; ++r) {
    if (staged) {
      out[r] = q0 + r < count ? s_out[q0 + r] : 0;
    } else {
      j = last_at_most(offsets + s0, j, span, p0 + q0 + r);
      out[r] = (int)(s0 + j);
    }
  }
  if (q0 + kSlotsPerThread <= count) {
    int4* dst = reinterpret_cast<int4*>(slot_out + p0 + q0);
    dst[0] = make_int4(out[0], out[1], out[2], out[3]);
    dst[1] = make_int4(out[4], out[5], out[6], out[7]);
  } else {
#pragma unroll
    for (int r = 0; r < kSlotsPerThread; ++r) {
      if (q0 + r < count) slot_out[p0 + q0 + r] = out[r];
    }
  }
}

}  // namespace

extern "C" {

// offsets (N,) i32, monotone exclusive prefix; slot (max_pairs,) i32,
// 16-byte aligned.
int expand_slots(const void* offsets, void* slot, long long n, long long max_pairs,
                 void* stream) {
  if (max_pairs == 0) return 0;
  if (((uintptr_t)slot & 15u) != 0u) return (int)cudaErrorInvalidValue;
  const long long blocks = (max_pairs + kSlotsPerBlock - 1) / kSlotsPerBlock;
  expand_slots_kernel<<<(unsigned)blocks, kSlotThreads, 0, (cudaStream_t)stream>>>(
      (const int*)offsets, (int*)slot, n, max_pairs);
  return (int)cudaGetLastError();
}

// offsets, depth_order (N,) i64 in depth order, offsets the monotone
// exclusive prefix of the full pair counts, so pair p < n_pairs belongs to
// the last slot whose offset is <= p; rect (N, 4) i32 [x0, y0, w, mask]
// (16-byte aligned) and cull (N, 6) f32 [mx, my, ca, cb, cc, opa] in
// ORIGINAL Gaussian order; cull may be null.  view_grid_y: 0 for one view,
// else the tile rows of each view stacked in the grid.  Outputs
// (n_pairs,): slot/gauss/tile i32, key i64.
int expand_bin(const void* offsets, const void* depth_order, const void* rect,
               const void* cull, void* slot, void* gauss, void* tile, void* key, long long n,
               long long n_pairs, int grid_x, int view_grid_y, int tile_size, int num_tiles,
               void* stream) {
  if (n_pairs == 0) return 0;
  if (n == 0 || ((uintptr_t)rect & 15u) != 0u || view_grid_y < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_pairs + kPairsPerBlock - 1) / kPairsPerBlock;
  expand_kernel<<<(unsigned)blocks, kExpandThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)offsets, (const long long*)depth_order, (const int4*)rect,
      (const float*)cull, (int*)slot, (int*)gauss, (int*)tile, (long long*)key, n, n_pairs,
      grid_x, view_grid_y, tile_size, num_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
