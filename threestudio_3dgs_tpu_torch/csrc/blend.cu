// Tile blend, forward (K1) and backward (K2), for Hopper (sm_90a).
//
// Replaces the TPU kernels blend_forward_pallas / blend_backward_pallas
// (threestudio_3dgs_tpu/ops/rasterizer/blend_pallas.py).  Same function as
// the JAX twin blend_jax.py: front-to-back compositing of the depth-ordered
// pairs of each tile, alpha = min(0.99, opa * exp(power)), a pair skipped
// when power > 0 or alpha < 1/255, a pixel stopped once its inclusive
// transmittance would fall below 1e-4; output channel C is the weight sum.
//
// Design.  One thread per pixel.  A tile is cut into work units, one block
// each: 8 x 8 pixels in K1 (tile 32: 16 units, tile 16: 4) and 16 x 16 in
// K2 (4 and 1; larger, as each unit adds a scratch slice of the tile's
// rows), so several units share an SM and one heavy tile spreads over
// several SMs.  A small first kernel ranks the tiles by pair count, and the
// blend kernels take their units in that order (block b walks the units of
// the b / U-th heaviest tile): the heaviest units start first and the light
// ones fill in behind them.  Each warp owns an 8 x 4 patch of the unit, so
// its lanes stop at about the same pair.
//
// Pair rows (F = 6 + C floats: 40 B at C = 4, 52 B at C = 7; the copies
// are 4-byte, so any F keeps them aligned) are staged 32 at a time into
// shared memory with cp.async, double buffered, so batch b + 1 lands while batch
// b is evaluated.  In K1 every warp stages its own batches and leaves as
// soon as its 32 pixels have stopped: K1 has no block barrier at all.  In
// K2 the unit stages together and leaves when all its pixels have stopped.
// Each lane then tests one staged pair against its warp's patch
// (pair_reaches: the bounding box of the ellipse where alpha can reach
// 1/255, widened), and the warp walks only the pairs that pass, in order:
// a pair that fails would be skipped by eval_pair at every pixel of the
// patch, so the walk is unchanged.  The walk evaluates 4 (K1) or 3 (K2)
// pairs at once, since alpha does not depend on the transmittance, then
// updates T through them in order.  Both kernels evaluate alpha and T
// through one helper built from _rn intrinsics, so the backward replays
// exactly the forward's stop decisions whatever the compiler contracts
// elsewhere.
//
// K2's reduction.  A pair's F gradient terms are summed over the unit's
// pixels: per warp, the terms of kGroup = 32 / F walked pairs (3 pairs at
// C = 3, 4: 27 or 30 values; 2 at C = 5..8: 22-28 values; padded to 32)
// are reduce-scattered in 5 halving shuffle steps (31 shuffles per group;
// lane l ends with the warp's sum of value l), skipped when no lane of the
// warp took part; the 8 warps' sums are then added in warp order.
// A tile of several units is summed across units without float atomics:
// each unit writes its rows [start, stop) to its own slice of a scratch
// buffer (U, P, F), and the tile's last unit to finish (an integer arrival
// counter and __threadfence) adds the slices in unit order.  Every sum has
// a fixed order, so reruns are bitwise identical.
//
// Views.  The single-pass batched render stacks B views as tile rows of
// one (B grid_y, grid_x) grid; with view_grid_y = grid_y > 0 a tile's pixel
// row is ((tile / grid_x) % view_grid_y) ts + y, view-local like the
// pairs' means, so each tile blends exactly as in its view's own render.
//
// Channels.  C, the blended channels, is a template parameter: C = 4 (rgb
// + view depth) on the Gaussian renderers, 7 (+ face normals) on SuGaR's,
// 3 without depth; every C from 3 to 8 is built.
//
// Bound on the H100: neither bytes nor FLOPs.  K1 issues about 40
// instructions per (pixel, pair) evaluation on the CUDA cores and is
// latency bound in its heaviest warps (one dependent transmittance chain
// per pixel, hundreds of pairs long); K2 adds the gradient terms (about
// 80 instructions an evaluation) and 31 shuffles per group of 3 (C <= 4)
// or 2 pairs per warp.  The culling cuts the evaluations, the units and
// the order cut the imbalance across SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaMin = 0.003921568859368563f;  // float32(1 / 255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kMinChannels = 3;         // blended channels built: 3 .. 8
constexpr int kMaxChannels = 8;
constexpr int kFwdUnit = 8;             // a K1 work unit is kFwdUnit^2 pixels
constexpr int kBwdUnit = 16;            // a K2 work unit is kBwdUnit^2 pixels
constexpr int kFwdThreads = kFwdUnit * kFwdUnit;  // one thread per pixel
constexpr int kBwdThreads = kBwdUnit * kBwdUnit;
constexpr int kFwdWarps = kFwdThreads / 32;  // each an 8 x 4 patch
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBatch = 32;              // pairs staged at a time: one per lane
constexpr int kFwdUnroll = 4;           // pair evaluations a K1 thread issues together
constexpr int kFwdStages = 2;           // batches a K1 warp has in flight or staged
constexpr int kOrderThreads = 256;
constexpr int kOrderTiles = 64;         // tiles an order block ranks
constexpr unsigned kFull = 0xffffffffu;

struct PairEval {
  float dx, dy, gauss, alpha_raw, alpha;
  bool ok;
};

// power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy, evaluated without contraction.
__device__ __forceinline__ PairEval eval_pair(const float* f, float px, float py) {
  PairEval e;
  e.dx = __fsub_rn(px, f[0]);
  e.dy = __fsub_rn(py, f[1]);
  const float qa = __fmul_rn(__fmul_rn(f[2], e.dx), e.dx);
  const float qc = __fmul_rn(__fmul_rn(f[4], e.dy), e.dy);
  const float qb = __fmul_rn(__fmul_rn(f[3], e.dx), e.dy);
  const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
  e.gauss = expf(fminf(power, 0.0f));
  e.alpha_raw = __fmul_rn(f[5], e.gauss);
  e.ok = (power <= 0.0f) && (e.alpha_raw >= kAlphaMin);
  e.alpha = fminf(e.alpha_raw, kAlphaMax);
  return e;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Threads id, id + count, ... copy the rows [b0, min(b0 + kBatch, end)) of
// kF floats.
template <int kF>
__device__ __forceinline__ void stage_rows(float* dst, const float* feats, long long b0,
                                           long long end, int id, int count) {
  const int n = (int)min((long long)kBatch, end - b0) * kF;
  const float* src = feats + b0 * kF;
  for (int k = id; k < n; k += count) cp_async4(dst + k, src + k);
}

// The pixel of this thread in unit `sub` of `tile`: warp w covers the
// 8 x 4 patch at (8 (w % (UNIT / 8)), 4 (w / (UNIT / 8))) of the unit.
// Returns the pixel's index in the tile and sets its centre coordinates.
// With view_grid_y > 0 the grid stacks views of view_grid_y tile rows
// each, and the row is taken in its view (the mod on the integer row, so
// a pair's arithmetic is that of the single-view render).
template <int UNIT>
__device__ __forceinline__ int unit_pixel(int tile, int sub, int grid_x, int view_grid_y, int ts,
                                          float& px, float& py) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units_x = ts / UNIT;
  const int x = (sub % units_x) * UNIT + (warp % (UNIT / 8)) * 8 + (lane & 7);
  const int y = (sub / units_x) * UNIT + (warp / (UNIT / 8)) * 4 + (lane >> 3);
  const int row = view_grid_y > 0 ? (tile / grid_x) % view_grid_y : tile / grid_x;
  px = (float)((tile % grid_x) * ts + x);
  py = (float)(row * ts + y);
  return y * ts + x;
}

// False only when the pair's alpha stays below 1/255 on the whole pixel
// rectangle [x0, x1] x [y0, y1], so that eval_pair would skip it at every
// one of those pixels: alpha_raw <= opacity, and alpha_raw >= 1/255 needs
// d^T Q d <= r2 = 2 ln(255 opacity) for the conic Q = [a b; b c], an
// ellipse whose bounding box is |dx| <= sqrt(r2 c / det), |dy| <=
// sqrt(r2 a / det).  The test is made squared, without a division or a
// root, on the rectangle's distance from the centre less a pixel, with r2
// widened for the rounding of power (under 2% of d^T Q d while det > 1e-4
// a c) and of the fast log; a conic that is not that clearly positive
// definite (or NaN) is never culled.
__device__ __forceinline__ bool pair_reaches(const float* f, float x0, float y0, float x1,
                                             float y1) {
  const float opa = f[5];
  if (!(opa >= kAlphaMin)) return false;
  const float a = f[2], b = f[3], c = f[4];
  const float det = a * c - b * b;
  if (!(a > 0.0f && c > 0.0f && det > 1e-4f * a * c)) return true;
  const float r2 = 2.2f * __logf(255.0f * opa) + 0.05f;
  const float ex = fmaxf(fmaxf(x0 - f[0], f[0] - x1) - 1.0f, 0.0f);
  const float ey = fmaxf(fmaxf(y0 - f[1], f[1] - y1) - 1.0f, 0.0f);
  return ex * ex * det <= r2 * c && ey * ey * det <= r2 * a;
}

// Bit j of the result: pair j of the staged batch (rows of kF floats, nb
// pairs) may reach this warp's 8 x 4 patch, whose pixel (px, py) is this
// lane's.
template <int kF>
__device__ __forceinline__ unsigned patch_pairs(const float* rows, int nb, float px, float py) {
  const int lane = threadIdx.x & 31;
  const float x0 = px - (float)(lane & 7), y0 = py - (float)(lane >> 3);
  return __ballot_sync(kFull, lane < nb && pair_reaches(rows + lane * kF, x0, y0, x0 + 7.0f,
                                                        y0 + 3.0f));
}

// Takes the N lowest set bits of mask (in order) into idx; -1 past its end.
template <int N>
__device__ __forceinline__ void take_pairs(unsigned& mask, int (&idx)[N]) {
#pragma unroll
  for (int q = 0; q < N; ++q) {
    idx[q] = mask ? __ffs(mask) - 1 : -1;
    mask &= mask - 1;
  }
}

// order[r] = the tile with the r-th most pairs (ties by tile index), and
// the tiles' arrival counters zeroed when there are any.  A block ranks
// kOrderTiles tiles, each counted against a quarter of all tiles by each
// of four threads.
__global__ void __launch_bounds__(kOrderThreads) blend_order_kernel(
    const long long* __restrict__ ranges, int num_tiles, int* __restrict__ order,
    int* __restrict__ arrive) {
  constexpr int kParts = kOrderThreads / kOrderTiles;
  __shared__ int s_cnt[kOrderThreads];
  __shared__ int s_rank[kOrderThreads];
  const int t = blockIdx.x * kOrderTiles + threadIdx.x % kOrderTiles;
  const int part = threadIdx.x / kOrderTiles;
  const int c = t < num_tiles ? (int)(ranges[t + 1] - ranges[t]) : -1;
  int rank = 0;
  for (int s0 = 0; s0 < num_tiles; s0 += kOrderThreads) {
    __syncthreads();
    const int s = s0 + threadIdx.x;
    s_cnt[threadIdx.x] = s < num_tiles ? (int)(ranges[s + 1] - ranges[s]) : -1;
    __syncthreads();
    const int n = min(kOrderThreads, num_tiles - s0);
    for (int k = part; k < n; k += kParts) {
      const int o = s_cnt[k];
      rank += (o > c) || (o == c && s0 + k < t);
    }
  }
  s_rank[threadIdx.x] = rank;
  __syncthreads();
  if (part == 0 && t < num_tiles) {
#pragma unroll
    for (int p = 1; p < kParts; ++p) rank += s_rank[threadIdx.x + p * kOrderTiles];
    order[rank] = t;
    if (arrive) arrive[t] = 0;
  }
}

template <int kChannels>
__global__ void __launch_bounds__(kFwdThreads, 12) blend_fwd_kernel(
    const float* __restrict__ feats, const long long* __restrict__ ranges,
    const int* __restrict__ order, float* __restrict__ out, int units_per_tile, int grid_x,
    int view_grid_y, int ts) {
  constexpr int kF = 6 + kChannels;  // floats per pair row
  __shared__ __align__(16) float s_rows[kFwdWarps][kFwdStages][kBatch * kF];
  const int tile = order[blockIdx.x / units_per_tile];
  const int sub = blockIdx.x % units_per_tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float px, py;
  const int pix = unit_pixel<kFwdUnit>(tile, sub, grid_x, view_grid_y, ts, px, py);
  const long long start = ranges[tile];
  const long long end = ranges[tile + 1];

  float acc[kChannels + 1];
#pragma unroll
  for (int c = 0; c <= kChannels; ++c) acc[c] = 0.0f;
  float T = 1.0f;
  bool done = false;
  // a ring of kFwdStages batches, one commit group each: batch b is in
  // slot b % kFwdStages, and batches b + 1 .. b + kFwdStages - 1 are in
  // flight while it is walked
#pragma unroll
  for (int i = 0; i < kFwdStages - 1; ++i) {
    const long long b = start + (long long)i * kBatch;
    if (b < end) stage_rows<kF>(s_rows[warp][i], feats, b, end, lane, 32);
    cp_async_commit();
  }
  int slot = 0;
  for (long long b0 = start; b0 < end; b0 += kBatch, slot = (slot + 1) % kFwdStages) {
    // the batch kFwdStages - 1 ahead goes into the last batch's slot, which
    // every lane finished reading before the __syncwarp ending the last
    // iteration
    const long long ahead = b0 + (long long)(kFwdStages - 1) * kBatch;
    if (ahead < end)
      stage_rows<kF>(s_rows[warp][(slot + kFwdStages - 1) % kFwdStages], feats, ahead, end,
                     lane, 32);
    cp_async_commit();
    cp_async_wait<kFwdStages - 1>();
    __syncwarp();
    const float* rows = s_rows[warp][slot];
    unsigned todo = patch_pairs<kF>(rows, (int)min((long long)kBatch, end - b0), px, py);
    while (todo) {
      // the pairs' evaluations do not depend on the transmittance: issue
      // kFwdUnroll of them together, then walk T through them in order
      int idx[kFwdUnroll];
      take_pairs(todo, idx);
      PairEval e[kFwdUnroll];
#pragma unroll
      for (int q = 0; q < kFwdUnroll; ++q) e[q] = eval_pair(rows + max(idx[q], 0) * kF, px, py);
#pragma unroll
      for (int q = 0; q < kFwdUnroll; ++q) {
        if (idx[q] < 0 || done || !e[q].ok) continue;
        const float t_next = __fmul_rn(T, __fsub_rn(1.0f, e[q].alpha));
        if (t_next < kTEps) {
          done = true;
          continue;
        }
        const float w = __fmul_rn(e[q].alpha, T);
        const float* f = rows + idx[q] * kF;
#pragma unroll
        for (int c = 0; c < kChannels; ++c) acc[c] += w * f[6 + c];
        acc[kChannels] += w;
        T = t_next;
      }
      if (__all_sync(kFull, done)) break;
    }
    if (__all_sync(kFull, done)) break;  // this warp's pixels have all stopped
    __syncwarp();
  }
  cp_async_wait<0>();
  float* o = out + ((long long)tile * ts * ts + pix) * (kChannels + 1);
#pragma unroll
  for (int c = 0; c <= kChannels; ++c) o[c] = acc[c];
}

// One halving step over the live values v[0, 2H): a lane keeps one half,
// sends the other to lane ^ H and adds that lane's copy of the half it keeps.
template <int H>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

// Sums v over the warp: lane l returns the sum of v[l] (31 shuffles).
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32], int lane) {
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  return v[0];
}

// partial (U, P, F), stops (T, U) and arrive (T,) are used only when a tile
// has more than one unit (U > 1); with U = 1 the unit writes d_feats.
template <int kChannels>
__global__ void __launch_bounds__(kBwdThreads, 2) blend_bwd_kernel(
    const float* __restrict__ feats, const long long* __restrict__ ranges,
    const int* __restrict__ order, const float* __restrict__ out,
    const float* __restrict__ g_out, float* __restrict__ d_feats, float* __restrict__ partial,
    long long* __restrict__ stops, int* __restrict__ arrive, long long n_pairs,
    int units_per_tile, int grid_x, int view_grid_y, int ts) {
  constexpr int kF = 6 + kChannels;  // floats per pair row
  constexpr int kGroup = 32 / kF;    // pairs per reduce-scatter: 3 at C <= 4, else 2
  static_assert((kGroup == 2 || kGroup == 3) && kGroup * kF <= 32,
                "a reduce-scatter group of 2 or 3 pairs must fit one warp");
  __shared__ __align__(16) float s_rows[2][kBatch * kF];
  __shared__ float s_part[kBwdWarps][kBatch * kF];  // per warp: its sum of each row
  __shared__ int s_last;
  const int tile = order[blockIdx.x / units_per_tile];
  const int sub = blockIdx.x % units_per_tile;
  const long long start = ranges[tile];
  const long long end = ranges[tile + 1];
  if (start >= end) return;  // the whole block: nothing to write
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float px, py;
  const int pix = unit_pixel<kBwdUnit>(tile, sub, grid_x, view_grid_y, ts, px, py);
  const long long po = ((long long)tile * ts * ts + pix) * (kChannels + 1);
  float g[kChannels + 1];
  float u_tot = 0.0f;
#pragma unroll
  for (int c = 0; c <= kChannels; ++c) {
    g[c] = g_out[po + c];
    u_tot += g[c] * out[po + c];
  }
  float* dst = units_per_tile == 1 ? d_feats : partial + (long long)sub * n_pairs * kF;

  float T = 1.0f;
  float prefix = 0.0f;
  bool done = false;
  stage_rows<kF>(s_rows[0], feats, start, end, threadIdx.x, kBwdThreads);
  cp_async_commit();
  long long stop = start;  // rows [start, stop) of dst written
  int buf = 0;
  for (long long b0 = start; b0 < end; b0 += kBatch, buf ^= 1) {
    // buf ^ 1 held the last batch, read before that batch's second barrier
    if (b0 + kBatch < end)
      stage_rows<kF>(s_rows[buf ^ 1], feats, b0 + kBatch, end, threadIdx.x, kBwdThreads);
    cp_async_commit();
    cp_async_wait<1>();
    // the batch's rows are visible, s_part is free, and the unit leaves
    // once every pixel has stopped
    if (__syncthreads_and(done)) break;
    const int nb = (int)min((long long)kBatch, end - b0);
    const float* rows = s_rows[buf];
    float* part = s_part[warp];
    for (int k = lane; k < nb * kF; k += 32) part[k] = 0.0f;
    __syncwarp();
    // the pairs that may reach the warp's patch, kGroup at a time: their
    // evaluations first (independent of T), then the walk in order, then
    // one reduce-scatter of the group's terms, skipped when no lane took
    // part; lane l's sum is term l % F of the group's pair l / F
    unsigned todo = __all_sync(kFull, done) ? 0u : patch_pairs<kF>(rows, nb, px, py);
    while (todo) {
      int idx[kGroup];
      take_pairs(todo, idx);
      PairEval ev[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) ev[q] = eval_pair(rows + max(idx[q], 0) * kF, px, py);
      float v[32];
      bool took_part = false;
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        float* d = v + q * kF;
#pragma unroll
        for (int k = 0; k < kF; ++k) d[k] = 0.0f;
        const PairEval& e = ev[q];
        const float* f = rows + max(idx[q], 0) * kF;
        if (idx[q] >= 0 && !done && e.ok) {
          const float t_next = __fmul_rn(T, __fsub_rn(1.0f, e.alpha));
          if (t_next < kTEps) {
            done = true;
          } else {
            const float w = __fmul_rn(e.alpha, T);
            float u = g[kChannels];
#pragma unroll
            for (int c = 0; c < kChannels; ++c) u += f[6 + c] * g[c];
            prefix += u * w;
            const float suffix = u_tot - prefix;
            const float d_alpha = u * T - suffix / fmaxf(1.0f - e.alpha, 1e-6f);
            if (e.alpha_raw < kAlphaMax) {
              const float d_power = f[5] * e.gauss * d_alpha;
              d[0] = d_power * (f[2] * e.dx + f[3] * e.dy);
              d[1] = d_power * (f[4] * e.dy + f[3] * e.dx);
              d[2] = d_power * (-0.5f * e.dx * e.dx);
              d[3] = d_power * (-e.dx * e.dy);
              d[4] = d_power * (-0.5f * e.dy * e.dy);
              d[5] = e.gauss * d_alpha;
            }
#pragma unroll
            for (int c = 0; c < kChannels; ++c) d[6 + c] = w * g[c];
            T = t_next;
            took_part = true;
          }
        }
      }
#pragma unroll
      for (int k = kGroup * kF; k < 32; ++k) v[k] = 0.0f;
      if (__any_sync(kFull, took_part)) {
        const float s = warp_reduce_scatter(v, lane);
        const int q = lane / kF;
        int row;
        if constexpr (kGroup == 3) {
          row = q == 0 ? idx[0] : (q == 1 ? idx[1] : idx[2]);
        } else {
          row = q == 0 ? idx[0] : idx[1];
        }
        if (q < kGroup && row >= 0) part[row * kF + lane - q * kF] = s;
      }
      if (__all_sync(kFull, done)) break;
    }
    __syncthreads();
    // the unit's row sums, warps in order; each row written once
    for (int idx = threadIdx.x; idx < nb * kF; idx += kBwdThreads) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) s += s_part[w][idx];
      dst[b0 * kF + idx] = s;
    }
    stop = b0 + nb;
  }
  cp_async_wait<0>();
  if (units_per_tile == 1) return;

  // Several units: the last to arrive sums the tile's slices in unit order.
  if (threadIdx.x == 0) stops[(long long)tile * units_per_tile + sub] = stop;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrive + tile, 1) == units_per_tile - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long* tile_stops = stops + (long long)tile * units_per_tile;
  long long reach = start;
  for (int u = 0; u < units_per_tile; ++u) reach = max(reach, __ldcg(tile_stops + u));
  for (long long p = start * kF + threadIdx.x; p < reach * kF; p += kBwdThreads) {
    const long long row = p / kF;
    float s = 0.0f;
    for (int u = 0; u < units_per_tile; ++u) {
      if (row < __ldcg(tile_stops + u)) s += __ldcg(partial + u * n_pairs * kF + p);
    }
    d_feats[p] = s;
  }
}

// Tiles 16 and 32 (the units divide them) and C = 3 .. 8 are built.
bool supported(int tile_size, int n_channels) {
  return (tile_size == 16 || tile_size == 32) && n_channels >= kMinChannels &&
         n_channels <= kMaxChannels;
}

template <int kChannels>
void launch_fwd(const float* feats, const long long* ranges, const int* order, float* out,
                int blocks, int units, int grid_x, int view_grid_y, int tile_size,
                cudaStream_t s) {
  blend_fwd_kernel<kChannels><<<blocks, kFwdThreads, 0, s>>>(feats, ranges, order, out, units,
                                                             grid_x, view_grid_y, tile_size);
}

template <int kChannels>
void launch_bwd(const float* feats, const long long* ranges, const int* order, const float* out,
                const float* g_out, float* d_feats, float* partial, long long* stops,
                int* arrive, long long n_pairs, int blocks, int units, int grid_x,
                int view_grid_y, int tile_size, cudaStream_t s) {
  blend_bwd_kernel<kChannels><<<blocks, kBwdThreads, 0, s>>>(
      feats, ranges, order, out, g_out, d_feats, partial, stops, arrive, n_pairs, units, grid_x,
      view_grid_y, tile_size);
}

// Calls LAUNCH<C>(args...) for the runtime channel count C (supported()
// checked first).
#define DISPATCH_CHANNELS(C, LAUNCH, ...) \
  switch (C) {                            \
    case 3: LAUNCH<3>(__VA_ARGS__); break; \
    case 4: LAUNCH<4>(__VA_ARGS__); break; \
    case 5: LAUNCH<5>(__VA_ARGS__); break; \
    case 6: LAUNCH<6>(__VA_ARGS__); break; \
    case 7: LAUNCH<7>(__VA_ARGS__); break; \
    default: LAUNCH<8>(__VA_ARGS__); break; \
  }

cudaError_t launch_order(const long long* ranges, int num_tiles, int* order, int* arrive,
                         cudaStream_t stream) {
  const int blocks = (num_tiles + kOrderTiles - 1) / kOrderTiles;
  blend_order_kernel<<<blocks, kOrderThreads, 0, stream>>>(ranges, num_tiles, order, arrive);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// feats (P, 6+C) f32; ranges (T+1,) i64; out (T, ts*ts, C+1) f32; order
// (T,) i32 scratch.  view_grid_y: 0 for one view, else the tile rows of
// each view stacked in the grid (a divisor of num_tiles / grid_x).
int blend_forward(const void* feats, const void* ranges, void* out, void* order, int num_tiles,
                  int grid_x, int view_grid_y, int tile_size, int n_channels, void* stream) {
  if (!supported(tile_size, n_channels) || view_grid_y < 0) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_order((const long long*)ranges, num_tiles, (int*)order, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  const int units = (tile_size / kFwdUnit) * (tile_size / kFwdUnit);
  DISPATCH_CHANNELS(n_channels, launch_fwd, (const float*)feats, (const long long*)ranges,
                    (const int*)order, (float*)out, num_tiles * units, units, grid_x, view_grid_y,
                    tile_size, s);
  return (int)cudaGetLastError();
}

// d_feats (P, 6+C) f32 must be zero-filled: rows a tile never reached stay
// 0.  view_grid_y as in blend_forward.  Scratch: order (T,) i32 always;
// with more than one unit a tile (tile 32): partial (U, P, F) f32, stops
// (T, U) i64, arrive (T,) i32.
int blend_backward(const void* feats, const void* ranges, const void* out, const void* g_out,
                   void* d_feats, void* partial, void* stops, void* arrive, void* order,
                   long long n_pairs, int num_tiles, int grid_x, int view_grid_y, int tile_size,
                   int n_channels, void* stream) {
  if (!supported(tile_size, n_channels) || view_grid_y < 0) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int units = (tile_size / kBwdUnit) * (tile_size / kBwdUnit);
  cudaError_t err = launch_order((const long long*)ranges, num_tiles, (int*)order,
                                 units > 1 ? (int*)arrive : nullptr, s);
  if (err != cudaSuccess) return (int)err;
  DISPATCH_CHANNELS(n_channels, launch_bwd, (const float*)feats, (const long long*)ranges,
                    (const int*)order, (const float*)out, (const float*)g_out, (float*)d_feats,
                    (float*)partial, (long long*)stops, (int*)arrive, n_pairs,
                    num_tiles * units, units, grid_x, view_grid_y, tile_size, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
