// Flash-attention forward (K5) for Hopper (sm_90a).
//
// Replaces the TPU kernel _flash_bhnd (threestudio_3dgs_tpu/ops/flash_attention.py,
// kernel _kernel): O = softmax(Q K^T * scale) V for each (batch * head), forward
// only (the SDS denoiser is never differentiated), for the UNet's long
// self-attention: n = 4096 and 1024 tokens, head dimension 64 (SD 2.1,
// MVDream) or 40 (Stable Zero123's level 0), any d <= 64 with d % 8 == 0, as
// the TPU kernel takes any d % 8 == 0.  The TPU kernel
// keeps all of one head's K and V in VMEM and takes an exact row softmax; at
// n = 4096 that is far more than a block's shared memory, so both kernels here
// walk K and V in tiles with an online softmax (a running row max m and sum l
// in f32, the f32 output accumulator rescaled when the max grows).
//
// Arithmetic of the TPU kernel, kept by both: s = (q . k) * scale in f32;
// p = exp(s - m); l sums the unrounded p; p is rounded to the input type
// before p . v; the output o / l is written in the input type.  The max that
// shifts p is the running one, not the row's final max, which moves the
// rounding of p by at most one unit in the last place of the input type.
//
// Bound on the H100: operations.  The function does 4 bh n^2 d FLOPs on
// 4 bh n d elements of input and output (43 FLOP per byte at n = 4096 in
// bf16), so its bound is the tensor cores' 989 TFLOP/s.  At d = 64 the
// softmax's bh n^2 exponentials cost about as much again on the SFU (16 per
// clock per SM: 0.18 ms at (40, 4096) against the 0.17 ms tensor bound), so
// the exponentials of one warpgroup have to run while tensor-core work is in
// flight.
//
// bf16 (the UNet's type): flash_fwd_wgmma, both products on wgmma.
//  - Work unit: 64 * CONSUMERS query rows of one head.  A block has CONSUMERS
//    consumer warpgroups of 64 rows each and one producer warp, and walks
//    units persistently (one block per SM), so the producer loads the next
//    unit's Q and first K/V tiles while the consumers finish this one.  The
//    producer loads Q once per unit and K/V tiles of BN keys into a ring of
//    STAGES stages with TMA, each completion reported to an mbarrier (one for
//    K, one for V, so S can start before V lands); the consumers free a
//    stage, and Q, through two more.
//  - Tensor maps are 3-D (d, n, bh) with the 128-byte swizzle and boxes of
//    64 columns (one 128-byte bf16 row): a tile past a head's last row is
//    zero-filled, never the next head's rows, so any n >= 1 works; for
//    d < 64 the columns d..63 of every box are zero-filled too, so they add
//    exact zeros to Q K^T and leave O's columns d..63 at zero, and only the
//    first d are stored (the row stride, 2 d bytes, is a multiple of 16 for
//    d % 8 == 0, as TMA needs).  expect_tx counts the whole box, fill
//    included.  Keys >= n are masked to -inf before the row max; query rows
//    >= n are not stored.
//    cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint, so
//    the library links only the runtime.
//  - S = Q K^T: m64nBNk16 with Q and K read from shared memory (K-major, B128
//    descriptors, four k16 steps over d).  O += P V: P from registers (the
//    f32 accumulator fragment of S packed to bf16x2 is the A fragment of the
//    next wgmma), V from shared memory as a transposed (MN-major) B operand.
//    Both accumulate in f32.
//  - Overlap inside a warpgroup: at key tile j the warpgroup issues S_j and
//    then P_{j-1} V_{j-1}, waits for S_j alone and takes its softmax while
//    P V runs on the tensor cores.  Across warpgroups: they take turns to
//    issue their products, ordered by named barriers, so the
//    tensor cores run one warpgroup's products while the others take their
//    softmax.  The online softmax runs in registers: a row of the m64
//    accumulator is spread over the 4 threads of a quad (two shuffles for
//    the max; l is summed per thread and reduced once at the end).
//    log2(e) is folded into the scale and p = exp2(s_raw * c - m_raw * c),
//    c = scale * log2(e): one FFMA and one ex2 per score, p off exp(s - m)
//    by about one f32 ulp.  This takes scale > 0 (the max of the raw scores
//    is the max of the scaled ones).
//  - setmaxnreg moves registers from the producer warpgroup (24) to the
//    three consumers (160 each), in a single if/else split.
//  - d <= 64 with d % 8 == 0 is taken, padded to 64 as above; other d are
//    refused.  At Zero123's (64, 1024, 40) the exponentials bound the
//    kernel (the SFU floor, 0.018 ms, is above the padded MMA bound, 0.017),
//    so the padding costs next to nothing.
//  - Shape: three consumers (192 query rows), 128-key stages, a 3-deep ring,
//    turns, every exponential on the SFU: of the variants timed on the H100
//    the fastest at n = 4096 (PERF.md, section 6).  192 rows do not divide the
//    UNet's n: at n = 1024 a head takes 6 units (1152 rows, 11% padding).
//
// f32 (MVDream's UNet, half_precision_weights: false): flash_fwd_split, both
// products on bf16 wgmma over a three-way split.  One TF32 pass rounds q and
// k to 10-bit mantissas, far outside the f32 check's 2e-5, and the CUDA
// cores' 67 TFLOP/s hold a kernel there to at least 0.64 ms at (10, 4096).
//  - Split: x = b0 + b1 + b2, three bf16 planes (24 bits of mantissa), each
//    the round-to-nearest bf16 of what the earlier ones leave.  A product
//    of two f32 values is taken as the six plane products b_i b'_j with
//    i + j <= 2 (the three dropped ones are below 2^-24 of it), exact
//    products summed in f32, the smallest terms first: 12 bf16 products a
//    tile pair, a floor of 12 * 2 bh n^2 d / 989 TFLOP/s (0.26 ms at
//    (10, 4096, 64)).  At keys in rising norm (raw scores up to 240) it is
//    4-8e-6 from the float64 value on the card, 2.5-4x closer than the
//    plain twin, whose cuBLAS f32 product is 1.4-2.5e-5 from it (PERF.md,
//    section 6).
//  - split_planes, a pass inside the same call, writes q's, k's and v's
//    planes to the caller's scratch (9 bh n d bf16, 1.5x the inputs'
//    bytes); from there every plane is a bf16 (bh, n, d) tensor that the
//    bf16 kernel's swizzle and descriptors read unchanged (boxes 64 columns
//    wide, zero-filled past d), and one TMA load of a 4-D (d, n, bh, plane)
//    map brings a tile's three planes.
//  - flash_fwd_split is flash_fwd_wgmma's structure at other sizes: units
//    of 128 query rows (two consumer warpgroups), 64-key stages in a 3-deep
//    ring (Q 48 KB + 3 x 48 KB of K and V planes = 192 KB of shared memory;
//    S, a tile's P V, O and P's three planes are 32 + 32 + 32 + 48
//    registers a thread, and setmaxnreg gives the consumers 240).  S accumulates its 24 k16 steps in
//    one f32 accumulator (m64n64k16, Q and K from shared memory); p is split
//    in registers into three bf16x2 A fragments; a tile's P V takes its 24
//    steps (V as the transposed operand) in an accumulator of its own, from
//    zero, and is added to O in f32 on the CUDA cores, so no tensor-core
//    sum runs over more than 24 steps (O summed on the tensor cores over
//    every key tile came out 2.43e-5 from the plain twin at rising keys,
//    2.28e-5 this way).
//  - Softmax as the TPU kernel's, in f32: s = raw * scale before the row
//    max (any scale, negative too), p = expf(s - m), l of the unsplit p,
//    o / l written in f32.  Keys >= n are masked, query rows >= n are not
//    stored, and the 1-D persistent grid takes any bh.

#include <cuda.h>  // CUtensorMap and its enums; no driver function is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;  // columns of a box: head dimensions d <= 64 are zero-filled to it

// --------------------------------------------------------------- bf16 kernel

constexpr int BN = 128;                 // keys per K/V stage
constexpr int STAGES = 3;               // K/V ring depth
constexpr int CONSUMERS = 3;            // warpgroups of 64 query rows
constexpr int BM = 64 * CONSUMERS;      // query rows per block
constexpr int THREADS = (CONSUMERS + 1) * 128;
// registers per thread after setmaxnreg: the producer warpgroup gives up
// what the consumers take, within the SM's 65,536
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 160;
static_assert(128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS) <= 65536, "register budget");
constexpr int ROW_BYTES = D * 2;        // one bf16 box row of 64: the 128-byte swizzle width
constexpr int Q_BYTES = BM * ROW_BYTES;
constexpr int KV_BYTES = BN * ROW_BYTES;
constexpr int SMEM_BYTES = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + alignment slack
constexpr int S_REGS = BN / 2;          // f32 scores per thread: 64 rows x BN over 128 threads
constexpr int P_REGS = BN / 4;          // bf16x2 of p per thread

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one 64 x rows x 1 box of a (d, n, bh) tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int row, int head,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(head), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile whose rows are
// 128 bytes: 8-row swizzle atoms 1024 bytes apart (SBO); LBO is not read for
// a K-major operand of this swizzle, nor for an MN-major one of width 64
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Turns of the consumer warpgroups: warpgroup w issues its
// products between a wait on named barrier 1 + w and an arrive on the next
// warpgroup's, so one warpgroup's softmax runs while the next one's products
// take the tensor cores.  Barrier 0 is __syncthreads'.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
template <int C = CONSUMERS>
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % C) : "memory");
}

// keep the compiler from moving reads or writes of wgmma operands across the
// asynchronous issue and wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, f32) = a (64 x 16) b (16 x 128) (+ d where acc), both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, f32) += a (64 x 16, registers) b (16 x 64, shared memory, MN-major: imm-trans-b 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x BN) = Q (this warpgroup's 64 rows) K^T: four k16 steps of 32 bytes
// along the swizzled 128-byte rows
__device__ __forceinline__ void issue_qk(float (&s)[S_REGS], uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = sw128_desc(sq + kk * 32), db = sw128_desc(sk + kk * 32);
    wgmma_ss(s, da, db, kk > 0);
  }
}

// O (64 x 64) += P (64 x BN, registers) V (BN x 64): k16 steps of 16 keys,
// 2048 bytes apart; the A fragment of step kk is p of keys 16 kk .. 16 kk + 15
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[P_REGS], uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
    wgmma_rs(o, a, sw128_desc(sv + kk * 16 * ROW_BYTES));
  }
}

// Online softmax of one tile of raw scores, in place: s becomes p =
// exp2(s c - m c) with the updated running max m (raw units, per row half);
// l takes the tile's unrounded p after its rescale; returns the factors
// alpha = exp2((m_old - m_new) c) that O must be rescaled by.  Thread (g, t)
// of a warp holds rows g and g + 8 of its 16, columns 8 i + 2 t + {0, 1}.
// Keys at or past `valid` (a ragged last tile) are -inf before the max.
__device__ __forceinline__ void softmax_tile(float (&s)[S_REGS], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c, int valid, int t) {
  if (valid < BN) {
#pragma unroll
    for (int i = 0; i < S_REGS; ++i) {
      if (8 * (i / 4) + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
    }
  }
  // four partial maxima and sums per row half: short dependency chains
  float mx[2][4], ls[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int k = 0; k < 4; ++k) mx[h][k] = -INFINITY, ls[h][k] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < S_REGS; ++i) {
    const int h = (i >> 1) & 1, k = ((i >> 2) & 1) * 2 + (i & 1);
    mx[h][k] = fmaxf(mx[h][k], s[i]);
  }
  float mc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mh = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
    mh = fmaxf(m[h], mh);
    mh = fmaxf(mh, __shfl_xor_sync(0xffffffffu, mh, 1));
    mh = fmaxf(mh, __shfl_xor_sync(0xffffffffu, mh, 2));
    alpha[h] = ex2((m[h] - mh) * c);  // 0 on the first tile, where m = -inf
    m[h] = mh;
    mc[h] = mh * c;
  }
#pragma unroll
  for (int i = 0; i < S_REGS; ++i) {
    const int h = (i >> 1) & 1, k = ((i >> 2) & 1) * 2 + (i & 1);
    s[i] = ex2(fmaf(s[i], c, -mc[h]));
    ls[h][k] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ((ls[h][0] + ls[h][1]) + (ls[h][2] + ls[h][3]));
}

// p rounded to bf16, packed as the A fragments of the P V product
__device__ __forceinline__ void pack_p(const float (&s)[S_REGS], uint32_t (&pa)[P_REGS]) {
#pragma unroll
  for (int i = 0; i < P_REGS; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// Persistent: block b takes the work units b, b + gridDim.x, ...; unit u is
// query tile u % qtiles of head u / qtiles, so the blocks in flight share
// heads (and K/V in L2).  The producer runs ahead into the next unit (its Q
// once every consumer's last S has read the previous one, its K/V as stages
// free up), so one unit's last P V and output store overlap the next one's
// loads.  Ring stages and phases count K/V tiles across units.
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int n,
                    int bh, int d, float c) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 3 * STAGES];
  // 1024-byte aligned: the 128-byte swizzle repeats every 8 rows
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk0 = base + Q_BYTES;
  const uint32_t sv0 = sk0 + STAGES * KV_BYTES;
  const uint32_t full_q = smem_addr(&bars[0]), empty_q = full_q + 8;
  const uint32_t full_k0 = empty_q + 8, full_v0 = full_k0 + 8 * STAGES, empty0 = full_v0 + 8 * STAGES;
  const int tiles = (n + BN - 1) / BN;
  const int qtiles = (n + BM - 1) / BM;
  const long long units = (long long)qtiles * bh;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, CONSUMERS * 4);  // lane 0 of every consumer warp
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k0 + 8 * st, 1);
      mbar_init(full_v0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer warpgroup: one thread issues every TMA load
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * 128) {
      int kv = 0, round = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x, ++round) {
        const int head = (int)(u / qtiles), q0 = (int)(u % qtiles) * BM;
        if (round > 0) mbar_wait(empty_q, (round - 1) & 1);
        mbar_expect_tx(full_q, Q_BYTES);
        tma_load(sq, &tq, q0, head, full_q);
        for (int j = 0; j < tiles; ++j, ++kv) {
          const int st = kv % STAGES;
          if (kv >= STAGES) mbar_wait(empty0 + 8 * st, (kv / STAGES - 1) & 1);
          mbar_expect_tx(full_k0 + 8 * st, KV_BYTES);
          tma_load(sk0 + st * KV_BYTES, &tk, j * BN, head, full_k0 + 8 * st);
          mbar_expect_tx(full_v0 + 8 * st, KV_BYTES);
          tma_load(sv0 + st * KV_BYTES, &tv, j * BN, head, full_v0 + 8 * st);
        }
      }
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int t = lane % 4;
    const uint32_t sq_wg = sq + wg * 64 * ROW_BYTES;
    float acc[32], s[S_REGS];
#pragma unroll
    for (int i = 0; i < S_REGS; ++i) s[i] = 0.f;
    uint32_t pa[P_REGS];

    if (wg == CONSUMERS - 1) turn_pass(wg);  // the first turn is warpgroup 0's
    int kv = 0, round = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x, ++round) {
      const int head = (int)(u / qtiles), q0 = (int)(u % qtiles) * BM;
      const bool last_unit = u + gridDim.x >= units;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

      mbar_wait(full_q, round & 1);
      // tile 0: S_0 and its softmax
      mbar_wait(full_k0 + 8 * (kv % STAGES), (kv / STAGES) & 1);
      fence_regs(s);
      turn_wait(wg);
      wgmma_fence();
      issue_qk(s, sq_wg, sk0 + (kv % STAGES) * KV_BYTES);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(s);
      if (tiles == 1 && lane == 0) mbar_arrive(empty_q);  // Q is read
      softmax_tile(s, m, l, alpha, c, min(BN, n), t);
      pack_p(s, pa);

      for (int j = 1; j < tiles; ++j) {
        const int cur = kv + j, st = cur % STAGES, prev = (cur - 1) % STAGES;
        mbar_wait(full_k0 + 8 * st, (cur / STAGES) & 1);
        mbar_wait(full_v0 + 8 * prev, ((cur - 1) / STAGES) & 1);
        fence_regs(s);
        fence_regs(acc);
        fence_regs(pa);
        turn_wait(wg);
        wgmma_fence();
        issue_qk(s, sq_wg, sk0 + st * KV_BYTES);  // S_j
        wgmma_commit();
        issue_pv(acc, pa, sv0 + prev * KV_BYTES);  // O += P_{j-1} V_{j-1}
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<1>();  // S_j is done; P V still runs
        fence_regs(s);
        if (j == tiles - 1 && lane == 0) mbar_arrive(empty_q);  // Q is read
        softmax_tile(s, m, l, alpha, c, min(BN, n - j * BN), t);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
        pack_p(s, pa);
      }
      kv += tiles;
      const int last = (kv - 1) % STAGES;
      mbar_wait(full_v0 + 8 * last, ((kv - 1) / STAGES) & 1);
      fence_regs(acc);
      fence_regs(pa);
      turn_wait(wg);
      wgmma_fence();
      issue_pv(acc, pa, sv0 + last * KV_BYTES);
      wgmma_commit();
      // the block's last turn: nobody waits for another
      if (!(last_unit && wg == CONSUMERS - 1)) turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * last);

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
      const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= n) continue;
        __nv_bfloat16* dst = o + ((long long)head * n + row) * d + 2 * t;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (8 * i >= d) break;  // columns d..63 are the zero fill's
          *reinterpret_cast<uint32_t*>(dst + 8 * i) =
              pack_bf16(acc[4 * i + 2 * h] / l[h], acc[4 * i + 2 * h + 1] / l[h]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- f32 kernel

constexpr int PLANES = 3;               // bf16 planes of an f32 value
constexpr int F_BN = 64;                // keys per K/V stage
constexpr int F_STAGES = 3;             // K/V ring depth
constexpr int F_CONSUMERS = 2;          // warpgroups of 64 query rows
constexpr int F_BM = 64 * F_CONSUMERS;  // query rows per block
constexpr int F_THREADS = (F_CONSUMERS + 1) * 128;
constexpr int F_PRODUCER_REGS = 24;
constexpr int F_CONSUMER_REGS = 240;
static_assert(128 * (F_PRODUCER_REGS + F_CONSUMERS * F_CONSUMER_REGS) <= 65536, "register budget");
constexpr int F_Q_PLANE = F_BM * ROW_BYTES;   // one plane of a unit's Q
constexpr int F_KV_PLANE = F_BN * ROW_BYTES;  // one plane of a K or V stage
constexpr int F_Q_BYTES = PLANES * F_Q_PLANE;
constexpr int F_KV_BYTES = PLANES * F_KV_PLANE;
constexpr int F_SMEM_BYTES = F_Q_BYTES + 2 * F_STAGES * F_KV_BYTES + 1024;  // + alignment slack
constexpr int F_S_REGS = F_BN / 2;      // f32 scores per thread
constexpr int F_P_REGS = F_BN / 4;      // bf16x2 of one plane of p per thread
constexpr int TERMS = 6;                // plane products b_i b_j with i + j <= 2

// term t of a split product is a_i b_j with i = term_a(t), j = term_b(t):
// (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0), the smallest first
__device__ __forceinline__ constexpr int term_a(int t) { return t < 3 ? 2 - t : (t < 5 ? 4 - t : 0); }
__device__ __forceinline__ constexpr int term_b(int t) { return t < 3 ? t : (t < 5 ? t - 3 : 0); }

// x (count4 float4s) -> three bf16 planes b0 = bf16(x), b1 = bf16(x - b0),
// b2 = bf16(x - b0 - b1), round to nearest (both differences are exact in
// f32); blockIdx.y picks q, k or v, whose planes follow each other in out
__global__ void split_planes(const float4* __restrict__ q, const float4* __restrict__ k,
                             const float4* __restrict__ v, uint2* __restrict__ out,
                             long long count4) {
  const float4* x = blockIdx.y == 0 ? q : (blockIdx.y == 1 ? k : v);
  uint2* dst = out + (long long)blockIdx.y * PLANES * count4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 xv = x[i];
    float2 lo = make_float2(xv.x, xv.y), hi = make_float2(xv.z, xv.w);
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      const __nv_bfloat162 bl = __float22bfloat162_rn(lo), bh = __float22bfloat162_rn(hi);
      dst[p * count4 + i] = make_uint2(*reinterpret_cast<const uint32_t*>(&bl),
                                       *reinterpret_cast<const uint32_t*>(&bh));
      const float2 fl = __bfloat1622float2(bl), fh = __bfloat1622float2(bh);
      lo = make_float2(lo.x - fl.x, lo.y - fl.y);
      hi = make_float2(hi.x - fh.x, hi.y - fh.y);
    }
  }
}

// one 64 x rows x 1 x 3 box of a (d, n, bh, plane) tensor map: the three
// planes of `rows` rows, plane p at dst + p * rows * 128
__device__ __forceinline__ void tma_load_planes(uint32_t dst, const CUtensorMap* map, int row,
                                                int head, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(head), "r"(0), "r"(bar)
      : "memory");
}

template <int P, int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[P][R]) {
#pragma unroll
  for (int p = 0; p < P; ++p) fence_regs(r[p]);
}

// d (64 x 64, f32) = a (64 x 16, registers) b (16 x 64, shared memory,
// MN-major) (+ d where acc)
__device__ __forceinline__ void wgmma_rs_acc(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 64, f32) = a (64 x 16) b (16 x 64) (+ d where acc), both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// S (64 x 64) = sum over the six terms of Q_i K_j^T: 24 k16 steps into one
// accumulator, from zero, the smallest products first; sq is this
// warpgroup's rows of plane 0 (plane i F_Q_PLANE further), sk plane 0 of a
// K stage
__device__ __forceinline__ void issue_qk_split(float (&s)[F_S_REGS], uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int t = 0; t < TERMS; ++t) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss64(s, sw128_desc(sq + term_a(t) * F_Q_PLANE + kk * 32),
                 sw128_desc(sk + term_b(t) * F_KV_PLANE + kk * 32), t > 0 || kk > 0);
    }
  }
}

// O (64 x 64) = sum over the six terms of P_i V_j, from zero: P's planes
// from registers, V's from a stage as transposed operands, the smallest
// first
__device__ __forceinline__ void issue_pv_split(float (&o)[32], const uint32_t (&pa)[PLANES][F_P_REGS],
                                               uint32_t sv) {
#pragma unroll
  for (int t = 0; t < TERMS; ++t) {
#pragma unroll
    for (int kk = 0; kk < F_BN / 16; ++kk) {
      const uint32_t(&p)[F_P_REGS] = pa[term_a(t)];
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      wgmma_rs_acc(o, a, sw128_desc(sv + term_b(t) * F_KV_PLANE + kk * 16 * ROW_BYTES),
                   t > 0 || kk > 0);
    }
  }
}

// Online softmax of one tile of raw f32 scores, in place: s = raw * scale
// (any sign), keys at or past `valid` -inf, then p = exp(s - m) with the
// updated running max m (per row half), l takes the tile's p after its
// rescale; returns alpha = exp(m_old - m_new), which O must be rescaled by.
// Thread (g, t) of a warp holds rows g and g + 8 of its 16, columns
// 8 i + 2 t + {0, 1}.
__device__ __forceinline__ void softmax_tile_f32(float (&s)[F_S_REGS], float (&m)[2], float (&l)[2],
                                                 float (&alpha)[2], float scale, int valid, int t) {
#pragma unroll
  for (int i = 0; i < F_S_REGS; ++i) {
    s[i] *= scale;
    if (valid < F_BN && 8 * (i / 4) + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
  }
  float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int i = 0; i < F_S_REGS; ++i) {
    const int h = (i >> 1) & 1;
    mx[h][i & 1] = fmaxf(mx[h][i & 1], s[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mh = fmaxf(m[h], fmaxf(mx[h][0], mx[h][1]));
    mh = fmaxf(mh, __shfl_xor_sync(0xffffffffu, mh, 1));
    mh = fmaxf(mh, __shfl_xor_sync(0xffffffffu, mh, 2));
    alpha[h] = expf(m[h] - mh);  // 0 on the first tile, where m = -inf
    m[h] = mh;
  }
  float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < F_S_REGS; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = expf(s[i] - m[h]);
    ls[h][i & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + (ls[h][0] + ls[h][1]);
}

// p split into three bf16 planes, packed as the A fragments of P V
__device__ __forceinline__ void split_p(const float (&s)[F_S_REGS], uint32_t (&pa)[PLANES][F_P_REGS]) {
#pragma unroll
  for (int i = 0; i < F_P_REGS; ++i) {
    float2 r = make_float2(s[2 * i], s[2 * i + 1]);
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      const __nv_bfloat162 b = __float22bfloat162_rn(r);
      pa[p][i] = *reinterpret_cast<const uint32_t*>(&b);
      const float2 f = __bfloat1622float2(b);
      r = make_float2(r.x - f.x, r.y - f.y);
    }
  }
}

// The f32 kernel: flash_fwd_wgmma's structure (persistent units, a
// producer warp feeding a TMA ring, consumer warpgroups taking turns, S_j
// issued with P_{j-1} V_{j-1}) over the bf16 planes that split_planes
// wrote, each tensor map a (d, n, bh, plane) view, one TMA load bringing
// all three planes of a tile.
__global__ void __launch_bounds__(F_THREADS, 1)
    flash_fwd_split(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, float* __restrict__ o, int n, int bh,
                    int d, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 3 * F_STAGES];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk0 = base + F_Q_BYTES;
  const uint32_t sv0 = sk0 + F_STAGES * F_KV_BYTES;
  const uint32_t full_q = smem_addr(&bars[0]), empty_q = full_q + 8;
  const uint32_t full_k0 = empty_q + 8, full_v0 = full_k0 + 8 * F_STAGES,
                 empty0 = full_v0 + 8 * F_STAGES;
  const int tiles = (n + F_BN - 1) / F_BN;
  const int qtiles = (n + F_BM - 1) / F_BM;
  const long long units = (long long)qtiles * bh;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, F_CONSUMERS * 4);  // lane 0 of every consumer warp
    for (int st = 0; st < F_STAGES; ++st) {
      mbar_init(full_k0 + 8 * st, 1);
      mbar_init(full_v0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, F_CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == F_CONSUMERS) {
    regs_dec<F_PRODUCER_REGS>();
    if (threadIdx.x == F_CONSUMERS * 128) {
      int kv = 0, round = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x, ++round) {
        const int head = (int)(u / qtiles), q0 = (int)(u % qtiles) * F_BM;
        if (round > 0) mbar_wait(empty_q, (round - 1) & 1);
        mbar_expect_tx(full_q, F_Q_BYTES);
        tma_load_planes(sq, &tq, q0, head, full_q);
        for (int j = 0; j < tiles; ++j, ++kv) {
          const int st = kv % F_STAGES;
          if (kv >= F_STAGES) mbar_wait(empty0 + 8 * st, (kv / F_STAGES - 1) & 1);
          mbar_expect_tx(full_k0 + 8 * st, F_KV_BYTES);
          tma_load_planes(sk0 + st * F_KV_BYTES, &tk, j * F_BN, head, full_k0 + 8 * st);
          mbar_expect_tx(full_v0 + 8 * st, F_KV_BYTES);
          tma_load_planes(sv0 + st * F_KV_BYTES, &tv, j * F_BN, head, full_v0 + 8 * st);
        }
      }
    }
  } else {
    regs_inc<F_CONSUMER_REGS>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int t = lane % 4;
    const uint32_t sq_wg = sq + wg * 64 * ROW_BYTES;
    // acc: O of the tiles so far; pv: one tile's P V, summed from zero
    float acc[32], pv[32], s[F_S_REGS];
#pragma unroll
    for (int i = 0; i < F_S_REGS; ++i) s[i] = 0.f;
    uint32_t pa[PLANES][F_P_REGS];

    if (wg == F_CONSUMERS - 1) turn_pass<F_CONSUMERS>(wg);  // the first turn is warpgroup 0's
    int kv = 0, round = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x, ++round) {
      const int head = (int)(u / qtiles), q0 = (int)(u % qtiles) * F_BM;
      const bool last_unit = u + gridDim.x >= units;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

      mbar_wait(full_q, round & 1);
      mbar_wait(full_k0 + 8 * (kv % F_STAGES), (kv / F_STAGES) & 1);
      fence_regs(s);
      turn_wait(wg);
      wgmma_fence();
      issue_qk_split(s, sq_wg, sk0 + (kv % F_STAGES) * F_KV_BYTES);
      wgmma_commit();
      turn_pass<F_CONSUMERS>(wg);
      wgmma_wait<0>();
      fence_regs(s);
      if (tiles == 1 && lane == 0) mbar_arrive(empty_q);  // Q is read
      softmax_tile_f32(s, m, l, alpha, scale, min(F_BN, n), t);
      split_p(s, pa);

      for (int j = 1; j < tiles; ++j) {
        const int cur = kv + j, st = cur % F_STAGES, prev = (cur - 1) % F_STAGES;
        mbar_wait(full_k0 + 8 * st, (cur / F_STAGES) & 1);
        mbar_wait(full_v0 + 8 * prev, ((cur - 1) / F_STAGES) & 1);
        fence_regs(s);
        fence_regs(pv);
        fence_regs(pa);
        turn_wait(wg);
        wgmma_fence();
        issue_qk_split(s, sq_wg, sk0 + st * F_KV_BYTES);  // S_j
        wgmma_commit();
        issue_pv_split(pv, pa, sv0 + prev * F_KV_BYTES);  // P_{j-1} V_{j-1}
        wgmma_commit();
        turn_pass<F_CONSUMERS>(wg);
        wgmma_wait<1>();  // S_j is done; P V still runs
        fence_regs(s);
        if (j == tiles - 1 && lane == 0) mbar_arrive(empty_q);  // Q is read
        softmax_tile_f32(s, m, l, alpha, scale, min(F_BN, n - j * F_BN), t);
        wgmma_wait<0>();
        fence_regs(pv);
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = (acc[i] + pv[i]) * alpha[(i >> 1) & 1];
        split_p(s, pa);
      }
      kv += tiles;
      const int last = (kv - 1) % F_STAGES;
      mbar_wait(full_v0 + 8 * last, ((kv - 1) / F_STAGES) & 1);
      fence_regs(pv);
      fence_regs(pa);
      turn_wait(wg);
      wgmma_fence();
      issue_pv_split(pv, pa, sv0 + last * F_KV_BYTES);
      wgmma_commit();
      // the block's last turn: nobody waits for another
      if (!(last_unit && wg == F_CONSUMERS - 1)) turn_pass<F_CONSUMERS>(wg);
      wgmma_wait<0>();
      fence_regs(pv);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * last);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += pv[i];

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
      const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= n) continue;
        float* dst = o + ((long long)head * n + row) * d + 2 * t;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (8 * i >= d) break;  // columns d..63 are the zero fill's
          *reinterpret_cast<float2*>(dst + 8 * i) =
              make_float2(acc[4 * i + 2 * h] / l[h], acc[4 * i + 2 * h + 1] / l[h]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// (d, n, bh) bf16 map with boxes of (64, rows, 1), 128-byte swizzle, zero
// fill (of rows past n and, for d < 64, of columns past d)
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh, int n, int d,
                int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o, int bh, int n, int d,
                 float scale, cudaStream_t stream) {
  if (!(scale > 0.f) || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(encode, &tq, q, bh, n, d, BM) || !tensor_map(encode, &tk, k, bh, n, d, BN) ||
      !tensor_map(encode, &tv, v, bh, n, d, BN)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return (int)err;
  }
  const long long units = (long long)((n + BM - 1) / BM) * bh;
  const float c = (float)((double)scale * 1.4426950408889634);  // scale * log2(e)
  flash_fwd_wgmma<<<(unsigned)(units < sms ? units : sms), THREADS, SMEM_BYTES, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, n, bh, d, c);
  return (int)cudaGetLastError();
}

// (d, n, bh, plane) map of three bf16 planes of a (bh, n, d) tensor, one
// after the other, with boxes of (64, rows, 1, 3), 128-byte swizzle, zero
// fill (of rows past n and, for d < 64, of columns past d)
bool plane_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh, int n, int d,
               int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh, (cuuint64_t)PLANES};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2,
                                 (cuuint64_t)bh * n * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D, (cuuint32_t)rows, 1, (cuuint32_t)PLANES};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the split pass, then the kernel on its planes; scratch holds 9 bh n d bf16
int launch_split(const void* q, const void* k, const void* v, void* o, void* scratch, int bh, int n,
                 int d, float scale, cudaStream_t stream) {
  if (scratch == nullptr ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)scratch) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const long long count = (long long)bh * n * d;  // elements of one input, one plane
  const uint8_t* planes = (const uint8_t*)scratch;
  CUtensorMap tq, tk, tv;
  if (!plane_map(encode, &tq, planes, bh, n, d, F_BM) ||
      !plane_map(encode, &tk, planes + PLANES * count * 2, bh, n, d, F_BN) ||
      !plane_map(encode, &tv, planes + 2 * PLANES * count * 2, bh, n, d, F_BN)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_split, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         F_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return (int)err;
  }
  const long long count4 = count / 4, split_blocks = (count4 + 255) / 256;
  split_planes<<<dim3((unsigned)(split_blocks < 8 * sms ? split_blocks : 8 * sms), 3), 256, 0,
                 stream>>>((const float4*)q, (const float4*)k, (const float4*)v, (uint2*)scratch,
                           count4);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long units = (long long)((n + F_BM - 1) / F_BM) * bh;
  flash_fwd_split<<<(unsigned)(units < sms ? units : sms), F_THREADS, F_SMEM_BYTES, stream>>>(
      tq, tk, tv, (float*)o, n, bh, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: (bh, n, d) contiguous and 16-byte aligned, all bf16 (is_bf16
// = 1: the wgmma kernel, which also needs scale > 0; scratch unused) or all
// f32 (the split kernel, any scale; scratch: 9 bh n d bf16, 16-byte
// aligned, for the planes of q, k and v).  Head dims d <= 64 with d % 8 == 0.
int flash_attention_forward(const void* q, const void* k, const void* v, void* o, void* scratch,
                            int bh, int n, int d, float scale, int is_bf16, void* stream) {
  if (d <= 0 || d > D || d % 8 != 0 || bh < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (bh == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return launch_wgmma(q, k, v, o, bh, n, d, scale, s);
  return launch_split(q, k, v, o, scratch, bh, n, d, scale, s);
}

}  // extern "C"
