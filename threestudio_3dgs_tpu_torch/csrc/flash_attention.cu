// Flash-attention forward (K5) for Hopper (sm_90a).
//
// Replaces the TPU kernel _flash_bhnd (threestudio_3dgs_tpu/ops/flash_attention.py,
// kernel _kernel): O = softmax(Q K^T * scale) V for each (batch * head), forward
// only (the SDS denoiser is never differentiated), for the UNet's long
// self-attention: n = 4096 and 1024 tokens, head dimension 64 (SD 2.1,
// MVDream), 40 (Stable Zero123's level 0) or 80 / 160 (its levels 1-2 when
// the conditioning image is 512^2); any d % 8 == 0 up to 256 in bf16 and 192
// in f32, as the TPU kernel takes any d % 8 == 0.  The TPU kernel
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
// Boxes.  A row of d columns is read as NB = ceil(d / 64) boxes of 64
// columns (one 128-byte bf16 row each, the 128-byte swizzle's width), each
// its own TMA load at column 64 b of a 3-D (d, n, bh) tensor map; the last
// box is zero-filled past d by TMA, so the padding adds exact zeros to
// Q K^T and leaves O's padded columns at zero, and only the first d columns
// are stored (the row stride, 2 d bytes, is a multiple of 16 for d % 8 == 0,
// as TMA needs).  A tile of R rows is NB slabs of R x 128 bytes, box b at
// b R 128.  S = Q K^T walks the k16 steps of every box, the zero fill's
// included; O = P V is one m64n64 accumulator a box.  Each
// kernel is a template over NB with its unit, key stage and ring depth
// picked per NB to fit the registers and the 227 KB of shared memory
// (bf16_shape / split_shape below).
//
// bf16 (the UNet's type): flash_fwd_wgmma, both products on wgmma.
//  - Work unit: 64 * CONS query rows of one head.  A block has CONS
//    consumer warpgroups of 64 rows each and one producer warp, and walks
//    units persistently (one block per SM), so the producer loads the next
//    unit's Q and first K/V tiles while the consumers finish this one.  The
//    producer loads Q once per unit and K/V tiles of BN keys into a ring of
//    STAGES stages with TMA, each completion reported to an mbarrier (one for
//    K, one for V, so S can start before V lands); the consumers free a
//    stage, and Q, through two more.
//  - A tile past a head's last row is zero-filled, never the next head's
//    rows, so any n >= 1 works.  expect_tx counts the whole boxes, fill
//    included.  Keys >= n are masked to -inf before the row max; query rows
//    >= n are not stored.
//    cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint, so
//    the library links only the runtime.
//  - S = Q K^T: m64nBNk16 with Q and K read from shared memory (K-major, B128
//    descriptors, four k16 steps a box).  O += P V: P from registers (the
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
//    consumers (160 each of three, 240 each of two), in a single if/else
//    split.
//  - Shape at d <= 64: three consumers (192 query rows), 128-key stages, a
//    3-deep ring, turns, every exponential on the SFU: of the variants timed
//    on the H100 the fastest at n = 4096 (PERF.md, section 6).  192 rows do
//    not divide the UNet's n: at n = 1024 a head takes 6 units (1152 rows,
//    11% padding).  At Zero123's (64, 1024, 40) the exponentials bound the
//    kernel (the SFU floor, 0.018 ms, is above the padded MMA bound, 0.017).
//  - d > 64: O holds 32 NB f32 a thread, so the unit shrinks to two
//    consumers (240 registers each); d <= 128 keeps 128-key stages in a
//    2-deep ring (160 KB), d <= 192 takes 64-key stages in a 3-deep ring
//    (192 KB), d <= 256 64-key stages in a 2-deep ring (192 KB).
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
//    bf16 kernel's swizzle and descriptors read unchanged, and one TMA load
//    of a 4-D (d, n, bh, plane) map brings the three planes of one box of a
//    tile (box b's plane p at (3 b + p) R 128).
//  - flash_fwd_split is flash_fwd_wgmma's structure at other sizes.  At
//    d <= 64: units of 128 query rows (two consumer warpgroups), 64-key
//    stages in a 3-deep ring (Q 48 KB + 3 x 48 KB of K and V planes = 192
//    KB of shared memory; S, a box's P V, O and P's three planes are 32 +
//    32 + 32 + 48 registers a thread, and setmaxnreg gives the consumers
//    240).  d <= 128: 32-key stages in a 2-deep ring (96 + 96 KB); d <= 192:
//    one consumer (64 rows), 32-key stages, 2-deep (72 + 144 KB).  S
//    accumulates its 24 k16 steps a box in one f32 accumulator (Q and K
//    from shared memory); p is split in registers into three bf16x2 A
//    fragments; a tile's P V takes its steps box by box (V as the
//    transposed operand) in an accumulator of its own, from zero, and is
//    added to that box of O in f32 on the CUDA cores, so no tensor-core sum
//    runs over more than 24 steps (O summed on the tensor cores over every
//    key tile came out 2.43e-5 from the plain twin at rising keys, 2.28e-5
//    this way).  The first box's P V overlaps the softmax; the others are
//    issued after it, one at a time.
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

constexpr int BOX = 64;          // columns of a box
constexpr int ROW_BYTES = 128;   // one bf16 box row: the 128-byte swizzle width
constexpr int MAX_BOXES_BF16 = 4;  // d <= 256
constexpr int MAX_BOXES_F32 = 3;   // d <= 192
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on the H100
constexpr int PRODUCER_REGS = 24;

// registers per consumer thread after setmaxnreg: the producer warpgroup
// gives up what the consumers take, within the SM's 65,536
template <int CONS>
__host__ __device__ constexpr int consumer_regs() {
  return CONS >= 3 ? 160 : 240;
}

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

// one 64 x rows x 1 box of a (d, n, bh) tensor map, at column col, into
// shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         int head, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(bar)
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
// take the tensor cores.  Barrier 0 is __syncthreads'.  A single consumer
// takes no turns.
template <int C>
__device__ __forceinline__ void turn_wait(int wg) {
  if constexpr (C > 1) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
template <int C>
__device__ __forceinline__ void turn_pass(int wg) {
  if constexpr (C > 1) asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % C) : "memory");
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
template <int P, int R>
__device__ __forceinline__ void fence_regs(float (&r)[P][R]) {
#pragma unroll
  for (int p = 0; p < P; ++p) fence_regs(r[p]);
}
template <int P, int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[P][R]) {
#pragma unroll
  for (int p = 0; p < P; ++p) fence_regs(r[p]);
}

// d (64 x 128, f32) = a (64 x 16) b (16 x 128) (+ d where acc), both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
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

// d (64 x 32, f32) = a (64 x 16) b (16 x 32) (+ d where acc), both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// S (64 x N) = a b (+ S where acc), the score product at a key stage of N keys
template <int N>
__device__ __forceinline__ void wgmma_s(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 128) {
    wgmma_ss128(d, da, db, acc);
  } else if constexpr (N == 64) {
    wgmma_ss64(d, da, db, acc);
  } else {
    static_assert(N == 32, "key stages of 32, 64 or 128 keys");
    wgmma_ss32(d, da, db, acc);
  }
}

// d (64 x 64, f32) += a (64 x 16, registers) b (16 x 64, shared memory,
// MN-major: imm-trans-b 1)
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- bf16 kernel

// the bf16 kernel's unit, key stage and ring depth per box count
template <int NB>
struct bf16_shape {
  static constexpr int CONS = NB == 1 ? 3 : 2;      // warpgroups of 64 query rows
  static constexpr int BN = NB <= 2 ? 128 : 64;     // keys per K/V stage
  static constexpr int STAGES = NB == 3 ? 3 : (NB == 1 ? 3 : 2);  // K/V ring depth
  static constexpr int BM = 64 * CONS;              // query rows per unit
  static constexpr int THREADS = (CONS + 1) * 128;
  static constexpr int Q_BYTES = NB * BM * ROW_BYTES;
  static constexpr int KV_BYTES = NB * BN * ROW_BYTES;  // one K or V stage
  static constexpr int SMEM_BYTES = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + alignment slack
  static_assert(SMEM_BYTES + 8 * (2 + 3 * STAGES) <= SMEM_LIMIT, "shared memory");
  static_assert(128 * (PRODUCER_REGS + CONS * consumer_regs<CONS>()) <= 65536, "register budget");
};

// S (64 x BN) = Q (this warpgroup's 64 rows) K^T: four k16 steps of 32 bytes
// along the swizzled 128-byte rows of each box (the zero fill's too: a
// step skipped on the run's d would be a branch between wgmmas, which
// ptxas answers by serialising them); box b of Q at sq + b BM 128, of K at
// sk + b BN 128
template <int NB, int BM, int BN>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int kk = 0; kk < BOX / 16; ++kk) {
      const uint64_t da = sw128_desc(sq + b * BM * ROW_BYTES + kk * 32),
                     db = sw128_desc(sk + b * BN * ROW_BYTES + kk * 32);
      wgmma_s<BN>(s, da, db, b > 0 || kk > 0);
    }
  }
}

// O (64 x 64 a box) += P (64 x BN, registers) V (BN x 64 a box): k16 steps
// of 16 keys, 2048 bytes apart; the A fragment of step kk is p of keys
// 16 kk .. 16 kk + 15
template <int NB, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[NB][32], const uint32_t (&pa)[BN / 4],
                                         uint32_t sv) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      wgmma_rs(o[b], a, sw128_desc(sv + b * BN * ROW_BYTES + kk * 16 * ROW_BYTES));
    }
  }
}

// Online softmax of one tile of raw scores, in place: s becomes p =
// exp2(s c - m c) with the updated running max m (raw units, per row half);
// l takes the tile's unrounded p after its rescale; returns the factors
// alpha = exp2((m_old - m_new) c) that O must be rescaled by.  Thread (g, t)
// of a warp holds rows g and g + 8 of its 16, columns 8 i + 2 t + {0, 1}.
// Keys at or past `valid` (a ragged last tile) are -inf before the max.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c, int valid, int t) {
  constexpr int S_REGS = BN / 2;
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
template <int BN>
__device__ __forceinline__ void pack_p(const float (&s)[BN / 2], uint32_t (&pa)[BN / 4]) {
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// Persistent: block b takes the work units b, b + gridDim.x, ...; unit u is
// query tile u % qtiles of head u / qtiles, so the blocks in flight share
// heads (and K/V in L2).  The producer runs ahead into the next unit (its Q
// once every consumer's last S has read the previous one, its K/V as stages
// free up), so one unit's last P V and output store overlap the next one's
// loads.  Ring stages and phases count K/V tiles across units.
template <int NB>
__global__ void __launch_bounds__(bf16_shape<NB>::THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int n,
                    int bh, int d, float c) {
  using S = bf16_shape<NB>;
  constexpr int CONS = S::CONS, BN = S::BN, BM = S::BM, STAGES = S::STAGES;
  constexpr int Q_BYTES = S::Q_BYTES, KV_BYTES = S::KV_BYTES;
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
    mbar_init(empty_q, CONS * 4);  // lane 0 of every consumer warp
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k0 + 8 * st, 1);
      mbar_init(full_v0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONS) {
    // producer warpgroup: one thread issues every TMA load
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONS * 128) {
      int kv = 0, round = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x, ++round) {
        const int head = (int)(u / qtiles), q0 = (int)(u % qtiles) * BM;
        if (round > 0) mbar_wait(empty_q, (round - 1) & 1);
        mbar_expect_tx(full_q, Q_BYTES);
        for (int b = 0; b < NB; ++b) tma_load(sq + b * BM * ROW_BYTES, &tq, BOX * b, q0, head, full_q);
        for (int j = 0; j < tiles; ++j, ++kv) {
          const int st = kv % STAGES;
          if (kv >= STAGES) mbar_wait(empty0 + 8 * st, (kv / STAGES - 1) & 1);
          mbar_expect_tx(full_k0 + 8 * st, KV_BYTES);
          for (int b = 0; b < NB; ++b) {
            tma_load(sk0 + st * KV_BYTES + b * BN * ROW_BYTES, &tk, BOX * b, j * BN, head,
                     full_k0 + 8 * st);
          }
          mbar_expect_tx(full_v0 + 8 * st, KV_BYTES);
          for (int b = 0; b < NB; ++b) {
            tma_load(sv0 + st * KV_BYTES + b * BN * ROW_BYTES, &tv, BOX * b, j * BN, head,
                     full_v0 + 8 * st);
          }
        }
      }
    }
  } else {
    regs_inc<consumer_regs<CONS>()>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int t = lane % 4;
    const uint32_t sq_wg = sq + wg * 64 * ROW_BYTES;
    float acc[NB][32], s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    uint32_t pa[BN / 4];

    if (wg == CONS - 1) turn_pass<CONS>(wg);  // the first turn is warpgroup 0's
    int kv = 0, round = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x, ++round) {
      const int head = (int)(u / qtiles), q0 = (int)(u % qtiles) * BM;
      const bool last_unit = u + gridDim.x >= units;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
      }
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

      mbar_wait(full_q, round & 1);
      // tile 0: S_0 and its softmax
      mbar_wait(full_k0 + 8 * (kv % STAGES), (kv / STAGES) & 1);
      fence_regs(s);
      turn_wait<CONS>(wg);
      wgmma_fence();
      issue_qk<NB, BM, BN>(s, sq_wg, sk0 + (kv % STAGES) * KV_BYTES);
      wgmma_commit();
      turn_pass<CONS>(wg);
      wgmma_wait<0>();
      fence_regs(s);
      if (tiles == 1 && lane == 0) mbar_arrive(empty_q);  // Q is read
      softmax_tile<BN>(s, m, l, alpha, c, min(BN, n), t);
      pack_p<BN>(s, pa);

      for (int j = 1; j < tiles; ++j) {
        const int cur = kv + j, st = cur % STAGES, prev = (cur - 1) % STAGES;
        mbar_wait(full_k0 + 8 * st, (cur / STAGES) & 1);
        mbar_wait(full_v0 + 8 * prev, ((cur - 1) / STAGES) & 1);
        fence_regs(s);
        fence_regs(acc);
        fence_regs(pa);
        turn_wait<CONS>(wg);
        wgmma_fence();
        issue_qk<NB, BM, BN>(s, sq_wg, sk0 + st * KV_BYTES);  // S_j
        wgmma_commit();
        issue_pv<NB, BN>(acc, pa, sv0 + prev * KV_BYTES);  // O += P_{j-1} V_{j-1}
        wgmma_commit();
        turn_pass<CONS>(wg);
        wgmma_wait<1>();  // S_j is done; P V still runs
        fence_regs(s);
        if (j == tiles - 1 && lane == 0) mbar_arrive(empty_q);  // Q is read
        softmax_tile<BN>(s, m, l, alpha, c, min(BN, n - j * BN), t);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[b][i] *= alpha[(i >> 1) & 1];
        }
        pack_p<BN>(s, pa);
      }
      kv += tiles;
      const int last = (kv - 1) % STAGES;
      mbar_wait(full_v0 + 8 * last, ((kv - 1) / STAGES) & 1);
      fence_regs(acc);
      fence_regs(pa);
      turn_wait<CONS>(wg);
      wgmma_fence();
      issue_pv<NB, BN>(acc, pa, sv0 + last * KV_BYTES);
      wgmma_commit();
      // the block's last turn: nobody waits for another
      if (!(last_unit && wg == CONS - 1)) turn_pass<CONS>(wg);
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
        for (int b = 0; b < NB; ++b) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (BOX * b + 8 * i >= d) break;  // the columns past d are the zero fill's
            *reinterpret_cast<uint32_t*>(dst + BOX * b + 8 * i) =
                pack_bf16(acc[b][4 * i + 2 * h] / l[h], acc[b][4 * i + 2 * h + 1] / l[h]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- f32 kernel

constexpr int PLANES = 3;               // bf16 planes of an f32 value
constexpr int TERMS = 6;                // plane products b_i b_j with i + j <= 2

// the split kernel's unit, key stage and ring depth per box count
template <int NB>
struct split_shape {
  static constexpr int CONS = NB <= 2 ? 2 : 1;   // warpgroups of 64 query rows
  static constexpr int BN = NB == 1 ? 64 : 32;   // keys per K/V stage
  static constexpr int STAGES = NB == 1 ? 3 : 2;  // K/V ring depth
  static constexpr int BM = 64 * CONS;
  static constexpr int THREADS = (CONS + 1) * 128;
  static constexpr int Q_SLAB = BM * ROW_BYTES;   // one plane of one box of a unit's Q
  static constexpr int KV_SLAB = BN * ROW_BYTES;  // one plane of one box of a K or V stage
  static constexpr int Q_BYTES = NB * PLANES * Q_SLAB;
  static constexpr int KV_BYTES = NB * PLANES * KV_SLAB;
  static constexpr int SMEM_BYTES = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + alignment slack
  static_assert(SMEM_BYTES + 8 * (2 + 3 * STAGES) <= SMEM_LIMIT, "shared memory");
  static_assert(128 * (PRODUCER_REGS + CONS * consumer_regs<CONS>()) <= 65536, "register budget");
};

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

// one 64 x rows x 1 x 3 box of a (d, n, bh, plane) tensor map at column
// col: the three planes of `rows` rows, plane p at dst + p * rows * 128
__device__ __forceinline__ void tma_load_planes(uint32_t dst, const CUtensorMap* map, int col,
                                                int row, int head, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(0), "r"(bar)
      : "memory");
}

// S (64 x BN) = sum over the six terms of Q_i K_j^T: 24 k16 steps a box into
// one accumulator, from zero, the smallest products first; sq is this
// warpgroup's rows of box 0 plane 0 (box b plane i (3 b + i) Q_SLAB
// further), sk box 0 plane 0 of a K stage
template <int NB, int Q_SLAB, int BN>
__device__ __forceinline__ void issue_qk_split(float (&s)[BN / 2], uint32_t sq, uint32_t sk) {
  constexpr int KV_SLAB = BN * ROW_BYTES;
#pragma unroll
  for (int t = 0; t < TERMS; ++t) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int kk = 0; kk < BOX / 16; ++kk) {
        wgmma_s<BN>(s, sw128_desc(sq + (PLANES * b + term_a(t)) * Q_SLAB + kk * 32),
                    sw128_desc(sk + (PLANES * b + term_b(t)) * KV_SLAB + kk * 32),
                    t > 0 || b > 0 || kk > 0);
      }
    }
  }
}

// O (64 x 64) of one box = sum over the six terms of P_i V_j, from zero:
// P's planes from registers, V's from box b of a stage (sv, its plane 0) as
// transposed operands, the smallest first
template <int BN>
__device__ __forceinline__ void issue_pv_split(float (&o)[32], const uint32_t (&pa)[PLANES][BN / 4],
                                               uint32_t sv) {
  constexpr int KV_SLAB = BN * ROW_BYTES;
#pragma unroll
  for (int t = 0; t < TERMS; ++t) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t(&p)[BN / 4] = pa[term_a(t)];
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      wgmma_rs_acc(o, a, sw128_desc(sv + term_b(t) * KV_SLAB + kk * 16 * ROW_BYTES),
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
template <int BN>
__device__ __forceinline__ void softmax_tile_f32(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                                 float (&alpha)[2], float scale, int valid, int t) {
  constexpr int S_REGS = BN / 2;
#pragma unroll
  for (int i = 0; i < S_REGS; ++i) {
    s[i] *= scale;
    if (valid < BN && 8 * (i / 4) + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
  }
  float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int i = 0; i < S_REGS; ++i) {
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
  for (int i = 0; i < S_REGS; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = expf(s[i] - m[h]);
    ls[h][i & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + (ls[h][0] + ls[h][1]);
}

// p split into three bf16 planes, packed as the A fragments of P V
template <int BN>
__device__ __forceinline__ void split_p(const float (&s)[BN / 2], uint32_t (&pa)[PLANES][BN / 4]) {
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) {
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

// P V of boxes 1 .. NB - 1 of a tile, one at a time after the first box's
// (which ran beside the softmax): each from zero in pv, then added to its
// box of O, rescaled by alpha (1 for the last tile)
template <int NB, int BN>
__device__ __forceinline__ void pv_rest(float (&acc)[NB][32], float (&pv)[32],
                                        const uint32_t (&pa)[PLANES][BN / 4], uint32_t sv,
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int b = 1; b < NB; ++b) {
    fence_regs(pv);
    wgmma_fence();
    issue_pv_split<BN>(pv, pa, sv + b * PLANES * BN * ROW_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = (acc[b][i] + pv[i]) * alpha[(i >> 1) & 1];
  }
}

// The f32 kernel: flash_fwd_wgmma's structure (persistent units, a
// producer warp feeding a TMA ring, consumer warpgroups taking turns, S_j
// issued with P_{j-1} V_{j-1}) over the bf16 planes that split_planes
// wrote, each tensor map a (d, n, bh, plane) view, one TMA load bringing
// all three planes of one box of a tile.
template <int NB>
__global__ void __launch_bounds__(split_shape<NB>::THREADS, 1)
    flash_fwd_split(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, float* __restrict__ o, int n, int bh,
                    int d, float scale) {
  using S = split_shape<NB>;
  constexpr int CONS = S::CONS, BN = S::BN, BM = S::BM, STAGES = S::STAGES;
  constexpr int Q_SLAB = S::Q_SLAB, KV_SLAB = S::KV_SLAB, Q_BYTES = S::Q_BYTES,
                KV_BYTES = S::KV_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 3 * STAGES];
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
    mbar_init(empty_q, CONS * 4);  // lane 0 of every consumer warp
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k0 + 8 * st, 1);
      mbar_init(full_v0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONS) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONS * 128) {
      int kv = 0, round = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x, ++round) {
        const int head = (int)(u / qtiles), q0 = (int)(u % qtiles) * BM;
        if (round > 0) mbar_wait(empty_q, (round - 1) & 1);
        mbar_expect_tx(full_q, Q_BYTES);
        for (int b = 0; b < NB; ++b) {
          tma_load_planes(sq + b * PLANES * Q_SLAB, &tq, BOX * b, q0, head, full_q);
        }
        for (int j = 0; j < tiles; ++j, ++kv) {
          const int st = kv % STAGES;
          if (kv >= STAGES) mbar_wait(empty0 + 8 * st, (kv / STAGES - 1) & 1);
          mbar_expect_tx(full_k0 + 8 * st, KV_BYTES);
          for (int b = 0; b < NB; ++b) {
            tma_load_planes(sk0 + st * KV_BYTES + b * PLANES * KV_SLAB, &tk, BOX * b, j * BN, head,
                            full_k0 + 8 * st);
          }
          mbar_expect_tx(full_v0 + 8 * st, KV_BYTES);
          for (int b = 0; b < NB; ++b) {
            tma_load_planes(sv0 + st * KV_BYTES + b * PLANES * KV_SLAB, &tv, BOX * b, j * BN, head,
                            full_v0 + 8 * st);
          }
        }
      }
    }
  } else {
    regs_inc<consumer_regs<CONS>()>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int t = lane % 4;
    const uint32_t sq_wg = sq + wg * 64 * ROW_BYTES;
    // acc: O of the tiles so far; pv: one box of one tile's P V, summed from zero
    float acc[NB][32], pv[32], s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    uint32_t pa[PLANES][BN / 4];
    const float one[2] = {1.f, 1.f};

    if (wg == CONS - 1) turn_pass<CONS>(wg);  // the first turn is warpgroup 0's
    int kv = 0, round = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x, ++round) {
      const int head = (int)(u / qtiles), q0 = (int)(u % qtiles) * BM;
      const bool last_unit = u + gridDim.x >= units;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
      }
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

      mbar_wait(full_q, round & 1);
      mbar_wait(full_k0 + 8 * (kv % STAGES), (kv / STAGES) & 1);
      fence_regs(s);
      turn_wait<CONS>(wg);
      wgmma_fence();
      issue_qk_split<NB, Q_SLAB, BN>(s, sq_wg, sk0 + (kv % STAGES) * KV_BYTES);
      wgmma_commit();
      turn_pass<CONS>(wg);
      wgmma_wait<0>();
      fence_regs(s);
      if (tiles == 1 && lane == 0) mbar_arrive(empty_q);  // Q is read
      softmax_tile_f32<BN>(s, m, l, alpha, scale, min(BN, n), t);
      split_p<BN>(s, pa);

      for (int j = 1; j < tiles; ++j) {
        const int cur = kv + j, st = cur % STAGES, prev = (cur - 1) % STAGES;
        mbar_wait(full_k0 + 8 * st, (cur / STAGES) & 1);
        mbar_wait(full_v0 + 8 * prev, ((cur - 1) / STAGES) & 1);
        fence_regs(s);
        fence_regs(pv);
        fence_regs(pa);
        turn_wait<CONS>(wg);
        wgmma_fence();
        issue_qk_split<NB, Q_SLAB, BN>(s, sq_wg, sk0 + st * KV_BYTES);  // S_j
        wgmma_commit();
        issue_pv_split<BN>(pv, pa, sv0 + prev * KV_BYTES);  // box 0 of P_{j-1} V_{j-1}
        wgmma_commit();
        turn_pass<CONS>(wg);
        wgmma_wait<1>();  // S_j is done; P V still runs
        fence_regs(s);
        if (j == tiles - 1 && lane == 0) mbar_arrive(empty_q);  // Q is read
        softmax_tile_f32<BN>(s, m, l, alpha, scale, min(BN, n - j * BN), t);
        wgmma_wait<0>();
        fence_regs(pv);
        fence_regs(pa);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[0][i] = (acc[0][i] + pv[i]) * alpha[(i >> 1) & 1];
        pv_rest<NB, BN>(acc, pv, pa, sv0 + prev * KV_BYTES, alpha);
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        split_p<BN>(s, pa);
      }
      kv += tiles;
      const int last = (kv - 1) % STAGES;
      mbar_wait(full_v0 + 8 * last, ((kv - 1) / STAGES) & 1);
      fence_regs(pv);
      fence_regs(pa);
      turn_wait<CONS>(wg);
      wgmma_fence();
      issue_pv_split<BN>(pv, pa, sv0 + last * KV_BYTES);
      wgmma_commit();
      // the block's last turn: nobody waits for another
      if (!(last_unit && wg == CONS - 1)) turn_pass<CONS>(wg);
      wgmma_wait<0>();
      fence_regs(pv);
      fence_regs(pa);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[0][i] += pv[i];
      pv_rest<NB, BN>(acc, pv, pa, sv0 + last * KV_BYTES, one);
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
        float* dst = o + ((long long)head * n + row) * d + 2 * t;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (BOX * b + 8 * i >= d) break;  // the columns past d are the zero fill's
            *reinterpret_cast<float2*>(dst + BOX * b + 8 * i) =
                make_float2(acc[b][4 * i + 2 * h] / l[h], acc[b][4 * i + 2 * h + 1] / l[h]);
          }
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
// fill (of rows past n and of columns past d)
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh, int n, int d,
                int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BOX, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

template <int NB>
int launch_wgmma_nb(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
                    int bh, int n, int d, float c, cudaStream_t stream) {
  using S = bf16_shape<NB>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  if (const int e = sm_count(&sms)) return e;
  const long long units = (long long)((n + S::BM - 1) / S::BM) * bh;
  flash_fwd_wgmma<NB><<<(unsigned)(units < sms ? units : sms), S::THREADS, S::SMEM_BYTES, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, n, bh, d, c);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_wgmma_maps(const void* q, const void* k, const void* v, void* o, int bh, int n, int d,
                      float scale, cudaStream_t stream) {
  using S = bf16_shape<NB>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(encode, &tq, q, bh, n, d, S::BM) || !tensor_map(encode, &tk, k, bh, n, d, S::BN) ||
      !tensor_map(encode, &tv, v, bh, n, d, S::BN)) {
    return (int)cudaErrorInvalidValue;
  }
  const float c = (float)((double)scale * 1.4426950408889634);  // scale * log2(e)
  return launch_wgmma_nb<NB>(tq, tk, tv, o, bh, n, d, c, stream);
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o, int bh, int n, int d,
                 float scale, cudaStream_t stream) {
  if (!(scale > 0.f) || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  switch ((d + BOX - 1) / BOX) {
    case 1: return launch_wgmma_maps<1>(q, k, v, o, bh, n, d, scale, stream);
    case 2: return launch_wgmma_maps<2>(q, k, v, o, bh, n, d, scale, stream);
    case 3: return launch_wgmma_maps<3>(q, k, v, o, bh, n, d, scale, stream);
    case 4: return launch_wgmma_maps<4>(q, k, v, o, bh, n, d, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// (d, n, bh, plane) map of three bf16 planes of a (bh, n, d) tensor, one
// after the other, with boxes of (64, rows, 1, 3), 128-byte swizzle, zero
// fill (of rows past n and of columns past d)
bool plane_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh, int n, int d,
               int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh, (cuuint64_t)PLANES};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2,
                                 (cuuint64_t)bh * n * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, (cuuint32_t)rows, 1, (cuuint32_t)PLANES};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the split pass, then the kernel on its planes; scratch holds 9 bh n d bf16
template <int NB>
int launch_split_nb(const void* q, const void* k, const void* v, void* o, void* scratch, int bh,
                    int n, int d, float scale, cudaStream_t stream) {
  using S = split_shape<NB>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const long long count = (long long)bh * n * d;  // elements of one input, one plane
  const uint8_t* planes = (const uint8_t*)scratch;
  CUtensorMap tq, tk, tv;
  if (!plane_map(encode, &tq, planes, bh, n, d, S::BM) ||
      !plane_map(encode, &tk, planes + PLANES * count * 2, bh, n, d, S::BN) ||
      !plane_map(encode, &tv, planes + 2 * PLANES * count * 2, bh, n, d, S::BN)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_split<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  if (const int e = sm_count(&sms)) return e;
  const long long count4 = count / 4, split_blocks = (count4 + 255) / 256;
  split_planes<<<dim3((unsigned)(split_blocks < 8 * sms ? split_blocks : 8 * sms), 3), 256, 0,
                 stream>>>((const float4*)q, (const float4*)k, (const float4*)v, (uint2*)scratch,
                           count4);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long units = (long long)((n + S::BM - 1) / S::BM) * bh;
  flash_fwd_split<NB><<<(unsigned)(units < sms ? units : sms), S::THREADS, S::SMEM_BYTES, stream>>>(
      tq, tk, tv, (float*)o, n, bh, d, scale);
  return (int)cudaGetLastError();
}

int launch_split(const void* q, const void* k, const void* v, void* o, void* scratch, int bh, int n,
                 int d, float scale, cudaStream_t stream) {
  if (scratch == nullptr ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)scratch) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  switch ((d + BOX - 1) / BOX) {
    case 1: return launch_split_nb<1>(q, k, v, o, scratch, bh, n, d, scale, stream);
    case 2: return launch_split_nb<2>(q, k, v, o, scratch, bh, n, d, scale, stream);
    case 3: return launch_split_nb<3>(q, k, v, o, scratch, bh, n, d, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (bh, n, d) contiguous and 16-byte aligned, all bf16 (is_bf16
// = 1: the wgmma kernel, which also needs scale > 0; scratch unused; d <=
// 256) or all f32 (the split kernel, any scale; scratch: 9 bh n d bf16,
// 16-byte aligned, for the planes of q, k and v; d <= 192).  Head dims
// d % 8 == 0.
int flash_attention_forward(const void* q, const void* k, const void* v, void* o, void* scratch,
                            int bh, int n, int d, float scale, int is_bf16, void* stream) {
  const int max_d = BOX * (is_bf16 ? MAX_BOXES_BF16 : MAX_BOXES_F32);
  if (d <= 0 || d > max_d || d % 8 != 0 || bh < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (bh == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return launch_wgmma(q, k, v, o, bh, n, d, scale, s);
  return launch_split(q, k, v, o, scratch, bh, n, d, scale, s);
}

}  // extern "C"
