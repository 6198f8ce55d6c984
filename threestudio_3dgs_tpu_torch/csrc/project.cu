// Per-Gaussian view preprocessing (K7) for Hopper (sm_90a): the forward
// projection with the binning's row fields, and its hand-derived backward.
//
// The JAX package autodiffs this stage (ops/rasterizer/preprocess.py), so
// K7 replaces no TPU kernel: it replaces the port's plain torch version,
// ``project_gaussians`` plus the row pass of ``plan_pairs``
// (``binning.row_fields``), which stay as its twins.
//
// project_fwd_kernel: one thread per (view, row).  It reads the row once
// (mean, scale, quaternion, opacity, alive, optional mean2d offset) and
// writes what ``project_gaussians`` returns (means2d, depth, conic, radius,
// tile rect, visible) and the row fields the binning reads: the packed
// (x0, y0, w, mask) rect of K4 with the reachable-tile bitmask of a rect of
// <= 24 tiles (else MASK_NONE), the exact pair count, the depth sort key
// (+inf for no pairs) and the (mx, my, ca, cb, cc, opa) cull fields.  A
// row that is dead or at view depth <= 0.2 exits early with the culled
// outputs: its depth, zeros elsewhere, MASK_NONE and the +inf key.  On B
// stacked views (grid.y = B) row r of view v is output row v * n + r, its
// tile rows shifted down by v * view_grid_y.
//
// Every step keeps the plain torch version's float32 operation order (one
// rounding per torch op, no fused multiply-add: the file is compiled with
// -fmad=false), so the discrete results -- the Jacobian clamp, det > 0,
// the radius ceil, the tile floors and the reachability test (K4's, in
// K4's order) -- and with them the counts, masks, rects and radii equal the
// plain version's bit for bit.  Two torch idioms are mirrored: x / s for a
// host scalar s is x * (1 / s) on the card, and 1 / x is reciprocal(x) * 1.
//
// project_bwd_kernel: one thread per (view, row) again.  It recomputes the
// row's forward terms from the inputs (nothing but the inputs is saved)
// and maps d means2d, d conics and d depths to d means3d, d scales, d quats
// and d means2d_offset, as torch.autograd does through the plain version:
// exact zeros on culled and det <= 0 rows (the double-where), clamp's
// gradient with its bounds included, the quaternion's normalisation and
// the scaling modifier.
//
// Bound on the H100: bytes (about 150 a row forward: 53 read, 97 written;
// 64 read and 48 written backward).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaskK = 24;
constexpr int kMaskNone = 1 << 24;
constexpr float kAlphaMin = 0.003921568859368563f;  // float32(1 / 255)
// a view's camera row: the (4, 4) row-major world-to-camera and full
// projection matrices, then the float32 focal lengths and Jacobian clamp
// limits the plain version computes on the host
constexpr int kCamFloats = 36;
constexpr int kFullProj = 16;
constexpr int kScalars = 32;  // focal_x, focal_y, lim_x, lim_y

}  // namespace

// Row inputs; each *_vs is the stride between views in elements (0: one
// tensor shared by every view).  alive and offset may be null.
struct ProjectInputs {
  const float* means3d;
  const float* scales;
  const float* quats;
  const float* opac;
  const unsigned char* alive;
  const float* offset;
  long long means3d_vs, scales_vs, quats_vs, opac_vs, alive_vs, offset_vs;
};

struct ProjectOutputs {
  float* means2d;         // (B n, 2)
  float* depths;          // (B n,)
  float* conics;          // (B n, 3)
  int* radii;             // (B n,)
  int* tiles_min;         // (B n, 2)
  int* tiles_max;         // (B n, 2)
  unsigned char* visible; // (B n,)
  int* rect;              // (B n, 4) x0, y0, w, mask
  long long* counts;      // (B n,)
  float* sort_key;        // (B n,)
  float* cull;            // (B n, 6)
};

struct ProjectGrads {
  const float* d_means2d;  // (B n, 2) or null (zero)
  const float* d_conics;   // (B n, 3) or null (zero)
  const float* d_depths;   // (B n,) or null (zero)
  float* means3d;          // (B n, 3)
  float* scales;           // (B n, 3)
  float* quats;            // (B n, 4)
  float* offset;           // (B n, 2) or null
};

struct ProjectShape {
  long long n;      // rows a view
  int width, height, tile_size, grid_x, grid_y;
  int view_grid_y;  // tile rows between stacked views (0: one view)
  float modifier;   // the scaling modifier
};

namespace {

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Can alpha = opa * exp(-Q/2) reach 1/255 inside the pixel rect
// [x0, x0+ts-1] x [y0, y0+ts-1]?  K4's test (csrc/expand.cu), same order.
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

__device__ __forceinline__ float recip(float x) { return (1.0f / x) * 1.0f; }

// m . row[0:3] + row[3], left to right (``_mv3``)
__device__ __forceinline__ float mv3(const float* row, float mx, float my, float mz) {
  return mx * __ldg(row) + my * __ldg(row + 1) + mz * __ldg(row + 2) + __ldg(row + 3);
}

// The forward terms of one row in frustum, in the plain version's order.
struct Terms {
  float px, py, depth;          // view space
  float hx, hy, rw;             // clip x, y and 1 / (w + 1e-7)
  float m2x, m2y;               // pixel mean (offset added)
  float sq;                     // |q|^2
  float nrm;                    // max(|q|^2, 1e-24)^(1/2)
  float qw, qx, qy, qz;         // normalised quaternion
  float r[9];                   // rotation, row-major
  float ms[3];                  // modifier * scale
  float s2[3];                  // (modifier * scale)^2
  float sig[6];                 // s00 s01 s02 s11 s12 s22
  float u, v;                   // px / depth, py / depth
  float tx, ty;                 // clamped view x, y
  float inv_z, inv_z2;
  float t0[3], t1[3];           // rows of J W
  float st0[3], st1[3];         // Sigma t0, Sigma t1
  float c00, c01, c11, det, inv_det;
  bool ok;                      // det > 0
};

__device__ __forceinline__ void cov_terms(Terms& t, const float* q, const float* s,
                                          float modifier) {
  t.sq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  t.nrm = sqrtf(fmaxf(t.sq, 1e-24f));
  t.qw = q[0] / t.nrm;
  t.qx = q[1] / t.nrm;
  t.qy = q[2] / t.nrm;
  t.qz = q[3] / t.nrm;
  const float w = t.qw, x = t.qx, y = t.qy, z = t.qz;
  t.r[0] = 1.0f - 2.0f * (y * y + z * z);
  t.r[1] = 2.0f * (x * y - w * z);
  t.r[2] = 2.0f * (x * z + w * y);
  t.r[3] = 2.0f * (x * y + w * z);
  t.r[4] = 1.0f - 2.0f * (x * x + z * z);
  t.r[5] = 2.0f * (y * z - w * x);
  t.r[6] = 2.0f * (x * z - w * y);
  t.r[7] = 2.0f * (y * z + w * x);
  t.r[8] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t.ms[k] = modifier * s[k];
    t.s2[k] = t.ms[k] * t.ms[k];
  }
  const float* r = t.r;
  const float a = t.s2[0], b = t.s2[1], c = t.s2[2];
  t.sig[0] = r[0] * r[0] * a + r[1] * r[1] * b + r[2] * r[2] * c;
  t.sig[1] = r[0] * r[3] * a + r[1] * r[4] * b + r[2] * r[5] * c;
  t.sig[2] = r[0] * r[6] * a + r[1] * r[7] * b + r[2] * r[8] * c;
  t.sig[3] = r[3] * r[3] * a + r[4] * r[4] * b + r[5] * r[5] * c;
  t.sig[4] = r[3] * r[6] * a + r[4] * r[7] * b + r[5] * r[8] * c;
  t.sig[5] = r[6] * r[6] * a + r[7] * r[7] * b + r[8] * r[8] * c;
}

__device__ __forceinline__ void sigma_vec(const float* sg, const float* v, float* out) {
  out[0] = sg[0] * v[0] + sg[1] * v[1] + sg[2] * v[2];
  out[1] = sg[1] * v[0] + sg[3] * v[1] + sg[4] * v[2];
  out[2] = sg[2] * v[0] + sg[4] * v[1] + sg[5] * v[2];
}

// Everything after the depth test, for a row in frustum (depth > 0.2).
__device__ __forceinline__ void row_terms(Terms& t, const float* m, const float* q,
                                          const float* s, const float* off,
                                          const float* cam, const ProjectShape& sh) {
  const float* W = cam;
  const float* P = cam + kFullProj;
  t.hx = mv3(P, m[0], m[1], m[2]);
  t.hy = mv3(P + 4, m[0], m[1], m[2]);
  const float wh = mv3(P + 12, m[0], m[1], m[2]);
  t.rw = recip(wh + 1e-7f);
  const float wf = (float)sh.width, hf = (float)sh.height;
  t.m2x = ((t.hx * t.rw + 1.0f) * wf - 1.0f) * 0.5f;
  t.m2y = ((t.hy * t.rw + 1.0f) * hf - 1.0f) * 0.5f;
  if (off != nullptr) {
    t.m2x = t.m2x + off[0] * (wf * 0.5f);
    t.m2y = t.m2y + off[1] * (hf * 0.5f);
  }
  cov_terms(t, q, s, sh.modifier);

  const float fx = __ldg(cam + kScalars), fy = __ldg(cam + kScalars + 1);
  const float lx = __ldg(cam + kScalars + 2), ly = __ldg(cam + kScalars + 3);
  t.u = t.px / t.depth;
  t.v = t.py / t.depth;
  t.tx = clampf(t.u, -lx, lx) * t.depth;
  t.ty = clampf(t.v, -ly, ly) * t.depth;
  t.inv_z = recip(t.depth);
  t.inv_z2 = t.inv_z * t.inv_z;
  const float j00 = fx * t.inv_z;
  const float j02 = -fx * t.tx * t.inv_z2;
  const float j11 = fy * t.inv_z;
  const float j12 = -fy * t.ty * t.inv_z2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t.t0[k] = j00 * __ldg(W + k) + j02 * __ldg(W + 8 + k);
    t.t1[k] = j11 * __ldg(W + 4 + k) + j12 * __ldg(W + 8 + k);
  }
  sigma_vec(t.sig, t.t0, t.st0);
  sigma_vec(t.sig, t.t1, t.st1);
  t.c00 = t.t0[0] * t.st0[0] + t.t0[1] * t.st0[1] + t.t0[2] * t.st0[2] + 0.3f;
  t.c01 = t.t1[0] * t.st0[0] + t.t1[1] * t.st0[1] + t.t1[2] * t.st0[2];
  t.c11 = t.t1[0] * t.st1[0] + t.t1[1] * t.st1[1] + t.t1[2] * t.st1[2] + 0.3f;
  t.det = t.c00 * t.c11 - t.c01 * t.c01;
  t.ok = t.det > 0.0f;
  t.inv_det = recip(t.ok ? t.det : 1.0f);
}

__device__ __forceinline__ void load3(const float* p, float* out) {
  out[0] = __ldg(p);
  out[1] = __ldg(p + 1);
  out[2] = __ldg(p + 2);
}

__global__ void __launch_bounds__(kThreads) project_fwd_kernel(ProjectInputs in,
                                                               const float* __restrict__ cams,
                                                               ProjectShape sh,
                                                               ProjectOutputs out) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= sh.n) return;
  const int view = blockIdx.y;
  const long long o = (long long)view * sh.n + row;
  float m[3];
  load3(in.means3d + view * in.means3d_vs + row * 3, m);
  const float* cam = cams + view * kCamFloats;
  const float* W = cam;
  Terms t;
  t.depth = mv3(W + 8, m[0], m[1], m[2]);
  bool alive = in.alive == nullptr || in.alive[view * in.alive_vs + row] != 0;
  out.depths[o] = t.depth;
  if (!(t.depth > 0.2f) || !alive) {
    out.means2d[2 * o] = 0.0f;
    out.means2d[2 * o + 1] = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) out.conics[3 * o + k] = 0.0f;
    out.radii[o] = 0;
    out.tiles_min[2 * o] = 0;
    out.tiles_min[2 * o + 1] = 0;
    out.tiles_max[2 * o] = 0;
    out.tiles_max[2 * o + 1] = 0;
    out.visible[o] = 0;
    reinterpret_cast<int4*>(out.rect)[o] = make_int4(0, 0, 0, kMaskNone);
    out.counts[o] = 0;
    out.sort_key[o] = INFINITY;
#pragma unroll
    for (int k = 0; k < 6; ++k) out.cull[6 * o + k] = 0.0f;
    return;
  }
  t.px = mv3(W, m[0], m[1], m[2]);
  t.py = mv3(W + 4, m[0], m[1], m[2]);
  float q[4], s[3], off[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = __ldg(in.quats + view * in.quats_vs + row * 4 + k);
  load3(in.scales + view * in.scales_vs + row * 3, s);
  if (in.offset != nullptr) {
    off[0] = __ldg(in.offset + view * in.offset_vs + row * 2);
    off[1] = __ldg(in.offset + view * in.offset_vs + row * 2 + 1);
  }
  row_terms(t, m, q, s, in.offset != nullptr ? off : nullptr, cam, sh);
  const float ca = t.c11 * t.inv_det;
  const float cb = -t.c01 * t.inv_det;
  const float cc = t.c00 * t.inv_det;

  const float mid = 0.5f * (t.c00 + t.c11);
  const float lambda1 = mid + sqrtf(fmaxf(mid * mid - t.det, 0.1f));
  const float radius = ceilf(3.0f * sqrtf(fmaxf(lambda1, 0.0f)));
  const float ts = (float)sh.tile_size;
  const float inv_ts = 1.0f / ts;
  const float gxf = (float)sh.grid_x, gyf = (float)sh.grid_y;
  const int x0 = (int)clampf(floorf((t.m2x - radius) * inv_ts), 0.0f, gxf);
  const int y0 = (int)clampf(floorf((t.m2y - radius) * inv_ts), 0.0f, gyf);
  const int x1 = (int)clampf(floorf((t.m2x + radius + ts - 1.0f) * inv_ts), 0.0f, gxf);
  const int y1 = (int)clampf(floorf((t.m2y + radius + ts - 1.0f) * inv_ts), 0.0f, gyf);
  const int rect_w = x1 - x0;
  const int area = rect_w * (y1 - y0);
  const bool visible = t.ok && radius > 0.0f && area > 0;
  const int shift = view * sh.view_grid_y;
  const float opa = __ldg(in.opac + view * in.opac_vs + row);

  int mask = kMaskNone;
  long long count = visible ? area : 0;
  if (visible && area <= kMaskK) {
    // rows of the rect are view-local here: (y0 + shift + j / w) % view_grid_y
    unsigned bits = 0u;
    for (int j = 0; j < area; ++j) {
      const int tx = x0 + j % rect_w;
      const int ty = y0 + j / rect_w;
      if (tile_reachable((float)(tx * sh.tile_size), (float)(ty * sh.tile_size), ts, t.m2x,
                         t.m2y, ca, cb, cc, opa)) {
        bits |= 1u << j;
      }
    }
    mask = (int)bits;
    count = __popc(bits);
  }

  out.means2d[2 * o] = t.m2x;
  out.means2d[2 * o + 1] = t.m2y;
  out.conics[3 * o] = ca;
  out.conics[3 * o + 1] = cb;
  out.conics[3 * o + 2] = cc;
  out.radii[o] = visible ? (int)radius : 0;
  out.tiles_min[2 * o] = x0;
  out.tiles_min[2 * o + 1] = y0 + shift;
  out.tiles_max[2 * o] = x1;
  out.tiles_max[2 * o + 1] = y1 + shift;
  out.visible[o] = visible ? 1 : 0;
  reinterpret_cast<int4*>(out.rect)[o] = make_int4(x0, y0 + shift, rect_w, mask);
  out.counts[o] = count;
  out.sort_key[o] = count > 0 ? t.depth : INFINITY;
  float* cf = out.cull + 6 * o;
  cf[0] = t.m2x;
  cf[1] = t.m2y;
  cf[2] = ca;
  cf[3] = cb;
  cf[4] = cc;
  cf[5] = opa;
}

__global__ void __launch_bounds__(kThreads) project_bwd_kernel(ProjectInputs in,
                                                               const float* __restrict__ cams,
                                                               ProjectShape sh,
                                                               ProjectGrads g) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= sh.n) return;
  const int view = blockIdx.y;
  const long long o = (long long)view * sh.n + row;
  float m[3];
  load3(in.means3d + view * in.means3d_vs + row * 3, m);
  const float* cam = cams + view * kCamFloats;
  const float* W = cam;
  const float* P = cam + kFullProj;
  Terms t;
  t.depth = mv3(W + 8, m[0], m[1], m[2]);
  const bool alive = in.alive == nullptr || in.alive[view * in.alive_vs + row] != 0;
  bool live = t.depth > 0.2f && alive;
  float q[4], s[3];
  if (live) {
    t.px = mv3(W, m[0], m[1], m[2]);
    t.py = mv3(W + 4, m[0], m[1], m[2]);
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = __ldg(in.quats + view * in.quats_vs + row * 4 + k);
    load3(in.scales + view * in.scales_vs + row * 3, s);
    // the offset moves means2d alone: no term below reads it
    row_terms(t, m, q, s, nullptr, cam, sh);
    live = t.ok;
  }
  if (!live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g.means3d[3 * o + k] = 0.0f;
      g.scales[3 * o + k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) g.quats[4 * o + k] = 0.0f;
    if (g.offset != nullptr) {
      g.offset[2 * o] = 0.0f;
      g.offset[2 * o + 1] = 0.0f;
    }
    return;
  }
  // an absent upstream gradient (null) is zero
  const float* dm2 = g.d_means2d;
  const float* dcn = g.d_conics;
  const float gmx = dm2 ? __ldg(dm2 + 2 * o) : 0.0f, gmy = dm2 ? __ldg(dm2 + 2 * o + 1) : 0.0f;
  const float gca = dcn ? __ldg(dcn + 3 * o) : 0.0f, gcb = dcn ? __ldg(dcn + 3 * o + 1) : 0.0f;
  const float gcc = dcn ? __ldg(dcn + 3 * o + 2) : 0.0f;
  const float gd = g.d_depths ? __ldg(g.d_depths + o) : 0.0f;
  const float wf = (float)sh.width, hf = (float)sh.height;

  // means2d = ((h * rw + 1) * size - 1) / 2 + offset * size / 2
  const float dnx = gmx * (wf * 0.5f), dny = gmy * (hf * 0.5f);
  if (g.offset != nullptr) {
    g.offset[2 * o] = dnx;
    g.offset[2 * o + 1] = dny;
  }
  const float dhx = dnx * t.rw, dhy = dny * t.rw;
  const float drw = dnx * t.hx + dny * t.hy;
  const float dwh = -drw * t.rw * t.rw;
  float dm[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dm[k] = dhx * __ldg(P + k) + dhy * __ldg(P + 4 + k) + dwh * __ldg(P + 12 + k);
  }

  // conic = (c11, -c01, c00) / det
  const float dinv = gca * t.c11 - gcb * t.c01 + gcc * t.c00;
  const float ddet = -dinv * t.inv_det * t.inv_det;
  const float dc00 = gcc * t.inv_det + ddet * t.c11;
  const float dc11 = gca * t.inv_det + ddet * t.c00;
  const float dc01 = -gcb * t.inv_det - 2.0f * t.c01 * ddet;

  // c00 = t0.S t0, c01 = t1.S t0, c11 = t1.S t1
  float dt0[3], dt1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dt0[k] = 2.0f * dc00 * t.st0[k] + dc01 * t.st1[k];
    dt1[k] = 2.0f * dc11 * t.st1[k] + dc01 * t.st0[k];
  }
  // symmetric gradient of Sigma: G = dc00 t0 t0' + dc01 (t0 t1' + t1 t0') / 2 + dc11 t1 t1',
  // its lower half the upper's mirror, so that an isotropic Gaussian's
  // rotation gets exactly the zero gradient it has (a rounding asymmetry
  // would leave noise that Adam turns into whole steps)
  float gs[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = i; j < 3; ++j) {
      gs[3 * i + j] = dc00 * (t.t0[i] * t.t0[j]) +
                      0.5f * dc01 * (t.t0[i] * t.t1[j] + t.t1[i] * t.t0[j]) +
                      dc11 * (t.t1[i] * t.t1[j]);
      gs[3 * j + i] = gs[3 * i + j];
    }
  }
  // Sigma = R diag(s2) R': ds2_k = (R' G R)_kk, dR = 2 G R diag(s2)
  float gr[9];  // G R
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gr[3 * i + k] = gs[3 * i] * t.r[k] + gs[3 * i + 1] * t.r[3 + k] + gs[3 * i + 2] * t.r[6 + k];
    }
  }
  float dr[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ds2 = t.r[k] * gr[k] + t.r[3 + k] * gr[3 + k] + t.r[6 + k] * gr[6 + k];
    g.scales[3 * o + k] = ds2 * 2.0f * t.ms[k] * sh.modifier;
#pragma unroll
    for (int i = 0; i < 3; ++i) dr[3 * i + k] = 2.0f * gr[3 * i + k] * t.s2[k];
  }
  // R(q^) -> dq^
  const float w = t.qw, x = t.qx, y = t.qy, z = t.qz;
  const float dqw = 2.0f * (-z * dr[1] + y * dr[2] + z * dr[3] - x * dr[5] - y * dr[6] + x * dr[7]);
  const float dqx = 2.0f * (y * dr[1] + z * dr[2] + y * dr[3] - 2.0f * x * dr[4] - w * dr[5] +
                            z * dr[6] + w * dr[7] - 2.0f * x * dr[8]);
  const float dqy = 2.0f * (-2.0f * y * dr[0] + x * dr[1] + w * dr[2] + x * dr[3] + z * dr[5] -
                            w * dr[6] + z * dr[7] - 2.0f * y * dr[8]);
  const float dqz = 2.0f * (-2.0f * z * dr[0] - w * dr[1] + x * dr[2] + w * dr[3] -
                            2.0f * z * dr[4] + y * dr[5] + x * dr[6] + y * dr[7]);
  // q^ = q / sqrt(max(|q|^2, 1e-24))
  const float dot = t.sq >= 1e-24f ? w * dqw + x * dqx + y * dqy + z * dqz : 0.0f;
  g.quats[4 * o] = (dqw - dot * w) / t.nrm;
  g.quats[4 * o + 1] = (dqx - dot * x) / t.nrm;
  g.quats[4 * o + 2] = (dqy - dot * y) / t.nrm;
  g.quats[4 * o + 3] = (dqz - dot * z) / t.nrm;

  // t0 = j00 W0 + j02 W2, t1 = j11 W1 + j12 W2
  float dj00 = 0.0f, dj02 = 0.0f, dj11 = 0.0f, dj12 = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dj00 += dt0[k] * __ldg(W + k);
    dj02 += dt0[k] * __ldg(W + 8 + k);
    dj11 += dt1[k] * __ldg(W + 4 + k);
    dj12 += dt1[k] * __ldg(W + 8 + k);
  }
  const float fx = __ldg(cam + kScalars), fy = __ldg(cam + kScalars + 1);
  const float lx = __ldg(cam + kScalars + 2), ly = __ldg(cam + kScalars + 3);
  const float dtx = -fx * t.inv_z2 * dj02;
  const float dty = -fy * t.inv_z2 * dj12;
  const float dinv_z2 = -fx * t.tx * dj02 - fy * t.ty * dj12;
  const float dinv_z = fx * dj00 + fy * dj11 + 2.0f * t.inv_z * dinv_z2;
  float dz = -dinv_z * t.inv_z * t.inv_z + gd;
  // tx = clamp(px / z, -lim, lim) * z, the clamp's gradient 1 on [-lim, lim]
  const float du = (t.u >= -lx && t.u <= lx) ? dtx * t.depth : 0.0f;
  const float dv = (t.v >= -ly && t.v <= ly) ? dty * t.depth : 0.0f;
  dz += dtx * clampf(t.u, -lx, lx) + dty * clampf(t.v, -ly, ly) - du * t.u / t.depth -
        dv * t.v / t.depth;
  const float dpx = du / t.depth, dpy = dv / t.depth;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dm[k] += dpx * __ldg(W + k) + dpy * __ldg(W + 4 + k) + dz * __ldg(W + 8 + k);
    g.means3d[3 * o + k] = dm[k];
  }
}

}  // namespace

// cams: (n_views, kCamFloats) float32 on the device, one row a view
extern "C" int project_fwd(ProjectInputs in, const float* cams, ProjectShape sh, int n_views,
                           ProjectOutputs out, cudaStream_t stream) {
  if (n_views < 1 || n_views > 65535) return (int)cudaErrorInvalidValue;
  const long long blocks = (sh.n + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  project_fwd_kernel<<<dim3((unsigned)blocks, n_views), kThreads, 0, stream>>>(in, cams, sh, out);
  return (int)cudaGetLastError();
}

extern "C" int project_bwd(ProjectInputs in, const float* cams, ProjectShape sh, int n_views,
                           ProjectGrads g, cudaStream_t stream) {
  if (n_views < 1 || n_views > 65535) return (int)cudaErrorInvalidValue;
  const long long blocks = (sh.n + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  project_bwd_kernel<<<dim3((unsigned)blocks, n_views), kThreads, 0, stream>>>(in, cams, sh, g);
  return (int)cudaGetLastError();
}
