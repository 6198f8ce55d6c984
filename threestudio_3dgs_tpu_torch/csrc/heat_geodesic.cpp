// Heat-method geodesic distances on a triangle mesh (Crane et al. 2013).
//
// TPU-native replacement for the reference's potpourri3d C++ dependency
// (reference geometry/dynamic_sugar.py:38,741-766: heat-method geodesic
// skinning weights for the deformation graph).  Host-side native component:
// CSR cotangent Laplacian + lumped mass assembly, Jacobi-preconditioned
// conjugate-gradient solves for the heat step (M + tL)u = delta and the
// Poisson step L phi = div X, one pair per source vertex.
//
// C ABI (ctypes, no pybind11 in this image):
//   heat_geodesic(verts f32[nv*3], nv, faces i32[nf*3], nf,
//                 sources i32[ns], ns, out f32[ns*nv]) -> 0 on success

#include <cmath>
#include <cstring>
#include <vector>
#include <map>
#include <algorithm>

namespace {

struct CSR {
  std::vector<long> rowptr;
  std::vector<int> col;
  std::vector<double> val;
  long n = 0;
};

// y = A x
static void spmv(const CSR& A, const std::vector<double>& x,
                 std::vector<double>& y) {
  for (long i = 0; i < A.n; ++i) {
    double acc = 0.0;
    for (long k = A.rowptr[i]; k < A.rowptr[i + 1]; ++k)
      acc += A.val[k] * x[A.col[k]];
    y[i] = acc;
  }
}

// Jacobi-preconditioned CG; returns iterations used.
static int cg(const CSR& A, const std::vector<double>& b,
              std::vector<double>& x, int max_iter, double tol) {
  long n = A.n;
  std::vector<double> r(n), z(n), p(n), Ap(n), dinv(n);
  for (long i = 0; i < n; ++i) {
    double d = 1e-30;
    for (long k = A.rowptr[i]; k < A.rowptr[i + 1]; ++k)
      if (A.col[k] == i) d = A.val[k];
    dinv[i] = 1.0 / d;
  }
  std::fill(x.begin(), x.end(), 0.0);
  r = b;
  double bnorm = 0.0;
  for (long i = 0; i < n; ++i) bnorm += b[i] * b[i];
  if (bnorm < 1e-300) return 0;
  for (long i = 0; i < n; ++i) z[i] = dinv[i] * r[i];
  p = z;
  double rz = 0.0;
  for (long i = 0; i < n; ++i) rz += r[i] * z[i];
  int it = 0;
  for (; it < max_iter; ++it) {
    spmv(A, p, Ap);
    double pAp = 1e-300;
    for (long i = 0; i < n; ++i) pAp += p[i] * Ap[i];
    double alpha = rz / pAp;
    double rnorm = 0.0;
    for (long i = 0; i < n; ++i) {
      x[i] += alpha * p[i];
      r[i] -= alpha * Ap[i];
      rnorm += r[i] * r[i];
    }
    if (rnorm <= tol * tol * bnorm) break;
    double rz_new = 0.0;
    for (long i = 0; i < n; ++i) {
      z[i] = dinv[i] * r[i];
      rz_new += r[i] * z[i];
    }
    double beta = rz_new / rz;
    rz = rz_new;
    for (long i = 0; i < n; ++i) p[i] = z[i] + beta * p[i];
  }
  return it;
}

static void build_csr(long nv, const std::vector<std::map<int, double>>& rows,
                      CSR& A) {
  A.n = nv;
  A.rowptr.assign(nv + 1, 0);
  for (long i = 0; i < nv; ++i) A.rowptr[i + 1] = A.rowptr[i] + rows[i].size();
  A.col.resize(A.rowptr[nv]);
  A.val.resize(A.rowptr[nv]);
  for (long i = 0; i < nv; ++i) {
    long k = A.rowptr[i];
    for (auto& kv : rows[i]) {
      A.col[k] = kv.first;
      A.val[k] = kv.second;
      ++k;
    }
  }
}

}  // namespace

extern "C" int heat_geodesic(const float* verts, long nv, const int* faces,
                             long nf, const int* sources, long ns,
                             float* out) {
  if (nv <= 0 || nf <= 0 || ns <= 0) return 1;
  auto V = [&](long i, int c) -> double { return verts[i * 3 + c]; };

  // --- cotan weights, lumped mass, mean edge length -----------------------
  std::vector<std::map<int, double>> Lrows(nv);  // stiffness (PSD)
  std::vector<double> mass(nv, 0.0);
  double edge_sum = 0.0;
  long edge_cnt = 0;
  std::vector<double> face_area(nf);
  for (long f = 0; f < nf; ++f) {
    int i = faces[f * 3], j = faces[f * 3 + 1], k = faces[f * 3 + 2];
    if (i < 0 || j < 0 || k < 0 || i >= nv || j >= nv || k >= nv) return 2;
    double e[3][3];  // edge vectors opposite each corner
    for (int c = 0; c < 3; ++c) {
      e[0][c] = V(k, c) - V(j, c);  // opposite i
      e[1][c] = V(i, c) - V(k, c);  // opposite j
      e[2][c] = V(j, c) - V(i, c);  // opposite k
    }
    double cxx = e[1][1] * e[2][2] - e[1][2] * e[2][1];
    double cyy = e[1][2] * e[2][0] - e[1][0] * e[2][2];
    double czz = e[1][0] * e[2][1] - e[1][1] * e[2][0];
    double area2 = std::sqrt(cxx * cxx + cyy * cyy + czz * czz);
    double area = 0.5 * std::max(area2, 1e-16);
    face_area[f] = area;
    int vid[3] = {i, j, k};
    for (int c = 0; c < 3; ++c) {
      mass[vid[c]] += area / 3.0;
      edge_sum += std::sqrt(e[c][0] * e[c][0] + e[c][1] * e[c][1] +
                            e[c][2] * e[c][2]);
      ++edge_cnt;
      // cot at corner c weights the edge OPPOSITE c (between the other two)
      int a = vid[(c + 1) % 3], b = vid[(c + 2) % 3];
      double dot = -(e[(c + 1) % 3][0] * e[(c + 2) % 3][0] +
                     e[(c + 1) % 3][1] * e[(c + 2) % 3][1] +
                     e[(c + 1) % 3][2] * e[(c + 2) % 3][2]);
      double cot = dot / (2.0 * area);
      double w = 0.5 * cot;
      Lrows[a][b] -= w;
      Lrows[b][a] -= w;
      Lrows[a][a] += w;
      Lrows[b][b] += w;
    }
  }
  double h = edge_sum / std::max(edge_cnt, 1L);
  double t = h * h;

  CSR L;
  build_csr(nv, Lrows, L);
  // A1 = M + t L ; A2 = L + eps M (regularized Poisson)
  CSR A1 = L, A2 = L;
  for (long i = 0; i < nv; ++i) {
    for (long k = A1.rowptr[i]; k < A1.rowptr[i + 1]; ++k) {
      if (A1.col[k] == i) {
        A1.val[k] = mass[i] + t * L.val[k];
        A2.val[k] = L.val[k] + 1e-8 * mass[i];
      } else {
        A1.val[k] = t * L.val[k];
      }
    }
  }

  std::vector<double> u(nv), b(nv), phi(nv), divx(nv);
  std::vector<double> gx(nf), gy(nf), gz(nf);
  for (long s = 0; s < ns; ++s) {
    int src = sources[s];
    if (src < 0 || src >= nv) return 3;
    // heat step
    std::fill(b.begin(), b.end(), 0.0);
    b[src] = 1.0;
    cg(A1, b, u, 2000, 1e-10);
    // face gradients of u, normalized and negated
    for (long f = 0; f < nf; ++f) {
      int i = faces[f * 3], j = faces[f * 3 + 1], k = faces[f * 3 + 2];
      double e0[3], e1[3], n[3];
      for (int c = 0; c < 3; ++c) {
        e0[c] = V(j, c) - V(i, c);
        e1[c] = V(k, c) - V(i, c);
      }
      n[0] = e0[1] * e1[2] - e0[2] * e1[1];
      n[1] = e0[2] * e1[0] - e0[0] * e1[2];
      n[2] = e0[0] * e1[1] - e0[1] * e1[0];
      double nl = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]) + 1e-30;
      for (int c = 0; c < 3; ++c) n[c] /= nl;
      // grad u = (1/2A) sum_i u_i (N x e_opp_i)
      double g[3] = {0, 0, 0};
      double uu[3] = {u[i], u[j], u[k]};
      double eo[3][3];
      for (int c = 0; c < 3; ++c) {
        eo[0][c] = V(k, c) - V(j, c);
        eo[1][c] = V(i, c) - V(k, c);
        eo[2][c] = V(j, c) - V(i, c);
      }
      for (int v = 0; v < 3; ++v) {
        double cx = n[1] * eo[v][2] - n[2] * eo[v][1];
        double cy = n[2] * eo[v][0] - n[0] * eo[v][2];
        double cz = n[0] * eo[v][1] - n[1] * eo[v][0];
        g[0] += uu[v] * cx;
        g[1] += uu[v] * cy;
        g[2] += uu[v] * cz;
      }
      double gl = std::sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]) + 1e-30;
      gx[f] = -g[0] / gl;
      gy[f] = -g[1] / gl;
      gz[f] = -g[2] / gl;
    }
    // divergence at vertices
    std::fill(divx.begin(), divx.end(), 0.0);
    for (long f = 0; f < nf; ++f) {
      int vid[3] = {faces[f * 3], faces[f * 3 + 1], faces[f * 3 + 2]};
      double X[3] = {gx[f], gy[f], gz[f]};
      auto cot_at = [](const double* a, const double* bb) {
        double dot = a[0] * bb[0] + a[1] * bb[1] + a[2] * bb[2];
        double cx = a[1] * bb[2] - a[2] * bb[1];
        double cy = a[2] * bb[0] - a[0] * bb[2];
        double cz = a[0] * bb[1] - a[1] * bb[0];
        double cl = std::sqrt(cx * cx + cy * cy + cz * cz) + 1e-30;
        return dot / cl;
      };
      for (int c = 0; c < 3; ++c) {
        int p = vid[c], q = vid[(c + 1) % 3], r = vid[(c + 2) % 3];
        double e1[3], e2[3], rp[3], rq[3], qp[3], qr[3];
        for (int d = 0; d < 3; ++d) {
          e1[d] = V(q, d) - V(p, d);
          e2[d] = V(r, d) - V(p, d);
          rp[d] = V(p, d) - V(r, d);
          rq[d] = V(q, d) - V(r, d);
          qp[d] = V(p, d) - V(q, d);
          qr[d] = V(r, d) - V(q, d);
        }
        // angle at r (opposite edge p-q) and at q (opposite edge p-r)
        double cot_r = cot_at(rp, rq);
        double cot_q = cot_at(qp, qr);
        double d1 = e1[0] * X[0] + e1[1] * X[1] + e1[2] * X[2];
        double d2 = e2[0] * X[0] + e2[1] * X[1] + e2[2] * X[2];
        divx[p] += 0.5 * (cot_r * d1 + cot_q * d2);
      }
    }
    // Poisson step: L is the PSD stiffness matrix (= -Laplacian in weak
    // form), so solve L phi = -div
    for (long i = 0; i < nv; ++i) divx[i] = -divx[i];
    cg(A2, divx, phi, 2000, 1e-10);
    double mn = phi[src];
    for (long i = 0; i < nv; ++i) {
      double d = phi[i] - mn;
      out[s * nv + i] = (float)(d < 0.0 ? 0.0 : d);
    }
  }
  return 0;
}
