// Quadric edge-collapse mesh decimation (Garland-Heckbert).
//
// Native replacement for the pymeshlab / pyfqmr decimators the reference
// shells out to at export time (reference geometry/mesh_utils.py:44-87).
// Host-side C++ (compiled with g++ -O2, bound via ctypes): decimation is a
// pointer-chasing priority-queue algorithm with data-dependent control flow
// -- the one part of the pipeline that genuinely does not map to XLA.
//
// Exported C API:
//   int decimate_mesh(const float* verts, long n_verts,
//                     const int* faces, long n_faces,
//                     long target_faces,
//                     float* out_verts, long* out_n_verts,
//                     int* out_faces, long* out_n_faces);
// Output buffers must be sized for the input counts; returns 0 on success.

#include <array>
#include <cmath>
#include <functional>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Quadric {
  double m[10] = {0};  // symmetric 4x4: xx xy xz xw yy yz yw zz zw ww
  void add_plane(double a, double b, double c, double d) {
    m[0] += a * a; m[1] += a * b; m[2] += a * c; m[3] += a * d;
    m[4] += b * b; m[5] += b * c; m[6] += b * d;
    m[7] += c * c; m[8] += c * d; m[9] += d * d;
  }
  void add(const Quadric& o) {
    for (int i = 0; i < 10; ++i) m[i] += o.m[i];
  }
  double eval(double x, double y, double z) const {
    return m[0] * x * x + 2 * m[1] * x * y + 2 * m[2] * x * z + 2 * m[3] * x +
           m[4] * y * y + 2 * m[5] * y * z + 2 * m[6] * y +
           m[7] * z * z + 2 * m[8] * z + m[9];
  }
};

struct Candidate {
  double cost;
  int u, v;
  long version;
  bool operator<(const Candidate& o) const { return cost > o.cost; }  // min-heap
};

struct V3 {
  double x, y, z;
};

}  // namespace

extern "C" int decimate_mesh(const float* verts_in, long n_verts,
                             const int* faces_in, long n_faces,
                             long target_faces,
                             float* out_verts, long* out_n_verts,
                             int* out_faces, long* out_n_faces) {
  std::vector<V3> pos(n_verts);
  for (long i = 0; i < n_verts; ++i)
    pos[i] = {verts_in[3 * i], verts_in[3 * i + 1], verts_in[3 * i + 2]};

  std::vector<std::array<int, 3>> faces(n_faces);
  for (long f = 0; f < n_faces; ++f)
    faces[f] = {faces_in[3 * f], faces_in[3 * f + 1], faces_in[3 * f + 2]};

  // union-find over collapsed vertices
  std::vector<int> parent(n_verts);
  for (long i = 0; i < n_verts; ++i) parent[i] = (int)i;
  std::function<int(int)> find = [&](int x) {
    while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
    return x;
  };

  // per-vertex quadrics from incident face planes
  std::vector<Quadric> quadrics(n_verts);
  std::vector<std::vector<int>> vert_faces(n_verts);
  auto face_alive = std::vector<char>(n_faces, 1);
  long alive_faces = n_faces;
  for (long f = 0; f < n_faces; ++f) {
    auto [a, b, c] = faces[f];
    const V3 &p = pos[a], &q = pos[b], &r = pos[c];
    double ux = q.x - p.x, uy = q.y - p.y, uz = q.z - p.z;
    double vx = r.x - p.x, vy = r.y - p.y, vz = r.z - p.z;
    double nx = uy * vz - uz * vy, ny = uz * vx - ux * vz, nz = ux * vy - uy * vx;
    double len = std::sqrt(nx * nx + ny * ny + nz * nz);
    if (len < 1e-12) { face_alive[f] = 0; --alive_faces; continue; }
    nx /= len; ny /= len; nz /= len;
    double d = -(nx * p.x + ny * p.y + nz * p.z);
    for (int k : {a, b, c}) {
      quadrics[k].add_plane(nx, ny, nz, d);
      vert_faces[k].push_back((int)f);
    }
  }

  std::vector<long> version(n_verts, 0);
  std::priority_queue<Candidate> heap;

  auto push_edge = [&](int u, int v) {
    u = find(u); v = find(v);
    if (u == v) return;
    Quadric q = quadrics[u];
    q.add(quadrics[v]);
    double mx = 0.5 * (pos[u].x + pos[v].x);
    double my = 0.5 * (pos[u].y + pos[v].y);
    double mz = 0.5 * (pos[u].z + pos[v].z);
    double best = q.eval(mx, my, mz);
    heap.push({best, u, v, version[u] + version[v]});
  };

  std::unordered_set<long long> seen_edges;
  auto edge_key = [](int a, int b) {
    if (a > b) std::swap(a, b);
    return ((long long)a << 32) | (unsigned)b;
  };
  for (long f = 0; f < n_faces; ++f) {
    if (!face_alive[f]) continue;
    for (int e = 0; e < 3; ++e) {
      int a = faces[f][e], b = faces[f][(e + 1) % 3];
      if (seen_edges.insert(edge_key(a, b)).second) push_edge(a, b);
    }
  }

  while (alive_faces > target_faces && !heap.empty()) {
    Candidate c = heap.top();
    heap.pop();
    int u = find(c.u), v = find(c.v);
    if (u == v) continue;
    if (version[u] + version[v] != c.version || u != c.u || v != c.v) continue;

    // collapse v into u at the midpoint
    pos[u] = {0.5 * (pos[u].x + pos[v].x), 0.5 * (pos[u].y + pos[v].y),
              0.5 * (pos[u].z + pos[v].z)};
    quadrics[u].add(quadrics[v]);
    parent[v] = u;
    version[u]++;

    // merge incidence lists; kill degenerate faces; re-push neighbor edges
    std::vector<int> merged;
    merged.reserve(vert_faces[u].size() + vert_faces[v].size());
    for (int side = 0; side < 2; ++side) {
      auto& lst = side ? vert_faces[v] : vert_faces[u];
      for (int f : lst) {
        if (!face_alive[f]) continue;
        int a = find(faces[f][0]), b = find(faces[f][1]), cc = find(faces[f][2]);
        if (a == b || b == cc || a == cc) {
          face_alive[f] = 0;
          --alive_faces;
        } else {
          merged.push_back(f);
        }
      }
    }
    vert_faces[u] = std::move(merged);
    vert_faces[v].clear();

    std::unordered_set<int> nbrs;
    for (int f : vert_faces[u]) {
      for (int k = 0; k < 3; ++k) {
        int w = find(faces[f][k]);
        if (w != u) nbrs.insert(w);
      }
    }
    for (int w : nbrs) push_edge(u, w);
  }

  // compact output
  std::vector<int> remap(n_verts, -1);
  long nv = 0;
  for (long f = 0; f < n_faces; ++f) {
    if (!face_alive[f]) continue;
    for (int k = 0; k < 3; ++k) {
      int r = find(faces[f][k]);
      if (remap[r] < 0) {
        remap[r] = (int)nv;
        out_verts[3 * nv] = (float)pos[r].x;
        out_verts[3 * nv + 1] = (float)pos[r].y;
        out_verts[3 * nv + 2] = (float)pos[r].z;
        ++nv;
      }
    }
  }
  long nf = 0;
  for (long f = 0; f < n_faces; ++f) {
    if (!face_alive[f]) continue;
    out_faces[3 * nf] = remap[find(faces[f][0])];
    out_faces[3 * nf + 1] = remap[find(faces[f][1])];
    out_faces[3 * nf + 2] = remap[find(faces[f][2])];
    ++nf;
  }
  *out_n_verts = nv;
  *out_n_faces = nf;
  return 0;
}
