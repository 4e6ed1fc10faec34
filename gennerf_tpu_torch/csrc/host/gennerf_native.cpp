// Host-side C++ of the PyTorch/CUDA port (gennerf_tpu_torch): marching
// cubes, nearest-neighbour distances through a 3D KD-tree, and a software
// depth rasterizer. The port's own copy of the routines it needs from the
// JAX package's native/gennerf_native.cpp, so that it builds and loads
// nothing outside its own tree.
//
//  * marching_cubes: isosurface extraction by marching tetrahedra (6-tet
//    cube decomposition, shared vertices welded on edge keys); vertices in
//    voxel coordinates, as skimage returns them.
//  * nn_distances: for each query point, the distance to its nearest
//    target point.
//  * rasterize_depth: a z-buffer of a triangle mesh seen by a pinhole
//    camera (offline evaluation renders the predicted mesh at the ground
//    truth's views with it).
//  * rasterize_shaded: the same z-buffer with each face lambert-shaded
//    into an RGB image (the validation tail's comparison renders).
//
// Built on first use by gennerf_tpu_torch/utils/native.py (the host C++
// compiler, -O3 -march=native -std=c++17 -shared -fPIC) and loaded with
// ctypes; plain C entry points.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>
#include <algorithm>

extern "C" {

void free_buffer(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Marching tetrahedra isosurface extraction
// ---------------------------------------------------------------------------

namespace {

struct V3 {
  float x, y, z;
};

// The 6-tetrahedra decomposition of a cube, as indices into the cube's 8
// corners (corner k has offsets ((k>>2)&1, (k>>1)&1, k&1) in (x, y, z)).
static const int kTets[6][4] = {
    {0, 5, 1, 6}, {0, 1, 3, 6}, {0, 3, 2, 6},
    {0, 2, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

// Unique key for an interpolated vertex on the segment between two grid
// nodes (node ids fit in 32 bits for volumes up to ~2^32 nodes).
static inline uint64_t edge_key(uint64_t a, uint64_t b) {
  if (a > b) std::swap(a, b);
  return (a << 32) | b;
}

struct MeshAccumulator {
  std::vector<float> verts;   // xyz triples
  std::vector<int> faces;     // index triples
  std::unordered_map<uint64_t, int> edge_to_vertex;

  int vertex_on_edge(uint64_t ka, uint64_t kb, const V3& pa, const V3& pb,
                     float va, float vb, float level) {
    uint64_t key = edge_key(ka, kb);
    auto it = edge_to_vertex.find(key);
    if (it != edge_to_vertex.end()) return it->second;
    float denom = vb - va;
    float t = denom != 0.0f ? (level - va) / denom : 0.5f;
    t = std::min(1.0f, std::max(0.0f, t));
    int id = static_cast<int>(verts.size() / 3);
    verts.push_back(pa.x + t * (pb.x - pa.x));
    verts.push_back(pa.y + t * (pb.y - pa.y));
    verts.push_back(pa.z + t * (pb.z - pa.z));
    edge_to_vertex.emplace(key, id);
    return id;
  }
};

}  // namespace

// volume: nx*ny*nz floats, x-major (index = (x*ny + y)*nz + z).
// Returns 0 on success; caller frees *out_verts / *out_faces via free_buffer.
int marching_cubes(const float* volume, int nx, int ny, int nz, float level,
                   float** out_verts, int** out_faces, int* n_verts,
                   int* n_faces) {
  if (nx < 2 || ny < 2 || nz < 2) {
    *out_verts = nullptr;
    *out_faces = nullptr;
    *n_verts = 0;
    *n_faces = 0;
    return 0;
  }
  MeshAccumulator mb;
  auto node = [&](int x, int y, int z) -> uint64_t {
    return (static_cast<uint64_t>(x) * ny + y) * nz + z;
  };
  auto val = [&](int x, int y, int z) -> float {
    return volume[(static_cast<size_t>(x) * ny + y) * nz + z];
  };

  int corner_off[8][3];
  for (int k = 0; k < 8; ++k) {
    corner_off[k][0] = (k >> 2) & 1;
    corner_off[k][1] = (k >> 1) & 1;
    corner_off[k][2] = k & 1;
  }

  for (int x = 0; x + 1 < nx; ++x) {
    for (int y = 0; y + 1 < ny; ++y) {
      for (int z = 0; z + 1 < nz; ++z) {
        float cv[8];
        uint64_t cid[8];
        V3 cp[8];
        bool any_lo = false, any_hi = false;
        for (int k = 0; k < 8; ++k) {
          int cx = x + corner_off[k][0];
          int cy = y + corner_off[k][1];
          int cz = z + corner_off[k][2];
          cv[k] = val(cx, cy, cz);
          cid[k] = node(cx, cy, cz);
          cp[k] = {static_cast<float>(cx), static_cast<float>(cy),
                   static_cast<float>(cz)};
          (cv[k] < level ? any_lo : any_hi) = true;
        }
        if (!any_lo || !any_hi) continue;  // no crossing in this cube

        for (const auto& tet : kTets) {
          int idx[4] = {tet[0], tet[1], tet[2], tet[3]};
          // classify corners
          int inside_mask = 0;
          for (int k = 0; k < 4; ++k)
            if (cv[idx[k]] < level) inside_mask |= 1 << k;
          if (inside_mask == 0 || inside_mask == 15) continue;

          // collect inside/outside corner lists (order preserved)
          int in_c[4], out_c[4], ni = 0, no = 0;
          for (int k = 0; k < 4; ++k) {
            if (inside_mask & (1 << k))
              in_c[ni++] = idx[k];
            else
              out_c[no++] = idx[k];
          }
          auto emit = [&](int a, int b, int c) {
            mb.faces.push_back(a);
            mb.faces.push_back(b);
            mb.faces.push_back(c);
          };
          auto vtx = [&](int a, int b) {
            return mb.vertex_on_edge(cid[a], cid[b], cp[a], cp[b], cv[a],
                                     cv[b], level);
          };
          if (ni == 1) {  // one inside: single triangle
            int a = in_c[0];
            emit(vtx(a, out_c[0]), vtx(a, out_c[1]), vtx(a, out_c[2]));
          } else if (ni == 3) {  // one outside: single triangle
            int a = out_c[0];
            emit(vtx(a, in_c[0]), vtx(a, in_c[1]), vtx(a, in_c[2]));
          } else {  // 2-2: quad as two triangles
            int a = in_c[0], b = in_c[1], c = out_c[0], d = out_c[1];
            int v0 = vtx(a, c), v1 = vtx(a, d), v2 = vtx(b, d), v3 = vtx(b, c);
            emit(v0, v1, v2);
            emit(v0, v2, v3);
          }
        }
      }
    }
  }

  *n_verts = static_cast<int>(mb.verts.size() / 3);
  *n_faces = static_cast<int>(mb.faces.size() / 3);
  *out_verts = static_cast<float*>(std::malloc(mb.verts.size() * sizeof(float)));
  *out_faces = static_cast<int*>(std::malloc(mb.faces.size() * sizeof(int)));
  if ((!*out_verts && !mb.verts.empty()) || (!*out_faces && !mb.faces.empty()))
    return 1;
  if (!mb.verts.empty())
    std::memcpy(*out_verts, mb.verts.data(), mb.verts.size() * sizeof(float));
  if (!mb.faces.empty())
    std::memcpy(*out_faces, mb.faces.data(), mb.faces.size() * sizeof(int));
  return 0;
}

// ---------------------------------------------------------------------------
// KD-tree nearest neighbor distances
// ---------------------------------------------------------------------------

namespace {

struct KDNode {
  float pt[3];
  int left = -1, right = -1;
  int axis = 0;
};

struct Pt {
  float p[3];
};

int build_kd(std::vector<KDNode>& nodes, std::vector<Pt>& pts, int lo, int hi,
             int depth) {
  if (lo >= hi) return -1;
  int axis = depth % 3;
  int mid = (lo + hi) / 2;
  std::nth_element(pts.begin() + lo, pts.begin() + mid, pts.begin() + hi,
                   [axis](const Pt& a, const Pt& b) {
                     return a.p[axis] < b.p[axis];
                   });
  int id = static_cast<int>(nodes.size());
  nodes.push_back(KDNode());
  nodes[id].pt[0] = pts[mid].p[0];
  nodes[id].pt[1] = pts[mid].p[1];
  nodes[id].pt[2] = pts[mid].p[2];
  nodes[id].axis = axis;
  int l = build_kd(nodes, pts, lo, mid, depth + 1);
  int r = build_kd(nodes, pts, mid + 1, hi, depth + 1);
  nodes[id].left = l;
  nodes[id].right = r;
  return id;
}

void query_kd(const std::vector<KDNode>& nodes, int id, const float* q,
              float& best) {
  if (id < 0) return;
  const KDNode& n = nodes[id];
  float dx = q[0] - n.pt[0], dy = q[1] - n.pt[1], dz = q[2] - n.pt[2];
  float d2 = dx * dx + dy * dy + dz * dz;
  if (d2 < best) best = d2;
  float delta = q[n.axis] - n.pt[n.axis];
  int near = delta < 0 ? n.left : n.right;
  int far = delta < 0 ? n.right : n.left;
  query_kd(nodes, near, q, best);
  if (delta * delta < best) query_kd(nodes, far, q, best);
}

}  // namespace

// ---------------------------------------------------------------------------
// Software depth rasterizer (pyrender/EGL replacement for offline eval)
// ---------------------------------------------------------------------------

// Rasterize a triangle mesh's z-buffer into a pinhole camera.
//   verts: n_v * 3 world-space vertices
//   faces: n_f * 3 vertex indices
//   world2cam: 4x4 row-major (camera = world2cam @ world)
//   K: fx, fy, cx, cy
// Writes depth[H*W] (0 where no geometry).
void rasterize_depth(const float* verts, int n_v, const int* faces, int n_f,
                     const float* world2cam, float fx, float fy, float cx,
                     float cy, int height, int width, float* depth) {
  std::fill(depth, depth + static_cast<size_t>(height) * width, 0.0f);
  std::vector<float> cam(static_cast<size_t>(n_v) * 3);
  for (int i = 0; i < n_v; ++i) {
    const float* v = verts + 3 * i;
    for (int r = 0; r < 3; ++r) {
      cam[3 * i + r] = world2cam[4 * r + 0] * v[0] + world2cam[4 * r + 1] * v[1] +
                       world2cam[4 * r + 2] * v[2] + world2cam[4 * r + 3];
    }
  }
  auto proj_u = [&](int i) { return fx * cam[3 * i] / cam[3 * i + 2] + cx; };
  auto proj_v = [&](int i) { return fy * cam[3 * i + 1] / cam[3 * i + 2] + cy; };

  for (int f = 0; f < n_f; ++f) {
    int a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
    float za = cam[3 * a + 2], zb = cam[3 * b + 2], zc = cam[3 * c + 2];
    if (za <= 1e-6f || zb <= 1e-6f || zc <= 1e-6f) continue;  // clip behind camera
    float ua = proj_u(a), va = proj_v(a);
    float ub = proj_u(b), vb = proj_v(b);
    float uc = proj_u(c), vc = proj_v(c);
    int x0 = std::max(0, (int)std::floor(std::min({ua, ub, uc})));
    int x1 = std::min(width - 1, (int)std::ceil(std::max({ua, ub, uc})));
    int y0 = std::max(0, (int)std::floor(std::min({va, vb, vc})));
    int y1 = std::min(height - 1, (int)std::ceil(std::max({va, vb, vc})));
    if (x0 > x1 || y0 > y1) continue;
    float denom = (vb - vc) * (ua - uc) + (uc - ub) * (va - vc);
    if (std::abs(denom) < 1e-12f) continue;
    float inv_za = 1.0f / za, inv_zb = 1.0f / zb, inv_zc = 1.0f / zc;
    for (int y = y0; y <= y1; ++y) {
      for (int x = x0; x <= x1; ++x) {
        float px = x + 0.0f, py = y + 0.0f;
        float w0 = ((vb - vc) * (px - uc) + (uc - ub) * (py - vc)) / denom;
        float w1 = ((vc - va) * (px - uc) + (ua - uc) * (py - vc)) / denom;
        float w2 = 1.0f - w0 - w1;
        if (w0 < -1e-5f || w1 < -1e-5f || w2 < -1e-5f) continue;
        // perspective-correct depth: interpolate 1/z
        float inv_z = w0 * inv_za + w1 * inv_zb + w2 * inv_zc;
        float z = 1.0f / inv_z;
        float& d = depth[static_cast<size_t>(y) * width + x];
        if (d == 0.0f || z < d) d = z;
      }
    }
  }
}

// Rasterize a lambert-shaded color render (pyrender logging replacement).
//   base_color: 3 floats in [0,1]; light_dir: world-space direction.
// Writes rgb[H*W*3] uint8 (white background) and depth[H*W].
void rasterize_shaded(const float* verts, int n_v, const int* faces, int n_f,
                      const float* world2cam, float fx, float fy, float cx,
                      float cy, int height, int width, const float* base_color,
                      const float* light_dir, unsigned char* rgb,
                      float* depth) {
  size_t npix = static_cast<size_t>(height) * width;
  std::fill(depth, depth + npix, 0.0f);
  std::fill(rgb, rgb + npix * 3, (unsigned char)255);
  std::vector<float> cam(static_cast<size_t>(n_v) * 3);
  for (int i = 0; i < n_v; ++i) {
    const float* v = verts + 3 * i;
    for (int r = 0; r < 3; ++r) {
      cam[3 * i + r] = world2cam[4 * r + 0] * v[0] + world2cam[4 * r + 1] * v[1] +
                       world2cam[4 * r + 2] * v[2] + world2cam[4 * r + 3];
    }
  }
  float ld[3] = {light_dir[0], light_dir[1], light_dir[2]};
  float ln = std::sqrt(ld[0] * ld[0] + ld[1] * ld[1] + ld[2] * ld[2]);
  for (float& x : ld) x /= std::max(ln, 1e-9f);

  for (int f = 0; f < n_f; ++f) {
    int a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
    float za = cam[3 * a + 2], zb = cam[3 * b + 2], zc = cam[3 * c + 2];
    if (za <= 1e-6f || zb <= 1e-6f || zc <= 1e-6f) continue;
    // world-space face normal for shading
    const float* va = verts + 3 * a;
    const float* vb = verts + 3 * b;
    const float* vc = verts + 3 * c;
    float e1[3] = {vb[0] - va[0], vb[1] - va[1], vb[2] - va[2]};
    float e2[3] = {vc[0] - va[0], vc[1] - va[1], vc[2] - va[2]};
    float n[3] = {e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                  e1[0] * e2[1] - e1[1] * e2[0]};
    float nn = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (nn < 1e-12f) continue;
    float lambert = std::abs(n[0] * ld[0] + n[1] * ld[1] + n[2] * ld[2]) / nn;
    float shade = 0.25f + 0.75f * lambert;

    float ua = fx * cam[3 * a] / za + cx, vva = fy * cam[3 * a + 1] / za + cy;
    float ub = fx * cam[3 * b] / zb + cx, vvb = fy * cam[3 * b + 1] / zb + cy;
    float uc = fx * cam[3 * c] / zc + cx, vvc = fy * cam[3 * c + 1] / zc + cy;
    int x0 = std::max(0, (int)std::floor(std::min({ua, ub, uc})));
    int x1 = std::min(width - 1, (int)std::ceil(std::max({ua, ub, uc})));
    int y0 = std::max(0, (int)std::floor(std::min({vva, vvb, vvc})));
    int y1 = std::min(height - 1, (int)std::ceil(std::max({vva, vvb, vvc})));
    if (x0 > x1 || y0 > y1) continue;
    float denom = (vvb - vvc) * (ua - uc) + (uc - ub) * (vva - vvc);
    if (std::abs(denom) < 1e-12f) continue;
    float inv_za = 1.0f / za, inv_zb = 1.0f / zb, inv_zc = 1.0f / zc;
    for (int y = y0; y <= y1; ++y) {
      for (int x = x0; x <= x1; ++x) {
        float w0 = ((vvb - vvc) * (x - uc) + (uc - ub) * (y - vvc)) / denom;
        float w1 = ((vvc - vva) * (x - uc) + (ua - uc) * (y - vvc)) / denom;
        float w2 = 1.0f - w0 - w1;
        if (w0 < -1e-5f || w1 < -1e-5f || w2 < -1e-5f) continue;
        float z = 1.0f / (w0 * inv_za + w1 * inv_zb + w2 * inv_zc);
        float& d = depth[static_cast<size_t>(y) * width + x];
        if (d == 0.0f || z < d) {
          d = z;
          unsigned char* px = rgb + (static_cast<size_t>(y) * width + x) * 3;
          for (int k = 0; k < 3; ++k) {
            float v = base_color[k] * shade * 255.0f;
            px[k] = (unsigned char)std::min(255.0f, std::max(0.0f, v));
          }
        }
      }
    }
  }
}

// For each of n_q query points, Euclidean distance to nearest of n_t targets.
void nn_distances(const float* queries, int n_q, const float* targets, int n_t,
                  float* out) {
  if (n_t == 0) {
    for (int i = 0; i < n_q; ++i) out[i] = INFINITY;
    return;
  }
  std::vector<Pt> pts(n_t);
  std::memcpy(pts.data(), targets, sizeof(float) * 3 * n_t);
  std::vector<KDNode> nodes;
  nodes.reserve(n_t);
  int root = build_kd(nodes, pts, 0, n_t, 0);
  for (int i = 0; i < n_q; ++i) {
    float best = INFINITY;
    query_kd(nodes, root, queries + 3 * i, best);
    out[i] = std::sqrt(best);
  }
}

}  // extern "C"
