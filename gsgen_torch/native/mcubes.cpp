// Isosurface extraction (marching tetrahedra) — native mesh-export core.
//
// Replaces the reference's PyMCubes dependency (utils/export.py:148-155
// in gsgen3d/gsgen) with a first-principles implementation: each grid
// cell splits into 6 tetrahedra; each tetrahedron contributes 0-2
// triangles with vertices linearly interpolated onto its edges.
// Vertices are deduplicated per grid edge, so the mesh is watertight
// and index-shared like PyMCubes output.
//
// C ABI (ctypes-friendly):
//   mt_marching_tetrahedra(grid, nx, ny, nz, iso,
//                          verts_out, verts_cap, faces_out, faces_cap,
//                          &n_verts, &n_faces) -> 0 ok / 1 overflow
//
// grid is float32, C-order [nx, ny, nz]; verts_out receives x,y,z in
// grid-index units; faces_out receives int32 triples.

#include <cstdint>
#include <cstdlib>
#include <unordered_map>
#include <vector>

namespace {

struct EdgeKey {
    uint64_t a, b;
    bool operator==(const EdgeKey &o) const { return a == o.a && b == o.b; }
};

struct EdgeKeyHash {
    size_t operator()(const EdgeKey &k) const {
        return std::hash<uint64_t>()(k.a * 1000003ull ^ k.b);
    }
};

// The 6-tetrahedra decomposition of a unit cube (corner indices 0-7,
// corner c = (x + (c&1), y + ((c>>1)&1), z + ((c>>2)&1))).  All six
// share the main diagonal 0-7, guaranteeing face-consistent splits
// between neighboring cells.
constexpr int kTets[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

}  // namespace

extern "C" int mt_marching_tetrahedra(
    const float *grid, int64_t nx, int64_t ny, int64_t nz, float iso,
    float *verts_out, int64_t verts_cap,
    int32_t *faces_out, int64_t faces_cap,
    int64_t *n_verts, int64_t *n_faces) {
  auto gid = [&](int64_t x, int64_t y, int64_t z) -> uint64_t {
    return (uint64_t)(x * ny + y) * (uint64_t)nz + (uint64_t)z;
  };
  auto val = [&](int64_t x, int64_t y, int64_t z) -> float {
    return grid[(x * ny + y) * nz + z];
  };

  std::unordered_map<EdgeKey, int32_t, EdgeKeyHash> edge_vert;
  edge_vert.reserve(1 << 16);
  int64_t nv = 0, nf = 0;

  // returns vertex index for the iso crossing on grid edge (ga, gb)
  auto vert_on_edge = [&](uint64_t ga, float va, float xa, float ya, float za,
                          uint64_t gb, float vb, float xb, float yb,
                          float zb) -> int32_t {
    EdgeKey key = ga < gb ? EdgeKey{ga, gb} : EdgeKey{gb, ga};
    auto it = edge_vert.find(key);
    if (it != edge_vert.end()) return it->second;
    float t = (iso - va) / (vb - va);
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    if (nv >= verts_cap) return -1;
    verts_out[nv * 3 + 0] = xa + t * (xb - xa);
    verts_out[nv * 3 + 1] = ya + t * (yb - ya);
    verts_out[nv * 3 + 2] = za + t * (zb - za);
    int32_t id = (int32_t)nv++;
    edge_vert.emplace(key, id);
    return id;
  };

  for (int64_t x = 0; x + 1 < nx; ++x) {
    for (int64_t y = 0; y + 1 < ny; ++y) {
      for (int64_t z = 0; z + 1 < nz; ++z) {
        float cv[8];
        float cx[8], cy[8], cz[8];
        uint64_t cg[8];
        for (int c = 0; c < 8; ++c) {
          int64_t xx = x + (c & 1), yy = y + ((c >> 1) & 1),
                  zz = z + ((c >> 2) & 1);
          cv[c] = val(xx, yy, zz);
          cx[c] = (float)xx;
          cy[c] = (float)yy;
          cz[c] = (float)zz;
          cg[c] = gid(xx, yy, zz);
        }
        for (const auto &tet : kTets) {
          int in[4], ni = 0, out[4], no = 0;
          for (int i = 0; i < 4; ++i) {
            if (cv[tet[i]] >= iso)
              in[ni++] = tet[i];
            else
              out[no++] = tet[i];
          }
          if (ni == 0 || ni == 4) continue;

          int32_t tri[6];
          int ntri = 0;
          auto emit_edge = [&](int a, int b) -> int32_t {
            return vert_on_edge(cg[a], cv[a], cx[a], cy[a], cz[a],
                                cg[b], cv[b], cx[b], cy[b], cz[b]);
          };
          if (ni == 1) {
            tri[0] = emit_edge(in[0], out[0]);
            tri[1] = emit_edge(in[0], out[1]);
            tri[2] = emit_edge(in[0], out[2]);
            ntri = 1;
          } else if (ni == 3) {
            tri[0] = emit_edge(in[0], out[0]);
            tri[1] = emit_edge(in[1], out[0]);
            tri[2] = emit_edge(in[2], out[0]);
            ntri = 1;
          } else {  // 2 in, 2 out -> quad -> 2 triangles
            int32_t v00 = emit_edge(in[0], out[0]);
            int32_t v01 = emit_edge(in[0], out[1]);
            int32_t v10 = emit_edge(in[1], out[0]);
            int32_t v11 = emit_edge(in[1], out[1]);
            tri[0] = v00; tri[1] = v01; tri[2] = v11;
            tri[3] = v00; tri[4] = v11; tri[5] = v10;
            ntri = 2;
          }
          for (int t = 0; t < ntri; ++t) {
            if (tri[3 * t] < 0 || tri[3 * t + 1] < 0 || tri[3 * t + 2] < 0)
              return 1;  // vertex overflow
            if (nf >= faces_cap) return 1;
            faces_out[nf * 3 + 0] = tri[3 * t];
            faces_out[nf * 3 + 1] = tri[3 * t + 1];
            faces_out[nf * 3 + 2] = tri[3 * t + 2];
            ++nf;
          }
        }
      }
    }
  }
  *n_verts = nv;
  *n_faces = nf;
  return 0;
}
