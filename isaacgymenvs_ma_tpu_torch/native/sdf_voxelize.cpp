// Native mesh -> signed-distance voxel grid (copy of
// isaacgymenvs_ma_tpu/native/sdf_voxelize.cpp for the PyTorch port; the
// code below the header is the same, so both packages bake the same grids
// bit for bit when built with the same flags).
//
// Replaces the reference's mesh-distance stack: PhysX SDF collisions
// (docs/factory.md "SDF-Based Collisions"), NVIDIA Warp mesh queries
// (industreal_algo_utils.py:49-157 SAPU) and pysdf/trimesh SDF rewards
// (industreal_algo_utils.py:202-283).  Grids are computed at scene-build
// time by this library, then sampled on the device with trilinear gathers
// (physics/sdf_grid.py): the hot path never touches the mesh.
//
// Distance: exact point-triangle distance (Ericson, Real-Time Collision
// Detection §5.1.5).  Sign: generalized winding number (Barill et al. 2018,
// via the van Oosterom-Strackee solid-angle formula), robust to open seams
// and self-intersections.  OpenMP over voxels.
//
// C API (ctypes):
//   sdf_voxelize(verts[nv*3], nv, tris[nt*3], nt,
//                origin[3], spacing[3], dims[3], out[dims0*dims1*dims2])
//   sdf_query_points(verts, nv, tris, nt, pts[np*3], np, out_dist[np])
// Layout: out[ix*dims1*dims2 + iy*dims2 + iz], voxel center at
// origin + spacing * (ix, iy, iz).

#include <cmath>
#include <cstdint>

namespace {

struct V3 {
  double x, y, z;
};

static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline double norm(V3 a) { return std::sqrt(dot(a, a)); }

// squared distance from point p to triangle (a, b, c)
static double point_tri_dist2(V3 p, V3 a, V3 b, V3 c) {
  V3 ab = sub(b, a), ac = sub(c, a), ap = sub(p, a);
  double d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0.0 && d2 <= 0.0) { V3 d = sub(p, a); return dot(d, d); }

  V3 bp = sub(p, b);
  double d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0.0 && d4 <= d3) { V3 d = sub(p, b); return dot(d, d); }

  double vc = d1 * d4 - d3 * d2;
  if (vc <= 0.0 && d1 >= 0.0 && d3 <= 0.0) {
    double v = d1 / (d1 - d3);
    V3 q = {a.x + v * ab.x, a.y + v * ab.y, a.z + v * ab.z};
    V3 d = sub(p, q);
    return dot(d, d);
  }

  V3 cp = sub(p, c);
  double d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0.0 && d5 <= d6) { V3 d = sub(p, c); return dot(d, d); }

  double vb = d5 * d2 - d1 * d6;
  if (vb <= 0.0 && d2 >= 0.0 && d6 <= 0.0) {
    double w = d2 / (d2 - d6);
    V3 q = {a.x + w * ac.x, a.y + w * ac.y, a.z + w * ac.z};
    V3 d = sub(p, q);
    return dot(d, d);
  }

  double va = d3 * d6 - d5 * d4;
  if (va <= 0.0 && (d4 - d3) >= 0.0 && (d5 - d6) >= 0.0) {
    double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    V3 bc = sub(c, b);
    V3 q = {b.x + w * bc.x, b.y + w * bc.y, b.z + w * bc.z};
    V3 d = sub(p, q);
    return dot(d, d);
  }

  double denom = 1.0 / (va + vb + vc);
  double v = vb * denom, w = vc * denom;
  V3 q = {a.x + v * ab.x + w * ac.x, a.y + v * ab.y + w * ac.y,
          a.z + v * ab.z + w * ac.z};
  V3 d = sub(p, q);
  return dot(d, d);
}

// solid angle of triangle (a, b, c) seen from p (van Oosterom & Strackee)
static double solid_angle(V3 p, V3 a, V3 b, V3 c) {
  V3 va = sub(a, p), vb = sub(b, p), vc = sub(c, p);
  double la = norm(va), lb = norm(vb), lc = norm(vc);
  double numer = dot(va, cross(vb, vc));
  double denom = la * lb * lc + dot(va, vb) * lc + dot(va, vc) * lb +
                 dot(vb, vc) * la;
  return 2.0 * std::atan2(numer, denom);
}

static double signed_distance(const float* verts, const int32_t* tris,
                              int32_t nt, V3 p) {
  double best = 1e30;
  double wind = 0.0;
  for (int32_t t = 0; t < nt; ++t) {
    const float* va = verts + 3 * tris[3 * t + 0];
    const float* vb = verts + 3 * tris[3 * t + 1];
    const float* vc = verts + 3 * tris[3 * t + 2];
    V3 a = {va[0], va[1], va[2]};
    V3 b = {vb[0], vb[1], vb[2]};
    V3 c = {vc[0], vc[1], vc[2]};
    double d2 = point_tri_dist2(p, a, b, c);
    if (d2 < best) best = d2;
    wind += solid_angle(p, a, b, c);
  }
  double d = std::sqrt(best);
  // inside when |winding number| ~ 1 (4*pi steradians); the absolute value
  // makes the sign independent of the mesh's triangle orientation
  return (std::fabs(wind) > 2.0 * M_PI) ? -d : d;
}

}  // namespace

extern "C" {

void sdf_voxelize(const float* verts, int32_t nv, const int32_t* tris,
                  int32_t nt, const float* origin, const float* spacing,
                  const int32_t* dims, float* out) {
  (void)nv;
  const int32_t dx = dims[0], dy = dims[1], dz = dims[2];
#pragma omp parallel for collapse(2) schedule(static)
  for (int32_t ix = 0; ix < dx; ++ix) {
    for (int32_t iy = 0; iy < dy; ++iy) {
      for (int32_t iz = 0; iz < dz; ++iz) {
        V3 p = {origin[0] + spacing[0] * ix, origin[1] + spacing[1] * iy,
                origin[2] + spacing[2] * iz};
        out[(int64_t)ix * dy * dz + (int64_t)iy * dz + iz] =
            (float)signed_distance(verts, tris, nt, p);
      }
    }
  }
}

void sdf_query_points(const float* verts, int32_t nv, const int32_t* tris,
                      int32_t nt, const float* pts, int32_t npts,
                      float* out) {
  (void)nv;
#pragma omp parallel for schedule(static)
  for (int32_t i = 0; i < npts; ++i) {
    V3 p = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
    out[i] = (float)signed_distance(verts, tris, nt, p);
  }
}

}  // extern "C"
