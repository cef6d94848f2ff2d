// Reference triangle rasterizer (CPU, C++).
//
// Native-code counterpart of the reference's only native dependency:
// PyTorch3D's `rasterize_meshes` CUDA extension (reference utils.py:51-63).
// Used for golden-testing the homography plane-sweep renderer and as a
// host-side fallback for perturbed-vertex geometry.
//
// Semantics (mirroring rasterize_meshes with blur_radius=0):
//   * vertices arrive in screen space: (x_pix, y_pix, z_view) with pixel
//     centers at integer coordinates;
//   * for each pixel, the K nearest (smallest positive z) covering faces
//     are recorded, z-sorted ascending;
//   * barycentric coordinates are perspective-corrected, so interpolating
//     vertex attributes reproduces the projective mapping of planar quads.
//
// Exposed via a plain C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Frag {
  float z;
  int32_t face;
  float b0, b1, b2;
};

inline double edge(double ax, double ay, double bx, double by, double cx,
                   double cy) {
  return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
}

}  // namespace

extern "C" {

// verts: (n_verts, 3) float32; faces: (n_faces, 3) int32.
// out_face: (H, W, K) int32 (init -1 by callee);
// out_z:    (H, W, K) float32;
// out_bary: (H, W, K, 3) float32.
void rasterize(const float* verts, int64_t n_verts, const int32_t* faces,
               int64_t n_faces, int32_t H, int32_t W, int32_t K,
               int32_t* out_face, float* out_z, float* out_bary) {
  std::vector<std::vector<Frag>> rows(static_cast<size_t>(H) * W);

  for (int64_t f = 0; f < n_faces; ++f) {
    const int32_t i0 = faces[3 * f + 0];
    const int32_t i1 = faces[3 * f + 1];
    const int32_t i2 = faces[3 * f + 2];
    if (i0 < 0 || i1 < 0 || i2 < 0 || i0 >= n_verts || i1 >= n_verts ||
        i2 >= n_verts)
      continue;
    const double x0 = verts[3 * i0], y0 = verts[3 * i0 + 1],
                 z0 = verts[3 * i0 + 2];
    const double x1 = verts[3 * i1], y1 = verts[3 * i1 + 1],
                 z1 = verts[3 * i1 + 2];
    const double x2 = verts[3 * i2], y2 = verts[3 * i2 + 1],
                 z2 = verts[3 * i2 + 2];
    if (z0 <= 0 && z1 <= 0 && z2 <= 0) continue;

    const double area = edge(x0, y0, x1, y1, x2, y2);
    if (std::fabs(area) < 1e-12) continue;

    const int32_t xmin =
        std::max<int32_t>(0, (int32_t)std::ceil(std::min({x0, x1, x2})));
    const int32_t xmax = std::min<int32_t>(
        W - 1, (int32_t)std::floor(std::max({x0, x1, x2})));
    const int32_t ymin =
        std::max<int32_t>(0, (int32_t)std::ceil(std::min({y0, y1, y2})));
    const int32_t ymax = std::min<int32_t>(
        H - 1, (int32_t)std::floor(std::max({y0, y1, y2})));

    for (int32_t y = ymin; y <= ymax; ++y) {
      for (int32_t x = xmin; x <= xmax; ++x) {
        const double px = x, py = y;
        double w0 = edge(x1, y1, x2, y2, px, py) / area;
        double w1 = edge(x2, y2, x0, y0, px, py) / area;
        double w2 = edge(x0, y0, x1, y1, px, py) / area;
        if (w0 < -1e-9 || w1 < -1e-9 || w2 < -1e-9) continue;

        // perspective-correct: weights proportional to bary/z
        const double c0 = w0 / z0, c1 = w1 / z1, c2 = w2 / z2;
        const double denom = c0 + c1 + c2;
        if (denom <= 0) continue;
        const double z = 1.0 / denom;  // interpolated view depth
        if (z <= 0) continue;

        Frag frag;
        frag.z = (float)z;
        frag.face = (int32_t)f;
        frag.b0 = (float)(c0 * z);
        frag.b1 = (float)(c1 * z);
        frag.b2 = (float)(c2 * z);
        rows[(size_t)y * W + x].push_back(frag);
      }
    }
  }

  for (int32_t y = 0; y < H; ++y) {
    for (int32_t x = 0; x < W; ++x) {
      auto& fr = rows[(size_t)y * W + x];
      std::sort(fr.begin(), fr.end(), [](const Frag& a, const Frag& b) {
        if (a.z != b.z) return a.z < b.z;
        return a.face < b.face;
      });
      const int32_t n = std::min<int32_t>((int32_t)fr.size(), K);
      const size_t base = ((size_t)y * W + x) * K;
      for (int32_t k = 0; k < n; ++k) {
        out_face[base + k] = fr[k].face;
        out_z[base + k] = fr[k].z;
        out_bary[(base + k) * 3 + 0] = fr[k].b0;
        out_bary[(base + k) * 3 + 1] = fr[k].b1;
        out_bary[(base + k) * 3 + 2] = fr[k].b2;
      }
    }
  }
}

}  // extern "C"
