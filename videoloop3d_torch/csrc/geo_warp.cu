// K20 geo_warp_fwd and K21 geo_warp_bwd: the triangle search of the
// vertex-grid warp (--optimize_geo_start) and its gradient.
//
// Replaces videoloop3d_tpu/render/geo_warp.py:warp_coordinates_verts (and
// its _bary), whose gradient JAX takes by autodiff of the 3x3-quad x
// 2-triangle loop.  The vertex projection stays in PyTorch (an einsum in
// the JAX package); these kernels take its (B, D, Hv, Wv) arrays: pixel
// position vpx, vpy and view depth vz of every vertex.
//
// K20, per (view b, plane d, pixel (px, py)): starting from the quad
// (qi0, qj0) of the flat plane sweep, test the 3x3 neighbouring quads
// (di, dj in -1, 0, 1, row-major; each clipped to the grid) and their two
// triangles, 013 = (TL, TR, BR) before 320 = (BR, BL, TL); among
// triangles whose three vertices are in front (vz > 1e-6) keep the first
// strict maximum of the smallest barycentric.  Write the winner's
// barycentric interpolation of the fixed texel UVs (x, y) and of the view
// depths (z), valid = score > -1e-4 && z > 1e-6 && (x, y) inside the
// plane texture, and the winner as an int8 (quad offset * 2 + triangle,
// -1 for none; x, y, z are then 0, 0, 1).
// The barycentric arithmetic is JAX's, one rounding per operation
// (__fmul_rn, __fadd_rn, __fdiv_rn: nvcc contracts nothing into an FMA),
// so the winner at a shared edge, where two scores are both near 0, is
// the plain version's whenever its inputs are bit-equal.
//
// K21 recomputes each sample's winning barycentrics the same way and
// scatters the cotangents of x, y, z onto the triangle's three vertices
// (d/d vpx, vpy, vz) with atomicAdd: reproducible to rounding, not bit
// for bit.  Where JAX clamps the barycentric denominator
// (|den| < 1e-12) the derivative through den is zero, as in autodiff of
// jnp.where.  Samples with a zero cotangent or no winner add nothing.
//
// Bound on the H100: K20 reads 8 B of quad guess per sample and writes
// 14 B; each sample evaluates 18 triangles, ~30 f32 operations each, so
// at production shapes (1.84 M samples) it is near the balance of bytes
// and operations.  The vertex arrays (3 x B x D x Hv x Wv f32, 295 KB at
// 32 x 36 x 64) stay in L1/L2.  K21 reads 12 B of cotangent, 8 B of quad
// guess and 1 B of winner per sample; the atomics hit L2.
// Design: one thread per sample, pixels fastest, so a warp's 32 samples
// read the same few quads.
#include "common.cuh"

namespace {

struct Bary {
  float b0, b1, b2;
  float den;     // the (possibly clamped) denominator
  bool clamped;  // |den| < 1e-12 was replaced by +-1e-12
};

// JAX's _bary, operation by operation.
__device__ __forceinline__ Bary bary(float px, float py, float ax, float ay,
                                     float bx, float by, float cx,
                                     float cy) {
  const float v0x = __fsub_rn(bx, ax), v0y = __fsub_rn(by, ay);
  const float v1x = __fsub_rn(cx, ax), v1y = __fsub_rn(cy, ay);
  const float v2x = __fsub_rn(px, ax), v2y = __fsub_rn(py, ay);
  Bary r;
  float den = __fsub_rn(__fmul_rn(v0x, v1y), __fmul_rn(v1x, v0y));
  r.clamped = fabsf(den) < 1e-12f;
  if (r.clamped) den = den < 0.0f ? -1e-12f : 1e-12f;
  r.den = den;
  r.b1 = __fdiv_rn(__fsub_rn(__fmul_rn(v2x, v1y), __fmul_rn(v1x, v2y)), den);
  r.b2 = __fdiv_rn(__fsub_rn(__fmul_rn(v0x, v2y), __fmul_rn(v2x, v0y)), den);
  r.b0 = __fsub_rn(__fsub_rn(1.0f, r.b1), r.b2);
  return r;
}

// jnp.minimum: a NaN operand propagates (fminf would drop it)
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// b0 * a + b1 * b + b2 * c, left to right
__device__ __forceinline__ float interp(const Bary& w, float a, float b,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w.b0, a), __fmul_rn(w.b1, b)),
                   __fmul_rn(w.b2, c));
}

// Quad corners c = 0..3 are TL, TR, BR, BL: row offset c >> 1, column
// offset 1 for TR and BR.  Triangle t's k-th corner: 013 (t = 0) and 320
// (t = 1).  Functions, not tables, so the unrolled forward loops fold
// them to constants and keep the corner arrays in registers.
__device__ __forceinline__ int corner_di(int c) { return c >> 1; }
__device__ __forceinline__ int corner_dj(int c) {
  return (c == 1 || c == 2) ? 1 : 0;
}
__device__ __forceinline__ int tri_corner(int t, int k) {
  return t == 0 ? k : (k + 2) & 3;
}

struct Sample {
  int px, py;
  long long bd;   // b * D + d
};

__device__ __forceinline__ Sample sample_of(long long idx, int h, int w) {
  Sample s;
  s.px = (int)(idx % w);
  const long long r = idx / w;
  s.py = (int)(r % h);
  s.bd = r / h;
  return s;
}

__global__ void geo_warp_fwd_kernel(
    const float* __restrict__ vpx, const float* __restrict__ vpy,
    const float* __restrict__ vz, const int* __restrict__ qi0,
    const int* __restrict__ qj0, const float* __restrict__ uvx,
    const float* __restrict__ uvy, long long n, int h, int w, int Hv, int Wv,
    float x_max, float y_max, float* __restrict__ xo, float* __restrict__ yo,
    float* __restrict__ zo, uint8_t* __restrict__ valid_o,
    int8_t* __restrict__ tri_o) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const Sample s = sample_of(idx, h, w);
  const long long base = s.bd * Hv * Wv;
  const float px = (float)s.px, py = (float)s.py;
  const int i0 = qi0[idx], j0 = qj0[idx];
  float best = -INFINITY, bx = 0.0f, by = 0.0f, bz = 1.0f;
  int win = -1;
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int qi = min(max(i0 + q / 3 - 1, 0), Hv - 2);
    const int qj = min(max(j0 + q % 3 - 1, 0), Wv - 2);
    float cx[4], cy[4], cz[4], cu[4], cv[4];
    bool ok[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int vi = qi + corner_di(c), vj = qj + corner_dj(c);
      const long long v = base + (long long)vi * Wv + vj;
      cx[c] = __ldg(vpx + v);
      cy[c] = __ldg(vpy + v);
      cz[c] = __ldg(vz + v);
      ok[c] = cz[c] > 1e-6f;
      cu[c] = __ldg(uvx + vj);
      cv[c] = __ldg(uvy + vi);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int a = tri_corner(t, 0), b = tri_corner(t, 1),
                c = tri_corner(t, 2);
      if (!(ok[a] && ok[b] && ok[c])) continue;   // score -inf: never wins
      const Bary r = bary(px, py, cx[a], cy[a], cx[b], cy[b], cx[c], cy[c]);
      const float score = min_nan(min_nan(r.b0, r.b1), r.b2);
      if (score > best) {
        best = score;
        bx = interp(r, cu[a], cu[b], cu[c]);
        by = interp(r, cv[a], cv[b], cv[c]);
        bz = interp(r, cz[a], cz[b], cz[c]);
        win = 2 * q + t;
      }
    }
  }
  const bool inside = bx >= 0.0f && bx <= x_max && by >= 0.0f && by <= y_max;
  xo[idx] = bx;
  yo[idx] = by;
  zo[idx] = bz;
  valid_o[idx] = (best > -1e-4f && bz > 1e-6f && inside) ? 1 : 0;
  tri_o[idx] = (int8_t)win;
}

__global__ void geo_warp_bwd_kernel(
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ gz, const float* __restrict__ vpx,
    const float* __restrict__ vpy, const float* __restrict__ vz,
    const int* __restrict__ qi0, const int* __restrict__ qj0,
    const int8_t* __restrict__ tri, const float* __restrict__ uvx,
    const float* __restrict__ uvy, long long n, int h, int w, int Hv, int Wv,
    float* __restrict__ d_vpx, float* __restrict__ d_vpy,
    float* __restrict__ d_vz) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int win = tri[idx];
  const float g_x = gx[idx], g_y = gy[idx], g_z = gz[idx];
  if (win < 0 || (g_x == 0.0f && g_y == 0.0f && g_z == 0.0f)) return;
  const Sample s = sample_of(idx, h, w);
  const long long base = s.bd * Hv * Wv;
  const int q = win >> 1, t = win & 1;
  const int qi = min(max(qi0[idx] + q / 3 - 1, 0), Hv - 2);
  const int qj = min(max(qj0[idx] + q % 3 - 1, 0), Wv - 2);
  long long vid[3];
  float px3[3], py3[3], pz3[3], u3[3], v3[3];
  for (int k = 0; k < 3; ++k) {
    const int c = tri_corner(t, k);
    const int vi = qi + corner_di(c), vj = qj + corner_dj(c);
    vid[k] = base + (long long)vi * Wv + vj;
    px3[k] = vpx[vid[k]];
    py3[k] = vpy[vid[k]];
    pz3[k] = vz[vid[k]];
    u3[k] = uvx[vj];
    v3[k] = uvy[vi];
  }
  const float px = (float)s.px, py = (float)s.py;
  const Bary r = bary(px, py, px3[0], py3[0], px3[1], py3[1], px3[2], py3[2]);
  // z = b0 za + b1 zb + b2 zc: the depths' own share
  atomicAdd(d_vz + vid[0], g_z * r.b0);
  atomicAdd(d_vz + vid[1], g_z * r.b1);
  atomicAdd(d_vz + vid[2], g_z * r.b2);
  // cotangents of the barycentrics; b0 = 1 - b1 - b2
  const float gb0 = g_x * u3[0] + g_y * v3[0] + g_z * pz3[0];
  const float gb1 = g_x * u3[1] + g_y * v3[1] + g_z * pz3[1] - gb0;
  const float gb2 = g_x * u3[2] + g_y * v3[2] + g_z * pz3[2] - gb0;
  const float v0x = px3[1] - px3[0], v0y = py3[1] - py3[0];
  const float v1x = px3[2] - px3[0], v1y = py3[2] - py3[0];
  const float v2x = px - px3[0], v2y = py - py3[0];
  // b1 = n1 / den, b2 = n2 / den
  const float gn1 = gb1 / r.den, gn2 = gb2 / r.den;
  const float gden =
      r.clamped ? 0.0f : -(gb1 * r.b1 + gb2 * r.b2) / r.den;
  // n1 = v2x v1y - v1x v2y;  n2 = v0x v2y - v2x v0y;
  // den = v0x v1y - v1x v0y
  const float g_v0x = gn2 * v2y + gden * v1y;
  const float g_v0y = -gn2 * v2x - gden * v1x;
  const float g_v1x = -gn1 * v2y - gden * v0y;
  const float g_v1y = gn1 * v2x + gden * v0x;
  const float g_v2x = gn1 * v1y - gn2 * v0y;
  const float g_v2y = -gn1 * v1x + gn2 * v0x;
  // v0 = b - a, v1 = c - a, v2 = p - a (the pixel is constant)
  atomicAdd(d_vpx + vid[0], -(g_v0x + g_v1x + g_v2x));
  atomicAdd(d_vpy + vid[0], -(g_v0y + g_v1y + g_v2y));
  atomicAdd(d_vpx + vid[1], g_v0x);
  atomicAdd(d_vpy + vid[1], g_v0y);
  atomicAdd(d_vpx + vid[2], g_v1x);
  atomicAdd(d_vpy + vid[2], g_v1y);
}

}  // namespace

VL3D_API int vl3d_geo_warp_fwd(const float* vpx, const float* vpy,
                               const float* vz, const int* qi0,
                               const int* qj0, const float* uvx,
                               const float* uvy, int B, int D, int h, int w,
                               int Hv, int Wv, float x_max, float y_max,
                               float* x, float* y, float* z, uint8_t* valid,
                               int8_t* tri, void* stream) {
  const long long n = (long long)B * D * h * w;
  if (n > 0) {
    geo_warp_fwd_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
        vpx, vpy, vz, qi0, qj0, uvx, uvy, n, h, w, Hv, Wv, x_max, y_max, x, y,
        z, valid, tri);
  }
  return (int)cudaGetLastError();
}

// d_vpx, d_vpy, d_vz must be zero-filled by the caller.
VL3D_API int vl3d_geo_warp_bwd(const float* gx, const float* gy,
                               const float* gz, const float* vpx,
                               const float* vpy, const float* vz,
                               const int* qi0, const int* qj0,
                               const int8_t* tri, const float* uvx,
                               const float* uvy, int B, int D, int h, int w,
                               int Hv, int Wv, float* d_vpx, float* d_vpy,
                               float* d_vz, void* stream) {
  const long long n = (long long)B * D * h * w;
  if (n > 0) {
    geo_warp_bwd_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
        gx, gy, gz, vpx, vpy, vz, qi0, qj0, tri, uvx, uvy, n, h, w, Hv, Wv,
        d_vpx, d_vpy, d_vz);
  }
  return (int)cudaGetLastError();
}
