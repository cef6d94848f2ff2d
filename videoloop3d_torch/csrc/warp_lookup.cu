// K1 warp_lookup: plane warp + paired tile-map lookup.
//
// Replaces videoloop3d_tpu/render/renderer.py:warp_coordinates (with
// core/planes.py:warp_grid) and renderer.py:tile_lookup2.  For each
// (view b, plane d, pixel (px, py)):
//   g = G[b,d] . (px, py, 1);  safe = |g.z| < 1e-12 ? 1e-12 : g.z
//   x = g.x / safe;  y = g.y / safe;  zview = 1 / safe
//   valid = x, y inside the plane texture rectangle && zview > 1e-6
//   j = clip(floor(x / sx), 0, ntw-1);  i = clip(floor(y / sy), 0, nth-1)
//   fu = (x - j*sx) / sx;  fv = (y - i*sy) / sy
//   k_s, k_d = valid ? tile maps [d, i, j] : -1
// With --add_uv_noise the caller passes the (B, D, h, w) draws nx, ny
// (renderer.py:add_texel_noise, JAX renderer.py:48-54): x += nx, y += ny
// after valid is computed and before the tile index and the fractions, so
// valid stays the un-jittered sample's and x, y are written jittered.
// Without them (nx = ny = null) nothing changes.
// The operation order is the JAX package's, one rounding per operation
// (no FMA, no fast math): j jumps at tile edges, so a one-ulp change in x
// would move a sample to the neighbouring tile.
//
// Bound on the H100: bytes.  It reads G and the two (D, nth, ntw) int32
// maps (a few hundred KB, L2-resident) and writes 29 bytes per
// (b, d, pixel): x, y, zview, fu, fv f32, k_s, k_d int32, valid u8 (and
// reads 8 bytes of uv-noise draws per element when given).
// Design: one thread per (b, d, pixel), pixels fastest, so a warp writes
// 32 neighbouring elements of each output.
//
// Its coordinate entry (tile_lookup_coords, the vertex warp's sparse
// route; JAX renderer.py:tile_lookup2 on given coordinates) reads x, y
// (f32) and valid (u8) per sample and writes k_s, k_d, i, j (int32): the
// same tile lookup code, 9 B read and 16 B written per sample.
#include "common.cuh"

// The tile lookup shared by both entries: tile (i, j) of the sample
// (x, y), both clipped to the grid.
__device__ __forceinline__ void tile_of(float x, float y, int nth, int ntw,
                                        float sy, float sx, int& i, int& j) {
  // float -> int conversion saturates (and maps NaN to 0) on the card,
  // like the plain version's cast on CUDA tensors; clipped after
  j = (int)floorf(__fdiv_rn(x, sx));
  i = (int)floorf(__fdiv_rn(y, sy));
  j = min(max(j, 0), ntw - 1);
  i = min(max(i, 0), nth - 1);
}

__global__ void warp_lookup_kernel(
    const float* __restrict__ G, const int* __restrict__ tm_s,
    const int* __restrict__ tm_d, const float* __restrict__ nx,
    const float* __restrict__ ny, int B, int D, int h, int w, int nth,
    int ntw, float x_max, float y_max, float sy, float sx,
    float* __restrict__ xo, float* __restrict__ yo, float* __restrict__ zo,
    uint8_t* __restrict__ valid_o, int* __restrict__ ks_o,
    int* __restrict__ kd_o, float* __restrict__ fu_o,
    float* __restrict__ fv_o) {
  const long long n = (long long)B * D * h * w;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int px = (int)(idx % w);
  const long long r = idx / w;
  const int py = (int)(r % h);
  const long long bd = r / h;
  const int d = (int)(bd % D);
  const float* g = G + bd * 9;
  const float fx = (float)px, fy = (float)py;
  const float gx = __fadd_rn(__fadd_rn(__fmul_rn(g[0], fx),
                                       __fmul_rn(g[1], fy)), g[2]);
  const float gy = __fadd_rn(__fadd_rn(__fmul_rn(g[3], fx),
                                       __fmul_rn(g[4], fy)), g[5]);
  const float gz = __fadd_rn(__fadd_rn(__fmul_rn(g[6], fx),
                                       __fmul_rn(g[7], fy)), g[8]);
  const float safe = fabsf(gz) < 1e-12f ? 1e-12f : gz;
  float x = __fdiv_rn(gx, safe);
  float y = __fdiv_rn(gy, safe);
  const float z = __fdiv_rn(1.0f, safe);
  const bool valid = (x >= 0.0f) && (x <= x_max) && (y >= 0.0f) &&
                     (y <= y_max) && (z > 1e-6f);
  if (nx) {
    x = __fadd_rn(x, nx[idx]);
    y = __fadd_rn(y, ny[idx]);
  }
  int i, j;
  tile_of(x, y, nth, ntw, sy, sx, i, j);
  const float fu = __fdiv_rn(__fsub_rn(x, __fmul_rn((float)j, sx)), sx);
  const float fv = __fdiv_rn(__fsub_rn(y, __fmul_rn((float)i, sy)), sy);
  const long long cell = ((long long)d * nth + i) * ntw + j;
  xo[idx] = x;
  yo[idx] = y;
  zo[idx] = z;
  valid_o[idx] = valid ? 1 : 0;
  ks_o[idx] = valid ? tm_s[cell] : -1;
  kd_o[idx] = valid ? tm_d[cell] : -1;
  fu_o[idx] = fu;
  fv_o[idx] = fv;
}

// The coordinate entry (--optimize_geo_start): x, y and valid come from
// memory (the vertex warp, jittered by the caller under uv noise) instead
// of G; it writes the tile maps' entries and the tile (i, j), from which
// the caller forms fu, fv under autograd.
__global__ void tile_lookup_coords_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const uint8_t* __restrict__ valid, const int* __restrict__ tm_s,
    const int* __restrict__ tm_d, long long n, int D, long long P, int nth,
    int ntw, float sy, float sx, int* __restrict__ ks_o,
    int* __restrict__ kd_o, int* __restrict__ i_o, int* __restrict__ j_o) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int d = (int)((idx / P) % D);
  int i, j;
  tile_of(x[idx], y[idx], nth, ntw, sy, sx, i, j);
  const long long cell = ((long long)d * nth + i) * ntw + j;
  const bool ok = valid[idx] != 0;
  ks_o[idx] = ok ? tm_s[cell] : -1;
  kd_o[idx] = ok ? tm_d[cell] : -1;
  i_o[idx] = i;
  j_o[idx] = j;
}

// nx, ny: null, or both (B, D, h, w) f32 draws
VL3D_API int vl3d_warp_lookup(const float* G, const int* tm_s,
                              const int* tm_d, const float* nx,
                              const float* ny, int B, int D, int h, int w,
                              int nth, int ntw, float x_max, float y_max,
                              float sy, float sx, float* x, float* y,
                              float* zview, uint8_t* valid, int* k_s,
                              int* k_d, float* fu, float* fv, void* stream) {
  const long long n = (long long)B * D * h * w;
  if (n > 0) {
    warp_lookup_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
        G, tm_s, tm_d, nx, ny, B, D, h, w, nth, ntw, x_max, y_max, sy, sx, x,
        y, zview, valid, k_s, k_d, fu, fv);
  }
  return (int)cudaGetLastError();
}

// x, y (B, D, h, w) f32, valid u8; writes k_s, k_d, i, j int32
VL3D_API int vl3d_tile_lookup_coords(const float* x, const float* y,
                                     const uint8_t* valid, const int* tm_s,
                                     const int* tm_d, int B, int D,
                                     long long P, int nth, int ntw, float sy,
                                     float sx, int* k_s, int* k_d, int* i,
                                     int* j, void* stream) {
  const long long n = (long long)B * D * P;
  if (n > 0) {
    tile_lookup_coords_kernel<<<grid_for(n), kBlock, 0,
                                (cudaStream_t)stream>>>(
        x, y, valid, tm_s, tm_d, n, D, P, nth, ntw, sy, sx, k_s, k_d, i, j);
  }
  return (int)cudaGetLastError();
}
