// K2 bilinear_tiles: bilinear sample of packed (N, th, tw, C) tiles, and
// K9 bilinear_tiles_grad: its gradient into f32 tiles.
//
// Replaces videoloop3d_tpu/render/sample.py:bilinear_tiles (the forward
// of render/adjoint.py:make_tile_adjoint on 4-D tiles).  Per sample:
//   k < 0 -> zeros;  u, v clamped to [0, tw-1] x [0, th-1];
//   corners (u0, v0) and (u0+1, v0+1) clamped to the tile;
//   out = lerp(lerp(t00, t01, fu), lerp(t10, t11, fu), fv)  in f32.
// The TPU version packs each 2x2 neighbourhood into one gather row
// because the TPU gather engine is descriptor-bound; a +1 corner that
// falls off the tile there reads a foreign texel with weight exactly 0.
// Clamping that corner to the tile gives the same values, so no packed
// copy is built here.  Texels may be bf16: loaded, widened to f32 and
// lerped in f32 (JAX promotes bf16 x f32 the same way); the output is f32.
//
// Bound on the H100: bytes.  Per sample it reads k, u, v (12 B) and
// writes C f32 (16 B); the referenced tiles (~22 MB at production
// size in f32) are read once from device memory and then mostly hit L2.
// Design: one thread per sample writing its C channels.
//
// K9 replaces videoloop3d_tpu/render/adjoint.py:_packed_tile_grad (the
// backward of make_tile_adjoint on 4-D tiles).  The TPU version avoids
// XLA's scatter-add: per packed tile it cuts a pixel window out of the
// (k, u, v, cotangent) stack and contracts it with tent weights on the
// MXU, exact only while the window covers every pixel of the tile.  Here
// each sample scatters its four corner weights with atomicAdd, exact for
// any warp, so no window, projection or active-tile bound is needed.
// Per sample with k >= 0: u, v clamped as in K2, the +1 corners clamped
// to the tile, grad[k, v_i, u_i, c] += ct[c] * w_corner.  Samples with
// k < 0 read nothing beyond k.
// Bound on the H100: bytes.  It reads k for every sample and u, v and C
// f32 cotangents for the valid ones, and writes the (N, th, tw, C)
// gradient once (the wrapper's zero-fill); the atomics mostly hit L2.
// Design: one thread per sample, 4 x C scalar atomicAdd (float4 atomics
// and fusing with the composite's backward are later work).  Atomics add
// in no fixed order: reproducible to roundoff, not bit for bit.
//
// K23 bilinear_tiles_coord_grad: the gradient of K2's samples with
// respect to u and v (--optimize_geo_start in the sparse phase: JAX takes
// it by autodiff of render/sample.py:bilinear_tiles).  As in JAX:
//   - the clip of u to [0, tw-1] passes 1 inside, 0.5 at exactly 0 and
//     at tw-1 (jnp.clip's maximum/minimum split a tie), 0 outside; v alike;
//   - the corners are JAX's quad-packed rows: flat texel indices r, r+1,
//     r+tw, r+tw+1 of the (N*th*tw, C) tiles (zero past the end), so at
//     u = tw-1 (fu = 0) the +1 corner is the next row's first texel,
//     whose weight in the value is 0 but whose difference enters d/du;
//   - g_u = clip'(u) sum_c ct_c ((1-fv)(t01-t00) + fv(t11-t10))_c,
//     g_v = clip'(v) sum_c ct_c ((1-fu)(t10-t00) + fu(t11-t01))_c, and
//     zero where k < 0.
// Bound: bytes; per sample k, u, v (12 B) and C f32 cotangents read, 8 B
// written, plus the touched texels.  Design: one thread per sample.
#include "common.cuh"

template <typename T>
__global__ void bilinear_tiles_kernel(const T* __restrict__ tiles,
                                      const int* __restrict__ k,
                                      const float* __restrict__ u,
                                      const float* __restrict__ v,
                                      long long n, int N, int th, int tw,
                                      int C, float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float* o = out + idx * C;
  const int kk = k[idx];
  if (kk < 0) {
    for (int c = 0; c < C; ++c) o[c] = 0.0f;
    return;
  }
  const long long tile = min(kk, N - 1);
  const float uu = fminf(fmaxf(u[idx], 0.0f), (float)(tw - 1));
  const float vv = fminf(fmaxf(v[idx], 0.0f), (float)(th - 1));
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float fu = __fsub_rn(uu, u0), fv = __fsub_rn(vv, v0);
  const int u0i = (int)u0, v0i = (int)v0;
  const int u1i = min(u0i + 1, tw - 1), v1i = min(v0i + 1, th - 1);
  const T* t0 = tiles + ((tile * th + v0i) * tw) * C;
  const T* t1 = tiles + ((tile * th + v1i) * tw) * C;
  for (int c = 0; c < C; ++c) {
    const float top = lerp_rn(to_f32(t0[u0i * C + c]),
                              to_f32(t0[u1i * C + c]), fu);
    const float bot = lerp_rn(to_f32(t1[u0i * C + c]),
                              to_f32(t1[u1i * C + c]), fu);
    o[c] = lerp_rn(top, bot, fv);
  }
}

VL3D_API int vl3d_bilinear_tiles(const void* tiles, int is_bf16,
                                 const int* k, const float* u,
                                 const float* v, long long n, int N, int th,
                                 int tw, int C, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (is_bf16) {
      bilinear_tiles_kernel<<<grid_for(n), kBlock, 0, s>>>(
          (const __nv_bfloat16*)tiles, k, u, v, n, N, th, tw, C, out);
    } else {
      bilinear_tiles_kernel<<<grid_for(n), kBlock, 0, s>>>(
          (const float*)tiles, k, u, v, n, N, th, tw, C, out);
    }
  }
  return (int)cudaGetLastError();
}

__global__ void bilinear_tiles_grad_kernel(const float* __restrict__ ct,
                                           const int* __restrict__ k,
                                           const float* __restrict__ u,
                                           const float* __restrict__ v,
                                           long long n, int N, int th,
                                           int tw, int C,
                                           float* __restrict__ grad) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int kk = k[idx];
  if (kk < 0) return;
  const long long tile = min(kk, N - 1);
  const float uu = fminf(fmaxf(u[idx], 0.0f), (float)(tw - 1));
  const float vv = fminf(fmaxf(v[idx], 0.0f), (float)(th - 1));
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float fu = __fsub_rn(uu, u0), fv = __fsub_rn(vv, v0);
  const int u0i = (int)u0, v0i = (int)v0;
  const int u1i = min(u0i + 1, tw - 1), v1i = min(v0i + 1, th - 1);
  const float wu0 = __fsub_rn(1.0f, fu), wv0 = __fsub_rn(1.0f, fv);
  const float w00 = __fmul_rn(wv0, wu0), w01 = __fmul_rn(wv0, fu);
  const float w10 = __fmul_rn(fv, wu0), w11 = __fmul_rn(fv, fu);
  float* g0 = grad + ((tile * th + v0i) * tw) * C;
  float* g1 = grad + ((tile * th + v1i) * tw) * C;
  const float* c_in = ct + idx * C;
  for (int c = 0; c < C; ++c) {
    const float g = c_in[c];
    atomicAdd(g0 + u0i * C + c, __fmul_rn(g, w00));
    atomicAdd(g0 + u1i * C + c, __fmul_rn(g, w01));
    atomicAdd(g1 + u0i * C + c, __fmul_rn(g, w10));
    atomicAdd(g1 + u1i * C + c, __fmul_rn(g, w11));
  }
}

// grad must be zero-filled by the caller.
VL3D_API int vl3d_bilinear_tiles_grad(const float* ct, const int* k,
                                      const float* u, const float* v,
                                      long long n, int N, int th, int tw,
                                      int C, float* grad, void* stream) {
  if (n > 0) {
    bilinear_tiles_grad_kernel<<<grid_for(n), kBlock, 0,
                                 (cudaStream_t)stream>>>(
        ct, k, u, v, n, N, th, tw, C, grad);
  }
  return (int)cudaGetLastError();
}

// d clip(u, 0, hi) / du as jax.grad gives it
__device__ __forceinline__ float clip_grad(float u, float hi) {
  if (u == 0.0f || u == hi) return 0.5f;
  return (u > 0.0f && u < hi) ? 1.0f : 0.0f;
}

template <typename T>
__global__ void bilinear_tiles_coord_grad_kernel(
    const T* __restrict__ tiles, const float* __restrict__ ct,
    const int* __restrict__ k, const float* __restrict__ u,
    const float* __restrict__ v, long long n, int N, int th, int tw, int C,
    float* __restrict__ gu, float* __restrict__ gv) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int kk = k[idx];
  if (kk < 0) {
    gu[idx] = 0.0f;
    gv[idx] = 0.0f;
    return;
  }
  const long long tile = min(kk, N - 1);
  const float u_in = u[idx], v_in = v[idx];
  const float uu = fminf(fmaxf(u_in, 0.0f), (float)(tw - 1));
  const float vv = fminf(fmaxf(v_in, 0.0f), (float)(th - 1));
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float fu = uu - u0, fv = vv - v0;
  const long long total = (long long)N * th * tw;
  const long long r = (tile * th + (int)v0) * tw + (int)u0;
  const long long rs[4] = {r, r + 1, r + tw, r + tw + 1};
  const float* c_in = ct + idx * C;
  float su = 0.0f, sv = 0.0f;
  for (int c = 0; c < C; ++c) {
    float t[4];
    for (int q = 0; q < 4; ++q) {
      t[q] = rs[q] < total ? to_f32(tiles[rs[q] * C + c]) : 0.0f;
    }
    const float g = c_in[c];
    su += g * ((1.0f - fv) * (t[1] - t[0]) + fv * (t[3] - t[2]));
    sv += g * ((1.0f - fu) * (t[2] - t[0]) + fu * (t[3] - t[1]));
  }
  gu[idx] = clip_grad(u_in, (float)(tw - 1)) * su;
  gv[idx] = clip_grad(v_in, (float)(th - 1)) * sv;
}

VL3D_API int vl3d_bilinear_tiles_coord_grad(const void* tiles, int is_bf16,
                                            const float* ct, const int* k,
                                            const float* u, const float* v,
                                            long long n, int N, int th,
                                            int tw, int C, float* gu,
                                            float* gv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (is_bf16) {
      bilinear_tiles_coord_grad_kernel<<<grid_for(n), kBlock, 0, s>>>(
          (const __nv_bfloat16*)tiles, ct, k, u, v, n, N, th, tw, C, gu, gv);
    } else {
      bilinear_tiles_coord_grad_kernel<<<grid_for(n), kBlock, 0, s>>>(
          (const float*)tiles, ct, k, u, v, n, N, th, tw, C, gu, gv);
    }
  }
  return (int)cudaGetLastError();
}
