// K3 bilinear_tiles_tilemajor: bilinear sample of tile-major,
// frame-stacked (N, th, tw, F_all, C) tiles at a subset of frames, and
// K10 bilinear_tiles_tilemajor_grad: its gradient over all frames.
//
// Replaces videoloop3d_tpu/render/sample.py:bilinear_tiles_tilemajor
// (the forward of render/adjoint.py:make_tile_adjoint on 5-D tiles),
// together with the frame gather dyn[..., ts, :] of models/mpv.py:287:
// the frame subset is read through the ts index array inside the kernel,
// so no (N, th, tw, F_sel, C) copy of the atlas is made per call.
// Semantics are K2's per frame: k < 0 -> zeros, u, v clamped to the
// tile, u1 = min(u0+1, tw-1) and v1 = min(v0+1, th-1) (JAX reads a
// foreign texel with weight 0 where this clamps), bf16 or f32 texels
// widened and lerped in f32, f32 output of shape (..., F_sel, C).
//
// Bound on the H100: bytes.  This is the slice's largest writer: one
// fixed-view chunk of 10 frames at production size writes
// 32 x 360 x 640 x 10 x 4 f32 = 1.18 GB, against 12 B of k, u, v per
// sample and the referenced texels of the selected frames.
// Design: one thread per (sample, frame) writing its C channels; frames
// are fastest, so a warp writes one contiguous run of output and reads
// the F_sel frames of one texel, which lie next to each other.
//
// K10 replaces videoloop3d_tpu/render/adjoint.py:_packed_tile_grad on
// 5-D tiles (the backward of make_tile_adjoint, adjoint.py:663, as the
// stage-2 training render uses it for the dynamic atlas).  The TPU version
// cuts a pixel window around every packed tile's footprint and contracts
// it on the MXU; here each (sample, frame) scatters its four corner
// weights with atomicAdd, exact for any warp, with no window, projection
// or active-tile bound: per sample with k >= 0, u, v clamped as in K3,
// grad[k, v_i, u_i, f, c] += ct[f, c] * w_corner.  Samples with k < 0
// read nothing beyond k.  The gradient is f32 whatever the texel dtype;
// the wrapper rounds it once to bf16 where the texels are bf16, as the
// TPU version's .astype(tiles_dtype) does.
// Bound on the H100: bytes.  It reads k for every sample, u, v and the
// F x C cotangent of the hits only, and writes the (N, th, tw, F, C) f32
// gradient once (the wrapper's zero-fill, 490 MB at production size).
// Design: one thread per (sample, frame), frames fastest, so the 32
// lanes of a warp add into 32 x C neighbouring floats of one texel (one
// L2 atomic transaction stream per corner).  Atomics add in no fixed
// order: reproducible to roundoff, not bit for bit.
#include "common.cuh"

template <typename T>
__global__ void bilinear_tiles_tilemajor_kernel(
    const T* __restrict__ tiles, const int* __restrict__ k,
    const float* __restrict__ u, const float* __restrict__ v,
    const int* __restrict__ ts, long long n, int N, int th, int tw,
    int F_all, int F_sel, int C, float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * F_sel) return;
  const long long s = idx / F_sel;
  const int f = (int)(idx % F_sel);
  float* o = out + idx * C;
  const int kk = k[s];
  if (kk < 0) {
    for (int c = 0; c < C; ++c) o[c] = 0.0f;
    return;
  }
  const long long tile = min(kk, N - 1);
  const int fr = ts ? min(max(ts[f], 0), F_all - 1) : f;
  const float uu = fminf(fmaxf(u[s], 0.0f), (float)(tw - 1));
  const float vv = fminf(fmaxf(v[s], 0.0f), (float)(th - 1));
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float fu = __fsub_rn(uu, u0), fv = __fsub_rn(vv, v0);
  const int u0i = (int)u0, v0i = (int)v0;
  const int u1i = min(u0i + 1, tw - 1), v1i = min(v0i + 1, th - 1);
  const long long texel = (long long)F_all * C;     // one texel, all frames
  const T* r0 = tiles + ((tile * th + v0i) * tw) * texel + (long long)fr * C;
  const T* r1 = tiles + ((tile * th + v1i) * tw) * texel + (long long)fr * C;
  for (int c = 0; c < C; ++c) {
    const float top = lerp_rn(to_f32(r0[u0i * texel + c]),
                              to_f32(r0[u1i * texel + c]), fu);
    const float bot = lerp_rn(to_f32(r1[u0i * texel + c]),
                              to_f32(r1[u1i * texel + c]), fu);
    o[c] = lerp_rn(top, bot, fv);
  }
}

VL3D_API int vl3d_bilinear_tiles_tilemajor(const void* tiles, int is_bf16,
                                           const int* k, const float* u,
                                           const float* v, const int* ts,
                                           long long n, int N, int th,
                                           int tw, int F_all, int F_sel,
                                           int C, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long m = n * F_sel;
  if (m > 0) {
    if (is_bf16) {
      bilinear_tiles_tilemajor_kernel<<<grid_for(m), kBlock, 0, s>>>(
          (const __nv_bfloat16*)tiles, k, u, v, ts, n, N, th, tw, F_all,
          F_sel, C, out);
    } else {
      bilinear_tiles_tilemajor_kernel<<<grid_for(m), kBlock, 0, s>>>(
          (const float*)tiles, k, u, v, ts, n, N, th, tw, F_all, F_sel, C,
          out);
    }
  }
  return (int)cudaGetLastError();
}

__global__ void bilinear_tiles_tilemajor_grad_kernel(
    const float* __restrict__ ct, const int* __restrict__ k,
    const float* __restrict__ u, const float* __restrict__ v, long long n,
    int N, int th, int tw, int F, int C, float* __restrict__ grad) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * F) return;
  const long long s = idx / F;
  const int f = (int)(idx % F);
  const int kk = k[s];
  if (kk < 0) return;
  const long long tile = min(kk, N - 1);
  const float uu = fminf(fmaxf(u[s], 0.0f), (float)(tw - 1));
  const float vv = fminf(fmaxf(v[s], 0.0f), (float)(th - 1));
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float fu = __fsub_rn(uu, u0), fv = __fsub_rn(vv, v0);
  const int u0i = (int)u0, v0i = (int)v0;
  const int u1i = min(u0i + 1, tw - 1), v1i = min(v0i + 1, th - 1);
  const float wu0 = __fsub_rn(1.0f, fu), wv0 = __fsub_rn(1.0f, fv);
  const float w00 = __fmul_rn(wv0, wu0), w01 = __fmul_rn(wv0, fu);
  const float w10 = __fmul_rn(fv, wu0), w11 = __fmul_rn(fv, fu);
  const long long texel = (long long)F * C;
  float* g0 = grad + ((tile * th + v0i) * tw) * texel + (long long)f * C;
  float* g1 = grad + ((tile * th + v1i) * tw) * texel + (long long)f * C;
  const float* c_in = ct + idx * C;
  for (int c = 0; c < C; ++c) {
    const float g = c_in[c];
    atomicAdd(g0 + u0i * texel + c, __fmul_rn(g, w00));
    atomicAdd(g0 + u1i * texel + c, __fmul_rn(g, w01));
    atomicAdd(g1 + u0i * texel + c, __fmul_rn(g, w10));
    atomicAdd(g1 + u1i * texel + c, __fmul_rn(g, w11));
  }
}

// grad must be zero-filled by the caller.
VL3D_API int vl3d_bilinear_tiles_tilemajor_grad(const float* ct, const int* k,
                                                const float* u, const float* v,
                                                long long n, int N, int th,
                                                int tw, int F, int C,
                                                float* grad, void* stream) {
  const long long m = n * F;
  if (m > 0) {
    bilinear_tiles_tilemajor_grad_kernel<<<grid_for(m), kBlock, 0,
                                           (cudaStream_t)stream>>>(
        ct, k, u, v, n, N, th, tw, F, C, grad);
  }
  return (int)cudaGetLastError();
}
