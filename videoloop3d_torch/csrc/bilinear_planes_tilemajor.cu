// K16 bilinear_planes_tilemajor: bilinear sample of the dense,
// frame-stacked (D, Ht, Wt, F_all, C) plane atlas of a dense stage-2 model
// at per-plane texel coordinates, at a subset of frames, and
// K17 bilinear_planes_tilemajor_grad: its gradient over all frames.
//
// Replaces videoloop3d_tpu/render/sample.py:bilinear_planes_tilemajor
// (the whole render of a dense stage-2 model, models/mpv.py:382-393),
// together with the frame gather dyn[..., ts, :] of models/mpv.py:387: the
// frame subset is read through the ts index array inside the kernel.
// For each plane d and sample s with align-corners texel coordinates
// (x, y): x0 = floor(x), y0 = floor(y), fx = x - x0, fy = y - y0; each of
// the four corners (x0 + i, y0 + j) reads ZERO when it lies outside the
// plane (no clamping, unlike K2/K3); texels are widened to f32 and
// lerped in f32 with one rounding per operation, in the JAX package's
// order: top = v00 (1 - fx) + v01 fx, bot = v10 (1 - fx) + v11 fx,
// out = top (1 - fy) + bot fy.  x0 and y0 are clamped in float to
// [-2, size] before the int conversion (a far-off coordinate of an
// invalid sample would make the conversion undefined); both corners of
// a clamped coordinate lie outside, as they did before.
//
// Every offset is 64-bit: a dense stage-1 checkpoint broadcast to 50
// frames at the shipped stage-1 width (32 x 576 x 1024 x 50 x 4) holds
// 3.77 G elements, past 2^31.
//
// Bound on the H100 (K16): bytes.  The training patch (D = 32, 180 x 320
// samples, all 50 frames) writes 32 x 57,600 x 50 x 4 f32 = 1.47 GB and
// reads 8 B of coordinates per sample plus the texels its samples touch.
// Design: one thread per (sample, frame) writing its C channels; frames
// are fastest, so the lanes of a warp read the neighbouring frames of one
// texel (one contiguous F*C row per corner) and write one contiguous run
// of output.
//
// K17 replaces the JAX package's autodiff of that gather (a scatter-add
// into the atlas).  Each (sample, frame) adds ct[f, c] * w_corner into the
// four corners that lie inside the plane with atomicAdd, into an f32
// buffer that the caller zero-fills; the wrapper rounds the sum once to
// the texel dtype (under --fp16 one rounding to bf16, where JAX adds in
// bf16).  Atomics add in no fixed order: reproducible to roundoff, not bit
// for bit.
// Bound on the H100 (K17): bytes.  It reads the coordinates and the
// (D, N, F, C) f32 cotangent once and writes the (D, Ht, Wt, F, C) f32
// gradient once (the zero-fill: 7.14 GB at the mpv_base width).
// Design: one thread per (sample, frame), frames fastest, so the lanes of
// a warp add into the neighbouring frames of one texel.
#include "common.cuh"

struct PlaneCorners {
  float fx, fy;
  long long r00, r01, r10, r11;    // texel rows (plane included), -1 outside
};

// the four corners of sample s of plane d; a corner outside the plane
// gets row -1
__device__ __forceinline__ PlaneCorners plane_corners(float xs, float ys,
                                                      long long d, int Ht,
                                                      int Wt) {
  PlaneCorners pc;
  const float x0 = floorf(xs), y0 = floorf(ys);
  pc.fx = __fsub_rn(xs, x0);
  pc.fy = __fsub_rn(ys, y0);
  const int x0i = (int)fminf(fmaxf(x0, -2.0f), (float)Wt);
  const int y0i = (int)fminf(fmaxf(y0, -2.0f), (float)Ht);
  const bool ix0 = x0i >= 0 && x0i < Wt, ix1 = x0i + 1 >= 0 && x0i + 1 < Wt;
  const bool iy0 = y0i >= 0 && y0i < Ht, iy1 = y0i + 1 >= 0 && y0i + 1 < Ht;
  const long long row0 = (d * Ht + y0i) * Wt + x0i;
  pc.r00 = (iy0 && ix0) ? row0 : -1;
  pc.r01 = (iy0 && ix1) ? row0 + 1 : -1;
  pc.r10 = (iy1 && ix0) ? row0 + Wt : -1;
  pc.r11 = (iy1 && ix1) ? row0 + Wt + 1 : -1;
  return pc;
}

template <typename T>
__device__ __forceinline__ float texel_or_zero(const T* __restrict__ tex,
                                               long long r, long long row,
                                               long long off) {
  return r >= 0 ? to_f32(tex[r * row + off]) : 0.0f;
}

template <typename T>
__global__ void bilinear_planes_tilemajor_kernel(
    const T* __restrict__ tex, const float* __restrict__ x,
    const float* __restrict__ y, const int* __restrict__ ts, int D,
    long long n, int Ht, int Wt, int F_all, int F_sel, int C,
    float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)D * n * F_sel) return;
  const long long s = idx / F_sel;                  // plane-major sample
  const int f = (int)(idx - s * F_sel);
  const PlaneCorners pc = plane_corners(x[s], y[s], s / n, Ht, Wt);
  const int fr = ts ? min(max(ts[f], 0), F_all - 1) : f;
  const long long row = (long long)F_all * C;       // one texel, all frames
  const long long off = (long long)fr * C;
  float* o = out + idx * C;
  for (int c = 0; c < C; ++c) {
    const float top = lerp_rn(texel_or_zero(tex, pc.r00, row, off + c),
                              texel_or_zero(tex, pc.r01, row, off + c), pc.fx);
    const float bot = lerp_rn(texel_or_zero(tex, pc.r10, row, off + c),
                              texel_or_zero(tex, pc.r11, row, off + c), pc.fx);
    o[c] = lerp_rn(top, bot, pc.fy);
  }
}

VL3D_API int vl3d_bilinear_planes_tilemajor(const void* tex, int is_bf16,
                                            const float* x, const float* y,
                                            const int* ts, int D, long long n,
                                            int Ht, int Wt, int F_all,
                                            int F_sel, int C, float* out,
                                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long m = (long long)D * n * F_sel;
  if (m > 0) {
    if (is_bf16) {
      bilinear_planes_tilemajor_kernel<<<grid_for(m), kBlock, 0, st>>>(
          (const __nv_bfloat16*)tex, x, y, ts, D, n, Ht, Wt, F_all, F_sel, C,
          out);
    } else {
      bilinear_planes_tilemajor_kernel<<<grid_for(m), kBlock, 0, st>>>(
          (const float*)tex, x, y, ts, D, n, Ht, Wt, F_all, F_sel, C, out);
    }
  }
  return (int)cudaGetLastError();
}

__global__ void bilinear_planes_tilemajor_grad_kernel(
    const float* __restrict__ ct, const float* __restrict__ x,
    const float* __restrict__ y, int D, long long n, int Ht, int Wt, int F,
    int C, float* __restrict__ grad) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)D * n * F) return;
  const long long s = idx / F;
  const int f = (int)(idx - s * F);
  const PlaneCorners pc = plane_corners(x[s], y[s], s / n, Ht, Wt);
  if (pc.r00 < 0 && pc.r01 < 0 && pc.r10 < 0 && pc.r11 < 0)
    return;                                         // wholly outside
  const float wx0 = __fsub_rn(1.0f, pc.fx), wy0 = __fsub_rn(1.0f, pc.fy);
  const long long rows[4] = {pc.r00, pc.r01, pc.r10, pc.r11};
  const float ws[4] = {__fmul_rn(wy0, wx0), __fmul_rn(wy0, pc.fx),
                       __fmul_rn(pc.fy, wx0), __fmul_rn(pc.fy, pc.fx)};
  const long long row = (long long)F * C;
  const float* c_in = ct + idx * C;
  for (int q = 0; q < 4; ++q) {
    if (rows[q] < 0) continue;
    float* g = grad + rows[q] * row + (long long)f * C;
    for (int c = 0; c < C; ++c) atomicAdd(g + c, __fmul_rn(c_in[c], ws[q]));
  }
}

// grad must be zero-filled by the caller.
VL3D_API int vl3d_bilinear_planes_tilemajor_grad(const float* ct,
                                                 const float* x,
                                                 const float* y, int D,
                                                 long long n, int Ht, int Wt,
                                                 int F, int C, float* grad,
                                                 void* stream) {
  const long long m = (long long)D * n * F;
  if (m > 0) {
    bilinear_planes_tilemajor_grad_kernel<<<grid_for(m), kBlock, 0,
                                            (cudaStream_t)stream>>>(
        ct, x, y, D, n, Ht, Wt, F, C, grad);
  }
  return (int)cudaGetLastError();
}
