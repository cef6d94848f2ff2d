// K7 fused_s1_fwd and K8 fused_s1_bwd: the stage-1 fused decode +
// over-composite + loop-mask composite + regularizer sums, and its VJP.
//
// Replaces videoloop3d_tpu/render/fused_s1.py:fused_composite_s1 (forward
// _fused_s1_fwd :90, backward _fused_s1_bwd :150).  Planes are stored far
// first (slot D-1 nearest).  Per (b, pixel), with the direct decoder and
// sigmoid activations:
//   rgb = sigmoid(f[:3]) * valid,  a = valid ? sigmoid(f[3]) : 0
//   bw = a * T;  out += rgb * bw;  alpha_sum += bw;  disp += dinv * bw
//   label += lp * bw  with lp = valid ? sigmoid(mask) : 0 (alpha detached)
//   T *= 1 - a;  sparsity sums |a| and a^2 over the planes
// and the smoothness sums |x(right) - x| and |x(down) - x| of rgb, a and lp
// over every plane.  The neighbour's decoded value is recomputed from its
// features.  Flags (bit 0 sparsity, 1 rgb-smooth, 2 a-smooth, 3 l-smooth,
// 4 use-loop, 5 want-disp) switch the terms as FusedS1Cfg does.
//
// The scalar sums are reduced deterministically: per-block partials in a
// fixed tree order, then one single-block pass over the partials, so two
// runs agree bit for bit.  The backward is the division-free reverse sweep
// of the JAX VJP: sweep A recomputes the incoming transmittance T_in of
// every plane (kept in a per-thread array of at most kMaxPlanes), sweep B
// walks far -> near:
//   g_i = <rgb, g_out> + g_asum + dinv g_disp
//   da = T_in (g_i - dT);  dT = a g_i + (1 - a) dT
// plus the sparsity coefficients (sign(0) = 0), the smoothness gradients
// (neighbours recomputed) and the mask-logit gradient through the detached
// alpha.  No atomics: each thread writes its own planes.  Every arithmetic
// step rounds once, in the order of the plain PyTorch version.
//
// Bound on the H100: bytes.  The forward reads 16 B of features, 1 B of
// validity and 4 B each of mask logit and disparity per (b, plane, pixel)
// and writes 24 B per pixel; the backward reads the same plus 24 B of
// cotangents per pixel and writes 20 B per (b, plane, pixel).  The
// neighbour reads hit L1/L2.  Design: one thread per (b, pixel), pixels
// fastest, looping over the planes in registers.
#include "common.cuh"

namespace {

constexpr int kSparsity = 1, kRgbSmooth = 2, kASmooth = 4, kLSmooth = 8,
              kUseLoop = 16, kWantDisp = 32;
constexpr int kMaxPlanes = 128;
constexpr int kSums = 7;   // sparsity ratio, rgb dx/dy, a dx/dy, l dx/dy

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float sign_f(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

struct Px {
  float r, g, b, a;       // decoded, masked by validity
  float s0, s1, s2, s3;   // sigmoids before the mask
  float vm;               // validity as 0 / 1
};

__device__ __forceinline__ Px decode(const float4* __restrict__ feats,
                                     const uint8_t* __restrict__ valid,
                                     long long o) {
  const float4 f = feats[o];
  Px p;
  p.vm = valid[o] ? 1.0f : 0.0f;
  p.s0 = sigmoid_f(f.x);
  p.s1 = sigmoid_f(f.y);
  p.s2 = sigmoid_f(f.z);
  p.s3 = sigmoid_f(f.w);
  p.r = __fmul_rn(p.s0, p.vm);
  p.g = __fmul_rn(p.s1, p.vm);
  p.b = __fmul_rn(p.s2, p.vm);
  p.a = valid[o] ? p.s3 : 0.0f;
  return p;
}

__device__ __forceinline__ float loop_p(const float* __restrict__ mask,
                                        const uint8_t* __restrict__ valid,
                                        long long o) {
  return valid[o] ? sigmoid_f(mask[o]) : 0.0f;
}

__device__ __forceinline__ float absdiff(float a, float b) {
  return fabsf(__fsub_rn(a, b));
}

// g_dx * (sign(x - left) - sign(right - x)) + g_dy * (same along h), with
// the missing neighbour's term 0 (the JAX pad-and-subtract spread)
__device__ __forceinline__ float smooth_grad(float x, bool has_l, float xl,
                                             bool has_r, float xr, bool has_u,
                                             float xu, bool has_d, float xd,
                                             float g_dx, float g_dy) {
  const float sw = __fsub_rn(has_l ? sign_f(__fsub_rn(x, xl)) : 0.0f,
                             has_r ? sign_f(__fsub_rn(xr, x)) : 0.0f);
  const float sh = __fsub_rn(has_u ? sign_f(__fsub_rn(x, xu)) : 0.0f,
                             has_d ? sign_f(__fsub_rn(xd, x)) : 0.0f);
  return __fadd_rn(__fmul_rn(g_dx, sw), __fmul_rn(g_dy, sh));
}

__global__ void fused_s1_fwd_kernel(
    const float4* __restrict__ feats, const uint8_t* __restrict__ valid,
    const float* __restrict__ mask, const float* __restrict__ dinv, int B,
    int D, int h, int w, int flags, float sp_eps, float* __restrict__ out,
    float* __restrict__ asum, float* __restrict__ disp,
    float* __restrict__ label, float* __restrict__ partials) {
  __shared__ float red[kSums][kBlock];
  const long long P = (long long)h * w;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float sums[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (idx < (long long)B * P) {
    const long long b = idx / P, p = idx % P;
    const int i = (int)(p / w), j = (int)(p % w);
    const bool has_r = j + 1 < w, has_d = i + 1 < h;
    const bool smooth = flags & (kRgbSmooth | kASmooth);
    float T = 1.0f, o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, as = 0.0f;
    float dsp = 0.0f, lab = 0.0f, l1 = 0.0f, l2 = 0.0f;
    for (int s = D - 1; s >= 0; --s) {
      const long long o = (b * D + s) * P + p;
      const Px c = decode(feats, valid, o);
      const float bw = __fmul_rn(c.a, T);
      o0 = __fadd_rn(o0, __fmul_rn(c.r, bw));
      o1 = __fadd_rn(o1, __fmul_rn(c.g, bw));
      o2 = __fadd_rn(o2, __fmul_rn(c.b, bw));
      as = __fadd_rn(as, bw);
      if (flags & kWantDisp) dsp = __fadd_rn(dsp, __fmul_rn(dinv[o], bw));
      if (flags & kUseLoop) {
        const float lp = loop_p(mask, valid, o);
        lab = __fadd_rn(lab, __fmul_rn(lp, bw));
        if (flags & kLSmooth) {
          if (has_r) sums[5] += absdiff(loop_p(mask, valid, o + 1), lp);
          if (has_d) sums[6] += absdiff(loop_p(mask, valid, o + w), lp);
        }
      }
      T = __fmul_rn(T, __fsub_rn(1.0f, c.a));
      if (flags & kSparsity) {
        l1 = __fadd_rn(l1, fabsf(c.a));
        l2 = __fadd_rn(l2, __fmul_rn(c.a, c.a));
      }
      if (smooth && has_r) {
        const Px n = decode(feats, valid, o + 1);
        sums[1] += absdiff(n.r, c.r) + absdiff(n.g, c.g) + absdiff(n.b, c.b);
        sums[3] += absdiff(n.a, c.a);
      }
      if (smooth && has_d) {
        const Px n = decode(feats, valid, o + w);
        sums[2] += absdiff(n.r, c.r) + absdiff(n.g, c.g) + absdiff(n.b, c.b);
        sums[4] += absdiff(n.a, c.a);
      }
    }
    out[idx * 3 + 0] = o0;
    out[idx * 3 + 1] = o1;
    out[idx * 3 + 2] = o2;
    asum[idx] = as;
    disp[idx] = dsp;
    label[idx] = lab;
    if (flags & kSparsity) sums[0] = __fdiv_rn(l1, fmaxf(sqrtf(l2), sp_eps));
  }
  // fixed-order tree reduction of the block's sums
  for (int k = 0; k < kSums; ++k) red[k][threadIdx.x] = sums[k];
  __syncthreads();
  for (int half = kBlock / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      for (int k = 0; k < kSums; ++k)
        red[k][threadIdx.x] += red[k][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < kSums; ++k) partials[blockIdx.x * kSums + k] = red[k][0];
  }
}

// One block: column sums of the (n_blocks, kSums) partials in a fixed order,
// then the regularizer scalars [sparsity, rgb_smooth, a_smooth, l_smooth].
__global__ void fused_s1_reduce_kernel(const float* __restrict__ partials,
                                       int n_blocks, float n_pix,
                                       float sqrt_planes, float n_rgb_dx,
                                       float n_rgb_dy, float n_dx, float n_dy,
                                       float* __restrict__ regs) {
  __shared__ float red[kSums][kBlock];
  float acc[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int blk = threadIdx.x; blk < n_blocks; blk += kBlock)
    for (int k = 0; k < kSums; ++k) acc[k] += partials[blk * kSums + k];
  for (int k = 0; k < kSums; ++k) red[k][threadIdx.x] = acc[k];
  __syncthreads();
  for (int half = kBlock / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      for (int k = 0; k < kSums; ++k)
        red[k][threadIdx.x] += red[k][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    regs[0] = __fdiv_rn(__fdiv_rn(red[0][0], n_pix), sqrt_planes);
    regs[1] = __fadd_rn(__fdiv_rn(red[1][0], n_rgb_dx),
                        __fdiv_rn(red[2][0], n_rgb_dy));
    regs[2] = __fadd_rn(__fdiv_rn(red[3][0], n_dx), __fdiv_rn(red[4][0], n_dy));
    regs[3] = __fadd_rn(__fdiv_rn(red[5][0], n_dx), __fdiv_rn(red[6][0], n_dy));
  }
}

// gscal = cotangents of [sparsity, rgb_smooth, a_smooth, l_smooth] (device)
__global__ void fused_s1_bwd_kernel(
    const float4* __restrict__ feats, const uint8_t* __restrict__ valid,
    const float* __restrict__ mask, const float* __restrict__ dinv,
    const float* __restrict__ g_out, const float* __restrict__ g_asum,
    const float* __restrict__ g_disp, const float* __restrict__ g_label,
    const float* __restrict__ gscal, int B, int D, int h, int w, int flags,
    float sp_eps, float sp_norm, float n_rgb_dx, float n_rgb_dy, float n_dx,
    float n_dy, float4* __restrict__ d_feats, float* __restrict__ d_mask) {
  const long long P = (long long)h * w;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * P) return;
  const long long b = idx / P, p = idx % P;
  const int i = (int)(p / w), j = (int)(p % w);
  const bool has_l = j > 0, has_r = j + 1 < w, has_u = i > 0,
             has_d = i + 1 < h;
  const bool rgb_smooth = flags & kRgbSmooth, a_smooth = flags & kASmooth;
  const bool use_loop = flags & kUseLoop, l_smooth = use_loop &&
                                                     (flags & kLSmooth);

  // sweep A (near -> far): incoming transmittance and sparsity sums
  float T_in[kMaxPlanes];
  float T = 1.0f, l1 = 0.0f, l2 = 0.0f;
  for (int s = D - 1; s >= 0; --s) {
    const long long o = (b * D + s) * P + p;
    const float a = valid[o] ? sigmoid_f(feats[o].w) : 0.0f;
    T_in[s] = T;
    T = __fmul_rn(T, __fsub_rn(1.0f, a));
    if (flags & kSparsity) {
      l1 = __fadd_rn(l1, fabsf(a));
      l2 = __fadd_rn(l2, __fmul_rn(a, a));
    }
  }
  float a_coef = 0.0f, b_coef = 0.0f;
  if (flags & kSparsity) {
    const float l2r = sqrtf(l2);
    const float l2c = fmaxf(l2r, sp_eps);
    const float scale = __fdiv_rn(gscal[0], sp_norm);
    a_coef = __fdiv_rn(scale, l2c);
    b_coef = l2r >= sp_eps
                 ? __fdiv_rn(__fmul_rn(scale, l1),
                             __fmul_rn(__fmul_rn(l2c, l2c), fmaxf(l2r, sp_eps)))
                 : 0.0f;
  }
  const float g_rs_dx = rgb_smooth ? __fdiv_rn(gscal[1], n_rgb_dx) : 0.0f;
  const float g_rs_dy = rgb_smooth ? __fdiv_rn(gscal[1], n_rgb_dy) : 0.0f;
  const float g_as_dx = a_smooth ? __fdiv_rn(gscal[2], n_dx) : 0.0f;
  const float g_as_dy = a_smooth ? __fdiv_rn(gscal[2], n_dy) : 0.0f;
  const float g_ls_dx = l_smooth ? __fdiv_rn(gscal[3], n_dx) : 0.0f;
  const float g_ls_dy = l_smooth ? __fdiv_rn(gscal[3], n_dy) : 0.0f;

  const float go0 = g_out[idx * 3 + 0], go1 = g_out[idx * 3 + 1],
              go2 = g_out[idx * 3 + 2];
  const float ga = g_asum[idx];
  const float gd = (flags & kWantDisp) ? g_disp[idx] : 0.0f;
  const float gl = use_loop ? g_label[idx] : 0.0f;

  // sweep B (far -> near): division-free composite cotangents
  float dT = 0.0f;
  for (int s = 0; s < D; ++s) {
    const long long o = (b * D + s) * P + p;
    const Px c = decode(feats, valid, o);
    float g_i = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.r, go0),
                                              __fmul_rn(c.g, go1)),
                                    __fmul_rn(c.b, go2)),
                          ga);
    if (flags & kWantDisp) g_i = __fadd_rn(g_i, __fmul_rn(dinv[o], gd));
    const float bw = __fmul_rn(c.a, T_in[s]);
    float da = __fmul_rn(T_in[s], __fsub_rn(g_i, dT));
    dT = __fadd_rn(__fmul_rn(c.a, g_i),
                   __fmul_rn(__fsub_rn(1.0f, c.a), dT));
    float dr = __fmul_rn(bw, go0), dg = __fmul_rn(bw, go1),
          db = __fmul_rn(bw, go2);
    if (flags & kSparsity) {
      da = __fsub_rn(__fadd_rn(da, __fmul_rn(a_coef, sign_f(c.a))),
                     __fmul_rn(b_coef, c.a));
    }
    if (rgb_smooth || a_smooth) {
      Px nl = {}, nr = {}, nu = {}, nd = {};
      if (has_l) nl = decode(feats, valid, o - 1);
      if (has_r) nr = decode(feats, valid, o + 1);
      if (has_u) nu = decode(feats, valid, o - w);
      if (has_d) nd = decode(feats, valid, o + w);
      if (rgb_smooth) {
        dr = __fadd_rn(dr, smooth_grad(c.r, has_l, nl.r, has_r, nr.r, has_u,
                                       nu.r, has_d, nd.r, g_rs_dx, g_rs_dy));
        dg = __fadd_rn(dg, smooth_grad(c.g, has_l, nl.g, has_r, nr.g, has_u,
                                       nu.g, has_d, nd.g, g_rs_dx, g_rs_dy));
        db = __fadd_rn(db, smooth_grad(c.b, has_l, nl.b, has_r, nr.b, has_u,
                                       nu.b, has_d, nd.b, g_rs_dx, g_rs_dy));
      }
      if (a_smooth) {
        da = __fadd_rn(da, smooth_grad(c.a, has_l, nl.a, has_r, nr.a, has_u,
                                       nu.a, has_d, nd.a, g_as_dx, g_as_dy));
      }
    }
    d_feats[o] = make_float4(
        __fmul_rn(__fmul_rn(dr, c.vm), __fmul_rn(c.s0, __fsub_rn(1.0f, c.s0))),
        __fmul_rn(__fmul_rn(dg, c.vm), __fmul_rn(c.s1, __fsub_rn(1.0f, c.s1))),
        __fmul_rn(__fmul_rn(db, c.vm), __fmul_rn(c.s2, __fsub_rn(1.0f, c.s2))),
        __fmul_rn(__fmul_rn(c.vm != 0.0f ? da : 0.0f, c.s3),
                  __fsub_rn(1.0f, c.s3)));
    if (use_loop) {
      const float lsig = sigmoid_f(mask[o]);
      float d_lp = __fmul_rn(gl, bw);
      if (l_smooth) {
        const float lp = c.vm != 0.0f ? lsig : 0.0f;
        d_lp = __fadd_rn(
            d_lp,
            smooth_grad(lp, has_l, has_l ? loop_p(mask, valid, o - 1) : 0.0f,
                        has_r, has_r ? loop_p(mask, valid, o + 1) : 0.0f,
                        has_u, has_u ? loop_p(mask, valid, o - w) : 0.0f,
                        has_d, has_d ? loop_p(mask, valid, o + w) : 0.0f,
                        g_ls_dx, g_ls_dy));
      }
      d_mask[o] = __fmul_rn(__fmul_rn(c.vm != 0.0f ? d_lp : 0.0f, lsig),
                            __fsub_rn(1.0f, lsig));
    }
  }
}

}  // namespace

// Rows of the per-block partials scratch of K7 and K14 (fused_s2.cu): the
// blocks of a launch of one thread per element over n elements.
VL3D_API int vl3d_partial_rows(long long n) { return (int)grid_for(n); }

// partials: scratch of vl3d_partial_rows(B*h*w) * 7 floats; regs: 4 floats.
VL3D_API int vl3d_fused_s1_fwd(const float* feats, const uint8_t* valid,
                               const float* mask, const float* dinv, int B,
                               int D, int h, int w, int flags, float sp_eps,
                               float n_pix, float sqrt_planes, float n_rgb_dx,
                               float n_rgb_dy, float n_dx, float n_dy,
                               float* out, float* asum, float* disp,
                               float* label, float* partials, float* regs,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * h * w;
  if (n > 0) {
    const unsigned int blocks = grid_for(n);
    fused_s1_fwd_kernel<<<blocks, kBlock, 0, s>>>(
        reinterpret_cast<const float4*>(feats), valid, mask, dinv, B, D, h, w,
        flags, sp_eps, out, asum, disp, label, partials);
    fused_s1_reduce_kernel<<<1, kBlock, 0, s>>>(
        partials, (int)blocks, n_pix, sqrt_planes, n_rgb_dx, n_rgb_dy, n_dx,
        n_dy, regs);
  }
  return (int)cudaGetLastError();
}

VL3D_API int vl3d_fused_s1_bwd(const float* feats, const uint8_t* valid,
                               const float* mask, const float* dinv,
                               const float* g_out, const float* g_asum,
                               const float* g_disp, const float* g_label,
                               const float* gscal, int B, int D, int h, int w,
                               int flags, float sp_eps, float sp_norm,
                               float n_rgb_dx, float n_rgb_dy, float n_dx,
                               float n_dy, float* d_feats, float* d_mask,
                               void* stream) {
  if (D > kMaxPlanes) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * h * w;
  if (n > 0) {
    fused_s1_bwd_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(feats), valid, mask, dinv, g_out,
        g_asum, g_disp, g_label, gscal, B, D, h, w, flags, sp_eps, sp_norm,
        n_rgb_dx, n_rgb_dy, n_dx, n_dy, reinterpret_cast<float4*>(d_feats),
        d_mask);
  }
  return (int)cudaGetLastError();
}
