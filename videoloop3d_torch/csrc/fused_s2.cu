// K14 fused_s2_fwd and K15 fused_s2_bwd: the stage-2 fused decode +
// static/dynamic select + over-composite + regularizer sums + disparity,
// and its VJP.
//
// Replaces videoloop3d_tpu/render/fused.py:fused_composite (:108; forward
// _fused_fwd :120, backward _fused_bwd :169).  Slots are stored far first
// (slot S-1 nearest).  Per (pixel, frame), with the direct decoder and
// sigmoid activations, slot s reads its dynamic sample where hit_d[s] and
// its static sample (the same for every frame) elsewhere:
//   rgb = sigmoid(v[:3]) * m,  a = m ? sigmoid(v[3]) : 0   (m = m_d or m_s)
//   bw = a * T;  out += rgb * bw;  alpha_sum += bw;  disp += dinv * bw
//   T *= 1 - a;  sparsity sums |a| and a^2 over the slots
// and the smoothness sums |x(right) - x| and |x(down) - x| of rgb and a at
// the same slot index and frame (under compaction a neighbour's slot s may
// hold another plane: the JAX package's semantics).  The neighbour's
// decoded value is recomputed from its samples.  Flags (bit 0 sparsity,
// 1 rgb-smooth, 2 a-smooth, 3 want-disp) switch the terms as FusedCfg does.
//
// The scalar sums are reduced deterministically: per-block partials in a
// fixed tree order, then one single-block pass over the partials.  The
// backward is the division-free reverse sweep of the JAX VJP: sweep A
// recomputes the incoming transmittance T_in of every slot (a per-thread
// array of at most kMaxSlots), sweep B walks far -> near:
//   g_i = <rgb, g_out> + g_asum + dinv g_disp
//   da = T_in (g_i - dT);  dT = a g_i + (1 - a) dT
// plus the sparsity coefficients (sign(0) = 0) and the smoothness
// gradients (neighbours recomputed).  A dynamic slot's texel cotangent is
// written per frame.  A static slot's is the sum over the frames: a block
// of the backward holds whole pixels (all F frames of each), each thread
// puts its frame's raw (d_rgb, da) in shared memory, and the pixel's
// frame-0 thread sums them in frame order, then applies the mask and the
// sigmoid's derivative.  No atomics, so two runs agree bit for bit.
// Every arithmetic step rounds once, in the order of the plain PyTorch
// version.  No cotangent for dinv or the masks.
//
// Bound on the H100: bytes.  The forward reads, per (slot, pixel), 3 B of
// masks, 4 B of dinv (with the disparity) and the samples it selects:
// 16 B per frame of a dynamic slot, 16 B for a static one; it writes 16 B
// (20 with the disparity) per (pixel, frame).  The backward reads the same
// plus the cotangents and writes the (S, P, F, 4) and (S, P, 4) f32 texel
// cotangents.  The neighbour reads hit L1/L2.  Design: one thread per
// (pixel, frame), frames fastest (as K4), looping over the slots in
// registers (the backward's blocks hold kBlock / F whole pixels); a
// warp's slot step reads one contiguous run of the dynamic samples.
#include "common.cuh"

namespace {

constexpr int kSparsity = 1, kRgbSmooth = 2, kASmooth = 4, kWantDisp = 8;
constexpr int kMaxSlots = 128;
constexpr int kSums = 5;   // sparsity ratio, rgb dx/dy, a dx/dy

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float sign_f(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float absdiff(float a, float b) {
  return fabsf(__fsub_rn(a, b));
}

struct Px {
  float r, g, b, a;       // decoded, masked
  float s0, s1, s2, s3;   // sigmoids before the mask
  float vm;               // the selected mask as 0 / 1
  bool dyn;               // hit_d: the dynamic sample was selected
};

struct In {
  const float4* vals_s;   // (S, P) texels
  const float4* vals_d;   // (S, P, F) texels
  const uint8_t* m_s;
  const uint8_t* hit_d;
  const uint8_t* m_d;
  const float* dinv;      // (S, P) or null
  int S, h, w, F;
};

// slot-pixel sp = s * P + p at frame f
__device__ __forceinline__ Px decode(const In& in, long long sp, int f) {
  Px c;
  c.dyn = in.hit_d[sp] != 0;
  float4 v;
  if (c.dyn) {
    v = in.vals_d[sp * in.F + f];
    c.vm = in.m_d[sp] ? 1.0f : 0.0f;
  } else {
    v = in.vals_s[sp];
    c.vm = in.m_s[sp] ? 1.0f : 0.0f;
  }
  c.s0 = sigmoid_f(v.x);
  c.s1 = sigmoid_f(v.y);
  c.s2 = sigmoid_f(v.z);
  c.s3 = sigmoid_f(v.w);
  c.r = __fmul_rn(c.s0, c.vm);
  c.g = __fmul_rn(c.s1, c.vm);
  c.b = __fmul_rn(c.s2, c.vm);
  c.a = c.vm != 0.0f ? c.s3 : 0.0f;
  return c;
}

__device__ __forceinline__ float alpha_of(const In& in, long long sp, int f) {
  if (in.hit_d[sp]) return in.m_d[sp] ? sigmoid_f(in.vals_d[sp * in.F + f].w)
                                      : 0.0f;
  return in.m_s[sp] ? sigmoid_f(in.vals_s[sp].w) : 0.0f;
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

__global__ void fused_s2_fwd_kernel(In in, int flags, float sp_eps,
                                    float* __restrict__ out,
                                    float* __restrict__ asum,
                                    float* __restrict__ disp,
                                    float* __restrict__ partials) {
  __shared__ float red[kSums][kBlock];
  const long long P = (long long)in.h * in.w;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float sums[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (idx < P * in.F) {
    const long long p = idx / in.F;
    const int f = (int)(idx % in.F);
    const int i = (int)(p / in.w), j = (int)(p % in.w);
    const bool has_r = j + 1 < in.w, has_d = i + 1 < in.h;
    const bool smooth = flags & (kRgbSmooth | kASmooth);
    float T = 1.0f, o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, as = 0.0f;
    float dsp = 0.0f, l1 = 0.0f, l2 = 0.0f;
    for (int s = in.S - 1; s >= 0; --s) {
      const long long sp = (long long)s * P + p;
      const Px c = decode(in, sp, f);
      const float bw = __fmul_rn(c.a, T);
      o0 = __fadd_rn(o0, __fmul_rn(c.r, bw));
      o1 = __fadd_rn(o1, __fmul_rn(c.g, bw));
      o2 = __fadd_rn(o2, __fmul_rn(c.b, bw));
      as = __fadd_rn(as, bw);
      if (flags & kWantDisp) dsp = __fadd_rn(dsp, __fmul_rn(in.dinv[sp], bw));
      T = __fmul_rn(T, __fsub_rn(1.0f, c.a));
      if (flags & kSparsity) {
        l1 = __fadd_rn(l1, fabsf(c.a));
        l2 = __fadd_rn(l2, __fmul_rn(c.a, c.a));
      }
      if (smooth && has_r) {
        const Px n = decode(in, sp + 1, f);
        sums[1] += absdiff(n.r, c.r) + absdiff(n.g, c.g) + absdiff(n.b, c.b);
        sums[3] += absdiff(n.a, c.a);
      }
      if (smooth && has_d) {
        const Px n = decode(in, sp + in.w, f);
        sums[2] += absdiff(n.r, c.r) + absdiff(n.g, c.g) + absdiff(n.b, c.b);
        sums[4] += absdiff(n.a, c.a);
      }
    }
    out[idx * 3 + 0] = o0;
    out[idx * 3 + 1] = o1;
    out[idx * 3 + 2] = o2;
    asum[idx] = as;
    disp[idx] = dsp;
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
// then the regularizer scalars [sparsity, rgb_smooth, a_smooth].
__global__ void fused_s2_reduce_kernel(const float* __restrict__ partials,
                                       int n_blocks, float n_pix,
                                       float sqrt_planes, float n_rgb_dx,
                                       float n_rgb_dy, float n_dx, float n_dy,
                                       float* __restrict__ regs) {
  __shared__ float red[kSums][kBlock];
  float acc[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
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
  }
}

// gscal = cotangents of [sparsity, rgb_smooth, a_smooth] (device).  A block
// holds ppb whole pixels: thread t is frame t % F of pixel t / F.
__global__ void fused_s2_bwd_kernel(
    In in, const float* __restrict__ g_out, const float* __restrict__ g_asum,
    const float* __restrict__ g_disp, const float* __restrict__ gscal,
    int flags, float sp_eps, float sp_norm, float n_rgb_dx, float n_rgb_dy,
    float n_dx, float n_dy, int ppb, float4* __restrict__ d_vals_s,
    float4* __restrict__ d_vals_d) {
  extern __shared__ float4 park[];   // ppb * F raw static cotangents
  const long long P = (long long)in.h * in.w;
  const int lp = threadIdx.x / in.F;
  const int f = threadIdx.x % in.F;
  const long long p = (long long)blockIdx.x * ppb + lp;
  const bool active = lp < ppb && p < P;
  const long long idx = p * in.F + f;
  const int i = (int)(p / in.w), j = (int)(p % in.w);
  const bool has_l = j > 0, has_r = j + 1 < in.w, has_u = i > 0,
             has_d = i + 1 < in.h;
  const bool rgb_smooth = flags & kRgbSmooth, a_smooth = flags & kASmooth;

  // sweep A (near -> far): incoming transmittance and sparsity sums
  float T_in[kMaxSlots];
  float T = 1.0f, l1 = 0.0f, l2 = 0.0f;
  for (int s = in.S - 1; s >= 0 && active; --s) {
    const float a = alpha_of(in, (long long)s * P + p, f);
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

  float go0 = 0.0f, go1 = 0.0f, go2 = 0.0f, ga = 0.0f, gd = 0.0f;
  if (active) {
    go0 = g_out[idx * 3 + 0];
    go1 = g_out[idx * 3 + 1];
    go2 = g_out[idx * 3 + 2];
    ga = g_asum[idx];
    if (flags & kWantDisp) gd = g_disp[idx];
  }

  // sweep B (far -> near): division-free composite cotangents; every
  // thread of the block walks the same S slots (the barriers below)
  float dT = 0.0f;
  for (int s = 0; s < in.S; ++s) {
    const long long sp = (long long)s * P + p;
    bool dyn = false;
    if (active) {
      const Px c = decode(in, sp, f);
      dyn = c.dyn;
      float g_i = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.r, go0),
                                                __fmul_rn(c.g, go1)),
                                      __fmul_rn(c.b, go2)),
                            ga);
      if (flags & kWantDisp) g_i = __fadd_rn(g_i, __fmul_rn(in.dinv[sp], gd));
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
        if (has_l) nl = decode(in, sp - 1, f);
        if (has_r) nr = decode(in, sp + 1, f);
        if (has_u) nu = decode(in, sp - in.w, f);
        if (has_d) nd = decode(in, sp + in.w, f);
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
      const long long o = sp * in.F + f;
      if (dyn) {
        d_vals_d[o] = make_float4(
            __fmul_rn(__fmul_rn(dr, c.vm),
                      __fmul_rn(c.s0, __fsub_rn(1.0f, c.s0))),
            __fmul_rn(__fmul_rn(dg, c.vm),
                      __fmul_rn(c.s1, __fsub_rn(1.0f, c.s1))),
            __fmul_rn(__fmul_rn(db, c.vm),
                      __fmul_rn(c.s2, __fsub_rn(1.0f, c.s2))),
            __fmul_rn(__fmul_rn(c.vm != 0.0f ? da : 0.0f, c.s3),
                      __fsub_rn(1.0f, c.s3)));
      } else {
        d_vals_d[o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        park[threadIdx.x] = make_float4(dr, dg, db, da);
      }
    }
    __syncthreads();
    if (active && f == 0) {
      // the static slot's cotangent: the frames' sum in frame order, then
      // the mask and the sigmoid's derivative
      float4 out = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (!dyn) {
        float r = 0.0f, g = 0.0f, b = 0.0f, a = 0.0f;
        for (int k = 0; k < in.F; ++k) {
          const float4 v = park[lp * in.F + k];
          r = __fadd_rn(r, v.x);
          g = __fadd_rn(g, v.y);
          b = __fadd_rn(b, v.z);
          a = __fadd_rn(a, v.w);
        }
        const float4 v = in.vals_s[sp];
        const float vm = in.m_s[sp] ? 1.0f : 0.0f;
        const float s0 = sigmoid_f(v.x), s1 = sigmoid_f(v.y),
                    s2 = sigmoid_f(v.z), s3 = sigmoid_f(v.w);
        out = make_float4(
            __fmul_rn(__fmul_rn(r, vm), __fmul_rn(s0, __fsub_rn(1.0f, s0))),
            __fmul_rn(__fmul_rn(g, vm), __fmul_rn(s1, __fsub_rn(1.0f, s1))),
            __fmul_rn(__fmul_rn(b, vm), __fmul_rn(s2, __fsub_rn(1.0f, s2))),
            __fmul_rn(__fmul_rn(vm != 0.0f ? a : 0.0f, s3),
                      __fsub_rn(1.0f, s3)));
      }
      d_vals_s[sp] = out;
    }
    __syncthreads();
  }
}

In make_in(const float* vals_s, const float* vals_d, const uint8_t* m_s,
           const uint8_t* hit_d, const uint8_t* m_d, const float* dinv, int S,
           int h, int w, int F) {
  In in;
  in.vals_s = reinterpret_cast<const float4*>(vals_s);
  in.vals_d = reinterpret_cast<const float4*>(vals_d);
  in.m_s = m_s;
  in.hit_d = hit_d;
  in.m_d = m_d;
  in.dinv = dinv;
  in.S = S;
  in.h = h;
  in.w = w;
  in.F = F;
  return in;
}

}  // namespace

// partials: scratch of vl3d_partial_rows(h*w*F) * 5 floats (fused_s1.cu);
// regs: 3 floats.
VL3D_API int vl3d_fused_s2_fwd(const float* vals_s, const float* vals_d,
                               const uint8_t* m_s, const uint8_t* hit_d,
                               const uint8_t* m_d, const float* dinv, int S,
                               int h, int w, int F, int flags, float sp_eps,
                               float n_pix, float sqrt_planes, float n_rgb_dx,
                               float n_rgb_dy, float n_dx, float n_dy,
                               float* out, float* asum, float* disp,
                               float* partials, float* regs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)h * w * F;
  if (n > 0) {
    const unsigned int blocks = grid_for(n);
    fused_s2_fwd_kernel<<<blocks, kBlock, 0, s>>>(
        make_in(vals_s, vals_d, m_s, hit_d, m_d, dinv, S, h, w, F), flags,
        sp_eps, out, asum, disp, partials);
    fused_s2_reduce_kernel<<<1, kBlock, 0, s>>>(
        partials, (int)blocks, n_pix, sqrt_planes, n_rgb_dx, n_rgb_dy, n_dx,
        n_dy, regs);
  }
  return (int)cudaGetLastError();
}

VL3D_API int vl3d_fused_s2_bwd(const float* vals_s, const float* vals_d,
                               const uint8_t* m_s, const uint8_t* hit_d,
                               const uint8_t* m_d, const float* dinv,
                               const float* g_out, const float* g_asum,
                               const float* g_disp, const float* gscal, int S,
                               int h, int w, int F, int flags, float sp_eps,
                               float sp_norm, float n_rgb_dx, float n_rgb_dy,
                               float n_dx, float n_dy, float* d_vals_s,
                               float* d_vals_d, void* stream) {
  if (S > kMaxSlots || F > 1024) return (int)cudaErrorInvalidValue;
  const long long P = (long long)h * w;
  if (P > 0 && F > 0) {
    const int ppb = F >= kBlock ? 1 : kBlock / F;   // whole pixels per block
    const unsigned int blocks = (unsigned int)((P + ppb - 1) / ppb);
    const size_t smem = sizeof(float4) * ppb * F;
    fused_s2_bwd_kernel<<<blocks, ppb * F, smem, (cudaStream_t)stream>>>(
        make_in(vals_s, vals_d, m_s, hit_d, m_d, dinv, S, h, w, F), g_out,
        g_asum, g_disp, gscal, flags, sp_eps, sp_norm, n_rgb_dx, n_rgb_dy,
        n_dx, n_dy, ppb, reinterpret_cast<float4*>(d_vals_s),
        reinterpret_cast<float4*>(d_vals_d));
  }
  return (int)cudaGetLastError();
}
