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
// hold another plane: the JAX package's semantics).  Flags (bit 0
// sparsity, 1 rgb-smooth, 2 a-smooth, 3 want-disp) switch the terms as
// FusedCfg does.
//
// The scalar sums are reduced deterministically: per-block partials in a
// fixed tree order, then one single-block pass over the partials.  The
// backward is the division-free reverse sweep of the JAX VJP: sweep A
// recomputes the incoming transmittance T_in of every slot, sweep B walks
// far -> near:
//   g_i = <rgb, g_out> + g_asum + dinv g_disp
//   da = T_in (g_i - dT);  dT = a g_i + (1 - a) dT
// plus the sparsity coefficients (sign(0) = 0) and the smoothness
// gradients.  A dynamic slot's texel cotangent is written per frame (a
// static slot's entries of d_vals_d as zeros).  A static slot's is the sum
// over the frames in frame order, then the mask and the sigmoid's
// derivative.  No atomics, so two runs agree bit for bit.  Every
// arithmetic step rounds once, in the order of the plain PyTorch version.
// No cotangent for dinv or the masks.
//
// Bound on the H100: bytes.  The forward reads, per (slot, pixel), 3 B of
// masks, 4 B of dinv (with the disparity) and the samples it selects:
// 16 B per frame of a dynamic slot, 16 B for a static one; it writes 16 B
// (20 with the disparity) per (pixel, frame).  The backward reads the same
// plus the cotangents and writes the (S, P, F, 4) and (S, P, 4) f32 texel
// cotangents.
//
// K14's design (fused_s2_fwd_tile_kernel).  A block owns K15's tile of
// kTw x kTh pixels with a halo of one column on the right and one row
// below (the only neighbours the smoothness sums read) and walks all F
// frames in chunks of fc (one thread per (pixel, frame) of a chunk,
// frames fastest, so out, alpha_sum and disp are written as contiguous
// runs).  Once per block it decodes every static sample of the tile and
// (with a smoothness term on) its halo for all S slots into a shared
// table of masked values, one entry a (slot, pixel, frame of a chunk),
// with the tile's reciprocal depths and a bit mask of each pixel's
// dynamic slots; per chunk it copies every slot's dynamic samples of the
// tile and halo in at once (cp.async, from the masks) and decodes each
// once in place, then every thread composites all slots near -> far
// (S - 1 first) from its own and its two neighbours' entries with no
// barrier between slots (a barrier a slot, with each slot's loads
// awaited, was measured slower).  The first design (fused_s2_fwd_kernel,
// kept as vl3d_fused_s2_fwd_first) ran one thread per (pixel, frame) and
// decoded every sample-frame three times (its own, and as the left and
// the upper neighbour); a static sample 3 F times.  Each (pixel,
// frame)'s five sums are written to a scratch at p F + f and reduced by
// the first design's tree over the same blocks of kBlock consecutive
// (pixel, frame)s (fused_s2_sums_kernel), so the outputs and the three
// scalars are the first design's bits.
//
// K15's design (fused_s2_bwd_tile_kernel).  A block owns a tile of
// kTw x kTh pixels and walks all F frames in chunks of fc (one thread per
// (pixel, frame) of a chunk, frames fastest: a pixel's fc frames are one
// contiguous run of d_vals_d).  Once per block it decodes every static
// sample of the tile and its one-pixel halo for all S slots into shared
// memory (4 sigmoids per (slot, pixel) of the tile and halo, not per
// frame) with each sample's flags.  Sweep A puts every slot's alpha in
// shared memory first (static ones from that table; a dynamic sample's
// alpha recomputed, its loads all in flight at once), then turns them
// into T_in in place ([slot][thread], not a per-thread array).  Sweep B
// decodes a chunk's dynamic samples of the tile and halo for slot s + 1
// (each once, plus the halo's share; two buffers) and, for the tile's
// static pixels whose neighbours are static too, slot s + 1's smoothness
// gradients (the same at every frame: one warp, once a slot and chunk)
// while every thread works on slot s from its own and its four
// neighbours' values in shared memory.  The static frame sum keeps the
// frame order: each thread parks its raw (d_rgb, da)
// of a static slot (two buffers), and during the next slot 4 x kNp
// threads (one a pixel and channel) add the chunk's fc values in frame
// order onto the pixel's running sum (shared, carried from chunk to
// chunk); the last chunk applies the mask and the derivative.  One
// barrier a slot.  So the result is the first design's bit for bit
// (fused_s2_bwd_kernel, kept as vl3d_fused_s2_bwd_first): the same
// operations on the same values in the same order.  fc is the largest
// chunk up to kFcMax that splits F evenly and lets two blocks share an SM,
// else fits the shared memory (bwd_layout).
#include <cuda_pipeline.h>

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

// fixed-order tree reduction of a block's per-thread sums into its row of
// partials
__device__ __forceinline__ void block_tree(float (*red)[kBlock],
                                           const float* sums,
                                           float* __restrict__ partials) {
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
  block_tree(red, sums, partials);
}

// K14's redesign writes each (pixel, frame)'s five sums here, at p F + f;
// this is the first design's tree over the same blocks of kBlock
// consecutive (pixel, frame)s, on the same values
__global__ void fused_s2_sums_kernel(const float* __restrict__ item_sums,
                                     long long n,
                                     float* __restrict__ partials) {
  __shared__ float red[kSums][kBlock];
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float sums[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (idx < n) {
    for (int k = 0; k < kSums; ++k) sums[k] = item_sums[idx * kSums + k];
  }
  block_tree(red, sums, partials);
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

// K15's first design.  gscal = cotangents of [sparsity, rgb_smooth,
// a_smooth] (device).  A block holds ppb whole pixels: thread t is frame
// t % F of pixel t / F.  Sweep A keeps T_in in a per-thread array (local
// memory), sweep B decodes each sample and its four neighbours per frame,
// and a pixel's frame-0 thread sums the parked static cotangents.
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

// K15's tile (see the header): kTw x kTh pixels, a one-pixel halo around
// them, chunks of at most kFcMax frames.
constexpr int kTw = 8, kTh = 4, kNp = kTw * kTh;
constexpr int kHw = kTw + 2, kHh = kTh + 2, kHalo = kHw * kHh;
constexpr int kFcMax = 10;
constexpr long long kBwdSmemLimit = 232448;   // a block's shared bytes
constexpr long long kBwdSmemTwo = 115712;     // two blocks' on one SM
// flag bits of a (slot, halo pixel): needed (in the image, not a corner),
// dynamic (hit_d), mask (m_d or m_s)
constexpr uint8_t kValid = 1, kDyn = 2, kVm = 4;

struct BwdLayout {
  int fc;          // frames a chunk
  int threads;     // kNp * fc
  long long smem;  // dynamic shared bytes
};

// The shared arrays, in this order: static sigmoids [S][kHalo] float4,
// running static sums [S][kNp] float4, the smoothness gradients of two
// slots' static neighbourhoods [2][kNp] float4, a chunk's dynamic
// sigmoids of two
// slots [2][kHalo][fc] float4, parked static cotangents of two slots
// [2][kNp][fc] float4, T_in [S][threads] float, flags [S][kHalo], "some
// dynamic sample" [S] and "static neighbourhood" [2][kNp] bytes.
inline long long bwd_smem(int S, int fc) {
  const long long b = 16LL * ((long long)S * kHalo + (long long)S * kNp
                              + 2LL * kNp + 2LL * kHalo * fc + 2LL * kNp * fc)
      + 4LL * S * kNp * fc + (long long)S * kHalo + S + 2LL * kNp;
  return (b + 15) / 16 * 16;
}

// render/fused.py:fused_s2_bwd_layout mirrors this: the largest even
// split of F into chunks of at most kFcMax frames whose block leaves room
// for a second one on the SM, else the largest whose block fits at all.
inline BwdLayout bwd_layout(int S, int F) {
  for (const long long limit : {kBwdSmemTwo, kBwdSmemLimit}) {
    for (int chunks = (F + kFcMax - 1) / kFcMax;; ++chunks) {
      const int fc = (F + chunks - 1) / chunks;
      if (bwd_smem(S, fc) <= limit) return {fc, kNp * fc, bwd_smem(S, fc)};
      if (fc == 1) break;
    }
  }
  return {1, kNp, bwd_smem(S, 1)};   // over the limit: the launch refuses
}

__device__ __forceinline__ float4 sigmoids(float4 v) {
  return make_float4(sigmoid_f(v.x), sigmoid_f(v.y), sigmoid_f(v.z),
                     sigmoid_f(v.w));
}

// decode()'s masked values from the sigmoids and the flags
__device__ __forceinline__ float4 masked(float4 sg, uint8_t fl) {
  const float vm = (fl & kVm) ? 1.0f : 0.0f;
  return make_float4(__fmul_rn(sg.x, vm), __fmul_rn(sg.y, vm),
                     __fmul_rn(sg.z, vm), vm != 0.0f ? sg.w : 0.0f);
}

// smooth_grad of the four channels (rgb with the rgb weights, alpha with
// the alpha ones) from the masked values of a pixel and its neighbours
__device__ __forceinline__ float4 smooth4(float4 c, bool hl, float4 l,
                                          bool hr, float4 r, bool hu,
                                          float4 u, bool hd, float4 d,
                                          float rs_dx, float rs_dy,
                                          float as_dx, float as_dy) {
  return make_float4(
      smooth_grad(c.x, hl, l.x, hr, r.x, hu, u.x, hd, d.x, rs_dx, rs_dy),
      smooth_grad(c.y, hl, l.y, hr, r.y, hu, u.y, hd, d.y, rs_dx, rs_dy),
      smooth_grad(c.z, hl, l.z, hr, r.z, hu, u.z, hd, d.z, rs_dx, rs_dy),
      smooth_grad(c.w, hl, l.w, hr, r.w, hu, u.w, hd, d.w, as_dx, as_dy));
}

__global__ void __launch_bounds__(kNp * kFcMax, 2) fused_s2_bwd_tile_kernel(
    In in, const float* __restrict__ g_out, const float* __restrict__ g_asum,
    const float* __restrict__ g_disp, const float* __restrict__ gscal,
    int flags, float sp_eps, float sp_norm, float n_rgb_dx, float n_rgb_dy,
    float n_dx, float n_dy, int fc, float4* __restrict__ d_vals_s,
    float4* __restrict__ d_vals_d) {
  extern __shared__ float4 smem4[];
  const int S = in.S, F = in.F, h = in.h, w = in.w;
  const long long P = (long long)h * w;
  const int nt = kNp * fc;
  float4* sdec = smem4;                        // [S][kHalo]
  float4* run = sdec + S * kHalo;              // [S][kNp]
  float4* smc = run + S * kNp;                 // [2][kNp]
  float4* dec = smc + 2 * kNp;                 // [2][kHalo][fc]
  float4* park = dec + 2 * kHalo * fc;         // [2][kNp][fc]
  float* tin = reinterpret_cast<float*>(park + 2 * kNp * fc);   // [S][nt]
  uint8_t* flg = reinterpret_cast<uint8_t*>(tin + (long long)S * nt);
  uint8_t* anyd = flg + S * kHalo;             // [S]
  uint8_t* cst = anyd + S;                     // [2][kNp]
  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * kTh, j0 = blockIdx.x * kTw;

  // the slot table: flags of every (slot, halo pixel), the static samples'
  // sigmoids, and whether a slot has a dynamic sample in the tile or halo
  for (int s = tid; s < S; s += nt) anyd[s] = 0;
  __syncthreads();
  for (int e = tid; e < S * kHalo; e += nt) {
    const int s = e / kHalo, k = e % kHalo;
    const int hi = k / kHw, hj = k % kHw;
    const int i = i0 + hi - 1, j = j0 + hj - 1;
    const bool corner =
        (hi == 0 || hi == kHh - 1) && (hj == 0 || hj == kHw - 1);
    uint8_t fl = 0;
    if (!corner && i >= 0 && i < h && j >= 0 && j < w) {
      const long long sp = (long long)s * P + (long long)i * w + j;
      const bool dyn = in.hit_d[sp] != 0;
      const bool m = dyn ? in.m_d[sp] != 0 : in.m_s[sp] != 0;
      fl = kValid | (dyn ? kDyn : 0) | (m ? kVm : 0);
      if (dyn) {
        anyd[s] = 1;
      } else {
        sdec[e] = sigmoids(in.vals_s[sp]);
      }
    }
    flg[e] = fl;
  }
  __syncthreads();

  // this thread's (pixel, frame) of a chunk
  const int px = tid / fc, fi = tid % fc;
  const int ty = px / kTw, tx = px % kTw;
  const int i = i0 + ty, j = j0 + tx;
  const bool in_img = i < h && j < w;
  const int k = (ty + 1) * kHw + tx + 1;       // its halo index
  const long long p = in_img ? (long long)i * w + j : 0;
  const bool has_l = j > 0, has_r = j + 1 < w, has_u = i > 0,
             has_d = i + 1 < h;
  const bool rgb_smooth = flags & kRgbSmooth, a_smooth = flags & kASmooth;
  const float g_rs_dx = rgb_smooth ? __fdiv_rn(gscal[1], n_rgb_dx) : 0.0f;
  const float g_rs_dy = rgb_smooth ? __fdiv_rn(gscal[1], n_rgb_dy) : 0.0f;
  const float g_as_dx = a_smooth ? __fdiv_rn(gscal[2], n_dx) : 0.0f;
  const float g_as_dy = a_smooth ? __fdiv_rn(gscal[2], n_dy) : 0.0f;

  // Slot s's smoothness gradients of the tile's static pixels whose
  // neighbours are static too (the same at every frame), into smc[s & 1],
  // flagged in cst[s & 1]: one warp, a pixel a lane.
  const bool smooth = rgb_smooth || a_smooth;
  auto static_smooth = [&](int s) {
    if (tid >= kNp) return;
    const int cy = tid / kTw, cx = tid % kTw;
    const int ci = i0 + cy, cj = j0 + cx;
    const int ck = (cy + 1) * kHw + cx + 1;
    const uint8_t* fs = flg + s * kHalo;
    const float4* sd = sdec + s * kHalo;
    const bool hl = cj > 0, hr = cj + 1 < w, hu = ci > 0, hd = ci + 1 < h;
    const bool con = ci < h && cj < w && !(fs[ck] & kDyn)
        && !(hl && (fs[ck - 1] & kDyn)) && !(hr && (fs[ck + 1] & kDyn))
        && !(hu && (fs[ck - kHw] & kDyn)) && !(hd && (fs[ck + kHw] & kDyn));
    cst[(s & 1) * kNp + tid] = con;
    if (!con) return;
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    smc[(s & 1) * kNp + tid] = smooth4(
        masked(sd[ck], fs[ck]), hl, hl ? masked(sd[ck - 1], fs[ck - 1]) : z,
        hr, hr ? masked(sd[ck + 1], fs[ck + 1]) : z, hu,
        hu ? masked(sd[ck - kHw], fs[ck - kHw]) : z, hd,
        hd ? masked(sd[ck + kHw], fs[ck + kHw]) : z, g_rs_dx, g_rs_dy,
        g_as_dx, g_as_dy);
  };

  // this thread's decode entries of a chunk: (halo pixel px, frame fi) and,
  // for the first kHalo - kNp pixels, (px + kNp, fi)
  const bool two = px + kNp < kHalo;
  auto halo_sp = [&](int s, int kk) {
    return (long long)s * P + (long long)(i0 + kk / kHw - 1) * w
        + (j0 + kk % kHw - 1);
  };

  const int n_chunks = (F + fc - 1) / fc;
  for (int c = 0; c < n_chunks; ++c) {
    const int f0 = c * fc;
    const int nf = min(fc, F - f0);
    const int f = f0 + fi;
    const bool active = in_img && fi < nf;
    const long long idx = p * F + f;

    // sweep A: the alphas of every slot into tin (the dynamic ones'
    // loads all issued at once), then near -> far, T_in over them in
    // place and the sparsity sums
    if (active) {
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const uint8_t fl = flg[s * kHalo + k];
        float a = 0.0f;
        if (fl & kVm) {
          a = (fl & kDyn) ? sigmoid_f(in.vals_d[((long long)s * P + p) * F
                                                + f].w)
                          : sdec[s * kHalo + k].w;
        }
        tin[s * nt + tid] = a;
      }
    }
    float T = 1.0f, l1 = 0.0f, l2 = 0.0f;
    for (int s = S - 1; s >= 0 && active; --s) {
      const float a = tin[s * nt + tid];
      tin[s * nt + tid] = T;
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
                               __fmul_rn(__fmul_rn(l2c, l2c),
                                         fmaxf(l2r, sp_eps)))
                   : 0.0f;
    }
    float go0 = 0.0f, go1 = 0.0f, go2 = 0.0f, ga = 0.0f, gd = 0.0f;
    if (active) {
      go0 = g_out[idx * 3 + 0];
      go1 = g_out[idx * 3 + 1];
      go2 = g_out[idx * 3 + 2];
      ga = g_asum[idx];
      if (flags & kWantDisp) gd = g_disp[idx];
    }

    // the chunk's dynamic samples of slot s in the tile and halo, each
    // once, into dec[s & 1]
    auto decode_dyn = [&](int s) {
      if (fi >= nf) return;
      const uint8_t* fs = flg + s * kHalo;
      float4* d = dec + (s & 1) * kHalo * fc;
      float4 v0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v1 = v0;
      const bool d0 = fs[px] & kDyn, d1 = two && (fs[px + kNp] & kDyn);
      if (d0) v0 = in.vals_d[halo_sp(s, px) * F + f];
      if (d1) v1 = in.vals_d[halo_sp(s, px + kNp) * F + f];
      if (d0) d[px * fc + fi] = sigmoids(v0);
      if (d1) d[(px + kNp) * fc + fi] = sigmoids(v1);
    };
    if (anyd[0]) decode_dyn(0);
    if (smooth) static_smooth(0);
    __syncthreads();   // dec[0] and smc[0] ready

    // sweep B (far -> near); one barrier a slot: the decode of slot s + 1
    // and the static sums of slot s - 1 overlap slot s
    float dT = 0.0f;
    for (int s = 0; s <= S; ++s) {
      if (s + 1 < S && anyd[s + 1]) decode_dyn(s + 1);
      if (smooth && s + 1 < S) static_smooth(s + 1);
      if (s < S && active) {
        const uint8_t* fs = flg + s * kHalo;
        const float4* ds = dec + (s & 1) * kHalo * fc;
        const long long sp = (long long)s * P + p;
        const uint8_t fl = fs[k];
        const bool dyn = fl & kDyn;
        const float vm = (fl & kVm) ? 1.0f : 0.0f;
        const float4 sg = dyn ? ds[k * fc + fi] : sdec[s * kHalo + k];
        const float4 cv = masked(sg, fl);
        float g_i = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(cv.x, go0),
                                                  __fmul_rn(cv.y, go1)),
                                        __fmul_rn(cv.z, go2)),
                              ga);
        if (flags & kWantDisp) g_i = __fadd_rn(g_i, __fmul_rn(in.dinv[sp], gd));
        const float Ts = tin[s * nt + tid];
        const float bw = __fmul_rn(cv.w, Ts);
        float da = __fmul_rn(Ts, __fsub_rn(g_i, dT));
        dT = __fadd_rn(__fmul_rn(cv.w, g_i),
                       __fmul_rn(__fsub_rn(1.0f, cv.w), dT));
        float dr = __fmul_rn(bw, go0), dg = __fmul_rn(bw, go1),
              db = __fmul_rn(bw, go2);
        if (flags & kSparsity) {
          da = __fsub_rn(__fadd_rn(da, __fmul_rn(a_coef, sign_f(cv.w))),
                         __fmul_rn(b_coef, cv.w));
        }
        if (smooth) {
          float4 sm;
          if (cst[(s & 1) * kNp + px]) {
            sm = smc[(s & 1) * kNp + px];
          } else {
            // a neighbour's masked values (zeros where it is missing)
            auto nb = [&](bool has, int kk) {
              if (!has) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              const uint8_t fn = fs[kk];
              return masked((fn & kDyn) ? ds[kk * fc + fi]
                                        : sdec[s * kHalo + kk], fn);
            };
            sm = smooth4(cv, has_l, nb(has_l, k - 1), has_r, nb(has_r, k + 1),
                         has_u, nb(has_u, k - kHw), has_d, nb(has_d, k + kHw),
                         g_rs_dx, g_rs_dy, g_as_dx, g_as_dy);
          }
          if (rgb_smooth) {
            dr = __fadd_rn(dr, sm.x);
            dg = __fadd_rn(dg, sm.y);
            db = __fadd_rn(db, sm.z);
          }
          if (a_smooth) da = __fadd_rn(da, sm.w);
        }
        const long long o = sp * F + f;
        if (dyn) {
          d_vals_d[o] = make_float4(
              __fmul_rn(__fmul_rn(dr, vm),
                        __fmul_rn(sg.x, __fsub_rn(1.0f, sg.x))),
              __fmul_rn(__fmul_rn(dg, vm),
                        __fmul_rn(sg.y, __fsub_rn(1.0f, sg.y))),
              __fmul_rn(__fmul_rn(db, vm),
                        __fmul_rn(sg.z, __fsub_rn(1.0f, sg.z))),
              __fmul_rn(__fmul_rn(vm != 0.0f ? da : 0.0f, sg.w),
                        __fsub_rn(1.0f, sg.w)));
        } else {
          d_vals_d[o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          park[(s & 1) * kNp * fc + px * fc + fi] = make_float4(dr, dg, db, da);
        }
      }
      // slot s - 1's static cotangents: the chunk's frames added in frame
      // order onto the running sum (one thread a pixel and channel); the
      // last chunk applies the mask and the sigmoid's derivative
      const int sl = s - 1;
      for (int e = tid; sl >= 0 && e < kNp * 4; e += nt) {
        const int cp = e >> 2, ch = e & 3;
        const int ci = i0 + cp / kTw, cj = j0 + cp % kTw;
        if (ci >= h || cj >= w) continue;
        const int ck = (cp / kTw + 1) * kHw + cp % kTw + 1;
        const uint8_t fl = flg[sl * kHalo + ck];
        const long long sp = (long long)sl * P + (long long)ci * w + cj;
        float* out = reinterpret_cast<float*>(d_vals_s) + sp * 4 + ch;
        if (fl & kDyn) {
          if (c == n_chunks - 1) *out = 0.0f;
          continue;
        }
        float* rs = reinterpret_cast<float*>(run + sl * kNp + cp) + ch;
        const float* pk = reinterpret_cast<const float*>(
            park + (sl & 1) * kNp * fc + cp * fc) + ch;
        float acc = c == 0 ? 0.0f : *rs;
        float pv[kFcMax];
#pragma unroll
        for (int q = 0; q < kFcMax; ++q) pv[q] = q < nf ? pk[q * 4] : 0.0f;
#pragma unroll
        for (int q = 0; q < kFcMax; ++q)
          if (q < nf) acc = __fadd_rn(acc, pv[q]);
        if (c < n_chunks - 1) {
          *rs = acc;
          continue;
        }
        const float vm = (fl & kVm) ? 1.0f : 0.0f;
        const float sv =
            reinterpret_cast<const float*>(sdec + sl * kHalo + ck)[ch];
        *out = ch < 3
            ? __fmul_rn(__fmul_rn(acc, vm), __fmul_rn(sv, __fsub_rn(1.0f, sv)))
            : __fmul_rn(__fmul_rn(vm != 0.0f ? acc : 0.0f, sv),
                        __fsub_rn(1.0f, sv));
      }
      __syncthreads();   // dec[(s + 1) & 1] ready; park[(s - 1) & 1] free
    }
  }
}

// K14's tile (see the header): kTw x kTh pixels and a halo of one column
// on the right and one row below (the neighbours the smoothness sums
// read; the corner is not needed), chunks of at most kFwdFcMax frames.
constexpr int kFHw = kTw + 1, kFHh = kTh + 1, kFHalo = kFHw * kFHh;
constexpr int kFwdFcMax = 10;

struct FwdLayout {
  int fc;          // frames a chunk
  int threads;     // kNp * fc
  long long smem;  // dynamic shared bytes
};

constexpr int kMaskWords = (kMaxSlots + 31) / 32;

// The shared arrays, in this order: the masked values of every (slot,
// tile or halo pixel, frame of a chunk) [S][kFHalo][fc] float4, the tile's
// reciprocal depths [S][kNp] float and the dynamic slots of each tile or
// halo pixel [kFHalo][kMaskWords] bit masks.
inline long long fwd_smem(int S, int fc) {
  const long long b = 16LL * S * kFHalo * fc + 4LL * S * kNp
      + 4LL * kFHalo * kMaskWords;
  return (b + 15) / 16 * 16;
}

// render/fused.py:fused_s2_fwd_layout mirrors this: as bwd_layout, the
// largest even split of F into chunks of at most kFwdFcMax frames whose
// block leaves room for a second one on the SM, else the largest whose
// block fits at all.
inline FwdLayout fwd_layout(int S, int F) {
  for (const long long limit : {kBwdSmemTwo, kBwdSmemLimit}) {
    for (int chunks = (F + kFwdFcMax - 1) / kFwdFcMax;; ++chunks) {
      const int fc = (F + chunks - 1) / chunks;
      if (fwd_smem(S, fc) <= limit) return {fc, kNp * fc, fwd_smem(S, fc)};
      if (fc == 1) break;
    }
  }
  return {1, kNp, fwd_smem(S, 1)};   // over the limit: the launch refuses
}

// K14's redesign.  Once per block: each static sample's masked value
// (decoded once a block), stored in all fc frame entries of the block's
// value table, the tile's reciprocal depths and each tile or halo pixel's
// dynamic slots as a bit mask.  Per chunk of fc frames (one thread per
// (pixel, frame), frames fastest): every slot's dynamic samples of the
// tile and halo are copied in at once (cp.async, all in flight together)
// and decoded in place (each once) into their frame entries; one
// barrier; then every thread composites all S slots
// near -> far (S - 1 first) from its own and its right and lower
// neighbours' entries, with no barrier between slots; one barrier before
// the next chunk's copies.  The same operations on the same values in the
// same order as fused_s2_fwd_kernel (kept as vl3d_fused_s2_fwd_first), so
// out, alpha_sum, disp and each (pixel, frame)'s five sums are its bits;
// the sums go to item_sums[p F + f] for fused_s2_sums_kernel.
__global__ void __launch_bounds__(kNp * kFwdFcMax) fused_s2_fwd_tile_kernel(
    In in, int flags, float sp_eps, int fc, float* __restrict__ out,
    float* __restrict__ asum, float* __restrict__ disp,
    float* __restrict__ item_sums) {
  extern __shared__ float4 smem4[];
  const int S = in.S, F = in.F, h = in.h, w = in.w;
  const long long P = (long long)h * w;
  const int nt = kNp * fc;
  float4* val = smem4;                         // [S][kFHalo][fc]
  float* dsm = reinterpret_cast<float*>(val + S * kFHalo * fc);  // [S][kNp]
  uint32_t* dmask = reinterpret_cast<uint32_t*>(dsm + S * kNp);
  // dmask [kFHalo][kMaskWords]: the slots where a halo pixel is dynamic
  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * kTh, j0 = blockIdx.x * kTw;
  const bool smooth = flags & (kRgbSmooth | kASmooth);
  const bool want_disp = flags & kWantDisp;

  // the slot table; without smoothness only the tile's own pixels
  for (int e = tid; e < kFHalo * kMaskWords; e += nt) dmask[e] = 0u;
  __syncthreads();
  for (int e = tid; e < S * kFHalo; e += nt) {
    const int s = e / kFHalo, k = e % kFHalo;
    const int hi = k / kFHw, hj = k % kFHw;
    const int i = i0 + hi, j = j0 + hj;
    const bool own = hi < kTh && hj < kTw;
    const bool need = own || (smooth && !(hi == kTh && hj == kTw));
    if (need && i < h && j < w) {
      const long long sp = (long long)s * P + (long long)i * w + j;
      const bool dyn = in.hit_d[sp] != 0;
      const bool m = dyn ? in.m_d[sp] != 0 : in.m_s[sp] != 0;
      const uint8_t fl = kValid | (dyn ? kDyn : 0) | (m ? kVm : 0);
      if (dyn) {
        atomicOr(dmask + k * kMaskWords + s / 32, 1u << (s % 32));
      } else {
        const float4 v = masked(sigmoids(in.vals_s[sp]), fl);
        for (int q = 0; q < fc; ++q) val[e * fc + q] = v;
      }
      if (own && want_disp) dsm[s * kNp + hi * kTw + hj] = in.dinv[sp];
    }
  }
  __syncthreads();

  // this thread's (pixel, frame) of a chunk
  const int px = tid / fc, fi = tid % fc;
  const int ty = px / kTw, tx = px % kTw;
  const int i = i0 + ty, j = j0 + tx;
  const bool in_img = i < h && j < w;
  const int k = ty * kFHw + tx;                // its halo index
  const long long p = in_img ? (long long)i * w + j : 0;
  const bool has_r = smooth && j + 1 < w, has_d = smooth && i + 1 < h;
  // its entries of a chunk: halo pixel px and, for the first
  // kFHalo - kNp pixels, px + kNp (their image pixels where flagged)
  const bool two = px + kNp < kFHalo;
  const long long hp0 = (long long)(i0 + px / kFHw) * w + (j0 + px % kFHw);
  const long long hp1 =
      (long long)(i0 + (px + kNp) / kFHw) * w + (j0 + (px + kNp) % kFHw);
  const int n_words = (S + 31) / 32;
  // the masked values' flags of an entry's dynamic sample
  auto vm_of = [&](int s, long long hp) {
    return (uint8_t)(kValid | kDyn | (in.m_d[s * P + hp] ? kVm : 0));
  };

  const int n_chunks = (F + fc - 1) / fc;
  for (int c = 0; c < n_chunks; ++c) {
    const int f0 = c * fc;
    const int nf = min(fc, F - f0);
    const int f = f0 + fi;
    const bool active = in_img && fi < nf;

    // every slot's dynamic samples of the chunk, copied in together (each
    // entry's dynamic slots from its mask), then decoded in place by the
    // thread that copied them
    if (fi < nf) {
      for (int wd = 0; wd < n_words; ++wd) {
        for (uint32_t m = dmask[px * kMaskWords + wd]; m; m &= m - 1) {
          const int s = wd * 32 + __ffs(m) - 1;
          __pipeline_memcpy_async(val + (s * kFHalo + px) * fc + fi,
                                  in.vals_d + (s * P + hp0) * F + f, 16);
        }
        if (!two) continue;
        for (uint32_t m = dmask[(px + kNp) * kMaskWords + wd]; m;
             m &= m - 1) {
          const int s = wd * 32 + __ffs(m) - 1;
          __pipeline_memcpy_async(val + (s * kFHalo + px + kNp) * fc + fi,
                                  in.vals_d + (s * P + hp1) * F + f, 16);
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    if (fi < nf) {
      for (int wd = 0; wd < n_words; ++wd) {
        for (uint32_t m = dmask[px * kMaskWords + wd]; m; m &= m - 1) {
          const int s = wd * 32 + __ffs(m) - 1;
          float4* e = val + (s * kFHalo + px) * fc + fi;
          *e = masked(sigmoids(*e), vm_of(s, hp0));
        }
        if (!two) continue;
        for (uint32_t m = dmask[(px + kNp) * kMaskWords + wd]; m;
             m &= m - 1) {
          const int s = wd * 32 + __ffs(m) - 1;
          float4* e = val + (s * kFHalo + px + kNp) * fc + fi;
          *e = masked(sigmoids(*e), vm_of(s, hp1));
        }
      }
    }
    __syncthreads();   // the chunk's values decoded

    if (active) {
      float T = 1.0f, o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, as = 0.0f;
      float dsp = 0.0f, l1 = 0.0f, l2 = 0.0f;
      float sums[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      const float4* vk = val + k * fc + fi;     // slot 0's own entry
      const float* dk = dsm + ty * kTw + tx;
#pragma unroll 4
      for (int s = S - 1; s >= 0; --s) {
        const float4* vp = vk + s * kFHalo * fc;
        // the neighbours read whether or not they count (their entries
        // lie in the table), then added where they do
        const float4 cv = vp[0], nr = vp[fc], nd = vp[kFHw * fc];
        const float bw = __fmul_rn(cv.w, T);
        o0 = __fadd_rn(o0, __fmul_rn(cv.x, bw));
        o1 = __fadd_rn(o1, __fmul_rn(cv.y, bw));
        o2 = __fadd_rn(o2, __fmul_rn(cv.z, bw));
        as = __fadd_rn(as, bw);
        if (want_disp) dsp = __fadd_rn(dsp, __fmul_rn(dk[s * kNp], bw));
        T = __fmul_rn(T, __fsub_rn(1.0f, cv.w));
        if (flags & kSparsity) {
          l1 = __fadd_rn(l1, fabsf(cv.w));
          l2 = __fadd_rn(l2, __fmul_rn(cv.w, cv.w));
        }
        const float rr = absdiff(nr.x, cv.x) + absdiff(nr.y, cv.y)
            + absdiff(nr.z, cv.z);
        const float ra = absdiff(nr.w, cv.w);
        const float dr = absdiff(nd.x, cv.x) + absdiff(nd.y, cv.y)
            + absdiff(nd.z, cv.z);
        const float da = absdiff(nd.w, cv.w);
        sums[1] = has_r ? sums[1] + rr : sums[1];
        sums[3] = has_r ? sums[3] + ra : sums[3];
        sums[2] = has_d ? sums[2] + dr : sums[2];
        sums[4] = has_d ? sums[4] + da : sums[4];
      }
      const long long idx = p * F + f;
      out[idx * 3 + 0] = o0;
      out[idx * 3 + 1] = o1;
      out[idx * 3 + 2] = o2;
      asum[idx] = as;
      disp[idx] = dsp;
      if (item_sums != nullptr) {
        if (flags & kSparsity)
          sums[0] = __fdiv_rn(l1, fmaxf(sqrtf(l2), sp_eps));
        for (int q = 0; q < kSums; ++q) item_sums[idx * kSums + q] = sums[q];
      }
    }
    __syncthreads();   // the chunk's values read
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

// K14 (the redesign): S <= 128 slots, F <= 1,024 frames, h * w pixels in
// a grid of ceil(w / kTw) x ceil(h / kTh) tiles.  item_sums: scratch of
// h*w*F * 5 floats, or null where no regularizer is on (flags & 7 == 0);
// partials: scratch of vl3d_partial_rows(h*w*F) * 5 floats (fused_s1.cu);
// regs: 3 floats.
VL3D_API int vl3d_fused_s2_fwd(const float* vals_s, const float* vals_d,
                               const uint8_t* m_s, const uint8_t* hit_d,
                               const uint8_t* m_d, const float* dinv, int S,
                               int h, int w, int F, int flags, float sp_eps,
                               float n_pix, float sqrt_planes, float n_rgb_dx,
                               float n_rgb_dy, float n_dx, float n_dy,
                               float* out, float* asum, float* disp,
                               float* item_sums, float* partials, float* regs,
                               void* stream) {
  if (S > kMaxSlots || F > 1024 || S < 0) return (int)cudaErrorInvalidValue;
  const bool any_sum = flags & (kSparsity | kRgbSmooth | kASmooth);
  if (any_sum && item_sums == nullptr) return (int)cudaErrorInvalidValue;
  const long long n = (long long)h * w * F;
  if (n <= 0) return 0;
  const FwdLayout lay = fwd_layout(S, F);
  if (lay.smem > kBwdSmemLimit) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTw - 1) / kTw, (h + kTh - 1) / kTh);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaFuncSetAttribute(fused_s2_fwd_tile_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)lay.smem);
  fused_s2_fwd_tile_kernel<<<grid, lay.threads, lay.smem, st>>>(
      make_in(vals_s, vals_d, m_s, hit_d, m_d, dinv, S, h, w, F), flags,
      sp_eps, lay.fc, out, asum, disp, any_sum ? item_sums : nullptr);
  // the first design's reduction of the same sums; with none on, its
  // partials are zeros and the reduction reads none
  const unsigned int blocks = grid_for(n);
  if (any_sum)
    fused_s2_sums_kernel<<<blocks, kBlock, 0, st>>>(item_sums, n, partials);
  fused_s2_reduce_kernel<<<1, kBlock, 0, st>>>(
      partials, any_sum ? (int)blocks : 0, n_pix, sqrt_planes, n_rgb_dx,
      n_rgb_dy, n_dx, n_dy, regs);
  return (int)cudaGetLastError();
}

// K14's layout for S slots and F frames: out = {fc, threads, smem}
// (render/fused.py:fused_s2_fwd_layout's keys, in order).
VL3D_API int vl3d_fused_s2_fwd_layout(int S, int F, long long* out) {
  const FwdLayout lay = fwd_layout(S, F);
  out[0] = lay.fc;
  out[1] = lay.threads;
  out[2] = lay.smem;
  return 0;
}

// K14's first design (for comparison; no wrapper calls it).  partials:
// scratch of vl3d_partial_rows(h*w*F) * 5 floats; regs: 3 floats.
VL3D_API int vl3d_fused_s2_fwd_first(
    const float* vals_s, const float* vals_d, const uint8_t* m_s,
    const uint8_t* hit_d, const uint8_t* m_d, const float* dinv, int S,
    int h, int w, int F, int flags, float sp_eps, float n_pix,
    float sqrt_planes, float n_rgb_dx, float n_rgb_dy, float n_dx,
    float n_dy, float* out, float* asum, float* disp, float* partials,
    float* regs, void* stream) {
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

// K15: S <= 128 slots, F <= 1,024 frames, h * w pixels in a grid of
// ceil(w / kTw) x ceil(h / kTh) tiles.
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
  if ((long long)h * w <= 0 || F <= 0 || S <= 0) return 0;
  const BwdLayout lay = bwd_layout(S, F);
  if (lay.smem > kBwdSmemLimit) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTw - 1) / kTw, (h + kTh - 1) / kTh);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(fused_s2_bwd_tile_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)lay.smem);
  fused_s2_bwd_tile_kernel<<<grid, lay.threads, lay.smem,
                             (cudaStream_t)stream>>>(
      make_in(vals_s, vals_d, m_s, hit_d, m_d, dinv, S, h, w, F), g_out,
      g_asum, g_disp, gscal, flags, sp_eps, sp_norm, n_rgb_dx, n_rgb_dy,
      n_dx, n_dy, lay.fc, reinterpret_cast<float4*>(d_vals_s),
      reinterpret_cast<float4*>(d_vals_d));
  return (int)cudaGetLastError();
}

// K15's layout for S slots and F frames: out = {fc, threads, smem}
// (render/fused.py:fused_s2_bwd_layout's keys, in order).
VL3D_API int vl3d_fused_s2_bwd_layout(int S, int F, long long* out) {
  const BwdLayout lay = bwd_layout(S, F);
  out[0] = lay.fc;
  out[1] = lay.threads;
  out[2] = lay.smem;
  return 0;
}

// K15's first design (for comparison; no wrapper calls it).
VL3D_API int vl3d_fused_s2_bwd_first(
    const float* vals_s, const float* vals_d, const uint8_t* m_s,
    const uint8_t* hit_d, const uint8_t* m_d, const float* dinv,
    const float* g_out, const float* g_asum, const float* g_disp,
    const float* gscal, int S, int h, int w, int F, int flags, float sp_eps,
    float sp_norm, float n_rgb_dx, float n_rgb_dy, float n_dx, float n_dy,
    float* d_vals_s, float* d_vals_d, void* stream) {
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
