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
// over every plane.  Flags (bit 0 sparsity, 1 rgb-smooth, 2 a-smooth, 3
// l-smooth, 4 use-loop, 5 want-disp) switch the terms as FusedS1Cfg does.
//
// The scalar sums are reduced deterministically: each pixel's seven sums,
// then 256-pixel partials in a fixed tree order, then one single-block
// pass over the partials, so two runs agree bit for bit.  The backward is
// the division-free reverse sweep of the JAX VJP: sweep A recomputes the
// incoming transmittance T_in of every plane (at most kMaxPlanes), sweep B
// walks far -> near:
//   g_i = <rgb, g_out> + g_asum + dinv g_disp
//   da = T_in (g_i - dT);  dT = a g_i + (1 - a) dT
// plus the sparsity coefficients (sign(0) = 0), the smoothness gradients
// and the mask-logit gradient through the detached alpha.  No atomics:
// each thread writes its own planes.  Every arithmetic step rounds once,
// in the order of the plain PyTorch version.
//
// Bound on the H100: bytes.  The forward reads 16 B of features, 1 B of
// validity and 4 B each of mask logit and disparity per (b, plane, pixel)
// and writes 24 B per pixel; the backward reads the same plus 24 B of
// cotangents per pixel and writes 20 B per (b, plane, pixel).  The first
// designs (fused_s1_fwd_kernel and fused_s1_bwd_kernel, kept as
// vl3d_fused_s1_fwd_first and vl3d_fused_s1_bwd_first for chip_smoke.py
// and the card tests only) run one thread per (b, pixel), pixels fastest,
// looping over the planes in registers and decoding each neighbour again
// from its features at every plane (K7: its pixel, the right and the lower
// one, about 13 sigmoids a (plane, pixel); K8: its pixel and four
// neighbours, about 21, and T_in in a per-thread array in local memory).
//
// Both redesigns run on a kTw x kTh = 16 x 8 pixel tile of one b, one
// thread a pixel, with the halo the pass reads staged in shared memory
// plane by plane, each (plane, tile or halo pixel) decoded once: a pixel's
// thread decodes its own pixel (its sigmoids, validity and loop sigmoid
// stay in registers) and warps of their own after the tile's decode the
// halo's ring, off the chains' path.  The staged values are r, g, b, a
// and, under l_smooth, the loop probability.  The has_l/r/u/d edges are
// the patch's, so a neighbour is read from the stage only where the first
// design decodes it.  Every output is the first design's chain of the same
// values, rounded the same way: the same bits.
//
// K8 (fused_s1_bwd_tile_kernel): the one-pixel halo, kRing = 52 pixels on
// two ring warps.  Pass A (near -> far) computes each own pixel's alpha
// once, T_in into shared memory ([D][kTilePx], each thread its own column,
// so no barrier) and the sparsity sums.  Pass B (far -> near) stages each
// plane's decoded tile and halo in a double buffer: plane s + 1's loads
// are issued before plane s's chain and decoded after it, one barrier a
// plane (none without a smoothness term).  About 5 + 1 sigmoids a (plane,
// pixel) on the chain's threads, 4 on the ring's for 0.41 of a pixel.
// Registers are held to 80 so that four blocks fit an SM (460 blocks at
// the stage-1 patch).  fused_s1_bwd_layout (and
// render/fused_s1.py:fused_s1_bwd_layout) gives the tile, the halo, the
// threads and the shared bytes by D.
//
// K7 (fused_s1_fwd_tile_kernel): the one-sided halo the forward reads,
// the column to the right and the row below (kFwdRing = 24 pixels, one
// ring warp).  One pass near -> far in groups of kFwdPlanes = 2 planes:
// a group's decode is staged in a double buffer after the previous
// group's chains, one barrier a group (none without a smoothness term),
// with the loads of the next group (kFwdAhead = 2 planes) in flight, in
// registers, while its chains run.  One plane a barrier, and 4 planes a
// barrier or ahead, were no faster on the H100 (PERF.md, K7's row).
// Each pixel's seven regularizer sums accumulate in the first design's
// order and go to a (7, B h w) scratch; fused_s1_tree_kernel reduces them
// by the first design's 256-pixel tree (pixel runs of the flat (b, i, j)
// order, the missing pixels of the last run as its idle threads' zeros)
// into the per-block partials, and its last block to finish reduces those
// as the first design's fused_s1_reduce_kernel does: the same bits for
// the four scalars too, in two kernels as before.  About 5 sigmoids a
// (plane, pixel) on the chain's threads and 5 on the ring's for 0.19 of a
// pixel, against about 13.  No plane limit.  fused_s1_fwd_layout (and
// render/fused_s1.py:fused_s1_fwd_layout) gives the tile, the stage, the
// threads and the shared bytes.
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

// one plane's raw inputs at one pixel
struct Raw {
  float4 f;
  bool vld;
  float m;    // mask logit (use_loop)
  float dv;   // disparity (want_disp)
};

__device__ __forceinline__ Raw load_raw(const float4* __restrict__ feats,
                                        const uint8_t* __restrict__ valid,
                                        const float* __restrict__ mask,
                                        const float* __restrict__ dinv,
                                        long long o) {
  Raw r;
  r.f = feats[o];
  r.vld = valid[o] != 0;
  r.m = mask != nullptr ? mask[o] : 0.0f;
  r.dv = dinv != nullptr ? dinv[o] : 0.0f;
  return r;
}

// decode() of a loaded pixel: the same operations in the same order
__device__ __forceinline__ Px decode_raw(const Raw& r) {
  Px p;
  p.vm = r.vld ? 1.0f : 0.0f;
  p.s0 = sigmoid_f(r.f.x);
  p.s1 = sigmoid_f(r.f.y);
  p.s2 = sigmoid_f(r.f.z);
  p.s3 = sigmoid_f(r.f.w);
  p.r = __fmul_rn(p.s0, p.vm);
  p.g = __fmul_rn(p.s1, p.vm);
  p.b = __fmul_rn(p.s2, p.vm);
  p.a = r.vld ? p.s3 : 0.0f;
  return p;
}

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

// One block of kBlock threads: column sums of the (n_blocks, kSums)
// partials in a fixed order, then the regularizer scalars [sparsity,
// rgb_smooth, a_smooth, l_smooth]; red: kSums x kBlock shared floats.
// The partials are read from L2 (another block may have written them).
__device__ __forceinline__ void reduce_partials(
    float (*red)[kBlock], const float* __restrict__ partials, int n_blocks,
    float n_pix, float sqrt_planes, float n_rgb_dx, float n_rgb_dy,
    float n_dx, float n_dy, float* __restrict__ regs) {
  float acc[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int blk = threadIdx.x; blk < n_blocks; blk += kBlock)
    for (int k = 0; k < kSums; ++k) acc[k] += __ldcg(partials + blk * kSums + k);
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

// K7's first design's second kernel: one block, reduce_partials
__global__ void fused_s1_reduce_kernel(const float* __restrict__ partials,
                                       int n_blocks, float n_pix,
                                       float sqrt_planes, float n_rgb_dx,
                                       float n_rgb_dy, float n_dx, float n_dy,
                                       float* __restrict__ regs) {
  __shared__ float red[kSums][kBlock];
  reduce_partials(red, partials, n_blocks, n_pix, sqrt_planes, n_rgb_dx,
                  n_rgb_dy, n_dx, n_dy, regs);
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

// K8's tile (see the header): kTw x kTh pixels, one thread each, with a
// one-pixel halo; the kRing halo pixels outside the tile are decoded by
// the kRingThreads threads after the tile's
constexpr int kTw = 16, kTh = 8;
constexpr int kTilePx = kTw * kTh;
constexpr int kHw = kTw + 2, kHh = kTh + 2;
constexpr int kHalo = kHw * kHh;
constexpr int kRing = kHalo - kTilePx;
constexpr int kRingThreads = (kRing + 31) / 32 * 32;
constexpr int kBwdThreads = kTilePx + kRingThreads;

struct BwdLayout {
  int tile_w, tile_h, halo, threads, smem;
};

// dynamic shared bytes: two staged planes' rgba (float4) and loop
// probabilities (float) of the tile and halo, then T_in [D][kTilePx]
BwdLayout bwd_layout(int D) {
  return BwdLayout{kTw, kTh, kHalo, kBwdThreads,
                   (int)((sizeof(float4) + sizeof(float)) * 2 * kHalo
                         + sizeof(float) * D * kTilePx)};
}

// the halo coordinates (row, column in [0, kHh) x [0, kHw)) of ring pixel
// r: the top row, the bottom row, the left column, the right column
__device__ __forceinline__ void ring_coord(int r, int& hy, int& hx) {
  if (r < kHw) {
    hy = 0;
    hx = r;
  } else if (r < 2 * kHw) {
    hy = kHh - 1;
    hx = r - kHw;
  } else if (r < 2 * kHw + kTh) {
    hy = r - 2 * kHw + 1;
    hx = 0;
  } else {
    hy = r - 2 * kHw - kTh + 1;
    hx = kHw - 1;
  }
}

__global__ void __launch_bounds__(kBwdThreads, 4) fused_s1_bwd_tile_kernel(
    const float4* __restrict__ feats, const uint8_t* __restrict__ valid,
    const float* __restrict__ mask, const float* __restrict__ dinv,
    const float* __restrict__ g_out, const float* __restrict__ g_asum,
    const float* __restrict__ g_disp, const float* __restrict__ g_label,
    const float* __restrict__ gscal, int D, int h, int w, int tiles_w,
    int tiles_per_b, int flags, float sp_eps, float sp_norm, float n_rgb_dx,
    float n_rgb_dy, float n_dx, float n_dy, float4* __restrict__ d_feats,
    float* __restrict__ d_mask) {
  extern __shared__ float4 bwd_smem[];
  float4* st_rgba = bwd_smem;                                    // [2][kHalo]
  float* st_lp = reinterpret_cast<float*>(st_rgba + 2 * kHalo);  // [2][kHalo]
  float* t_in = st_lp + 2 * kHalo;                               // [D][kTilePx]

  const int t = threadIdx.x;
  const int b = blockIdx.x / tiles_per_b;
  const int tile = blockIdx.x - b * tiles_per_b;
  const int i0 = (tile / tiles_w) * kTh, j0 = (tile % tiles_w) * kTw;
  const int ty = t / kTw, tx = t - ty * kTw;
  const int i = i0 + ty, j = j0 + tx;
  const bool own = t < kTilePx && i < h && j < w;
  const long long P = (long long)h * w;
  const long long p = (long long)i * w + j;
  const long long idx = (long long)b * P + p;
  const int hc = (ty + 1) * kHw + tx + 1;     // own pixel in the stage
  const bool has_l = j > 0, has_r = j + 1 < w, has_u = i > 0,
             has_d = i + 1 < h;
  const bool rgb_smooth = flags & kRgbSmooth, a_smooth = flags & kASmooth;
  const bool use_loop = flags & kUseLoop, l_smooth = use_loop &&
                                                     (flags & kLSmooth);
  const bool want_disp = flags & kWantDisp;
  const bool stage_rgba = rgb_smooth || a_smooth;
  const bool stage = stage_rgba || l_smooth;
  const float* mask_p = use_loop ? mask : nullptr;
  const float* dinv_p = want_disp ? dinv : nullptr;

  // a ring thread's halo pixel, if it lies in the patch
  int rc = -1;
  long long rp = 0;
  const int rt = t - kTilePx;
  if (stage && rt >= 0 && rt < kRing) {
    int hy, hx;
    ring_coord(rt, hy, hx);
    const int ri = i0 + hy - 1, rj = j0 + hx - 1;
    if (ri >= 0 && ri < h && rj >= 0 && rj < w) {
      rc = hy * kHw + hx;
      rp = (long long)ri * w + rj;
    }
  }

  // pass A (near -> far): incoming transmittance and sparsity sums
  float l1 = 0.0f, l2 = 0.0f;
  if (own) {
    const float* fw = reinterpret_cast<const float*>(feats) + 3;
    float T = 1.0f;
#pragma unroll 8
    for (int s = D - 1; s >= 0; --s) {
      const long long o = ((long long)b * D + s) * P + p;
      const float a = valid[o] ? sigmoid_f(fw[4 * o]) : 0.0f;
      t_in[s * kTilePx + t] = T;
      T = __fmul_rn(T, __fsub_rn(1.0f, a));
      if (flags & kSparsity) {
        l1 = __fadd_rn(l1, fabsf(a));
        l2 = __fadd_rn(l2, __fmul_rn(a, a));
      }
    }
  }
  float a_coef = 0.0f, b_coef = 0.0f;
  if (own && (flags & kSparsity)) {
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
  float go0 = 0.0f, go1 = 0.0f, go2 = 0.0f, ga = 0.0f, gd = 0.0f, gl = 0.0f;
  if (own) {
    go0 = g_out[idx * 3 + 0];
    go1 = g_out[idx * 3 + 1];
    go2 = g_out[idx * 3 + 2];
    ga = g_asum[idx];
    gd = want_disp ? g_disp[idx] : 0.0f;
    gl = use_loop ? g_label[idx] : 0.0f;
  }

  // pass B (far -> near).  c, lsig, dv: the own pixel's plane in
  // registers; the stage: the tile and halo of the plane; nxt, rnxt: the
  // next plane's raw inputs, loaded before this plane's chain.
  const long long base = (long long)b * D * P;
  Px c = {};
  float lsig = 0.0f, dv = 0.0f;
  Raw nxt = {}, rnxt = {};
  // decode plane s from nxt / rnxt into c and stage buffer s & 1
  auto stage_plane = [&](int s) {
    const int buf = s & 1;
    if (own) {
      c = decode_raw(nxt);
      lsig = use_loop ? sigmoid_f(nxt.m) : 0.0f;
      dv = nxt.dv;
      if (stage_rgba) st_rgba[buf * kHalo + hc] = make_float4(c.r, c.g, c.b,
                                                              c.a);
      if (l_smooth) st_lp[buf * kHalo + hc] = c.vm != 0.0f ? lsig : 0.0f;
    }
    if (rc >= 0) {
      if (stage_rgba) {
        const Px n = decode_raw(rnxt);
        st_rgba[buf * kHalo + rc] = make_float4(n.r, n.g, n.b, n.a);
      }
      if (l_smooth) {
        st_lp[buf * kHalo + rc] = rnxt.vld ? sigmoid_f(rnxt.m) : 0.0f;
      }
    }
  };
  auto load_plane = [&](int s) {
    const long long po = base + (long long)s * P;
    if (own) nxt = load_raw(feats, valid, mask_p, dinv_p, po + p);
    if (rc >= 0) {
      rnxt = load_raw(feats, valid, l_smooth ? mask : nullptr, nullptr,
                      po + rp);
    }
  };
  load_plane(0);
  stage_plane(0);
  if (stage) __syncthreads();
  float dT = 0.0f;
  for (int s = 0; s < D; ++s) {
    if (s + 1 < D) load_plane(s + 1);
    if (own) {
      const long long o = base + (long long)s * P + p;
      const float tin = t_in[s * kTilePx + t];
      float g_i = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.r, go0),
                                                __fmul_rn(c.g, go1)),
                                      __fmul_rn(c.b, go2)),
                            ga);
      if (want_disp) g_i = __fadd_rn(g_i, __fmul_rn(dv, gd));
      const float bw = __fmul_rn(c.a, tin);
      float da = __fmul_rn(tin, __fsub_rn(g_i, dT));
      dT = __fadd_rn(__fmul_rn(c.a, g_i),
                     __fmul_rn(__fsub_rn(1.0f, c.a), dT));
      float dr = __fmul_rn(bw, go0), dg = __fmul_rn(bw, go1),
            db = __fmul_rn(bw, go2);
      if (flags & kSparsity) {
        da = __fsub_rn(__fadd_rn(da, __fmul_rn(a_coef, sign_f(c.a))),
                       __fmul_rn(b_coef, c.a));
      }
      const int buf = s & 1;
      if (stage_rgba) {
        const float4* sr = st_rgba + buf * kHalo;
        const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float4 nl = has_l ? sr[hc - 1] : z;
        const float4 nr = has_r ? sr[hc + 1] : z;
        const float4 nu = has_u ? sr[hc - kHw] : z;
        const float4 nd = has_d ? sr[hc + kHw] : z;
        if (rgb_smooth) {
          dr = __fadd_rn(dr, smooth_grad(c.r, has_l, nl.x, has_r, nr.x,
                                         has_u, nu.x, has_d, nd.x, g_rs_dx,
                                         g_rs_dy));
          dg = __fadd_rn(dg, smooth_grad(c.g, has_l, nl.y, has_r, nr.y,
                                         has_u, nu.y, has_d, nd.y, g_rs_dx,
                                         g_rs_dy));
          db = __fadd_rn(db, smooth_grad(c.b, has_l, nl.z, has_r, nr.z,
                                         has_u, nu.z, has_d, nd.z, g_rs_dx,
                                         g_rs_dy));
        }
        if (a_smooth) {
          da = __fadd_rn(da, smooth_grad(c.a, has_l, nl.w, has_r, nr.w,
                                         has_u, nu.w, has_d, nd.w, g_as_dx,
                                         g_as_dy));
        }
      }
      d_feats[o] = make_float4(
          __fmul_rn(__fmul_rn(dr, c.vm),
                    __fmul_rn(c.s0, __fsub_rn(1.0f, c.s0))),
          __fmul_rn(__fmul_rn(dg, c.vm),
                    __fmul_rn(c.s1, __fsub_rn(1.0f, c.s1))),
          __fmul_rn(__fmul_rn(db, c.vm),
                    __fmul_rn(c.s2, __fsub_rn(1.0f, c.s2))),
          __fmul_rn(__fmul_rn(c.vm != 0.0f ? da : 0.0f, c.s3),
                    __fsub_rn(1.0f, c.s3)));
      if (use_loop) {
        float d_lp = __fmul_rn(gl, bw);
        if (l_smooth) {
          const float* sl = st_lp + buf * kHalo;
          const float lp = c.vm != 0.0f ? lsig : 0.0f;
          d_lp = __fadd_rn(
              d_lp, smooth_grad(lp, has_l, has_l ? sl[hc - 1] : 0.0f, has_r,
                                has_r ? sl[hc + 1] : 0.0f, has_u,
                                has_u ? sl[hc - kHw] : 0.0f, has_d,
                                has_d ? sl[hc + kHw] : 0.0f, g_ls_dx,
                                g_ls_dy));
        }
        d_mask[o] = __fmul_rn(__fmul_rn(c.vm != 0.0f ? d_lp : 0.0f, lsig),
                              __fsub_rn(1.0f, lsig));
      }
    }
    if (s + 1 < D) stage_plane(s + 1);
    if (stage) __syncthreads();
  }
}

// K7's tile (see the header): K8's kTw x kTh pixels, one thread each,
// and the one-sided halo the forward reads, decoded by one ring warp: the
// column to the right (kTh pixels), then the row below (kTw)
constexpr int kFwdHw = kTw + 1, kFwdHh = kTh + 1;
constexpr int kFwdHalo = kFwdHw * kFwdHh;   // staged entries (corner unused)
constexpr int kFwdRing = kTw + kTh;
constexpr int kFwdRingThreads = (kFwdRing + 31) / 32 * 32;
constexpr int kFwdThreads = kTilePx + kFwdRingThreads;
constexpr int kFwdPlanes = 2;               // planes staged a barrier
constexpr int kFwdAhead = 2;                // planes loaded ahead of a chain

struct FwdLayout {
  int tile_w, tile_h, halo, threads, smem;
};

// static shared bytes: two buffers of kFwdPlanes staged planes' rgba
// (float4) and loop probabilities (float) of the tile and its one-sided
// halo
FwdLayout fwd_layout() {
  return FwdLayout{kTw, kTh, kFwdHalo, kFwdThreads,
                   (int)((sizeof(float4) + sizeof(float)) * 2 * kFwdPlanes
                         * kFwdHalo)};
}

// pix: the pixels' seven sums, pix[k * n + idx] for idx < n = B h w.
// kFwdPlanes planes staged a barrier, kFwdAhead (a multiple of kFwdPlanes)
// planes' loads in flight
__global__ void __launch_bounds__(kFwdThreads, 4) fused_s1_fwd_tile_kernel(
    const float4* __restrict__ feats, const uint8_t* __restrict__ valid,
    const float* __restrict__ mask, const float* __restrict__ dinv, int D,
    int h, int w, int tiles_w, int tiles_per_b, int flags, float sp_eps,
    float* __restrict__ out, float* __restrict__ asum,
    float* __restrict__ disp, float* __restrict__ label,
    float* __restrict__ pix) {
  static_assert(kFwdAhead % kFwdPlanes == 0, "whole groups of planes ahead");
  __shared__ float4 st_rgba[2][kFwdPlanes][kFwdHalo];
  __shared__ float st_lp[2][kFwdPlanes][kFwdHalo];

  const int t = threadIdx.x;
  const int b = blockIdx.x / tiles_per_b;
  const int tile = blockIdx.x - b * tiles_per_b;
  const int i0 = (tile / tiles_w) * kTh, j0 = (tile % tiles_w) * kTw;
  const int ty = t / kTw, tx = t - ty * kTw;
  const int i = i0 + ty, j = j0 + tx;
  const bool own = t < kTilePx && i < h && j < w;
  const long long P = (long long)h * w;
  const long long p = (long long)i * w + j;
  const int hc = ty * kFwdHw + tx;            // own pixel in the stage
  const bool has_r = j + 1 < w, has_d = i + 1 < h;
  const bool smooth = flags & (kRgbSmooth | kASmooth);
  const bool use_loop = flags & kUseLoop;
  const bool l_smooth = use_loop && (flags & kLSmooth);
  const bool want_disp = flags & kWantDisp;
  const bool stage = smooth || l_smooth;
  const float* mask_p = use_loop ? mask : nullptr;
  const float* dinv_p = want_disp ? dinv : nullptr;

  // a ring thread's halo pixel, if it lies in the patch
  int rc = -1;
  long long rp = 0;
  const int rt = t - kTilePx;
  if (rt >= 0) {
    if (!stage) return;                      // no barrier without a stage
    if (rt < kFwdRing) {
      const int hy = rt < kTh ? rt : kTh, hx = rt < kTh ? kTw : rt - kTh;
      const int ri = i0 + hy, rj = j0 + hx;
      if (ri < h && rj < w) {
        rc = hy * kFwdHw + hx;
        rp = (long long)ri * w + rj;
      }
    }
  }

  // a thread's pixel: its own (the chain's) or its ring pixel
  const bool mine = own || rc >= 0;
  const long long mp = own ? p : rp;
  const float* m_ptr = own ? mask_p : (l_smooth ? mask : nullptr);
  const float* d_ptr = own ? dinv_p : nullptr;
  const int mc = own ? hc : rc;
  const long long base = (long long)b * D * P;
  auto load_plane = [&](int s, Raw& r) {
    if (mine && s >= 0)
      r = load_raw(feats, valid, m_ptr, d_ptr, base + (long long)s * P + mp);
  };
  float T = 1.0f, o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, as = 0.0f;
  float dsp = 0.0f, lab = 0.0f, l1 = 0.0f, l2 = 0.0f;
  float sums[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  // a plane's decode into registers and stage slot st[buf][k]
  auto stage_plane = [&](const Raw& r, int buf, int k, Px& c, float& lp) {
    if (!mine) return;
    if (smooth || own) c = decode_raw(r);
    if (use_loop && (own || l_smooth)) lp = r.vld ? sigmoid_f(r.m) : 0.0f;
    if (smooth) st_rgba[buf][k][mc] = make_float4(c.r, c.g, c.b, c.a);
    if (l_smooth) st_lp[buf][k][mc] = lp;
  };
  // the own pixel's chain of one plane, its neighbours from slot [buf][k]
  auto chain = [&](const Px& c, float lp, float dv, int buf, int k) {
    const float bw = __fmul_rn(c.a, T);
    o0 = __fadd_rn(o0, __fmul_rn(c.r, bw));
    o1 = __fadd_rn(o1, __fmul_rn(c.g, bw));
    o2 = __fadd_rn(o2, __fmul_rn(c.b, bw));
    as = __fadd_rn(as, bw);
    if (want_disp) dsp = __fadd_rn(dsp, __fmul_rn(dv, bw));
    if (use_loop) {
      lab = __fadd_rn(lab, __fmul_rn(lp, bw));
      if (l_smooth) {
        if (has_r) sums[5] += absdiff(st_lp[buf][k][hc + 1], lp);
        if (has_d) sums[6] += absdiff(st_lp[buf][k][hc + kFwdHw], lp);
      }
    }
    T = __fmul_rn(T, __fsub_rn(1.0f, c.a));
    if (flags & kSparsity) {
      l1 = __fadd_rn(l1, fabsf(c.a));
      l2 = __fadd_rn(l2, __fmul_rn(c.a, c.a));
    }
    if (smooth && has_r) {
      const float4 n = st_rgba[buf][k][hc + 1];
      sums[1] += absdiff(n.x, c.r) + absdiff(n.y, c.g) + absdiff(n.z, c.b);
      sums[3] += absdiff(n.w, c.a);
    }
    if (smooth && has_d) {
      const float4 n = st_rgba[buf][k][hc + kFwdHw];
      sums[2] += absdiff(n.x, c.r) + absdiff(n.y, c.g) + absdiff(n.z, c.b);
      sums[4] += absdiff(n.w, c.a);
    }
  };
  // a ring of kFwdAhead planes' raw inputs in registers: plane s in
  // r[(D - 1 - s) % kFwdAhead].  A group of kFwdPlanes planes from s0 down:
  // decode them into registers and the stage buffer of the group's parity,
  // reuse their registers for the loads kFwdAhead planes further, then (after
  // the barrier) the own pixel's chains in plane order
  Raw r[kFwdAhead];
#pragma unroll
  for (int u = 0; u < kFwdAhead; ++u) {
    r[u] = Raw{};
    load_plane(D - 1 - u, r[u]);
  }
  int group = 0;
  for (int s = D - 1; s >= 0; s -= kFwdAhead) {
#pragma unroll
    for (int u = 0; u < kFwdAhead; u += kFwdPlanes) {
      const int s0 = s - u, buf = group++ & 1;
      if (s0 < 0) break;                     // uniform over the block
      Px c[kFwdPlanes];
      float lp[kFwdPlanes], dv[kFwdPlanes];
#pragma unroll
      for (int k = 0; k < kFwdPlanes; ++k) {
        c[k] = Px{};
        lp[k] = 0.0f;
        dv[k] = r[u + k].dv;
        if (s0 - k >= 0) stage_plane(r[u + k], buf, k, c[k], lp[k]);
        load_plane(s0 - k - kFwdAhead, r[u + k]);
      }
      if (stage) __syncthreads();
      if (own) {
#pragma unroll
        for (int k = 0; k < kFwdPlanes; ++k) {
          if (s0 - k >= 0) chain(c[k], lp[k], dv[k], buf, k);
        }
      }
    }
  }
  if (!own) return;
  const long long idx = (long long)b * P + p;
  const long long n = (long long)gridDim.x / tiles_per_b * P;
  // the tree kernel's ticket, after the pixels' sums
  if (idx == 0) *reinterpret_cast<unsigned*>(pix + kSums * n) = 0u;
  out[idx * 3 + 0] = o0;
  out[idx * 3 + 1] = o1;
  out[idx * 3 + 2] = o2;
  asum[idx] = as;
  disp[idx] = dsp;
  label[idx] = lab;
  if (flags & kSparsity) sums[0] = __fdiv_rn(l1, fmaxf(sqrtf(l2), sp_eps));
#pragma unroll
  for (int k = 0; k < kSums; ++k) pix[k * n + idx] = sums[k];
}

// the first design's block partials from the pixels' sums: the 256 pixels
// of block blockIdx.x in its tree order, its idle threads' zeros past n;
// the block that finishes last (by a ticket the tile kernel zeroed) then
// reduces the partials as fused_s1_reduce_kernel does
__global__ void fused_s1_tree_kernel(const float* __restrict__ pix,
                                     long long n,
                                     float* __restrict__ partials,
                                     unsigned* __restrict__ ticket,
                                     float n_pix, float sqrt_planes,
                                     float n_rgb_dx, float n_rgb_dy,
                                     float n_dx, float n_dy,
                                     float* __restrict__ regs) {
  __shared__ float red[kSums][kBlock];
  __shared__ bool last;
  const long long idx = (long long)blockIdx.x * kBlock + threadIdx.x;
  for (int k = 0; k < kSums; ++k)
    red[k][threadIdx.x] = idx < n ? pix[k * n + idx] : 0.0f;
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
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    reduce_partials(red, partials, (int)gridDim.x, n_pix, sqrt_planes,
                    n_rgb_dx, n_rgb_dy, n_dx, n_dy, regs);
  }
}

}  // namespace

// Rows of the per-block partials scratch of K7 and K14 (fused_s2.cu): the
// blocks of a launch of one thread per element over n elements.
VL3D_API int vl3d_partial_rows(long long n) { return (int)grid_for(n); }

// K7 (fused_s1_fwd_tile_kernel, then fused_s1_tree_kernel).  pix: scratch
// of 7 * B*h*w floats and one word for the tree's ticket; partials:
// scratch of vl3d_partial_rows(B*h*w) * 7 floats; regs: 4 floats.
VL3D_API int vl3d_fused_s1_fwd(const float* feats, const uint8_t* valid,
                               const float* mask, const float* dinv, int B,
                               int D, int h, int w, int flags, float sp_eps,
                               float n_pix, float sqrt_planes, float n_rgb_dx,
                               float n_rgb_dy, float n_dx, float n_dy,
                               float* out, float* asum, float* disp,
                               float* label, float* pix, float* partials,
                               float* regs, void* stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * h * w;
  if (n > 0) {
    const FwdLayout lay = fwd_layout();
    const int tiles_w = (w + kTw - 1) / kTw, tiles_h = (h + kTh - 1) / kTh;
    const long long blocks = (long long)B * tiles_w * tiles_h;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    fused_s1_fwd_tile_kernel<<<(unsigned)blocks, lay.threads, 0, s>>>(
        reinterpret_cast<const float4*>(feats), valid, mask, dinv, D, h, w,
        tiles_w, tiles_w * tiles_h, flags, sp_eps, out, asum, disp, label,
        pix);
    fused_s1_tree_kernel<<<grid_for(n), kBlock, 0, s>>>(
        pix, n, partials, reinterpret_cast<unsigned*>(pix + kSums * n),
        n_pix, sqrt_planes, n_rgb_dx, n_rgb_dy, n_dx, n_dy, regs);
  }
  return (int)cudaGetLastError();
}

// K7's first design (fused_s1_fwd_kernel; for comparison, no wrapper calls
// it); arguments as vl3d_fused_s1_fwd's less pix.
VL3D_API int vl3d_fused_s1_fwd_first(const float* feats, const uint8_t* valid,
                                     const float* mask, const float* dinv,
                                     int B, int D, int h, int w, int flags,
                                     float sp_eps, float n_pix,
                                     float sqrt_planes, float n_rgb_dx,
                                     float n_rgb_dy, float n_dx, float n_dy,
                                     float* out, float* asum, float* disp,
                                     float* label, float* partials,
                                     float* regs, void* stream) {
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

// K7's layout for D planes: out = {tile_w, tile_h, halo, threads, smem}
// (render/fused_s1.py:fused_s1_fwd_layout's keys, in order);
// cudaErrorInvalidValue for D < 1 (no upper limit).
VL3D_API int vl3d_fused_s1_fwd_layout(int D, long long* out) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const FwdLayout lay = fwd_layout();
  out[0] = lay.tile_w;
  out[1] = lay.tile_h;
  out[2] = lay.halo;
  out[3] = lay.threads;
  out[4] = lay.smem;
  return 0;
}

// K8 (fused_s1_bwd_tile_kernel); D <= kMaxPlanes.
VL3D_API int vl3d_fused_s1_bwd(const float* feats, const uint8_t* valid,
                               const float* mask, const float* dinv,
                               const float* g_out, const float* g_asum,
                               const float* g_disp, const float* g_label,
                               const float* gscal, int B, int D, int h, int w,
                               int flags, float sp_eps, float sp_norm,
                               float n_rgb_dx, float n_rgb_dy, float n_dx,
                               float n_dy, float* d_feats, float* d_mask,
                               void* stream) {
  if (D < 1 || D > kMaxPlanes) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * h * w;
  if (n > 0) {
    const BwdLayout lay = bwd_layout(D);
    const int tiles_w = (w + kTw - 1) / kTw, tiles_h = (h + kTh - 1) / kTh;
    const long long blocks = (long long)B * tiles_w * tiles_h;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (lay.smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fused_s1_bwd_tile_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem);
      if (e != cudaSuccess) return (int)e;
    }
    fused_s1_bwd_tile_kernel<<<(unsigned)blocks, lay.threads, lay.smem,
                               (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(feats), valid, mask, dinv, g_out,
        g_asum, g_disp, g_label, gscal, D, h, w, tiles_w, tiles_w * tiles_h,
        flags, sp_eps, sp_norm, n_rgb_dx, n_rgb_dy, n_dx, n_dy,
        reinterpret_cast<float4*>(d_feats), d_mask);
  }
  return (int)cudaGetLastError();
}

// K8's first design (fused_s1_bwd_kernel; for comparison, no wrapper calls
// it); arguments as vl3d_fused_s1_bwd's.
VL3D_API int vl3d_fused_s1_bwd_first(const float* feats,
                                     const uint8_t* valid, const float* mask,
                                     const float* dinv, const float* g_out,
                                     const float* g_asum, const float* g_disp,
                                     const float* g_label, const float* gscal,
                                     int B, int D, int h, int w, int flags,
                                     float sp_eps, float sp_norm,
                                     float n_rgb_dx, float n_rgb_dy,
                                     float n_dx, float n_dy, float* d_feats,
                                     float* d_mask, void* stream) {
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

// K8's layout for D planes: out = {tile_w, tile_h, halo, threads, smem}
// (render/fused_s1.py:fused_s1_bwd_layout's keys, in order);
// cudaErrorInvalidValue beyond 1 <= D <= kMaxPlanes.
VL3D_API int vl3d_fused_s1_bwd_layout(int D, long long* out) {
  if (D < 1 || D > kMaxPlanes) return (int)cudaErrorInvalidValue;
  const BwdLayout lay = bwd_layout(D);
  out[0] = lay.tile_w;
  out[1] = lay.tile_h;
  out[2] = lay.halo;
  out[3] = lay.threads;
  out[4] = lay.smem;
  return 0;
}
