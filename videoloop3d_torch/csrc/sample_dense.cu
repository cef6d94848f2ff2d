// K5 sample_dense and K6 sample_dense_grad: the dense stage-1 plane sampler
// and its atlas gradient.
//
// Replaces videoloop3d_tpu/render/adjoint.py:sample_dense_blockadj (forward
// _block_matmul_sample, backward _block_matmul_atlas_grad), whose semantics
// are those of render/sample.py:bilinear_planes: an align-corners bilinear
// sample of per-plane (D, Ht, Wt, C) textures at (B, D, h, w) texel
// coordinates, each of the four corners read as zero where it lies outside
// the texture.  The TPU version contracts per-block texel windows on the MXU
// because gathers and scatters were slow there; it is exact only while the
// window covers the block's samples.  On the GPU the direct forms are exact
// for any warp: K5 gathers four corners per sample, K6 scatters the four
// corner weights times the cotangent with atomics.
//
// The atlas and the loop-mask atlas (C = 1) are separate pointers, so no
// concatenated (D, Ht, Wt, C + 1) copy is built per step; mask pointers may
// be null.  The atlas has C channels: the direct decoder's C = 4 takes one
// float4 per texel (the kernels below as first written); any other C (13
// for rgb_sh, 36 for rgba_sh, --atlas_cnl for nex_rgb / mlp_alpha) takes
// the general-C kernels, with the same per-channel arithmetic, so both
// paths agree bit for bit at C = 4.  Corners are found from
// floor(x), clamped to [-2, Wt] in float before the int conversion, so
// coordinates far outside the plane or behind the camera index nothing.
// Lerps follow bilinear_planes' order with one rounding per operation:
//   top = v00 (1 - fx) + v01 fx;  bot = v10 (1 - fx) + v11 fx;
//   out = top (1 - fy) + bot fy.
// K6 applies the transposed weights in the order autograd takes through the
// plain version (g (1 - fy) (1 - fx) for v00, ...).  Its atomics add in
// no fixed order, so its sums are reproducible only to rounding.
//
// Bound on the H100: bytes.  K5 reads 8 B of coordinates per sample, the
// texels the samples touch, and writes 4 (C + 1) B per sample.  K6 reads the
// 4 (C + 1) B cotangent and 8 B of coordinates per sample and
// read-modify-writes the touched texels of the gradient, which the wrapper
// zero-fills first (at C = 4 the fill, 20 B a texel of the 32 x 576 x 1024
// planes, is most of the bound).  Design: K5 one thread per (b, d, pixel),
// pixels fastest, so a warp reads and writes contiguous runs and its texel
// reads stay within a few rows.  K5 at C != 4 (redesigned): a block takes
// 256 consecutive samples; one thread per sample finds its corners once
// and samples the loop-mask channel, then the block's threads sweep its
// (sample, channel) outputs, or (sample, 4 channels) where C % 4 == 0 and
// the atlas is 16-byte aligned, in output order, so that a warp's texel
// reads run over consecutive channels and a block writes one contiguous
// span (a thread per sample looping over 36 channels strides its warp's
// accesses by 144 B).  Its first design, one thread per (sample, channel),
// redid the corners, the coordinate loads and two 64-bit divisions in
// each of the C + 1 threads of a sample; it stays callable as
// vl3d_sample_dense_per_channel, for chip_smoke.py's comparison only.  K6
// at C != 4 runs one thread per (sample, channel), C scalar atomics per
// corner.
// K6 at C = 4 (the direct decoder) adds each corner's four channels with
// one 128-bit atomicAdd(float4*) (sm_90) where the first design issued
// four scalar atomics: 1.84 M samples at the stage-1 shapes make 7.4 M
// corner adds into the atlas and 7.4 M into the mask.  Summing a 32 x 8
// pixel tile's corners in shared memory first and adding each touched
// texel once was built and measured slower than these atomics alone:
// sm_90 has no shared-memory float atomic add (it compiles to a
// compare-and-swap loop, ATOMS.CAST.SPIN), and at ~1.45 texels a pixel a
// tile's texel box holds ~0.6 texels a corner, so the flush saves little.
// The first design stays callable as vl3d_sample_dense_grad_scalar, for
// chip_smoke.py's comparison only.
//
// K22 sample_dense_coord_grad: the gradient of the same samples with
// respect to their coordinates (--optimize_geo_start: JAX takes it by
// autodiff of render/sample.py:bilinear_planes).  Per sample, with the
// four corners read as K5 reads them (zero outside the texture) and the
// cotangent g over the atlas's C channels and, when given, the loop-mask
// channel (JAX samples the mask as channel C of one source):
//   g_x = sum_c g_c ((1 - fy)(v01 - v00) + fy (v11 - v10))_c
//   g_y = sum_c g_c ((1 - fx)(v10 - v00) + fx (v11 - v01))_c
// Texels are f32 or bf16 (widened to f32).  Bound: bytes; it reads the
// 4 (C + 1) B cotangent and 8 B of coordinates per sample and the touched
// texels, and writes 8 B.  First design (sample_dense_coord_grad_kernel):
// one thread per sample, as K5's float4 kernel, walking its C channels in
// order; nvcc contracts each channel's terms into fma(1 - fy, v01 - v00,
// fy (v11 - v10)), then fma(g_c, that, s).  At C = 4 (the direct decoder)
// it stays the design, a thread's corners 16 B apart.  At other C its
// warp's loads of g_c and of each corner's channel c stride by 4C bytes
// (144 B at rgba_sh's 36): each load instruction touches up to 32 lines,
// and a warp's ~23 KB of rows falls out of L1 before the next channel
// reads them again.  It stays callable as
// vl3d_sample_dense_coord_grad_first (chip_smoke.py and the card tests
// only).
// K22 at C != 4 (redesigned, coord_grad_staged_kernel): each warp takes
// 32 consecutive samples (a block of 256 threads, 256 samples;
// coord_grad_layout) and works alone, synchronized by __syncwarp only.
// Lane t finds sample t's corners once, as K5's sweep does, and computes
// the loop-mask channel's terms in registers.  The warp then sweeps its
// 32 samples' (sample, four channels) items in output order: a lane's
// loads of the cotangent and of each corner run over consecutive
// channels, as one vector each where C % 4 == 0 and the pointers are
// aligned (two items a lane in flight), else as scalar loads (a sample's
// last item holds C % 4 channels).  Each channel's g_c and its two terms,
// spelled out as the first design's contraction, go to shared memory in
// three planes [channel][sample] at a sample stride of 33 words, so that
// neither the sweep's stores nor the chain's loads meet in a bank.  Lane t
// then runs sample t's chain s = fma(g_c, term_c, s) in channel order, and
// the mask's last: the first design's sums, bit for bit.  C is swept in
// passes of at most 16 channels (55 KB of shared memory a block, three
// blocks an SM), the chains' sums carried across passes in registers.
// One thread a sample in 256-sample blocks with two barriers, a chunk of
// 36, was measured slower at C = 8 and 13; so were a thread a channel,
// loads copied with cp.async and longer unrolls (PERF.md, K22).  Bf16
// texels at C % 4 != 0 keep the first design, whose 2-byte rows stay in
// L1 (the staged kernel's scalar route was slower there).  Texel indices
// are 32-bit (the launcher refuses an atlas of 2^31 texels or more).
#include <climits>
#include <cstdint>

#include "vec.cuh"

namespace {

struct Corners {
  int x0, y0;       // top-left corner, possibly outside the texture
  float fx, fy;
  bool in00, in01, in10, in11;
};

__device__ __forceinline__ Corners corners_of(float x, float y, int Ht,
                                              int Wt) {
  Corners c;
  const float xf = floorf(x), yf = floorf(y);
  c.fx = __fsub_rn(x, xf);
  c.fy = __fsub_rn(y, yf);
  // clamp in float first: a huge or non-finite coordinate becomes -2 or
  // the size, both of whose corners are outside
  c.x0 = (int)fminf(fmaxf(xf, -2.0f), (float)Wt);
  c.y0 = (int)fminf(fmaxf(yf, -2.0f), (float)Ht);
  const bool xin0 = c.x0 >= 0 && c.x0 < Wt;
  const bool xin1 = c.x0 + 1 >= 0 && c.x0 + 1 < Wt;
  const bool yin0 = c.y0 >= 0 && c.y0 < Ht;
  const bool yin1 = c.y0 + 1 >= 0 && c.y0 + 1 < Ht;
  c.in00 = xin0 && yin0;
  c.in01 = xin1 && yin0;
  c.in10 = xin0 && yin1;
  c.in11 = xin1 && yin1;
  return c;
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  return make_float4(lerp_rn(a.x, b.x, f), lerp_rn(a.y, b.y, f),
                     lerp_rn(a.z, b.z, f), lerp_rn(a.w, b.w, f));
}

__global__ void sample_dense_kernel(const float4* __restrict__ atlas,
                                    const float* __restrict__ mask,
                                    const float* __restrict__ x,
                                    const float* __restrict__ y, int D,
                                    long long P, long long n, int Ht, int Wt,
                                    float4* __restrict__ out,
                                    float* __restrict__ out_mask) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int d = (int)((idx / P) % D);
  const Corners c = corners_of(x[idx], y[idx], Ht, Wt);
  const long long row0 = ((long long)d * Ht + c.y0) * Wt + c.x0;
  const long long row1 = row0 + Wt;
  const float4 z4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 v00 = c.in00 ? atlas[row0] : z4;
  const float4 v01 = c.in01 ? atlas[row0 + 1] : z4;
  const float4 v10 = c.in10 ? atlas[row1] : z4;
  const float4 v11 = c.in11 ? atlas[row1 + 1] : z4;
  out[idx] = lerp4(lerp4(v00, v01, c.fx), lerp4(v10, v11, c.fx), c.fy);
  if (mask != nullptr) {
    const float m00 = c.in00 ? mask[row0] : 0.0f;
    const float m01 = c.in01 ? mask[row0 + 1] : 0.0f;
    const float m10 = c.in10 ? mask[row1] : 0.0f;
    const float m11 = c.in11 ? mask[row1 + 1] : 0.0f;
    out_mask[idx] = lerp_rn(lerp_rn(m00, m01, c.fx), lerp_rn(m10, m11, c.fx),
                            c.fy);
  }
}

// kVector: one 128-bit atomicAdd(float4*) (sm_90); else four scalar ones
// (K6's first design)
template <bool kVector>
__device__ __forceinline__ void add4(float* dst, float4 v) {
  if constexpr (kVector) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
  } else {
    atomicAdd(dst + 0, v.x);
    atomicAdd(dst + 1, v.y);
    atomicAdd(dst + 2, v.z);
    atomicAdd(dst + 3, v.w);
  }
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s),
                     __fmul_rn(v.w, s));
}

template <bool kVector>
__global__ void sample_dense_grad_kernel(const float4* __restrict__ g,
                                         const float* __restrict__ gm,
                                         const float* __restrict__ x,
                                         const float* __restrict__ y, int D,
                                         long long P, long long n, int Ht,
                                         int Wt, float* __restrict__ g_atlas,
                                         float* __restrict__ g_mask) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int d = (int)((idx / P) % D);
  const Corners c = corners_of(x[idx], y[idx], Ht, Wt);
  const long long row0 = ((long long)d * Ht + c.y0) * Wt + c.x0;
  const long long row1 = row0 + Wt;
  const float wx0 = __fsub_rn(1.0f, c.fx), wy0 = __fsub_rn(1.0f, c.fy);
  const float4 gv = g[idx];
  const float4 gt = scale4(gv, wy0), gb = scale4(gv, c.fy);
  if (c.in00) add4<kVector>(g_atlas + row0 * 4, scale4(gt, wx0));
  if (c.in01) add4<kVector>(g_atlas + (row0 + 1) * 4, scale4(gt, c.fx));
  if (c.in10) add4<kVector>(g_atlas + row1 * 4, scale4(gb, wx0));
  if (c.in11) add4<kVector>(g_atlas + (row1 + 1) * 4, scale4(gb, c.fx));
  if (gm != nullptr) {
    const float m = gm[idx];
    const float mt = __fmul_rn(m, wy0), mb = __fmul_rn(m, c.fy);
    if (c.in00) atomicAdd(g_mask + row0, __fmul_rn(mt, wx0));
    if (c.in01) atomicAdd(g_mask + row0 + 1, __fmul_rn(mt, c.fx));
    if (c.in10) atomicAdd(g_mask + row1, __fmul_rn(mb, wx0));
    if (c.in11) atomicAdd(g_mask + row1 + 1, __fmul_rn(mb, c.fx));
  }
}

// K6 at C = 4 with shared-memory accumulation (a design measured slower
// than the 128-bit atomics alone and kept for chip_smoke.py's comparison
// only): a block takes a 32 x 8 tile of one (b, d) plane's h x w pixels;
// where the texel box of its corners inside the texture holds at most
// `window` texels, the block adds its corners' C + 1 channels into shared
// memory and then adds each touched texel to global memory once (one
// float4 and one scalar atomic); otherwise it adds them to global memory
// directly, as sample_dense_grad_kernel, and counts itself in *over.
__global__ void sample_dense_grad_window_kernel(
    const float4* __restrict__ g, const float* __restrict__ gm,
    const float* __restrict__ x, const float* __restrict__ y, int D, int h,
    int w, int Ht, int Wt, int window, float* __restrict__ g_atlas,
    float* __restrict__ g_mask, int* over) {
  extern __shared__ float4 acc[];   // window float4s, then window floats
  float* accm = reinterpret_cast<float*>(acc + window);
  __shared__ int box[4][kBlock / 32];
  const int plane = blockIdx.y, d = plane % D;
  const int tiles_w = (w + 31) / 32;
  const int px = (blockIdx.x % tiles_w) * 32 + threadIdx.x % 32;
  const int py = (blockIdx.x / tiles_w) * 8 + threadIdx.x / 32;
  const bool live = px < w && py < h;
  const long long idx = ((long long)plane * h + py) * w + px;
  Corners c{};
  if (live) c = corners_of(x[idx], y[idx], Ht, Wt);
  const bool top = c.in00 || c.in01, bot = c.in10 || c.in11;
  const bool lft = c.in00 || c.in10, rgt = c.in01 || c.in11;
  const bool any = live && (top || bot);
  // the texel box: rows r0..r1, columns c0..c1 of the in-texture corners
  int v[4] = {any ? (top ? c.y0 : c.y0 + 1) : INT_MAX,
              any ? -(bot ? c.y0 + 1 : c.y0) : INT_MAX,
              any ? (lft ? c.x0 : c.x0 + 1) : INT_MAX,
              any ? -(rgt ? c.x0 + 1 : c.x0) : INT_MAX};
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  for (int k = 0; k < 4; ++k) {
    const int m = __reduce_min_sync(0xffffffffu, v[k]);
    if (lane == 0) box[k][wid] = m;
  }
  __syncthreads();
  for (int k = 0; k < 4; ++k) {
    v[k] = box[k][0];
    for (int j = 1; j < kBlock / 32; ++j) v[k] = min(v[k], box[k][j]);
  }
  if (v[0] == INT_MAX) return;   // no corner of the tile in the texture
  const int r0 = v[0], r1 = -v[1], c0 = v[2], c1 = -v[3];
  const int bw = c1 - c0 + 1;
  const long long nbox = (long long)(r1 - r0 + 1) * bw;
  const float wx0 = __fsub_rn(1.0f, c.fx), wy0 = __fsub_rn(1.0f, c.fy);
  const float4 gv = any ? g[idx] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 gt = scale4(gv, wy0), gb = scale4(gv, c.fy);
  const float m = any && gm != nullptr ? gm[idx] : 0.0f;
  const float mt = __fmul_rn(m, wy0), mb = __fmul_rn(m, c.fy);
  const float4 cv[4] = {scale4(gt, wx0), scale4(gt, c.fx), scale4(gb, wx0),
                        scale4(gb, c.fx)};
  const float cm[4] = {__fmul_rn(mt, wx0), __fmul_rn(mt, c.fx),
                       __fmul_rn(mb, wx0), __fmul_rn(mb, c.fx)};
  const bool in[4] = {c.in00, c.in01, c.in10, c.in11};
  if (nbox > window) {
    if (threadIdx.x == 0 && over != nullptr) atomicAdd(over, 1);
    if (!any) return;
    const long long row0 = ((long long)d * Ht + c.y0) * Wt + c.x0;
    for (int k = 0; k < 4; ++k) {
      if (!in[k]) continue;
      const long long t = row0 + (k >> 1) * Wt + (k & 1);
      atomicAdd(reinterpret_cast<float4*>(g_atlas + t * 4), cv[k]);
      if (gm != nullptr) atomicAdd(g_mask + t, cm[k]);
    }
    return;
  }
  for (int t = threadIdx.x; t < nbox; t += kBlock) {
    acc[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    accm[t] = 0.0f;
  }
  __syncthreads();
  if (any) {
    const int l0 = (c.y0 - r0) * bw + (c.x0 - c0);
    for (int k = 0; k < 4; ++k) {
      if (!in[k]) continue;
      const int l = l0 + (k >> 1) * bw + (k & 1);
      atomicAdd(&acc[l].x, cv[k].x);
      atomicAdd(&acc[l].y, cv[k].y);
      atomicAdd(&acc[l].z, cv[k].z);
      atomicAdd(&acc[l].w, cv[k].w);
      if (gm != nullptr) atomicAdd(accm + l, cm[k]);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nbox; t += kBlock) {
    const float4 a = acc[t];
    const long long texel = ((long long)d * Ht + r0 + t / bw) * Wt + c0
        + t % bw;
    if (a.x != 0.0f || a.y != 0.0f || a.z != 0.0f || a.w != 0.0f)
      atomicAdd(reinterpret_cast<float4*>(g_atlas + texel * 4), a);
    if (gm != nullptr && accm[t] != 0.0f) atomicAdd(g_mask + texel, accm[t]);
  }
}

// K5's first design at any C (chip_smoke.py's comparison only): the
// float4 kernel's arithmetic, one thread per (sample, channel), the
// loop-mask channel last (channel C), so that a warp reads and writes
// consecutive channels of its samples' texels.
__global__ void sample_dense_c_kernel(const float* __restrict__ atlas,
                                      const float* __restrict__ mask,
                                      const float* __restrict__ x,
                                      const float* __restrict__ y, int D,
                                      long long P, long long n, int Ht, int Wt,
                                      int C, float* __restrict__ out,
                                      float* __restrict__ out_mask) {
  const int Cm = C + (mask != nullptr ? 1 : 0);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * Cm) return;
  const long long idx = t / Cm;
  const int k = (int)(t - idx * Cm);
  const int d = (int)((idx / P) % D);
  const Corners c = corners_of(x[idx], y[idx], Ht, Wt);
  const long long row0 = ((long long)d * Ht + c.y0) * Wt + c.x0;
  const long long row1 = row0 + Wt;
  // the channel's texels: stride C from texel to texel (1 for the mask)
  const float* src = k < C ? atlas + k : mask;
  const long long s = k < C ? C : 1;
  const float v00 = c.in00 ? src[row0 * s] : 0.0f;
  const float v01 = c.in01 ? src[(row0 + 1) * s] : 0.0f;
  const float v10 = c.in10 ? src[row1 * s] : 0.0f;
  const float v11 = c.in11 ? src[(row1 + 1) * s] : 0.0f;
  const float v = lerp_rn(lerp_rn(v00, v01, c.fx), lerp_rn(v10, v11, c.fx),
                          c.fy);
  if (k < C) {
    out[idx * C + k] = v;
  } else {
    out_mask[idx] = v;
  }
}

__device__ __forceinline__ float lerp_v(float a, float b, float f) {
  return lerp_rn(a, b, f);
}
__device__ __forceinline__ float4 lerp_v(float4 a, float4 b, float f) {
  return lerp4(a, b, f);
}

// outputs a thread loads before it lerps any: four of one channel, two of
// four channels (at four, 98 registers held two blocks an SM)
template <typename V>
struct Sweep {
  static constexpr int kUnroll = 4;
};
template <>
struct Sweep<float4> {
  static constexpr int kUnroll = 2;
};

// K5 at C != 4: a block takes kBlock consecutive samples.  Thread t finds
// sample t's corners once (corners_of), samples its loop-mask channel, and
// leaves the texel index of corner (x0, y0), the four in-texture bits, fx
// and fy in shared memory.  The block's threads then sweep the block's
// count x Cv outputs in output order, V one channel (Cv = C) or four
// (float4, Cv = C / 4): consecutive threads on consecutive outputs, so a
// block writes one contiguous span of out.  A thread's (sample, channel)
// steps by kBlock outputs with a carry (no division); Sweep<V>::kUnroll
// outputs' texels are loaded before any is lerped.  Texel indices are 32-bit (the
// launcher refuses an atlas of 2^31 texels or more).
template <typename V>
__global__ void __launch_bounds__(kBlock) sample_dense_block_kernel(
    const V* __restrict__ atlas, const float* __restrict__ mask,
    const float* __restrict__ x, const float* __restrict__ y, int D,
    long long P, long long n, int Ht, int Wt, int Cv, V* __restrict__ out,
    float* __restrict__ out_mask) {
  __shared__ int4 slot[kBlock];     // texel of (x0, y0), in bits, fx, fy
  const long long first = (long long)blockIdx.x * kBlock;
  const int count = (int)min((long long)kBlock, n - first);
  if ((int)threadIdx.x < count) {
    const long long idx = first + threadIdx.x;
    const int d = (int)((idx / P) % D);
    const Corners c = corners_of(x[idx], y[idx], Ht, Wt);
    const int row0 = (d * Ht + c.y0) * Wt + c.x0;
    slot[threadIdx.x] = make_int4(
        row0, (int)c.in00 | (int)c.in01 << 1 | (int)c.in10 << 2
        | (int)c.in11 << 3, __float_as_int(c.fx), __float_as_int(c.fy));
    if (mask != nullptr) {
      const int row1 = row0 + Wt;
      const float m00 = c.in00 ? mask[row0] : 0.0f;
      const float m01 = c.in01 ? mask[row0 + 1] : 0.0f;
      const float m10 = c.in10 ? mask[row1] : 0.0f;
      const float m11 = c.in11 ? mask[row1 + 1] : 0.0f;
      out_mask[idx] = lerp_rn(lerp_rn(m00, m01, c.fx),
                              lerp_rn(m10, m11, c.fx), c.fy);
    }
  }
  __syncthreads();
  const int total = count * Cv;
  V* __restrict__ dst = out + first * Cv;
  const long long down = (long long)Wt * Cv;     // one texel row, in V
  const int ds = kBlock / Cv, dk = kBlock - ds * Cv;
  int s = threadIdx.x / Cv;
  int k = threadIdx.x - s * Cv;
  const V zero{};
  constexpr int kSweepUnroll = Sweep<V>::kUnroll;
  for (int o = threadIdx.x; o < total; o += kSweepUnroll * kBlock) {
    V v[kSweepUnroll][4];
    float fx[kSweepUnroll], fy[kSweepUnroll];
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u) {
      const int4 sl = o + u * kBlock < total ? slot[s]
                                             : make_int4(0, 0, 0, 0);
      const V* a = atlas + ((long long)sl.x * Cv + k);
      v[u][0] = (sl.y & 1) ? a[0] : zero;
      v[u][1] = (sl.y & 2) ? a[Cv] : zero;
      v[u][2] = (sl.y & 4) ? a[down] : zero;
      v[u][3] = (sl.y & 8) ? a[down + Cv] : zero;
      fx[u] = __int_as_float(sl.z);
      fy[u] = __int_as_float(sl.w);
      k += dk;
      s += ds;
      if (k >= Cv) {
        k -= Cv;
        ++s;
      }
    }
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u) {
      if (o + u * kBlock < total)
        dst[o + u * kBlock] = lerp_v(lerp_v(v[u][0], v[u][1], fx[u]),
                                     lerp_v(v[u][2], v[u][3], fx[u]), fy[u]);
    }
  }
}

// K6 at any C: one thread per (sample, channel) as K5's, four scalar
// atomics (consecutive addresses across a warp), the float4 kernel's
// products.
__global__ void sample_dense_grad_c_kernel(const float* __restrict__ g,
                                           const float* __restrict__ gm,
                                           const float* __restrict__ x,
                                           const float* __restrict__ y, int D,
                                           long long P, long long n, int Ht,
                                           int Wt, int C,
                                           float* __restrict__ g_atlas,
                                           float* __restrict__ g_mask) {
  const int Cm = C + (gm != nullptr ? 1 : 0);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * Cm) return;
  const long long idx = t / Cm;
  const int k = (int)(t - idx * Cm);
  const int d = (int)((idx / P) % D);
  const Corners c = corners_of(x[idx], y[idx], Ht, Wt);
  const long long row0 = ((long long)d * Ht + c.y0) * Wt + c.x0;
  const long long row1 = row0 + Wt;
  const float wx0 = __fsub_rn(1.0f, c.fx), wy0 = __fsub_rn(1.0f, c.fy);
  const float gv = k < C ? g[idx * C + k] : gm[idx];
  float* dst = k < C ? g_atlas + k : g_mask;
  const long long s = k < C ? C : 1;
  const float gt = __fmul_rn(gv, wy0), gb = __fmul_rn(gv, c.fy);
  if (c.in00) atomicAdd(dst + row0 * s, __fmul_rn(gt, wx0));
  if (c.in01) atomicAdd(dst + (row0 + 1) * s, __fmul_rn(gt, c.fx));
  if (c.in10) atomicAdd(dst + row1 * s, __fmul_rn(gb, wx0));
  if (c.in11) atomicAdd(dst + (row1 + 1) * s, __fmul_rn(gb, c.fx));
}

template <typename T>
__global__ void sample_dense_coord_grad_kernel(
    const T* __restrict__ atlas, const T* __restrict__ mask,
    const float* __restrict__ g, const float* __restrict__ gm,
    const float* __restrict__ x, const float* __restrict__ y, int D,
    long long P, long long n, int Ht, int Wt, int C, float* __restrict__ gx,
    float* __restrict__ gy) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int d = (int)((idx / P) % D);
  const Corners c = corners_of(x[idx], y[idx], Ht, Wt);
  const long long row0 = ((long long)d * Ht + c.y0) * Wt + c.x0;
  const long long row1 = row0 + Wt;
  const float wx0 = 1.0f - c.fx, wy0 = 1.0f - c.fy;
  const T* t00 = atlas + row0 * C;
  const T* t10 = atlas + row1 * C;
  const float* gi = g + idx * C;
  float sx = 0.0f, sy = 0.0f;
  for (int k = 0; k < C; ++k) {
    const float a00 = c.in00 ? to_f32(t00[k]) : 0.0f;
    const float a01 = c.in01 ? to_f32(t00[C + k]) : 0.0f;
    const float a10 = c.in10 ? to_f32(t10[k]) : 0.0f;
    const float a11 = c.in11 ? to_f32(t10[C + k]) : 0.0f;
    sx += gi[k] * (wy0 * (a01 - a00) + c.fy * (a11 - a10));
    sy += gi[k] * (wx0 * (a10 - a00) + c.fx * (a11 - a01));
  }
  if (mask != nullptr) {
    const float m00 = c.in00 ? to_f32(mask[row0]) : 0.0f;
    const float m01 = c.in01 ? to_f32(mask[row0 + 1]) : 0.0f;
    const float m10 = c.in10 ? to_f32(mask[row1]) : 0.0f;
    const float m11 = c.in11 ? to_f32(mask[row1 + 1]) : 0.0f;
    const float m = gm[idx];
    sx += m * (wy0 * (m01 - m00) + c.fy * (m11 - m10));
    sy += m * (wx0 * (m10 - m00) + c.fx * (m11 - m01));
  }
  gx[idx] = sx;
  gy[idx] = sy;
}

// one channel's two terms of K22's sums, as nvcc contracted the first
// design's loop: fma(1 - fy, v01 - v00, fy (v11 - v10)) and
// fma(1 - fx, v10 - v00, fx (v11 - v01)), each other operation rounded once
__device__ __forceinline__ void coord_terms(float v00, float v01, float v10,
                                            float v11, float fx, float fy,
                                            float wx0, float wy0, float& dx,
                                            float& dy) {
  dx = __fmaf_rn(wy0, __fsub_rn(v01, v00), __fmul_rn(fy, __fsub_rn(v11, v10)));
  dy = __fmaf_rn(wx0, __fsub_rn(v10, v00), __fmul_rn(fx, __fsub_rn(v11, v01)));
}

// K22's redesign (coord_grad_layout plans it): a block of 256 threads
// takes 256 samples, each warp 32 of them on its own (no barrier across
// warps).  A warp's shared memory is its samples' slots (int4: the texel
// of corner (x0, y0), the four in-texture bits, fx, fy) and three planes
// of chunk x 33 floats (g_c, the x term, the y term of each staged
// (channel, sample), a sample stride of 33 words, so that neither the
// sweep's stores nor the chain's loads meet in a bank).
constexpr int kCoordThreads = kBlock;
constexpr int kCoordGroup = 32;                 // a warp's samples
constexpr int kCoordLd = kCoordGroup + 1;
constexpr int kCoordChunk = 16;                 // channels a pass
constexpr int kCoordMaxC = 1024;

struct CoordLayout {
  long long samples, blocks, threads, chunk, smem;
};

int coord_smem(int chunk) {
  return kCoordThreads * (int)sizeof(int4)
      + (kCoordThreads / kCoordGroup) * 3 * chunk * kCoordLd * 4;
}

// the layout of a launch over n samples of C channels of a (D, Ht, Wt, C)
// atlas, or false beyond its limits (1 <= C <= 1,024, n >= 0, at most
// 2^31 - 1 blocks, texel indices below 2^31).
// render/sample.py:dense_coord_grad_layout mirrors it.
bool coord_grad_layout(long long n, int C, long long D, long long Ht,
                       long long Wt, CoordLayout* lay) {
  if (C < 1 || C > kCoordMaxC || n < 0 || D * Ht * Wt + Wt >= INT_MAX)
    return false;
  lay->samples = kCoordThreads;
  lay->blocks = (n + kCoordThreads - 1) / kCoordThreads;
  lay->threads = kCoordThreads;
  lay->chunk = C < kCoordChunk ? C : kCoordChunk;
  lay->smem = coord_smem((int)lay->chunk);
  return lay->blocks <= 0x7fffffffLL;
}

// one texel channel widened to f32 through the read-only path
__device__ __forceinline__ float ld_texel(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_texel(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// kVec: each item's four channels as one vector a corner and one of the
// cotangent (C % 4 == 0, atlas and g aligned), two items a thread loaded
// together; else four scalar loads a corner, a sample's last item holding
// C % 4 channels, one item a thread
template <typename T, bool kVec>
__global__ void __launch_bounds__(kCoordThreads, 3) coord_grad_staged_kernel(
    const T* __restrict__ atlas, const T* __restrict__ mask,
    const float* __restrict__ g, const float* __restrict__ gm,
    const float* __restrict__ x, const float* __restrict__ y, int D,
    long long P, long long n, int Ht, int Wt, int C, int chunk,
    float* __restrict__ gx, float* __restrict__ gy) {
  constexpr int G = kCoordGroup, ld = kCoordLd, kV = 4;
  constexpr int kU = kVec ? 2 : 1;
  extern __shared__ int4 coord_smem_i4[];
  const int warp = threadIdx.x / G, t = threadIdx.x % G;
  int4* slot = coord_smem_i4 + warp * G;
  float* gs = reinterpret_cast<float*>(coord_smem_i4 + kCoordThreads)
      + warp * 3 * chunk * ld;
  float* xs = gs + chunk * ld;
  float* ys = xs + chunk * ld;
  const long long first = (long long)blockIdx.x * kCoordThreads + warp * G;
  if (first >= n) return;
  const int count = (int)min((long long)G, n - first);
  float mg = 0.0f, mdx = 0.0f, mdy = 0.0f;   // the mask channel's
  if (t < count) {
    const long long idx = first + t;
    const int d = (int)((idx / P) % D);
    const Corners c = corners_of(x[idx], y[idx], Ht, Wt);
    const int row0 = (d * Ht + c.y0) * Wt + c.x0;
    slot[t] = make_int4(row0, (int)c.in00 | (int)c.in01 << 1
                        | (int)c.in10 << 2 | (int)c.in11 << 3,
                        __float_as_int(c.fx), __float_as_int(c.fy));
    if (mask != nullptr) {
      const int row1 = row0 + Wt;
      const float m00 = c.in00 ? ld_texel(mask + row0) : 0.0f;
      const float m01 = c.in01 ? ld_texel(mask + row0 + 1) : 0.0f;
      const float m10 = c.in10 ? ld_texel(mask + row1) : 0.0f;
      const float m11 = c.in11 ? ld_texel(mask + row1 + 1) : 0.0f;
      coord_terms(m00, m01, m10, m11, c.fx, c.fy, __fsub_rn(1.0f, c.fx),
                  __fsub_rn(1.0f, c.fy), mdx, mdy);
      mg = gm[idx];
    }
  }
  const float* __restrict__ gb = g + first * C;
  const long long down = (long long)Wt * C;    // one texel row
  float sx = 0.0f, sy = 0.0f;
  for (int c0 = 0; c0 < C; c0 += chunk) {
    const int kc = min(chunk, C - c0);
    const int cv = (kc + kV - 1) / kV;         // items a sample
    const int total = count * cv;
    const int ds = G / cv, dq = G - ds * cv;
    int s = t / cv;
    int q = t - s * cv;
    __syncwarp();   // the slots written; the last chunk's chains read
    for (int o = t; o < total; o += kU * G) {
      VecF<kV> v[kU][4], gv[kU];
      float fx[kU], fy[kU];
      int su[kU], qu[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const bool live = o + u * G < total;
        const int4 sl = live ? slot[s] : make_int4(0, 0, 0, 0);
        const int k0 = c0 + q * kV;
        const T* a = atlas + ((long long)sl.x * C + k0);
        const float* gp = gb + ((long long)s * C + k0);
        if constexpr (kVec) {
#pragma unroll
          for (int j = 0; j < kV; ++j) {
            v[u][0].v[j] = v[u][1].v[j] = v[u][2].v[j] = v[u][3].v[j] = 0.0f;
            gv[u].v[j] = 0.0f;
          }
          if (sl.y & 1) v[u][0] = ld_vec<kV>(a);
          if (sl.y & 2) v[u][1] = ld_vec<kV>(a + C);
          if (sl.y & 4) v[u][2] = ld_vec<kV>(a + down);
          if (sl.y & 8) v[u][3] = ld_vec<kV>(a + down + C);
          if (live) gv[u] = ld_vec<kV>(gp);
        } else {
          const int nk = live ? min(kV, C - k0) : 0;
#pragma unroll
          for (int j = 0; j < kV; ++j) {
            const bool on = j < nk;
            v[u][0].v[j] = on && (sl.y & 1) ? ld_texel(a + j) : 0.0f;
            v[u][1].v[j] = on && (sl.y & 2) ? ld_texel(a + C + j) : 0.0f;
            v[u][2].v[j] = on && (sl.y & 4) ? ld_texel(a + down + j) : 0.0f;
            v[u][3].v[j] = on && (sl.y & 8) ? ld_texel(a + down + C + j)
                                            : 0.0f;
            gv[u].v[j] = on ? __ldg(gp + j) : 0.0f;
          }
        }
        fx[u] = __int_as_float(sl.z);
        fy[u] = __int_as_float(sl.w);
        su[u] = s;
        qu[u] = q;
        q += dq;
        s += ds;
        if (q >= cv) {
          q -= cv;
          ++s;
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (o + u * G >= total) break;
        const float wx0 = __fsub_rn(1.0f, fx[u]);
        const float wy0 = __fsub_rn(1.0f, fy[u]);
        // channels of this item (four on the vector route)
        const int nk = kVec ? kV : min(kV, kc - qu[u] * kV);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          if (j >= nk) break;
          float dx, dy;
          coord_terms(v[u][0].v[j], v[u][1].v[j], v[u][2].v[j],
                      v[u][3].v[j], fx[u], fy[u], wx0, wy0, dx, dy);
          const int e = (qu[u] * kV + j) * ld + su[u];
          gs[e] = gv[u].v[j];
          xs[e] = dx;
          ys[e] = dy;
        }
      }
    }
    __syncwarp();
    if (t < count) {
#pragma unroll 4
      for (int k = 0; k < kc; ++k) {
        const float gk = gs[k * ld + t];
        sx = __fmaf_rn(gk, xs[k * ld + t], sx);
        sy = __fmaf_rn(gk, ys[k * ld + t], sy);
      }
    }
  }
  if (t < count) {
    if (mask != nullptr) {
      sx = __fmaf_rn(mg, mdx, sx);
      sy = __fmaf_rn(mg, mdy, sy);
    }
    gx[first + t] = sx;
    gy[first + t] = sy;
  }
}

template <typename T, bool kVec>
int launch_coord_staged(const T* atlas, const T* mask, const float* g,
                        const float* gm, const float* x, const float* y,
                        int D, long long P, long long n, int Ht, int Wt,
                        int C, const CoordLayout& lay, float* gx, float* gy,
                        cudaStream_t s) {
  auto k = coord_grad_staged_kernel<T, kVec>;
  static bool opted = false;   // one opt-in per instantiation
  if (!opted) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         coord_smem(kCoordChunk));
    opted = true;
  }
  k<<<(unsigned)lay.blocks, (unsigned)lay.threads, (size_t)lay.smem, s>>>(
      atlas, mask, g, gm, x, y, D, P, n, Ht, Wt, C, (int)lay.chunk, gx, gy);
  return (int)cudaGetLastError();
}

}  // namespace

// atlas (D, Ht, Wt, C) f32 (16-byte aligned when C = 4; fewer than 2^31
// texels when C != 4), mask (D, Ht, Wt, 1) or null; writes out (n, C) and
// out_mask (n) when mask is given.
VL3D_API int vl3d_sample_dense(const float* atlas, const float* mask,
                               const float* x, const float* y, int B, int D,
                               long long P, int Ht, int Wt, int C, float* out,
                               float* out_mask, void* stream) {
  const long long n = (long long)B * D * P;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (C == 4) {
      sample_dense_kernel<<<grid_for(n), kBlock, 0, s>>>(
          reinterpret_cast<const float4*>(atlas), mask, x, y, D, P, n, Ht, Wt,
          reinterpret_cast<float4*>(out), out_mask);
    } else {
      if ((long long)D * Ht * Wt + Wt >= INT_MAX)
        return (int)cudaErrorInvalidValue;
      if (C % 4 == 0 && reinterpret_cast<uintptr_t>(atlas) % 16 == 0
          && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
        sample_dense_block_kernel<<<grid_for(n), kBlock, 0, s>>>(
            reinterpret_cast<const float4*>(atlas), mask, x, y, D, P, n, Ht,
            Wt, C / 4, reinterpret_cast<float4*>(out), out_mask);
      } else {
        sample_dense_block_kernel<<<grid_for(n), kBlock, 0, s>>>(
            atlas, mask, x, y, D, P, n, Ht, Wt, C, out, out_mask);
      }
    }
  }
  return (int)cudaGetLastError();
}

// K5's first design at any C (one thread per (sample, channel)): for
// chip_smoke.py's and the card tests' comparison only; no path of the
// port calls it.
VL3D_API int vl3d_sample_dense_per_channel(const float* atlas,
                                           const float* mask, const float* x,
                                           const float* y, int B, int D,
                                           long long P, int Ht, int Wt, int C,
                                           float* out, float* out_mask,
                                           void* stream) {
  const long long n = (long long)B * D * P;
  if (n > 0) {
    const long long m = n * (C + (mask != nullptr ? 1 : 0));
    sample_dense_c_kernel<<<grid_for(m), kBlock, 0, (cudaStream_t)stream>>>(
        atlas, mask, x, y, D, P, n, Ht, Wt, C, out, out_mask);
  }
  return (int)cudaGetLastError();
}

// g_atlas (16-byte aligned at C = 4) and g_mask must be zero-filled by
// the caller.
VL3D_API int vl3d_sample_dense_grad(const float* g, const float* gm,
                                    const float* x, const float* y, int B,
                                    int D, long long P, int Ht, int Wt, int C,
                                    float* g_atlas, float* g_mask,
                                    void* stream) {
  const long long n = (long long)B * D * P;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (C == 4) {
      sample_dense_grad_kernel<true><<<grid_for(n), kBlock, 0, s>>>(
          reinterpret_cast<const float4*>(g), gm, x, y, D, P, n, Ht, Wt,
          g_atlas, g_mask);
    } else {
      const long long m = n * (C + (gm != nullptr ? 1 : 0));
      sample_dense_grad_c_kernel<<<grid_for(m), kBlock, 0, s>>>(
          g, gm, x, y, D, P, n, Ht, Wt, C, g_atlas, g_mask);
    }
  }
  return (int)cudaGetLastError();
}

// K6's first design at C = 4 (four scalar atomics a corner): for
// chip_smoke.py's comparison only; no path of the port calls it.
VL3D_API int vl3d_sample_dense_grad_scalar(const float* g, const float* gm,
                                           const float* x, const float* y,
                                           int B, int D, long long P, int Ht,
                                           int Wt, float* g_atlas,
                                           float* g_mask, void* stream) {
  const long long n = (long long)B * D * P;
  if (n > 0)
    sample_dense_grad_kernel<false><<<grid_for(n), kBlock, 0,
                                      (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(g), gm, x, y, D, P, n, Ht, Wt,
        g_atlas, g_mask);
  return (int)cudaGetLastError();
}

// K6 at C = 4 with shared-memory accumulation in windows of `window`
// texels (sample_dense_grad_window_kernel): for chip_smoke.py's
// comparison only; no path of the port calls it.  The samples are B x D
// planes of h x w pixels; over (one int, zeroed by the caller) or null
// counts the tiles whose texel box exceeded the window.
VL3D_API int vl3d_sample_dense_grad_window(const float* g, const float* gm,
                                           const float* x, const float* y,
                                           int B, int D, int h, int w, int Ht,
                                           int Wt, int window, float* g_atlas,
                                           float* g_mask, int* over,
                                           void* stream) {
  if ((long long)B * D * h * w == 0) return 0;
  const int smem = window * 20;
  auto k = sample_dense_grad_window_kernel;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((unsigned)(((w + 31) / 32) * ((h + 7) / 8)),
                  (unsigned)(B * D));
  k<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(g), gm, x, y, D, h, w, Ht, Wt, window,
      g_atlas, g_mask, over);
  return (int)cudaGetLastError();
}

namespace {

int launch_coord_first(const void* atlas, const void* mask, int is_bf16,
                       const float* g, const float* gm, const float* x,
                       const float* y, int D, long long P, long long n,
                       int Ht, int Wt, int C, float* gx, float* gy,
                       cudaStream_t s) {
  if (n > 0) {
    if (is_bf16) {
      sample_dense_coord_grad_kernel<<<grid_for(n), kBlock, 0, s>>>(
          (const __nv_bfloat16*)atlas, (const __nv_bfloat16*)mask, g, gm, x,
          y, D, P, n, Ht, Wt, C, gx, gy);
    } else {
      sample_dense_coord_grad_kernel<<<grid_for(n), kBlock, 0, s>>>(
          (const float*)atlas, (const float*)mask, g, gm, x, y, D, P, n, Ht,
          Wt, C, gx, gy);
    }
  }
  return (int)cudaGetLastError();
}

int launch_coord_redesign(const void* atlas, const void* mask, int is_bf16,
                          const float* g, const float* gm, const float* x,
                          const float* y, int D, long long P, long long n,
                          int Ht, int Wt, int C, float* gx, float* gy,
                          cudaStream_t s) {
  CoordLayout lay;
  if (!coord_grad_layout(n, C, D, Ht, Wt, &lay))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const bool vec = C % 4 == 0
      && reinterpret_cast<uintptr_t>(atlas) % (is_bf16 ? 8 : 16) == 0
      && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (is_bf16) {
    const auto* a = (const __nv_bfloat16*)atlas;
    const auto* m = (const __nv_bfloat16*)mask;
    return vec ? launch_coord_staged<__nv_bfloat16, true>(
                     a, m, g, gm, x, y, D, P, n, Ht, Wt, C, lay, gx, gy, s)
               : launch_coord_staged<__nv_bfloat16, false>(
                     a, m, g, gm, x, y, D, P, n, Ht, Wt, C, lay, gx, gy, s);
  }
  const auto* a = (const float*)atlas;
  const auto* m = (const float*)mask;
  return vec ? launch_coord_staged<float, true>(a, m, g, gm, x, y, D, P, n,
                                                Ht, Wt, C, lay, gx, gy, s)
             : launch_coord_staged<float, false>(a, m, g, gm, x, y, D, P, n,
                                                 Ht, Wt, C, lay, gx, gy, s);
}

}  // namespace

// K22.  atlas (D, Ht, Wt, C) and mask (D, Ht, Wt, 1) or null, both f32 or
// both bf16 (is_bf16); g (n, C), gm (n) or null; writes gx, gy (n).  C = 4
// and bf16 texels at C % 4 != 0: the first design's kernel; otherwise
// coord_grad_staged_kernel (coord_grad_layout's limits).
VL3D_API int vl3d_sample_dense_coord_grad(const void* atlas, const void* mask,
                                          int is_bf16, const float* g,
                                          const float* gm, const float* x,
                                          const float* y, int B, int D,
                                          long long P, int Ht, int Wt, int C,
                                          float* gx, float* gy,
                                          void* stream) {
  const long long n = (long long)B * D * P;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 4 || (is_bf16 && C % 4 != 0)) {
    return launch_coord_first(atlas, mask, is_bf16, g, gm, x, y, D, P, n, Ht,
                              Wt, C, gx, gy, s);
  }
  return launch_coord_redesign(atlas, mask, is_bf16, g, gm, x, y, D, P, n,
                               Ht, Wt, C, gx, gy, s);
}

// K22's first design at any C, one thread a sample walking its channels
// (sample_dense_coord_grad_kernel): for chip_smoke.py's and the card
// tests' comparison only; arguments as vl3d_sample_dense_coord_grad's.
VL3D_API int vl3d_sample_dense_coord_grad_first(
    const void* atlas, const void* mask, int is_bf16, const float* g,
    const float* gm, const float* x, const float* y, int B, int D,
    long long P, int Ht, int Wt, int C, float* gx, float* gy, void* stream) {
  return launch_coord_first(atlas, mask, is_bf16, g, gm, x, y, D,
                            P, (long long)B * D * P, Ht, Wt, C, gx, gy,
                            (cudaStream_t)stream);
}

// K22's staged kernel at any C and texel type, the routes that keep the
// first design included (C = 4; bf16 at C % 4 != 0): for chip_smoke.py's
// and the card tests' comparison only; arguments as
// vl3d_sample_dense_coord_grad's.
VL3D_API int vl3d_sample_dense_coord_grad_staged(
    const void* atlas, const void* mask, int is_bf16, const float* g,
    const float* gm, const float* x, const float* y, int B, int D,
    long long P, int Ht, int Wt, int C, float* gx, float* gy, void* stream) {
  return launch_coord_redesign(atlas, mask, is_bf16, g, gm, x, y, D, P,
                               (long long)B * D * P, Ht, Wt, C, gx, gy,
                               (cudaStream_t)stream);
}

// K22's staged layout over n samples of a (D, Ht, Wt, C) atlas: out =
// {samples, blocks, threads, chunk, smem} (render/sample.py:
// dense_coord_grad_layout's keys, in order); cudaErrorInvalidValue beyond
// its limits.
VL3D_API int vl3d_sample_dense_coord_grad_layout(long long n, int C, int D,
                                                 int Ht, int Wt,
                                                 long long* out) {
  CoordLayout lay;
  if (!coord_grad_layout(n, C, D, Ht, Wt, &lay))
    return (int)cudaErrorInvalidValue;
  out[0] = lay.samples;
  out[1] = lay.blocks;
  out[2] = lay.threads;
  out[3] = lay.chunk;
  out[4] = lay.smem;
  return 0;
}
