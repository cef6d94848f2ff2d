// K19 nn_band_err: the eval's NN error of one direction of K18's search.
//
// Replaces videoloop3d_tpu/eval/nnmse.py:_block_err_fn's sel_err
// (:132-145): for every crop, the sum over its spatial patch columns, the
// ns temporal patches i of the source, the frames k < pt of a patch and the
// (c, dy, dx) channels q of a per-frame patch of
//   |tar[c, nn(i)*st + k, h, w] - src[c, i*st + k, h, w]|
// with nn the source's nearest target patch from K18 (its row argmin for
// x -> y, its column argmin for y -> x; the wrapper swaps src and tar).
// eval/nnmse.py divides the sums by pt * columns * ns * d and averages the
// crops, as sel_err's means and np.mean do.
//
// Bound on the H100: bytes (each input read once: the two (3, 50, 280, 560)
// f32 clips of an eval pair, 188 MB, ~0.06 ms), though the pt-fold reuse of
// each frame and the gather of the selected patches read up to 2 pt times
// that through L1/L2.  What holds it is instructions and load latency: one
// gathered load and two f32 operations a term, 0.56-1.0 G terms a call.
//
// Design (nn_band_err_unit_kernel, its layout in band_err_layout, mirrored
// by losses/patch_nn.py:nn_band_err_layout): one block per (crop, tile of
// tw neighbouring columns of one row), tw the largest power of two up to
// 8 with tw d <= kErrTileUnits (8 / 4 / 1 at the eval's p5 / p11 / p17):
// the columns of a tile overlap, so their reads share the block's L1 or
// its staged footprint.  Its work is cut into units (j, q, g): column j of
// the tile, channel q and the g-th range of `span` consecutive source
// patches (about kErrUnits units a block; threads a multiple of 32 up to
// kErrMaxThreads take units tid, tid + threads, ...).  Each unit computes
// its channel's source and target offsets once and walks (i, k) with no
// integer division.  At st = 1 and pt = 3, 5 or 7 (every eval scale) the
// source frames of patch i are i .. i + pt - 1, so a register window of pt
// values slides one frame a patch: one source load a patch instead of pt,
// and whole groups of pt patches with no branch between their loads.  The
// pt target loads of patch i (frames sel[i]*st + k) are issued together,
// from device memory (L1) or, where the tile's whole target footprint (tt
// frames x C ph fw, f32) fits kErrStageMax bytes, from that footprint
// staged once in shared memory (kStageBatch loads a thread in flight).
// bf16 inputs are widened to f32 at the load.  The PT = 3 instances are
// bounded to three 512-thread blocks an SM (at most 42 registers, a few
// bytes spilled): at p17 that ran faster than two blocks at 64 registers.
//
// Sums, in f32 and a fixed order, no atomics: each unit's chain over (i, k)
// in order (span * pt terms: 308 / 230 / 144 at the eval scales, against
// the first design's longest, 91 / 327 / 488), a thread's units added in
// turn, a fixed shuffle tree within each warp, the warps' sums in order
// (one partial a block), then crop_sums_kernel over a crop's blocks as in
// the first design.  Deterministic, but not bit-equal to the first design,
// whose chains stride the flat index by 256.
//
// First design (nn_band_err_kernel, vl3d_nn_band_err_first): one 256-thread
// block per (crop, column), each thread a strided share of the flat
// (i, k, q) index, three integer divisions and two dependent gathers a
// term, a 256-wide shared-memory tree.
#include "nn_crops.cuh"

namespace {

constexpr int kThreads = 256;          // first design; crop_sums_kernel
constexpr int kErrUnits = 256;         // units aimed at per block
constexpr int kErrTileUnits = 1536;    // tw d at most this
constexpr int kErrMaxThreads = 512;
constexpr int kErrStageMax = 64 * 1024;  // staged target window, bytes
constexpr int kErrSmemLimit = 227 * 1024;
constexpr int kStageBatch = 8;           // staged loads in flight a thread

// patch_nn.py:nn_band_err_layout mirrors this
struct BandErrLayout {
  int threads, groups, span, units, per_thread, chain, window, tw, tiles,
      fw, stage, smem;
};

// C channels of (ph, pw) per-frame patches, nw columns a row at stride sw,
// ns source patches of pt frames at stride st, tt target frames; tw
// columns a block (-1: the largest power of two up to 8 with tw d at most
// kErrTileUnits) and stage (-1: where the staged footprint takes at most
// kErrStageMax bytes; 0 never; 1 where it fits)
__host__ __device__ inline BandErrLayout band_err_layout(
    int C, int ph, int pw, int sw, int nw, int ns, int pt, int st, int tt,
    int tw, int stage) {
  BandErrLayout L;
  const int d = C * ph * pw;
  const int n = ns > 0 ? ns : 1;
  if (tw <= 0) {
    // the largest power of two up to 8 with tw d <= kErrTileUnits
    for (tw = 8; tw > 1 && tw * d > kErrTileUnits; tw >>= 1) {
    }
  }
  L.tw = tw < nw ? tw : (nw > 0 ? nw : 1);
  L.tiles = (nw + L.tw - 1) / L.tw;
  L.fw = (L.tw - 1) * sw + pw;
  int g = kErrUnits / (L.tw * d);
  g = g < 1 ? 1 : (g > n ? n : g);
  L.span = (n + g - 1) / g;
  L.groups = (n + L.span - 1) / L.span;
  L.units = L.groups * L.tw * d;
  L.per_thread = (L.units + kErrMaxThreads - 1) / kErrMaxThreads;
  L.threads = ((L.units + L.per_thread - 1) / L.per_thread + 31) / 32 * 32;
  L.chain = L.span * pt;
  L.window = (st == 1 && (pt == 3 || pt == 5 || pt == 7)) ? pt : 0;
  // the footprint's target offsets, the selected patches, the warp sums
  const int nf = C * ph * L.fw;
  const int base = 4 * (nf + L.tw * n + 32);
  const long long stg = 4LL * tt * nf;
  L.stage = stage < 0 ? (stg <= kErrStageMax)
                      : (stage > 0 && base + stg <= kErrSmemLimit);
  L.smem = base + (L.stage ? (int)stg : 0);
  return L;
}

// offs / offt[q]: the offset of channel q = (c * ph + dy) * pw + dx of a
// per-frame (1, ph, pw) patch in src (C, Ts, H, W) / tar (C, Tt, H, W)
__device__ __forceinline__ void frame_offsets(int* offs, int* offt, int C,
                                              int ph, int pw, int Ts, int Tt,
                                              int H, int W) {
  const int hw = H * W;
  for (int q = threadIdx.x; q < C * ph * pw; q += kThreads) {
    const int in_plane = ((q / pw) % ph) * W + q % pw;
    const int c = q / (pw * ph);
    offs[q] = c * Ts * hw + in_plane;
    offt[q] = c * Tt * hw + in_plane;
  }
}

// the fixed-order tree sum of v over the block's kThreads threads
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  return red[0];
}

template <typename T>
__global__ void nn_band_err_kernel(const T* __restrict__ src,
                                   const T* __restrict__ tar, int C, int Ts,
                                   int Tt, int H, int W, NnCrops cr,
                                   NnStarts so, int ns,
                                   const int* __restrict__ nn,
                                   float* __restrict__ partial) {
  extern __shared__ int sm[];
  const int d = C * cr.ph * cr.pw;
  int* offs = sm;                                     // [d]
  int* offt = offs + d;                               // [d]
  int* sel = offt + d;                                // [ns]
  float* red = reinterpret_cast<float*>(sel + ns);    // [kThreads]
  const int ncols = cr.nh * cr.nw;
  const int crop = blockIdx.x / ncols, col = blockIdx.x % ncols;
  const long long hw = (long long)H * W;
  const long long pix =
      (long long)(so.h0[crop / cr.n_w] + (col / cr.nw) * cr.sh) * W
      + (so.w0[crop % cr.n_w] + (col % cr.nw) * cr.sw);
  frame_offsets(offs, offt, C, cr.ph, cr.pw, Ts, Tt, H, W);
  for (int i = threadIdx.x; i < ns; i += kThreads)
    sel[i] = nn[(long long)blockIdx.x * ns + i];
  __syncthreads();
  const int pt = cr.pt, st = cr.st;
  const int n = ns * pt * d;
  float acc = 0.0f;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int q = e % d;
    const int k = (e / d) % pt;
    const int i = e / (d * pt);
    const float a = to_f32(src[(i * st + k) * hw + pix + offs[q]]);
    const float b = to_f32(tar[(sel[i] * st + k) * hw + pix + offt[q]]);
    acc = __fadd_rn(acc, fabsf(__fsub_rn(b, a)));
  }
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void crop_sums_kernel(const float* __restrict__ partial,
                                 int ncols, float* __restrict__ out) {
  __shared__ float red[kThreads];
  float acc = 0.0f;
  for (int c = threadIdx.x; c < ncols; c += kThreads)
    acc = __fadd_rn(acc, partial[(long long)blockIdx.x * ncols + c]);
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// |b - a| added to acc, rounded once an operation
__device__ __forceinline__ float add_err(float acc, float b, float a) {
  return __fadd_rn(acc, fabsf(__fsub_rn(b, a)));
}

// Patch ii (the r-th of its group of PT) of a unit_window: frame ii + PT - 1
// into the window, the PT target frames tb .. tb + PT - 1 loaded together,
// the PT terms in k order.
template <typename T, int PT, bool STAGE>
__device__ __forceinline__ float window_patch(float acc, float (&win)[PT],
                                              int r, const T* sp,
                                              const T* tp, const float* stq,
                                              int fs, long long hw, int ii,
                                              int tb) {
  win[(r + PT - 1) % PT] = to_f32(sp[(ii + PT - 1) * hw]);
  float tv[PT];
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    if constexpr (STAGE)
      tv[k] = stq[(tb + k) * fs];
    else
      tv[k] = to_f32(tp[(tb + k) * hw]);
  }
#pragma unroll
  for (int k = 0; k < PT; ++k) acc = add_err(acc, tv[k], win[(r + k) % PT]);
  return acc;
}

// One unit at st = 1, PT = pt: patches i0 .. i1 - 1 of one channel.  sp /
// tp point at the channel's sample of frame 0 in src / tar; stq at the
// channel's column of the staged target window (STAGE).  Frame i + k of
// patch i sits in win[(i - i0 + k) % PT]: unrolled by PT, each slot index
// is a constant.
template <typename T, int PT, bool STAGE>
__device__ __forceinline__ float unit_window(const T* sp, const T* tp,
                                             const float* stq, int fs,
                                             long long hw,
                                             const int* __restrict__ sel,
                                             int i0, int i1) {
  float win[PT];
#pragma unroll
  for (int k = 0; k < PT - 1; ++k) win[k] = to_f32(sp[(i0 + k) * hw]);
  float acc = 0.0f;
  // whole groups of PT patches: no branch between their loads
  int i = i0;
  for (; i + PT <= i1; i += PT) {
#pragma unroll
    for (int r = 0; r < PT; ++r)
      acc = window_patch<T, PT, STAGE>(acc, win, r, sp, tp, stq, fs, hw,
                                       i + r, sel[i + r]);
  }
#pragma unroll
  for (int r = 0; r < PT - 1; ++r) {
    if (i + r >= i1) break;
    acc = window_patch<T, PT, STAGE>(acc, win, r, sp, tp, stq, fs, hw, i + r,
                                     sel[i + r]);
  }
  return acc;
}

// One unit at any pt and st: two loads a term, no division.
template <typename T, bool STAGE>
__device__ __forceinline__ float unit_generic(const T* sp, const T* tp,
                                              const float* stq, int fs,
                                              long long hw,
                                              const int* __restrict__ sel,
                                              int i0, int i1, int pt,
                                              int st) {
  float acc = 0.0f;
  for (int i = i0; i < i1; ++i) {
    const T* s = sp + (long long)(i * st) * hw;
    const int tb = sel[i] * st;
    for (int k = 0; k < pt; ++k) {
      const float a = to_f32(s[k * hw]);
      float b;
      if constexpr (STAGE)
        b = stq[(tb + k) * fs];
      else
        b = to_f32(tp[(tb + k) * hw]);
      acc = add_err(acc, b, a);
    }
  }
  return acc;
}

// The redesign (see the file's header).  PT: pt where the sliding window
// applies (L.window), else 0.
template <typename T, int PT, bool STAGE>
__global__ void __launch_bounds__(kErrMaxThreads, PT == 3 ? 3 : 2)
nn_band_err_unit_kernel(
    const T* __restrict__ src, const T* __restrict__ tar, int C, int Ts,
    int Tt, int H, int W, NnCrops cr, NnStarts so, int ns, int tt,
    const int* __restrict__ nn, BandErrLayout L,
    float* __restrict__ partial) {
  extern __shared__ float smf[];
  const int ph = cr.ph, pw = cr.pw, d = C * ph * pw;
  const int fw = L.fw, nf = C * ph * fw, n = ns > 0 ? ns : 1;
  int* offt = reinterpret_cast<int*>(smf);            // [nf]
  int* sel = offt + nf;                               // [tw][max(ns, 1)]
  float* wsum = reinterpret_cast<float*>(sel + L.tw * n);  // [32]
  float* stg = wsum + 32;                             // [tt][nf] (STAGE)
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int per_crop = cr.nh * L.tiles;
  const int crop = blockIdx.x / per_crop, rem = blockIdx.x % per_crop;
  const int row = rem / L.tiles, col0 = (rem % L.tiles) * L.tw;
  const int ncol = min(L.tw, cr.nw - col0);   // the tile's columns
  const long long hw = (long long)H * W;
  const long long pix =
      (long long)(so.h0[crop / cr.n_w] + row * cr.sh) * W
      + (so.w0[crop % cr.n_w] + col0 * cr.sw);
  const long long nn0 = ((long long)crop * cr.nh * cr.nw + row * cr.nw
                         + col0) * ns;
  for (int e = tid; e < ncol * ns; e += nthr)
    sel[(e / ns) * n + e % ns] = nn[nn0 + e];
  if constexpr (STAGE) {
    // footprint element e = (c * ph + dy) * fw + x, its x clamped to the
    // tile's columns (a partial tile's footprint is narrower)
    const int fw_in = (ncol - 1) * cr.sw + pw;
    for (int e = tid; e < nf; e += nthr) {
      const int r = e / fw, x = min(e % fw, fw_in - 1);
      offt[e] = (r / ph) * Tt * (int)hw + (r % ph) * W + x;
    }
  }
  __syncthreads();
  if constexpr (STAGE) {
    // stg[f * nf + e] = tar[f, footprint element e]: the flat (f, e) index
    // stepped by the block's threads without a division an element
    const int fstep = nthr / nf, estep = nthr % nf;
    int e = tid % nf, f = tid / nf;
    const T* tb = tar + pix;
    while (f < tt) {
      // kStageBatch elements a thread in flight; past the window the
      // address is clamped to its last frame and nothing is stored
      int fs[kStageBatch], es[kStageBatch];
      float v[kStageBatch];
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b) {
        fs[b] = f;
        es[b] = e;
        e += estep;
        f += fstep;
        if (e >= nf) {
          e -= nf;
          ++f;
        }
      }
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b)
        v[b] = to_f32(tb[min(fs[b], tt - 1) * hw + offt[es[b]]]);
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b)
        if (fs[b] < tt) stg[fs[b] * nf + es[b]] = v[b];
    }
    __syncthreads();
  }
  float acc = 0.0f;
  for (int u = tid; u < L.units; u += nthr) {
    // unit u: channel q, column j of the tile, patch range g
    const int q = u % d, r = u / d;
    const int j = r % L.tw, g = r / L.tw;
    const int i0 = g * L.span;
    const int i1 = min(ns, i0 + L.span);
    if (j >= ncol || i0 >= i1) continue;
    const int row_q = q / pw;   // c * ph + dy
    const int c = row_q / ph, dy = row_q % ph, x = j * cr.sw + q % pw;
    const long long in_plane = (long long)dy * W + x;
    const T* sp = src + pix + (long long)c * Ts * hw + in_plane;
    const T* tp = tar + pix + (long long)c * Tt * hw + in_plane;
    const float* stq = stg + row_q * fw + x;
    float ua;
    if constexpr (PT > 0)
      ua = unit_window<T, PT, STAGE>(sp, tp, stq, nf, hw, sel + j * n, i0,
                                     i1);
    else
      ua = unit_generic<T, STAGE>(sp, tp, stq, nf, hw, sel + j * n, i0, i1,
                                  cr.pt, cr.st);
    acc = __fadd_rn(acc, ua);
  }
  // a fixed tree within each warp, then the warps' sums in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o));
  if ((tid & 31) == 0) wsum[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = wsum[0];
    for (int w = 1; w < (nthr >> 5); ++w) s = __fadd_rn(s, wsum[w]);
    partial[blockIdx.x] = s;
  }
}

template <typename T, int PT, bool STAGE>
cudaError_t launch_unit(const void* src, const void* tar, int C, int Ts,
                        int Tt, int H, int W, const NnCrops& cr,
                        const NnStarts& so, int ns, int tt, const int* nn,
                        const BandErrLayout& L, unsigned int blocks,
                        float* partial, cudaStream_t s) {
  auto k = nn_band_err_unit_kernel<T, PT, STAGE>;
  if (L.smem > 48 * 1024)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         L.smem);
  k<<<blocks, L.threads, L.smem, s>>>((const T*)src, (const T*)tar, C, Ts,
                                      Tt, H, W, cr, so, ns, tt, nn, L,
                                      partial);
  return cudaGetLastError();
}

template <typename T, bool STAGE>
cudaError_t launch_pt(const void* src, const void* tar, int C, int Ts,
                      int Tt, int H, int W, const NnCrops& cr,
                      const NnStarts& so, int ns, int tt, const int* nn,
                      const BandErrLayout& L, unsigned int blocks,
                      float* partial, cudaStream_t s) {
  switch (L.window) {
    case 3:
      return launch_unit<T, 3, STAGE>(src, tar, C, Ts, Tt, H, W, cr, so, ns,
                                      tt, nn, L, blocks, partial, s);
    case 5:
      return launch_unit<T, 5, STAGE>(src, tar, C, Ts, Tt, H, W, cr, so, ns,
                                      tt, nn, L, blocks, partial, s);
    case 7:
      return launch_unit<T, 7, STAGE>(src, tar, C, Ts, Tt, H, W, cr, so, ns,
                                      tt, nn, L, blocks, partial, s);
    default:
      return launch_unit<T, 0, STAGE>(src, tar, C, Ts, Tt, H, W, cr, so, ns,
                                      tt, nn, L, blocks, partial, s);
  }
}

}  // namespace

// K19's layout for patch dim d, ns source patches of pt frames at stride
// st and tt target frames (stage: -1 the layout's choice, 0 read the
// target from device memory, 1 stage it where it fits): threads, groups,
// span, units, units a thread, longest chain, window, staged, dynamic
// shared bytes (for the card's checks against
// losses/patch_nn.py:nn_band_err_layout)
VL3D_API int vl3d_nn_band_err_layout(int C, int ph, int pw, int sw, int nw,
                                     int ns, int pt, int st, int tt, int tw,
                                     int stage, long long* out) {
  const BandErrLayout L =
      band_err_layout(C, ph, pw, sw, nw, ns, pt, st, tt, tw, stage);
  const int v[12] = {L.threads, L.groups, L.span, L.units, L.per_thread,
                     L.chain, L.window, L.tw, L.tiles, L.fw, L.stage,
                     L.smem};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

// src (C, Ts, H, W), tar (C, Tt, H, W); ns source and nt target patches;
// partial: (crops * columns) f32 scratch; out: (crops,) f32; tw and stage
// as for vl3d_nn_band_err_layout
VL3D_API int vl3d_nn_band_err(const void* src, const void* tar, int is_bf16,
                              int C, int Ts, int Tt, int H, int W,
                              const int* plan, int ns, int nt, int tw,
                              int stage, const int* nn, float* partial,
                              float* out, void* stream) {
  NnCrops cr;
  NnStarts so;
  if (!unpack_crops(plan, &cr, &so)) return (int)cudaErrorInvalidValue;
  const int crops = cr.n_h * cr.n_w;
  const int ncols = cr.nh * cr.nw;
  if (crops <= 0 || ncols <= 0) return 0;
  const int tt = (nt - 1) * cr.st + cr.pt;
  const BandErrLayout L = band_err_layout(C, cr.ph, cr.pw, cr.sw, cr.nw, ns,
                                          cr.pt, cr.st, tt, tw, stage);
  if (L.smem > kErrSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int per_crop = cr.nh * L.tiles;
  const unsigned int blocks = (unsigned int)crops * per_crop;
  cudaError_t err;
  if (is_bf16)
    err = L.stage ? launch_pt<__nv_bfloat16, true>(
                        src, tar, C, Ts, Tt, H, W, cr, so, ns, tt, nn, L,
                        blocks, partial, s)
                  : launch_pt<__nv_bfloat16, false>(
                        src, tar, C, Ts, Tt, H, W, cr, so, ns, tt, nn, L,
                        blocks, partial, s);
  else
    err = L.stage ? launch_pt<float, true>(src, tar, C, Ts, Tt, H, W, cr, so,
                                           ns, tt, nn, L, blocks, partial, s)
                  : launch_pt<float, false>(src, tar, C, Ts, Tt, H, W, cr,
                                            so, ns, tt, nn, L, blocks,
                                            partial, s);
  if (err != cudaSuccess) return (int)err;
  crop_sums_kernel<<<crops, kThreads, 0, s>>>(partial, per_crop, out);
  return (int)cudaGetLastError();
}

// The first design (see the file's header), for chip_smoke.py and the
// card tests: first_designs.py:nn_band_err_first
VL3D_API int vl3d_nn_band_err_first(const void* src, const void* tar,
                                    int is_bf16, int C, int Ts, int Tt, int H,
                                    int W, const int* plan, int ns,
                                    const int* nn, float* partial, float* out,
                                    void* stream) {
  NnCrops cr;
  NnStarts so;
  if (!unpack_crops(plan, &cr, &so)) return (int)cudaErrorInvalidValue;
  const int crops = cr.n_h * cr.n_w;
  const int ncols = cr.nh * cr.nw;
  if (crops <= 0 || ncols <= 0) return 0;
  const int d = C * cr.ph * cr.pw;
  const int smem = (int)sizeof(int) * (2 * d + ns + kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int blocks = (unsigned int)crops * ncols;
  if (is_bf16) {
    nn_band_err_kernel<<<blocks, kThreads, smem, s>>>(
        (const __nv_bfloat16*)src, (const __nv_bfloat16*)tar, C, Ts, Tt, H,
        W, cr, so, ns, nn, partial);
  } else {
    nn_band_err_kernel<<<blocks, kThreads, smem, s>>>(
        (const float*)src, (const float*)tar, C, Ts, Tt, H, W, cr, so, ns,
        nn, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  crop_sums_kernel<<<crops, kThreads, 0, s>>>(partial, ncols, out);
  return (int)cudaGetLastError();
}
