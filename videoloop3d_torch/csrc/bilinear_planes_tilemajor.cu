// K16 bilinear_planes_tilemajor: bilinear sample of the dense,
// frame-stacked (D, Ht, Wt, F_all, C) plane atlas of a dense stage-2 model
// at per-plane texel coordinates, at a subset of frames, and
// K17 bilinear_planes_tilemajor_grad: its gradient over all frames.
//
// Replaces videoloop3d_tpu/render/sample.py:bilinear_planes_tilemajor
// (the whole render of a dense stage-2 model, models/mpv.py:382-393),
// together with the frame gather dyn[..., ts, :] of models/mpv.py:387 and
// the astype(gather_dtype) of the f32 atlas: the frame subset is read
// through the ts index array inside the kernel, and under --fp16 each f32
// texel is rounded to bf16 (to nearest even, as .to(torch.bfloat16)) in
// registers.  For each plane d and sample s with align-corners texel
// coordinates (x, y): x0 = floor(x), y0 = floor(y), fx = x - x0,
// fy = y - y0; each of the four corners (x0 + i, y0 + j) reads ZERO when
// it lies outside the plane (no clamping, unlike K2/K3); texels are
// widened to f32 and lerped in f32 with one rounding per operation, in the
// JAX package's order: top = v00 (1 - fx) + v01 fx, bot = v10 (1 - fx) +
// v11 fx, out = top (1 - fy) + bot fy.  x0 and y0 are clamped in float to
// [-2, size] before the int conversion (a far-off coordinate of an
// invalid sample would make the conversion undefined); both corners of a
// clamped coordinate lie outside.
//
// Offsets: a plane's elements are indexed in 32 bits (the wrappers refuse
// a plane of 2^31 elements or more), the plane's start in 64 bits: a dense
// stage-1 checkpoint broadcast to 50 frames at the shipped stage-1 width
// (32 x 576 x 1024 x 50 x 4) holds 3.77 G elements, past 2^31.
//
// K16.  Bound on the H100: bytes.  The training patch (D = 32, 180 x 320
// samples, all 50 frames) writes 32 x 57,600 x 50 x 4 f32 = 1.47 GB and
// reads 8 B of coordinates per sample plus the texels its samples touch
// (2 B each from a bf16 stack, 4 B from the f32 atlas in the rounding
// mode).  Design (planes_sweep_kernel): a block takes 256 samples, either
// consecutive ones or, given the samples' image width (img_w > 0: the
// wrapper passes it for (D, h, w) coordinates of 128 or more outputs a
// sample, the training patch), an 8 x 32 tile of the image, whose row
// neighbours read the same texel rows through one L1 (measured faster at
// 50 frames, slower at the eval chunk's 10).  One thread per sample finds
// its four corners once (in-plane texel indices, -1 outside, and the
// fractions) into shared memory; then the block's threads sweep its
// (sample, frame, 4 channels) outputs in output order, so that a warp's
// lanes read the neighbouring frames of one texel row and write one
// contiguous run: one 16-byte load a corner from f32 texels, one 8-byte
// load from bf16, one 16-byte streaming store.  Over all frames a texel's
// F x C row is contiguous in the stack and in the output, so the wrapper
// passes it as one frame of F C channels and the vectors run over it (4
// floats, or 2 where F C is only even: C = 13 at an even F); with a frame
// subset the vectors run over C (4, else 1).  A thread issues the loads
// of four items at once from f32 texels (one from bf16: more was measured
// slower there).  The first design, one thread per (sample, frame) with a
// 64-bit division, the corners recomputed for every frame and C scalar
// loads a corner, stays callable as vl3d_bilinear_planes_tilemajor_first
// (chip_smoke.py and the card tests only).
//
// K17 replaces the JAX package's autodiff of that gather (a scatter-add
// into the atlas).  Bound on the H100: bytes.  It reads the coordinates
// and the (D, N, F, C) f32 cotangent once and writes the (D, Ht, Wt, F, C)
// f32 gradient once, zeros included: 7.14 GB at the mpv_base width, most
// of the 2.58 ms bound.  Design: one deterministic gather that writes
// every texel exactly once and needs no zero fill, no atomics and no cast
// pass.
//   1. Bins (bin_key_kernel, then a stable LSD radix sort a plane:
//      bins.cuh's bin_hist_kernel, bin_scan_kernel, bin_scatter_kernel,
//      8-bit digits, as K27's first design): each sample with a corner on the
//      plane gets the key of the kBinH x kBinW texel tile of its top-left
//      corner (x0, y0), on a grid extended by one tile row and column for
//      x0 = -1 or y0 = -1, times 4 plus its class (0 inside the tile's
//      last row and column, 1 on the last column, 2 on both, 3 on the last
//      row); samples with no corner on the plane get the largest key and
//      are never read.  The scatter ranks a tile of 2,048 keys in rounds
//      of 256 in index order (__match_any_sync within a warp, per-warp
//      counts across warps), so the sort is stable: a bin lists its
//      samples by index, and two launches give the same bits.
//      bin_offsets_kernel finds each key's start by binary search.
//   2. The gather (planes_grad_gather_kernel): one block per (plane,
//      texel tile, slice of the F x C row) reads its own bin (all classes),
//      the left tile's classes 1-2 and the upper tile's 2-3, whose right
//      or lower corners fall into the tile, and the upper-left tile's class
//      2.  Its threads decode a batch of those samples (corners, in-tile
//      texel slots, the four weights) into shared memory, then each thread
//      owns its own columns of the slice (4, 2 or 1 floats, by what F x C
//      allows), loads them from each sample's cotangent row with one
//      vector load (800 B a sample at F = 50, C = 4) and adds
//      w_q * ct[s, f, c] into the tile's accumulators in shared memory: no
//      two threads add to one word, in a fixed order (the bins' order, the
//      corners q = 0..3), each product and sum rounded once.  Then the
//      block writes the tile's texels once, zeros included, as contiguous
//      runs of the slice, the f32 sum rounded to bf16 and widened back in
//      the rounding mode (the old chain K17, .to(bf16), .to(f32) on the
//      same sum); a tile that no sample reads writes zeros straight away.
// The layout (tile, slices, threads, shared memory and scratch) is
// render/sample.py:planes_grad_layout's; vl3d_planes_grad_layout returns
// this file's for the card tests and chip_smoke.py to compare.
// The first design, one thread per (sample, frame) with four scalar f32
// atomicAdds per corner into a zero-filled buffer (1.47 G atomics at the
// training patch), stays callable as
// vl3d_bilinear_planes_tilemajor_grad_first (chip_smoke.py and the card
// tests only).
#include "bins.cuh"
#include "vec.cuh"

namespace {

// ---------------------------------------------------------------------------
// the first designs
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// shared by the redesigns
// ---------------------------------------------------------------------------

// floor of the coordinate clamped in float to [-2, size], its fraction
__device__ __forceinline__ int corner0(float v, int size, float* frac) {
  const float v0 = floorf(v);
  *frac = __fsub_rn(v, v0);
  return (int)fminf(fmaxf(v0, -2.0f), (float)size);
}

// ---------------------------------------------------------------------------
// K16's redesign: corners once per sample, outputs swept in output order
// ---------------------------------------------------------------------------

constexpr int kSweepThreads = 256;     // samples a block
// with the samples' image width known: a block takes a tile of the image,
// whose row neighbours share texel rows in the block's L1
constexpr int kSweepRows = 8, kSweepCols = 32;
static_assert(kSweepRows * kSweepCols == kSweepThreads, "a tile a block");

// kRound: f32 texels rounded to bf16 before the lerps; kV channels a load
template <typename T, bool kRound, int kV>
__global__ void __launch_bounds__(kSweepThreads) planes_sweep_kernel(
    const T* __restrict__ tex, const float* __restrict__ x,
    const float* __restrict__ y, const int* __restrict__ ts, long long n,
    long long n_total, int img_w, int Ht, int Wt, int F_all, int F_sel,
    int C, float* __restrict__ out) {
  __shared__ long long s_idx[kSweepThreads];     // the sample
  __shared__ long long s_plane[kSweepThreads];   // its plane's first element
  __shared__ int s_r[4][kSweepThreads];          // in-plane texel, -1 outside
  __shared__ float s_fx[kSweepThreads], s_fy[kSweepThreads];
  int ns;
  long long s_first = 0;
  int tile_w = kSweepThreads, tile_row = 0;
  if (img_w > 0) {
    // a kSweepRows x kSweepCols tile of a plane's img_h x img_w samples
    const int img_h = (int)(n / img_w);
    const int nty = (img_h + kSweepRows - 1) / kSweepRows;
    const int ntx = (img_w + kSweepCols - 1) / kSweepCols;
    const long long d = blockIdx.x / (nty * ntx);
    const int t = (int)(blockIdx.x - d * nty * ntx);
    const int r0 = (t / ntx) * kSweepRows, c0 = (t % ntx) * kSweepCols;
    tile_w = min(kSweepCols, img_w - c0);
    ns = min(kSweepRows, img_h - r0) * tile_w;
    s_first = d * n + (long long)r0 * img_w + c0;
    tile_row = img_w;
  } else {
    s_first = (long long)blockIdx.x * kSweepThreads;
    ns = (int)min((long long)kSweepThreads, n_total - s_first);
  }
  const int row = F_all * C;                     // one texel, all frames
  if (threadIdx.x < ns) {
    const int ti = threadIdx.x / tile_w, tj = threadIdx.x - ti * tile_w;
    const long long s = s_first + (long long)ti * tile_row + tj;
    s_idx[threadIdx.x] = s;
    float fx, fy;
    const int x0 = corner0(x[s], Wt, &fx), y0 = corner0(y[s], Ht, &fy);
    const bool ix0 = x0 >= 0 && x0 < Wt, ix1 = x0 + 1 >= 0 && x0 + 1 < Wt;
    const bool iy0 = y0 >= 0 && y0 < Ht, iy1 = y0 + 1 >= 0 && y0 + 1 < Ht;
    const int r0 = y0 * Wt + x0;
    s_r[0][threadIdx.x] = (iy0 && ix0) ? r0 : -1;
    s_r[1][threadIdx.x] = (iy0 && ix1) ? r0 + 1 : -1;
    s_r[2][threadIdx.x] = (iy1 && ix0) ? r0 + Wt : -1;
    s_r[3][threadIdx.x] = (iy1 && ix1) ? r0 + Wt + 1 : -1;
    s_fx[threadIdx.x] = fx;
    s_fy[threadIdx.x] = fy;
    s_plane[threadIdx.x] = (s / n) * Ht * Wt * (long long)row;
  }
  __syncthreads();
  const int nv = C / kV;                         // vectors a frame
  const int per = F_sel * nv;                    // vectors a sample
  const int total = ns * per;
  // kU items a thread at a time, their loads issued together: four for
  // f32 texels (more bytes in flight), one for bf16 (more unrolling was
  // measured slower there)
  constexpr int kU = sizeof(T) == 4 ? 4 : 1;
  for (int i0 = threadIdx.x; i0 < total; i0 += kU * kSweepThreads) {
    VecF<kV> v[kU][4];
    int sls[kU], fs[kU], cvs[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kSweepThreads;
      if (i >= total) break;
      const int sl = i / per, rem = i - sl * per;
      const int f = nv == 1 ? rem : (F_sel == 1 ? 0 : rem / nv);
      const int cv = rem - f * nv;
      sls[u] = sl;
      fs[u] = f;
      cvs[u] = cv;
      const int fr = ts ? min(max(__ldg(ts + f), 0), F_all - 1) : f;
      const int off = fr * C + cv * kV;
      const T* tp = tex + s_plane[sl];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = s_r[q][sl];
        if (r >= 0) {
          v[u][q] = ld_vec<kV>(tp + (r * row + off));
        } else {
#pragma unroll
          for (int c = 0; c < kV; ++c) v[u][q].v[c] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (i0 + u * kSweepThreads >= total) break;
      const int sl = sls[u];
      const float fx = s_fx[sl], fy = s_fy[sl];
      VecF<kV> o;
#pragma unroll
      for (int c = 0; c < kV; ++c) {
        float w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = kRound ? round_bf16(v[u][q].v[c]) : v[u][q].v[c];
        const float top = lerp_rn(w[0], w[1], fx);
        const float bot = lerp_rn(w[2], w[3], fx);
        o.v[c] = lerp_rn(top, bot, fy);
      }
      st_vec_cs<kV>(out + (s_idx[sl] * F_sel + fs[u]) * C + cvs[u] * kV, o);
    }
  }
}

template <typename T, bool kRound>
int launch_sweep(const T* tex, const float* x, const float* y, const int* ts,
                 long long n, long long n_total, int img_w, int Ht, int Wt,
                 int F_all, int F_sel, int C, int vec, float* out,
                 cudaStream_t st) {
  long long blocks = (n_total + kSweepThreads - 1) / kSweepThreads;
  if (img_w > 0) {
    const long long img_h = n / img_w;
    blocks = n_total / n * ((img_h + kSweepRows - 1) / kSweepRows)
        * ((img_w + kSweepCols - 1) / kSweepCols);
  }
  const unsigned grid = (unsigned)blocks;
  if (vec == 4) {
    planes_sweep_kernel<T, kRound, 4><<<grid, kSweepThreads, 0, st>>>(
        tex, x, y, ts, n, n_total, img_w, Ht, Wt, F_all, F_sel, C, out);
  } else if (vec == 2) {
    planes_sweep_kernel<T, kRound, 2><<<grid, kSweepThreads, 0, st>>>(
        tex, x, y, ts, n, n_total, img_w, Ht, Wt, F_all, F_sel, C, out);
  } else {
    planes_sweep_kernel<T, kRound, 1><<<grid, kSweepThreads, 0, st>>>(
        tex, x, y, ts, n, n_total, img_w, Ht, Wt, F_all, F_sel, C, out);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K17's redesign: stable bins, then one gather a (plane, tile, slice)
// ---------------------------------------------------------------------------

constexpr int kBinH = 4, kBinW = 8;               // texels of a tile
constexpr int kBinT = kBinH * kBinW;
constexpr int kGatherMaxThreads = 128;            // columns of a slice
constexpr int kGatherUnroll = 8;    // cotangent rows a thread loads at once
constexpr int kSmemLimit = 232448;                // an H100 block's maximum

struct GradLayout {
  int nty, ntx;         // texel tiles of a plane
  int nby, nbx;         // bins of a plane (one more row and column)
  int nk1;              // keys a plane: the bins' 4 classes and the sentinel
  int passes;           // 8-bit digits of the largest key
  int ntiles;           // sort blocks a plane
  int ncols;            // vectors of an F x C row
  int nslices, slice_cols, threads, smem;
  long long scratch;    // bytes
};

// mirrored by render/sample.py:planes_grad_layout
GradLayout grad_layout(int D, long long n, int Ht, int Wt, int F, int C,
                       int vec) {
  GradLayout L;
  L.nty = (Ht + kBinH - 1) / kBinH;
  L.ntx = (Wt + kBinW - 1) / kBinW;
  L.nby = L.nty + 1;
  L.nbx = L.ntx + 1;
  const long long sentinel = (long long)L.nby * L.nbx * 4;
  L.nk1 = (int)(sentinel + 1);
  L.passes = sort_passes(sentinel);
  L.ntiles = (int)((n + kSortTile - 1) / kSortTile);
  L.ncols = F * C / vec;
  L.nslices = (L.ncols + kGatherMaxThreads - 1) / kGatherMaxThreads;
  L.slice_cols = L.nslices ? (L.ncols + L.nslices - 1) / L.nslices : 0;
  L.threads = (L.slice_cols + 31) / 32 * 32;
  L.smem = 4 * (kBinT * L.slice_cols * vec + 9 * L.threads);
  L.scratch = bins_scratch(D, n, L.ntiles, L.nk1);
  return L;
}

// keys[d n + i]: the bin key of sample i of plane d
__global__ void bin_key_kernel(const float* __restrict__ x,
                               const float* __restrict__ y, long long total,
                               int Ht, int Wt, int nbx, unsigned sentinel,
                               unsigned* __restrict__ keys) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float fx, fy;
  const int x0 = corner0(x[i], Wt, &fx), y0 = corner0(y[i], Ht, &fy);
  unsigned key = sentinel;
  if (x0 >= -1 && x0 < Wt && y0 >= -1 && y0 < Ht) {
    const int bx = (x0 + kBinW) / kBinW, by = (y0 + kBinH) / kBinH;
    const bool lc = (x0 + kBinW) % kBinW == kBinW - 1;
    const bool lr = (y0 + kBinH) % kBinH == kBinH - 1;
    const unsigned cls = lc ? (lr ? 2u : 1u) : (lr ? 3u : 0u);
    key = ((unsigned)by * nbx + bx) * 4u + cls;
  }
  keys[i] = key;
}

// one block a (plane, texel tile, slice of the F x C row); its dynamic
// shared memory: the accumulators [kBinT][slice_cols kV], then a batch of
// decoded samples: index, four in-tile texel slots (-1: not this tile's),
// four weights
template <int kV, bool kRound>
__global__ void __launch_bounds__(kGatherMaxThreads) planes_grad_gather_kernel(
    const float* __restrict__ ct, const float* __restrict__ x,
    const float* __restrict__ y, const int* __restrict__ perm,
    const int* __restrict__ off, long long n, int Ht, int Wt, int FC,
    int ntx, int nty, int nbx, int nk1, int slice_cols, int ncols,
    float* __restrict__ grad) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int nthr = blockDim.x;
  int* e_s = reinterpret_cast<int*>(acc + kBinT * slice_cols * kV);
  int* e_t = e_s + nthr;                       // [4][nthr]
  float* e_w = reinterpret_cast<float*>(e_t + 4 * nthr);   // [4][nthr]
  __shared__ int rng[8];                       // the four ranges [lo, hi)

  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const int tx = (int)(tile % ntx);
  const long long t2 = tile / ntx;
  const int ty = (int)(t2 % nty);
  const long long d = t2 / nty;
  const int c0 = blockIdx.y * slice_cols;      // the slice's first vector
  const int cols = min(slice_cols, ncols - c0);
  const int x_lo = tx * kBinW, y_lo = ty * kBinH;
  if (tid < 4) {
    // own bin (ty + 1, tx + 1): classes 0-3; left (ty + 1, tx): 1-2; up
    // (ty, tx + 1): 2-3; upper left (ty, tx): 2
    const int by = ty + (tid == 0 || tid == 1 ? 1 : 0);
    const int bx = tx + (tid == 0 || tid == 2 ? 1 : 0);
    const int clo = tid == 0 ? 0 : (tid == 1 ? 1 : 2);
    const int chi = tid == 0 ? 4 : (tid == 1 ? 3 : (tid == 2 ? 4 : 3));
    const int* o = off + d * nk1 + (by * nbx + bx) * 4;
    rng[2 * tid] = o[clo];
    rng[2 * tid + 1] = o[chi];
  }
  __syncthreads();
  int m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) m += rng[2 * q + 1] - rng[2 * q];
  const long long plane = d * n;
  if (m > 0) {
    for (int i = tid; i < kBinT * cols; i += nthr) {
      VecF<kV> z;
#pragma unroll
      for (int c = 0; c < kV; ++c) z.v[c] = 0.0f;
      const int t = i / cols, c = i - t * cols;
      st_vec<kV>(acc + (t * slice_cols + c) * kV, z);
    }
    for (int e0 = 0; e0 < m; e0 += nthr) {
      __syncthreads();                         // the last batch is added
      const int e = e0 + tid;
      if (e < m) {
        int q = 0, rem = e;
        while (rem >= rng[2 * q + 1] - rng[2 * q]) {
          rem -= rng[2 * q + 1] - rng[2 * q];
          ++q;
        }
        const int s = perm[plane + rng[2 * q] + rem];
        float fx, fy;
        const int x0 = corner0(x[plane + s], Wt, &fx);
        const int y0 = corner0(y[plane + s], Ht, &fy);
        const float wx0 = __fsub_rn(1.0f, fx), wy0 = __fsub_rn(1.0f, fy);
        const float ws[4] = {__fmul_rn(wy0, wx0), __fmul_rn(wy0, fx),
                             __fmul_rn(fy, wx0), __fmul_rn(fy, fx)};
        e_s[tid] = s;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
          const bool in = xi >= 0 && xi < Wt && yi >= 0 && yi < Ht
              && xi >= x_lo && xi < x_lo + kBinW && yi >= y_lo
              && yi < y_lo + kBinH;
          e_t[k * nthr + tid] = in ? (yi - y_lo) * kBinW + (xi - x_lo) : -1;
          e_w[k * nthr + tid] = ws[k];
        }
      }
      __syncthreads();
      const int nb = min(nthr, m - e0);
      if (tid < cols) {
        const float* cp = ct + plane * FC + (c0 + tid) * kV;
        float* ap = acc + tid * kV;
        for (int j = 0; j < nb; j += kGatherUnroll) {
          VecF<kV> v[kGatherUnroll];
#pragma unroll
          for (int u = 0; u < kGatherUnroll; ++u)
            if (j + u < nb) v[u] = ld_vec<kV>(cp + (long long)e_s[j + u] * FC);
#pragma unroll
          for (int u = 0; u < kGatherUnroll; ++u) {
            if (j + u >= nb) break;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int t = e_t[k * nthr + j + u];
              if (t < 0) continue;
              const float w = e_w[k * nthr + j + u];
              float* a = ap + t * slice_cols * kV;
              VecF<kV> s = ld_vec_plain<kV>(a);
#pragma unroll
              for (int c = 0; c < kV; ++c)
                s.v[c] = __fadd_rn(s.v[c], __fmul_rn(v[u].v[c], w));
              st_vec<kV>(a, s);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  // every texel of the tile written once, zeros included
  for (int i = tid; i < kBinT * cols; i += nthr) {
    const int t = i / cols, c = i - t * cols;
    const int xi = x_lo + t % kBinW, yi = y_lo + t / kBinW;
    if (xi >= Wt || yi >= Ht) continue;
    VecF<kV> v;
    if (m > 0) {
      v = ld_vec_plain<kV>(acc + (t * slice_cols + c) * kV);
      if constexpr (kRound) {
#pragma unroll
        for (int k = 0; k < kV; ++k) v.v[k] = round_bf16(v.v[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kV; ++k) v.v[k] = 0.0f;
    }
    st_vec_cs<kV>(grad + ((d * Ht + yi) * Wt + xi) * FC + (c0 + c) * kV, v);
  }
}

template <int kV, bool kRound>
int launch_gather(const GradLayout& L, const float* ct, const float* x,
                  const float* y, const int* perm, const int* off, int D,
                  long long n, int Ht, int Wt, int FC, float* grad,
                  cudaStream_t st) {
  auto k = planes_grad_gather_kernel<kV, kRound>;
  if (L.smem > 48 * 1024)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         L.smem);
  const dim3 grid((unsigned)((long long)D * L.nty * L.ntx), L.nslices);
  k<<<grid, L.threads, L.smem, st>>>(ct, x, y, perm, off, n, Ht, Wt, FC,
                                     L.ntx, L.nty, L.nbx, L.nk1,
                                     L.slice_cols, L.ncols, grad);
  return (int)cudaGetLastError();
}

}  // namespace

// K16 (the redesign).  tex: f32 (is_bf16 0) or bf16 texels; round_bf16:
// f32 texels rounded to bf16 before the lerps; vec: 4 or 2 where C is a
// multiple and the pointers allow the vector's access, else 1; img_w: the
// samples' image width for image tiles, else 0.
VL3D_API int vl3d_bilinear_planes_tilemajor(const void* tex, int is_bf16,
                                            int round_bf16, const float* x,
                                            const float* y, const int* ts,
                                            int D, long long n, int img_w,
                                            int Ht, int Wt, int F_all,
                                            int F_sel, int C, int vec,
                                            float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)D * n;
  if (total == 0 || F_sel == 0) return (int)cudaGetLastError();
  if (img_w > 0 && n % img_w != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_sweep<__nv_bfloat16, false>(
        (const __nv_bfloat16*)tex, x, y, ts, n, total, img_w, Ht, Wt, F_all,
        F_sel, C, vec, out, st);
  if (round_bf16)
    return launch_sweep<float, true>((const float*)tex, x, y, ts, n, total,
                                     img_w, Ht, Wt, F_all, F_sel, C, vec, out,
                                     st);
  return launch_sweep<float, false>((const float*)tex, x, y, ts, n, total,
                                    img_w, Ht, Wt, F_all, F_sel, C, vec, out,
                                    st);
}

// K17 (the redesign): the (D, Ht, Wt, F, C) f32 gradient, every texel
// written (no zero fill); round_bf16: each sum rounded to bf16 and stored
// widened.  vec: 4, 2 or 1 floats a column (F C divisible, pointers
// aligned).  scratch: planes_grad_layout's bytes.
VL3D_API int vl3d_bilinear_planes_tilemajor_grad(
    const float* ct, const float* x, const float* y, int D, long long n,
    int Ht, int Wt, int F, int C, int vec, int round_bf16, void* scratch,
    long long scratch_bytes, float* grad, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const GradLayout L = grad_layout(D, n, Ht, Wt, F, C, vec);
  if (scratch_bytes < L.scratch || L.smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if ((long long)D * L.nty * L.ntx == 0 || L.ncols == 0)
    return (int)cudaGetLastError();
  const long long total = (long long)D * n;
  const Bins bins = sort_bins(
      scratch, D, n, L.ntiles, L.nk1, L.passes,
      [&](unsigned* keys) {
        bin_key_kernel<<<grid_for(total), kBlock, 0, st>>>(
            x, y, total, Ht, Wt, L.nbx, (unsigned)(L.nk1 - 1), keys);
      },
      st);
  const int FC = F * C;
  const int* perm = bins.perm;
  const int* off = bins.off;
  if (vec == 4)
    return round_bf16 ? launch_gather<4, true>(L, ct, x, y, perm, off, D, n,
                                               Ht, Wt, FC, grad, st)
                      : launch_gather<4, false>(L, ct, x, y, perm, off, D, n,
                                                Ht, Wt, FC, grad, st);
  if (vec == 2)
    return round_bf16 ? launch_gather<2, true>(L, ct, x, y, perm, off, D, n,
                                               Ht, Wt, FC, grad, st)
                      : launch_gather<2, false>(L, ct, x, y, perm, off, D, n,
                                                Ht, Wt, FC, grad, st);
  return round_bf16 ? launch_gather<1, true>(L, ct, x, y, perm, off, D, n, Ht,
                                             Wt, FC, grad, st)
                    : launch_gather<1, false>(L, ct, x, y, perm, off, D, n,
                                              Ht, Wt, FC, grad, st);
}

// K17's layout as this file computes it, for the mirror checks:
// out[13] = nty, ntx, nby, nbx, nk1, passes, ntiles, ncols, nslices,
// slice_cols, threads, smem, scratch bytes
VL3D_API int vl3d_planes_grad_layout(int D, long long n, int Ht, int Wt,
                                     int F, int C, int vec, long long* out) {
  const GradLayout L = grad_layout(D, n, Ht, Wt, F, C, vec);
  const long long v[13] = {L.nty, L.ntx, L.nby, L.nbx, L.nk1, L.passes,
                           L.ntiles, L.ncols, L.nslices, L.slice_cols,
                           L.threads, L.smem, L.scratch};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return 0;
}

// the first designs (chip_smoke.py and the card tests only)
VL3D_API int vl3d_bilinear_planes_tilemajor_first(const void* tex,
                                                  int is_bf16, const float* x,
                                                  const float* y,
                                                  const int* ts, int D,
                                                  long long n, int Ht, int Wt,
                                                  int F_all, int F_sel, int C,
                                                  float* out, void* stream) {
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

// grad must be zero-filled by the caller.
VL3D_API int vl3d_bilinear_planes_tilemajor_grad_first(
    const float* ct, const float* x, const float* y, int D, long long n,
    int Ht, int Wt, int F, int C, float* grad, void* stream) {
  const long long m = (long long)D * n * F;
  if (m > 0) {
    bilinear_planes_tilemajor_grad_kernel<<<grid_for(m), kBlock, 0,
                                            (cudaStream_t)stream>>>(
        ct, x, y, D, n, Ht, Wt, F, C, grad);
  }
  return (int)cudaGetLastError();
}
