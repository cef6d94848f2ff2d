// K3 bilinear_tiles_tilemajor: bilinear sample of tile-major,
// frame-stacked (N, th, tw, F_all, C) tiles at a subset of frames, and
// K10 bilinear_tiles_tilemajor_grad: its gradient over all frames.
//
// Replaces videoloop3d_tpu/render/sample.py:bilinear_tiles_tilemajor
// (the forward of render/adjoint.py:make_tile_adjoint on 5-D tiles),
// together with the frame gather dyn[..., ts, :] of models/mpv.py:287 and
// the astype(gather_dtype) of mpv.py:285: the frame subset is read through
// the ts index array inside the kernel, so no (N, th, tw, F_sel, C) copy
// of the atlas is made per call, and under --fp16 the f32 atlas is read
// and each texel rounded to bf16 (to nearest even, as .to(torch.bfloat16))
// in registers, so no bf16 copy of the atlas is made either: the samples
// are bit for bit those of the copy.
// Semantics are K2's per frame: k < 0 -> zeros, u, v clamped to the
// tile, u1 = min(u0+1, tw-1) and v1 = min(v0+1, th-1) (JAX reads a
// foreign texel with weight 0 where this clamps), bf16 or f32 texels
// widened and lerped in f32, f32 output of shape (..., F_sel, C).
//
// Bound on the H100: bytes.  This is the slice's largest writer: one
// fixed-view chunk of 10 frames at production size writes
// 32 x 360 x 640 x 10 x 4 f32 = 1.18 GB, against 12 B of k, u, v per
// sample and the referenced texels of the selected frames.
// Design at the direct decoder's C = 4 (bilinear_tiles_tilemajor_kernel):
// one thread per (sample, frame) writing its C channels; frames are
// fastest, so a warp writes one contiguous run of output and reads the
// F_sel frames of one texel, which lie next to each other.
// At C != 4 (the SH and NeX decoders: 13, 36 channels) that design stores
// C scalars a thread C floats apart across a warp (a store instruction
// touches about 52 sectors at C = 13) and reached 11 % of the card's
// memory rate, so there K3 is bilinear_tiles_tilemajor_sweep_kernel, K2's
// sweep (csrc/bilinear_tiles.cu) over the F_sel x C outputs a sample: a
// block takes a run of samples (tiles_tilemajor_layout: about 32 K outputs
// a block, a multiple of 4 samples), finds each one's corners once (the
// four corner texels' element offsets at frame 0 and fu, fv; a miss
// flagged) and stages the frame offsets ts[f] C (f C without ts) in shared
// memory, then its threads sweep the run's count x F_sel x C outputs in
// output order, four consecutive outputs a thread and one float4 store
// (four scalars where out is not 16-byte aligned), the (sample, frame,
// channel) stepped with a carry, not divided out (the staged sample and
// frame offset read at a group's first output and again only where the
// carry changes them).  Every output is the
// same three lerp_rn of the same four texels (each rounded to bf16 first
// in the rounding mode) as in the first design, which stays callable as
// vl3d_bilinear_tiles_tilemajor_first (bilinear_tiles_tilemajor_kernel at
// any C; chip_smoke.py and the card tests only).  Loading a group's four
// texels of a corner as one vector where they lie next to each other was
// measured no faster (PERF.md, PR 24) and is not used.  Texel offsets are
// 32-bit (the launcher refuses tiles of 2^31 elements or more at C != 4),
// the block's output offset 64-bit (an rgba_sh eval chunk is 2.65e9
// floats).
//
// K10 replaces videoloop3d_tpu/render/adjoint.py:_packed_tile_grad on
// 5-D tiles (the backward of make_tile_adjoint, adjoint.py:663, as the
// stage-2 training render uses it for the dynamic atlas), with its
// .astype(tiles_dtype) (adjoint.py:660).  Per sample with k >= 0, u, v
// clamped as in K3: grad[min(k, N-1), v_i, u_i, f, c] += ct[f, c] w_corner.
// Samples with k < 0 read nothing beyond k (their u and v may be
// non-finite).  Bound on the H100: bytes.  It reads k for every sample,
// u, v and the F x C cotangent of the hits, and writes the (N, th, tw, F,
// C) f32 gradient once, zeros included: 490 MB at the stage-2 patch, most
// of its bound.
// Design: one deterministic gather that writes every texel exactly once
// (no zero fill before the adds: the tiles no sample reads get their
// zeros alone), with no atomics and no cast pass.
//   1. Bins (tiles_key_kernel, then bins.cuh's stable radix sort, one
//      "plane" a leading index of the samples: the slots or planes of the
//      (S, h, w) sweep): each sample with k >= 0 gets the key of its tile
//      min(k, N - 1); the others the sentinel N, never read.  Concatenated
//      in plane order, a tile's per-plane ranges list its samples in index
//      order.
//   2. The gather (tiles_grad_gather_kernel): one block per (tile, slice of
//      the F x C row).  Its threads decode a batch of kBatch of the bin's
//      samples (the sample, the four in-tile texels, the four weights, u
//      and v clamped as in K3) into shared memory and copy the batch's
//      cotangent rows of the slice in beside them (cp.async, all in flight
//      at once); then each thread owns one column of the slice (4, 2 or 1
//      floats, as F x C allows) for the texels of one of four parity groups
//      (texel row and column parity: a sample's corners fall one into each
//      group, all into one texel's group where u or v is clamped at the
//      tile's far edge) and adds w_q * ct[s, f, c] into the tile's
//      accumulators in shared memory:
//      no two threads add to one word, in a fixed order (bin order, then
//      q = 0..3), each product and sum rounded once.  Then the block writes
//      the tile's slice once, zeros included, the f32 sum rounded to bf16
//      and widened back in the rounding mode (--fp16: the gradient of the
//      f32 atlas through .to(torch.bfloat16), the bits of the old chain:
//      K10's sum, .to(bf16), .to(f32)).  The tiles that no sample reads
//      (most of them: a patch sees a part of the scene) are written by a
//      plain zero fill at full occupancy (tiles_count_kernel,
//      tiles_zero_kernel); the gather's blocks stay resident (as many as
//      the card holds at once) and take the tiles with samples in turn.
//      Deterministic: two launches give the same bits.
// The layout (slices, threads, shared memory and scratch) is
// render/sample.py:tiles_grad_layout's; vl3d_tiles_grad_layout returns this
// file's for the card tests and chip_smoke.py to compare.
//
// K9 at C != 4 (the static atlas of the SH and NeX decoders; it replaces
// videoloop3d_tpu/render/adjoint.py:_packed_tile_grad on 4-D tiles, as
// csrc/bilinear_tiles.cu says) runs the same bins and gather on its
// (N, th, tw, C) tiles, K10's layout at F = 1: vl3d_bilinear_tiles_grad_
// gather (kStatic).  A row of C floats leaves a thread about one add a
// sample, so the add loop is cut to it: the decode writes, for each
// sample, which of its corners fall in each parity class (a 16-bit mask),
// and a thread adds only its class's corners, in q order, instead of
// testing all four.  The tiles that no sample reads are zero-filled with
// float4 stores where a tile's th tw C floats allow, a 2-D grid of (tile,
// run of a tile) so that no index is divided.  The layout is
// render/sample.py:static_grad_layout's (vl3d_static_grad_layout).
// Under --fp16 each tile's f32 sums are rounded to bf16 and widened inside
// the gather, as K10's; no flag or rounding pass is needed.
// The first design, one thread per (sample, frame) with four scalar f32
// atomicAdds a corner and channel into a zero-filled buffer, stays callable
// as vl3d_bilinear_tiles_tilemajor_grad_first (chip_smoke.py and the card
// tests only).
#include <cuda_pipeline.h>

#include "bins.cuh"
#include "vec.cuh"

namespace {

// kRound: f32 texels rounded to bf16 before the lerps
template <typename T, bool kRound>
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
  auto tex = [&](const T* r) {
    const float x = to_f32(*r);
    return kRound ? round_bf16(x) : x;
  };
  for (int c = 0; c < C; ++c) {
    const float top = lerp_rn(tex(r0 + u0i * texel + c),
                              tex(r0 + u1i * texel + c), fu);
    const float bot = lerp_rn(tex(r1 + u0i * texel + c),
                              tex(r1 + u1i * texel + c), fu);
    o[c] = lerp_rn(top, bot, fv);
  }
}

// K3's redesign at C != 4 (see the header): the layout of a launch over n
// samples of F_sel x C outputs, or false beyond its limits (1 <= C <=
// 1024, F_sel >= 1, n >= 0, at most 2^31 - 1 blocks, the shared memory
// within the 48 KB a block takes without opting in).
// render/sample.py:tiles_tilemajor_layout mirrors it.
struct TilemajorLayout {
  int samples;          // samples a block, a multiple of 4
  long long blocks;
  int threads;
  int smem;             // int4 offsets, float2 fu, fv a sample; F_sel ints
};

constexpr int kTmMaxC = 1024;
constexpr long long kTmMaxSamples = 1024;
constexpr long long kTmOutputs = 32LL * 4 * kBlock;   // a block's, at least
constexpr long long kTmSmemLimit = 48 * 1024;

bool tilemajor_layout(long long n, int F_sel, int C, TilemajorLayout* lay) {
  if (C < 1 || C > kTmMaxC || F_sel < 1 || n < 0) return false;
  const long long row = (long long)F_sel * C;      // outputs a sample
  long long s = 4 * ((kTmOutputs + 4 * row - 1) / (4 * row));
  if (s > kTmMaxSamples) s = kTmMaxSamples;
  const long long smem = s * (long long)(sizeof(int4) + sizeof(float2))
      + 4LL * F_sel;
  lay->samples = (int)s;
  lay->blocks = (n + s - 1) / s;
  lay->threads = kBlock;
  lay->smem = (int)(smem <= kTmSmemLimit ? smem : kTmSmemLimit + 1);
  return lay->blocks <= 0x7fffffffLL && smem <= kTmSmemLimit;
}

// kRound: f32 texels rounded to bf16 before the lerps.  tm_q[s]: the
// element offsets of sample s's corners (u0, v0), (u1, v0), (u0, v1),
// (u1, v1) at frame 0, channel 0, tm_q[s].x = -1 for a miss; tm_f[s]: fu,
// fv; tm_fr[f]: frame f's element offset in a texel's F_all x C run.
// vec4: out is 16-byte aligned (a block's run starts at a multiple of 4
// floats: samples is one).
template <typename T, bool kRound>
__global__ void __launch_bounds__(kBlock)
bilinear_tiles_tilemajor_sweep_kernel(
    const T* __restrict__ tiles, const int* __restrict__ k,
    const float* __restrict__ u, const float* __restrict__ v,
    const int* __restrict__ ts, long long n, int N, int th, int tw,
    int F_all, int F_sel, int C, int samples, int vec4,
    float* __restrict__ out) {
  extern __shared__ int4 tm_q[];
  float2* tm_f = reinterpret_cast<float2*>(tm_q + samples);
  int* tm_fr = reinterpret_cast<int*>(tm_f + samples);
  const long long first = (long long)blockIdx.x * samples;
  const int count = (int)min((long long)samples, n - first);
  const int texel = F_all * C;
  for (int i = threadIdx.x; i < count; i += kBlock) {
    const long long idx = first + i;
    const int kk = k[idx];
    if (kk < 0) {
      tm_q[i] = make_int4(-1, 0, 0, 0);
      tm_f[i] = make_float2(0.0f, 0.0f);
      continue;
    }
    const int tile = min(kk, N - 1);
    const float uu = fminf(fmaxf(u[idx], 0.0f), (float)(tw - 1));
    const float vv = fminf(fmaxf(v[idx], 0.0f), (float)(th - 1));
    const float u0 = floorf(uu), v0 = floorf(vv);
    const int u0i = (int)u0, v0i = (int)v0;
    const int u1i = min(u0i + 1, tw - 1), v1i = min(v0i + 1, th - 1);
    const int r0 = (tile * th + v0i) * tw, r1 = (tile * th + v1i) * tw;
    tm_q[i] = make_int4((r0 + u0i) * texel, (r0 + u1i) * texel,
                        (r1 + u0i) * texel, (r1 + u1i) * texel);
    tm_f[i] = make_float2(__fsub_rn(uu, u0), __fsub_rn(vv, v0));
  }
  for (int f = threadIdx.x; f < F_sel; f += kBlock)
    tm_fr[f] = (ts ? min(max(ts[f], 0), F_all - 1) : f) * C;
  __syncthreads();
  auto tex = [&](int e) {
    const float x = to_f32(tiles[e]);
    return kRound ? round_bf16(x) : x;
  };
  const int row = F_sel * C;
  const int total = count * row;
  float* __restrict__ dst = out + first * row;
  // a thread's groups of four consecutive outputs are kStep apart: that
  // step as (samples, frames, channels) to carry
  constexpr int kStep = 4 * kBlock;
  const int js = kStep / row, jj = kStep - js * row;
  const int jf = jj / C, jc = jj - jf * C;
  int o = 4 * (int)threadIdx.x;
  int s = o / row, f = (o - s * row) / C, c = o - s * row - f * C;
  for (; o < total; o += kStep) {
    // the four outputs' offsets and weights, the (sample, frame, channel)
    // carried one output at a time (the staged sample and frame read again
    // where the carry changes them), then all their loads
    int off[4];
    int4 qe[4];
    float2 we[4];
    int ss = s, ff = f, cc = c, fe = tm_fr[f];
    int4 qq = tm_q[s];
    float2 ww = tm_f[s];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qe[e] = o + e < total ? qq : make_int4(-1, 0, 0, 0);
      we[e] = ww;
      off[e] = fe + cc;
      if (++cc == C) {
        cc = 0;
        if (++ff == F_sel) {
          ff = 0;
          if (++ss < count) {
            qq = tm_q[ss];
            ww = tm_f[ss];
          }
        }
        fe = tm_fr[ff];
      }
    }
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      r[e] = 0.0f;
      if (qe[e].x >= 0) {
        const float top = lerp_rn(tex(qe[e].x + off[e]),
                                  tex(qe[e].y + off[e]), we[e].x);
        const float bot = lerp_rn(tex(qe[e].z + off[e]),
                                  tex(qe[e].w + off[e]), we[e].x);
        r[e] = lerp_rn(top, bot, we[e].y);
      }
    }
    if (vec4 && o + 4 <= total) {
      __stcs(reinterpret_cast<float4*>(dst + o),
             make_float4(r[0], r[1], r[2], r[3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (o + e < total) __stcs(dst + o + e, r[e]);
      }
    }
    s += js;
    f += jf;
    c += jc;
    if (c >= C) {
      c -= C;
      ++f;
    }
    if (f >= F_sel) {
      f -= F_sel;
      ++s;
    }
  }
}

// K10's first design (see the header)
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

// ---------------------------------------------------------------------------
// K10's redesign: stable bins, then one gather a (tile, slice)
// ---------------------------------------------------------------------------

// a thread's texels: one of the kGroups classes of texel (row, column)
// parity
constexpr int kGroups = 4;
constexpr int kMaxCols = 32;           // vectors of a slice
constexpr long long kAccBudget = 65536;   // accumulator bytes a block
constexpr int kBatch = 64;    // samples decoded and staged at a time
constexpr long long kSmemLimit = 232448;  // an H100 block's maximum

struct TilesGradLayout {
  int nk1;              // keys: the N tiles and the sentinel
  int passes;           // 8-bit digits of the sentinel
  int ntiles;           // sort blocks a plane
  int ncols;            // vectors of an F x C row
  int nslices, slice_cols, threads;
  int zero_vec;         // floats a store of the empty tiles' zero fill
  long long smem;       // dynamic shared bytes a block
  long long scratch;    // bytes
};

// mirrored by render/sample.py:tiles_grad_layout
TilesGradLayout tiles_grad_layout(int D, long long n, int N, int th, int tw,
                                  int F, int C, int vec) {
  TilesGradLayout L;
  L.nk1 = N + 1;
  L.passes = sort_passes(N);
  L.ntiles = (int)((n + kSortTile - 1) / kSortTile);
  L.ncols = F * C / vec;
  const long long col_bytes = 4LL * th * tw * vec;   // a column, all texels
  const long long fit = kAccBudget / col_bytes;
  const int max_cols = (int)(fit < 1 ? 1 : (fit < kMaxCols ? fit : kMaxCols));
  L.nslices = (L.ncols + max_cols - 1) / max_cols;
  L.slice_cols = L.nslices ? (L.ncols + L.nslices - 1) / L.nslices : 0;
  L.threads = (kGroups * L.slice_cols + 31) / 32 * 32;
  if (L.threads < 32) L.threads = 32;
  // a batch's samples (8 B), the accumulators, the batch's cotangent rows
  // of the slice, its texels and weights (16 B each), the ranges' starts
  // and running starts
  const long long b = 8LL * kBatch + (col_bytes * L.slice_cols + 15) / 16 * 16
      + 4LL * kBatch * L.slice_cols * vec + 32LL * kBatch
      + 4LL * (2 * D + 1);
  L.smem = (b + 15) / 16 * 16;
  L.zero_vec = vec;
  // and each tile's number of samples, the number of tiles with samples
  // and their list
  L.scratch = bins_scratch(D, n, L.ntiles, L.nk1)
      + align256(4LL * (2 * N + 1));
  return L;
}

// K9's at C != 4: K10's at F = 1, with a batch's class masks (kBatch
// ints) after the ranges' starts, and the zero fill in float4 where a
// tile's floats allow; mirrored by render/sample.py:static_grad_layout
TilesGradLayout static_grad_layout(int D, long long n, int N, int th, int tw,
                                   int C, int vec) {
  TilesGradLayout L = tiles_grad_layout(D, n, N, th, tw, 1, C, vec);
  L.smem += 4LL * kBatch;
  L.zero_vec = (long long)th * tw * C % 4 == 0 ? 4 : vec;
  return L;
}

// keys[i]: the tile of sample i, N where k < 0
__global__ void tiles_key_kernel(const int* __restrict__ k, long long total,
                                 int N, unsigned* __restrict__ keys) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int kk = k[i];
  keys[i] = kk < 0 ? (unsigned)N : (unsigned)min(kk, N - 1);
}

// count[t]: tile t's samples over all planes; the tiles with samples
// appended to active[0 .. *n_active) (in no fixed order: each is gathered
// by one block alone, so the order changes no bit of the result)
__global__ void tiles_count_kernel(const int* __restrict__ off, int D,
                                   int nk1, int N, int* __restrict__ count,
                                   int* __restrict__ active,
                                   int* __restrict__ n_active) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N) return;
  int m = 0;
  for (int d = 0; d < D; ++d) {
    const int* o = off + (long long)d * nk1 + t;
    m += o[1] - o[0];
  }
  count[t] = m;
  if (m > 0) active[atomicAdd(n_active, 1)] = t;
}

// the zeros of the tiles that no sample reads, kV floats a thread: a
// plain fill at full occupancy (the gather's blocks of those tiles return
// at once)
template <int kV>
__global__ void tiles_zero_kernel(const int* __restrict__ count,
                                  long long vecs_per_tile, long long total,
                                  float* __restrict__ grad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || count[i / vecs_per_tile] != 0) return;
  VecF<kV> z;
#pragma unroll
  for (int c = 0; c < kV; ++c) z.v[c] = 0.0f;
  st_vec_cs<kV>(grad + i * kV, z);
}

// K9's: the zeros of tile blockIdx.x (vecs_per_tile runs of kV floats)
// where no sample reads it, kBlock runs a block along y
template <int kV>
__global__ void tiles_zero_rows_kernel(const int* __restrict__ count,
                                       int vecs_per_tile,
                                       float* __restrict__ grad) {
  const int i = blockIdx.y * kBlock + threadIdx.x;
  if (i >= vecs_per_tile || count[blockIdx.x] != 0) return;
  VecF<kV> z;
#pragma unroll
  for (int c = 0; c < kV; ++c) z.v[c] = 0.0f;
  st_vec_cs<kV>(grad + ((long long)blockIdx.x * vecs_per_tile + i) * kV, z);
}

// kStatic: K9's (F = 1; each sample's corners of each class as a mask),
// else K10's
template <int kV, bool kRound, bool kStatic>
__global__ void __launch_bounds__(kGroups * kMaxCols) tiles_grad_gather_kernel(
    const float* __restrict__ ct, const float* __restrict__ u,
    const float* __restrict__ v, const int* __restrict__ perm,
    const int* __restrict__ off, const int* __restrict__ active,
    const int* __restrict__ n_active, int D, long long n, int th, int tw,
    int FC, int nk1, int slice_cols, int ncols, float* __restrict__ grad) {
  extern __shared__ float4 smem4[];
  const int nthr = blockDim.x, tid = threadIdx.x;
  const int T = th * tw;
  long long* e_s = reinterpret_cast<long long*>(smem4);       // [kBatch]
  float* acc = reinterpret_cast<float*>(e_s + kBatch);   // [T][slice kV]
  // [kBatch][slice kV], at a 16-byte boundary
  float* stg = acc + (T * slice_cols * kV + 3) / 4 * 4;
  int4* e_t = reinterpret_cast<int4*>(stg + kBatch * slice_cols * kV);
  float4* e_w = reinterpret_cast<float4*>(e_t + kBatch);     // [kBatch]
  int* rlo = reinterpret_cast<int*>(e_w + kBatch);           // [D]
  int* pre = rlo + D;                                             // [D + 1]
  int* e_m = pre + D + 1;                    // [kBatch], K9's class masks
  const int c0 = blockIdx.y * slice_cols;      // the slice's first vector
  const int cols = min(slice_cols, ncols - c0);
  // the blocks stay resident and take the tiles with samples in turn
  const int na = *n_active;
  for (int a = blockIdx.x; a < na; a += gridDim.x) {
    const long long tile = active[a];
    __syncthreads();                             // the last tile is written
    // the bin's range in each plane, then their starts in plane order
    for (int d = tid; d < D; d += nthr) {
      const int* o = off + (long long)d * nk1 + tile;
      rlo[d] = o[0];
      pre[d + 1] = o[1] - o[0];
    }
    __syncthreads();
    if (tid == 0) {
      pre[0] = 0;
      for (int d = 0; d < D; ++d) pre[d + 1] += pre[d];
    }
    __syncthreads();
    const int m = pre[D];
    // the tile's slice
    float* gt = grad + tile * T * FC + (long long)c0 * kV;
    for (int i = tid; i < T * cols; i += nthr) {
      VecF<kV> z;
#pragma unroll
      for (int c = 0; c < kV; ++c) z.v[c] = 0.0f;
      const int t = i / cols, c = i - t * cols;
      st_vec<kV>(acc + (t * slice_cols + c) * kV, z);
    }
    const int g = tid / cols, col = tid - g * cols;   // parity, column
    for (int e0 = 0; e0 < m; e0 += kBatch) {
      __syncthreads();                         // the last batch is added
      const int nb = min(kBatch, m - e0);
      for (int b = tid; b < nb; b += nthr) {
        const int e = e0 + b;
        int lo = 0, hi = D;                    // the last plane starting <= e
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (pre[mid] <= e) lo = mid; else hi = mid;
        }
        const long long s = (long long)lo * n
            + perm[(long long)lo * n + rlo[lo] + (e - pre[lo])];
        const float uu = fminf(fmaxf(u[s], 0.0f), (float)(tw - 1));
        const float vv = fminf(fmaxf(v[s], 0.0f), (float)(th - 1));
        const float u0 = floorf(uu), v0 = floorf(vv);
        const float fu = __fsub_rn(uu, u0), fv = __fsub_rn(vv, v0);
        const int u0i = (int)u0, v0i = (int)v0;
        const int u1i = min(u0i + 1, tw - 1), v1i = min(v0i + 1, th - 1);
        const float wu0 = __fsub_rn(1.0f, fu), wv0 = __fsub_rn(1.0f, fv);
        const float ws[4] = {__fmul_rn(wv0, wu0), __fmul_rn(wv0, fu),
                             __fmul_rn(fv, wu0), __fmul_rn(fv, fu)};
        e_s[b] = s;
        int tq[4], cm = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ui = (q & 1) ? u1i : u0i, vi = (q & 2) ? v1i : v0i;
          const int cls = ((vi & 1) << 1) | (ui & 1);
          if constexpr (kStatic) {
            tq[q] = vi * tw + ui;
            cm |= 1 << (4 * cls + q);
          } else {
            tq[q] = ((vi * tw + ui) << 2) | cls;
          }
        }
        if constexpr (kStatic) e_m[b] = cm;
        e_t[b] = make_int4(tq[0], tq[1], tq[2], tq[3]);
        e_w[b] = make_float4(ws[0], ws[1], ws[2], ws[3]);
      }
      __syncthreads();
      // the batch's cotangent rows of the slice, all copies in flight
      for (int i = tid; i < nb * cols; i += nthr) {
        const int j = i / cols, c = i - j * cols;
        __pipeline_memcpy_async(stg + (j * slice_cols + c) * kV,
                                ct + e_s[j] * FC + (long long)(c0 + c) * kV,
                                sizeof(float) * kV);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      if (kStatic && g < kGroups) {
        // the corners of this thread's class, in q order (one, unless u
        // or v is clamped at the tile's far edge)
        float* ap = acc + col * kV;
        const float* sp = stg + col * kV;
        const int* tex = reinterpret_cast<const int*>(e_t);
        const float* wts = reinterpret_cast<const float*>(e_w);
        for (int j = 0; j < nb; ++j) {
          int cm = (e_m[j] >> (4 * g)) & 15;
          if (!cm) continue;
          const VecF<kV> c4 = ld_vec_plain<kV>(sp + j * slice_cols * kV);
          do {
            const int q = __ffs(cm) - 1;
            cm &= cm - 1;
            float* a = ap + tex[4 * j + q] * slice_cols * kV;
            const float w = wts[4 * j + q];
            VecF<kV> sum = ld_vec_plain<kV>(a);
#pragma unroll
            for (int x = 0; x < kV; ++x)
              sum.v[x] = __fadd_rn(sum.v[x], __fmul_rn(c4.v[x], w));
            st_vec<kV>(a, sum);
          } while (cm);
        }
      } else if (g < kGroups) {
        // a sample's texels, weights and cotangent read one sample ahead
        // of its adds (the adds' stores would otherwise hold them back)
        float* ap = acc + col * kV;
        const float* sp = stg + col * kV;
        int4 tq = e_t[0];
        float4 wq = e_w[0];
        VecF<kV> cv = ld_vec_plain<kV>(sp);
        for (int j = 0; j < nb; ++j) {
          const int4 t4 = tq;
          const float4 w4 = wq;
          const VecF<kV> c4 = cv;
          if (j + 1 < nb) {
            tq = e_t[j + 1];
            wq = e_w[j + 1];
            cv = ld_vec_plain<kV>(sp + (j + 1) * slice_cols * kV);
          }
          const int ts[4] = {t4.x, t4.y, t4.z, t4.w};
          const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if ((ts[c] & 3) != g) continue;
            float* a = ap + (ts[c] >> 2) * slice_cols * kV;
            VecF<kV> sum = ld_vec_plain<kV>(a);
#pragma unroll
            for (int x = 0; x < kV; ++x)
              sum.v[x] = __fadd_rn(sum.v[x], __fmul_rn(c4.v[x], ws[c]));
            st_vec<kV>(a, sum);
          }
        }
      }
    }
    __syncthreads();
    // every texel of the tile's slice written once, zeros included
    for (int i = tid; i < T * cols; i += nthr) {
      const int t = i / cols, c = i - t * cols;
      VecF<kV> val = ld_vec_plain<kV>(acc + (t * slice_cols + c) * kV);
      if constexpr (kRound) {
#pragma unroll
        for (int x = 0; x < kV; ++x) val.v[x] = round_bf16(val.v[x]);
      }
      st_vec_cs<kV>(gt + (long long)t * FC + c * kV, val);
    }
  }
}

template <int kV, bool kRound, bool kStatic>
int launch_tiles_gather(const TilesGradLayout& L, const float* ct,
                        const float* u, const float* v, const Bins& bins,
                        int* count, int D, long long n, int N, int th,
                        int tw, int FC, float* grad, cudaStream_t st) {
  int* n_active = count + N;
  int* active = n_active + 1;
  cudaMemsetAsync(n_active, 0, sizeof(int), st);
  tiles_count_kernel<<<grid_for(N), kBlock, 0, st>>>(bins.off, D, L.nk1, N,
                                                      count, active,
                                                      n_active);
  if (kStatic) {
    const int per_tile = th * tw * FC / L.zero_vec;
    const dim3 zg((unsigned)N, (unsigned)((per_tile + kBlock - 1) / kBlock));
    if (L.zero_vec == 4) {
      tiles_zero_rows_kernel<4><<<zg, kBlock, 0, st>>>(count, per_tile, grad);
    } else {
      tiles_zero_rows_kernel<kV><<<zg, kBlock, 0, st>>>(count, per_tile,
                                                        grad);
    }
  } else {
    const long long per_tile = (long long)th * tw * FC / kV;
    tiles_zero_kernel<kV><<<grid_for(per_tile * N), kBlock, 0, st>>>(
        count, per_tile, per_tile * N, grad);
  }
  auto k = tiles_grad_gather_kernel<kV, kRound, kStatic>;
  if (L.smem > 48 * 1024)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)L.smem);
  // as many blocks a slice as the card holds at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, L.threads,
                                                (size_t)L.smem);
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int gx = (int)((resident + L.nslices - 1) / L.nslices);
  const dim3 grid((unsigned)(gx < N ? gx : N), (unsigned)L.nslices);
  k<<<grid, L.threads, L.smem, st>>>(ct, u, v, bins.perm, bins.off, active,
                                     n_active, D, n, th, tw, FC, L.nk1,
                                     L.slice_cols, L.ncols, grad);
  return (int)cudaGetLastError();
}

// The bins and the gather of K10 (kStatic false) or K9 (true) for the
// layout L, vec floats a column.
template <bool kStatic>
int tiles_grad_run(const TilesGradLayout& L, const float* ct, const int* k,
                   const float* u, const float* v, int D, long long n, int N,
                   int th, int tw, int FC, int vec, int round_bf16,
                   void* scratch, long long scratch_bytes, float* grad,
                   cudaStream_t st) {
  if (scratch_bytes < L.scratch || L.smem > kSmemLimit || D < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || L.ncols == 0) return (int)cudaGetLastError();
  const long long total = (long long)D * n;
  const Bins bins = sort_bins(
      scratch, D, n, L.ntiles, L.nk1, L.passes,
      [&](unsigned* keys) {
        tiles_key_kernel<<<grid_for(total), kBlock, 0, st>>>(k, total, N,
                                                             keys);
      },
      st);
  int* count = reinterpret_cast<int*>(
      (char*)scratch + bins_scratch(D, n, L.ntiles, L.nk1));
  if (vec == 4)
    return round_bf16
        ? launch_tiles_gather<4, true, kStatic>(L, ct, u, v, bins, count, D,
                                                n, N, th, tw, FC, grad, st)
        : launch_tiles_gather<4, false, kStatic>(L, ct, u, v, bins, count,
                                                 D, n, N, th, tw, FC, grad,
                                                 st);
  if (vec == 2)
    return round_bf16
        ? launch_tiles_gather<2, true, kStatic>(L, ct, u, v, bins, count, D,
                                                n, N, th, tw, FC, grad, st)
        : launch_tiles_gather<2, false, kStatic>(L, ct, u, v, bins, count,
                                                 D, n, N, th, tw, FC, grad,
                                                 st);
  return round_bf16
      ? launch_tiles_gather<1, true, kStatic>(L, ct, u, v, bins, count, D, n,
                                              N, th, tw, FC, grad, st)
      : launch_tiles_gather<1, false, kStatic>(L, ct, u, v, bins, count, D,
                                               n, N, th, tw, FC, grad, st);
}

int launch_tm_first(const void* tiles, int is_bf16, int round_bf16,
                    const int* k, const float* u, const float* v,
                    const int* ts, long long n, int N, int th, int tw,
                    int F_all, int F_sel, int C, float* out, cudaStream_t s) {
  const long long m = n * F_sel;
  if (m > 0) {
    if (is_bf16) {
      bilinear_tiles_tilemajor_kernel<__nv_bfloat16, false>
          <<<grid_for(m), kBlock, 0, s>>>((const __nv_bfloat16*)tiles, k, u,
                                          v, ts, n, N, th, tw, F_all, F_sel,
                                          C, out);
    } else if (round_bf16) {
      bilinear_tiles_tilemajor_kernel<float, true>
          <<<grid_for(m), kBlock, 0, s>>>((const float*)tiles, k, u, v, ts, n,
                                          N, th, tw, F_all, F_sel, C, out);
    } else {
      bilinear_tiles_tilemajor_kernel<float, false>
          <<<grid_for(m), kBlock, 0, s>>>((const float*)tiles, k, u, v, ts, n,
                                          N, th, tw, F_all, F_sel, C, out);
    }
  }
  return (int)cudaGetLastError();
}

int launch_tm_sweep(const void* tiles, int is_bf16, int round_bf16,
                    const int* k, const float* u, const float* v,
                    const int* ts, long long n, int N, int th, int tw,
                    int F_all, int F_sel, int C, float* out, cudaStream_t s) {
  TilemajorLayout lay;
  if (!tilemajor_layout(n, F_sel, C, &lay)
      || (long long)N * th * tw * F_all * C > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int vec4 = (uintptr_t)out % 16 == 0;
    const dim3 grid((unsigned)lay.blocks);
    if (is_bf16) {
      bilinear_tiles_tilemajor_sweep_kernel<__nv_bfloat16, false>
          <<<grid, lay.threads, lay.smem, s>>>(
              (const __nv_bfloat16*)tiles, k, u, v, ts, n, N, th, tw, F_all,
              F_sel, C, lay.samples, vec4, out);
    } else if (round_bf16) {
      bilinear_tiles_tilemajor_sweep_kernel<float, true>
          <<<grid, lay.threads, lay.smem, s>>>(
              (const float*)tiles, k, u, v, ts, n, N, th, tw, F_all, F_sel, C,
              lay.samples, vec4, out);
    } else {
      bilinear_tiles_tilemajor_sweep_kernel<float, false>
          <<<grid, lay.threads, lay.smem, s>>>(
              (const float*)tiles, k, u, v, ts, n, N, th, tw, F_all, F_sel, C,
              lay.samples, vec4, out);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K3.  tiles: f32 (is_bf16 0) or bf16 texels; round_bf16: f32 texels
// rounded to bf16 before the lerps (the --fp16 gather of the f32 atlas).
// C = 4: bilinear_tiles_tilemajor_kernel; other C:
// bilinear_tiles_tilemajor_sweep_kernel (tiles of fewer than 2^31
// elements, tiles_tilemajor_layout's limits).
VL3D_API int vl3d_bilinear_tiles_tilemajor(const void* tiles, int is_bf16,
                                           int round_bf16, const int* k,
                                           const float* u, const float* v,
                                           const int* ts, long long n, int N,
                                           int th, int tw, int F_all,
                                           int F_sel, int C, float* out,
                                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 4) {
    return launch_tm_first(tiles, is_bf16, round_bf16, k, u, v, ts, n, N, th,
                           tw, F_all, F_sel, C, out, s);
  }
  return launch_tm_sweep(tiles, is_bf16, round_bf16, k, u, v, ts, n, N, th,
                         tw, F_all, F_sel, C, out, s);
}

// K3's first design at any C: one thread per (sample, frame)
// (bilinear_tiles_tilemajor_kernel; chip_smoke.py and the card tests
// only); arguments as vl3d_bilinear_tiles_tilemajor's.
VL3D_API int vl3d_bilinear_tiles_tilemajor_first(
    const void* tiles, int is_bf16, int round_bf16, const int* k,
    const float* u, const float* v, const int* ts, long long n, int N,
    int th, int tw, int F_all, int F_sel, int C, float* out, void* stream) {
  return launch_tm_first(tiles, is_bf16, round_bf16, k, u, v, ts, n, N, th,
                         tw, F_all, F_sel, C, out, (cudaStream_t)stream);
}

// K3's redesign's layout over n samples of F_sel x C outputs: out =
// {samples, blocks, threads, smem} (render/sample.py:tiles_tilemajor_layout's
// keys, in order); cudaErrorInvalidValue beyond its limits.
VL3D_API int vl3d_bilinear_tiles_tilemajor_layout(long long n, int F_sel,
                                                  int C, long long* out) {
  TilemajorLayout lay;
  if (!tilemajor_layout(n, F_sel, C, &lay)) return (int)cudaErrorInvalidValue;
  out[0] = lay.samples;
  out[1] = lay.blocks;
  out[2] = lay.threads;
  out[3] = lay.smem;
  return 0;
}

// K10 (the redesign): the (N, th, tw, F, C) f32 gradient, every texel
// written (no zero fill); D x n samples (D planes of the sort); round_bf16:
// each sum rounded to bf16 and stored widened.  vec: 4, 2 or 1 floats a
// column (F C divisible, pointers aligned).  scratch: tiles_grad_layout's
// bytes.
VL3D_API int vl3d_bilinear_tiles_tilemajor_grad(
    const float* ct, const int* k, const float* u, const float* v, int D,
    long long n, int N, int th, int tw, int F, int C, int vec, int round_bf16,
    void* scratch, long long scratch_bytes, float* grad, void* stream) {
  const TilesGradLayout L = tiles_grad_layout(D, n, N, th, tw, F, C, vec);
  return tiles_grad_run<false>(L, ct, k, u, v, D, n, N, th, tw, F * C, vec,
                               round_bf16, scratch, scratch_bytes, grad,
                               (cudaStream_t)stream);
}

// K9 at C != 4 (the redesign): the (N, th, tw, C) f32 gradient of D x n
// samples, every texel written, by K10's bins and gather at F = 1
// (static_grad_layout); the rest as vl3d_bilinear_tiles_tilemajor_grad.
VL3D_API int vl3d_bilinear_tiles_grad_gather(
    const float* ct, const int* k, const float* u, const float* v, int D,
    long long n, int N, int th, int tw, int C, int vec, int round_bf16,
    void* scratch, long long scratch_bytes, float* grad, void* stream) {
  const TilesGradLayout L = static_grad_layout(D, n, N, th, tw, C, vec);
  return tiles_grad_run<true>(L, ct, k, u, v, D, n, N, th, tw, C, vec,
                              round_bf16, scratch, scratch_bytes, grad,
                              (cudaStream_t)stream);
}

// K10's layout as this file computes it, for the mirror checks:
// out[9] = nk1, passes, ntiles, ncols, nslices, slice_cols, threads, smem,
// scratch bytes
VL3D_API int vl3d_tiles_grad_layout(int D, long long n, int N, int th, int tw,
                                    int F, int C, int vec, long long* out) {
  const TilesGradLayout L = tiles_grad_layout(D, n, N, th, tw, F, C, vec);
  const long long v[9] = {L.nk1, L.passes, L.ntiles, L.ncols, L.nslices,
                          L.slice_cols, L.threads, L.smem, L.scratch};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// K9's layout at C != 4 as this file computes it: out[10] = the nine of
// vl3d_tiles_grad_layout, then the zero fill's floats a store
VL3D_API int vl3d_static_grad_layout(int D, long long n, int N, int th,
                                     int tw, int C, int vec, long long* out) {
  const TilesGradLayout L = static_grad_layout(D, n, N, th, tw, C, vec);
  const long long v[10] = {L.nk1, L.passes, L.ntiles, L.ncols, L.nslices,
                           L.slice_cols, L.threads, L.smem, L.scratch,
                           L.zero_vec};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// K10's first design (chip_smoke.py and the card tests only); grad must be
// zero-filled by the caller.
VL3D_API int vl3d_bilinear_tiles_tilemajor_grad_first(
    const float* ct, const int* k, const float* u, const float* v,
    long long n, int N, int th, int tw, int F, int C, float* grad,
    void* stream) {
  const long long m = n * F;
  if (m > 0) {
    bilinear_tiles_tilemajor_grad_kernel<<<grid_for(m), kBlock, 0,
                                           (cudaStream_t)stream>>>(
        ct, k, u, v, n, N, th, tw, F, C, grad);
  }
  return (int)cudaGetLastError();
}
