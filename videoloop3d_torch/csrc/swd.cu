// K24 swd_project, K25 swd_sort_l1 and K26 swd_project_grad: the
// sliced-Wasserstein 3-D patch loss (the "swd" looping loss) and its
// gradient in the render.
//
// Replaces videoloop3d_tpu/losses/swd.py:48 swd_3d_loss, its default
// (no-mask) branch under autodiff: the VALID conv3d of the projections
// (:66-77, lax.conv_general_dilated), the per-column sort (:100-102,
// jnp.sort), _match_lengths (:105) and jnp.mean(jnp.abs(.)), and the
// transposes of all four.  v is (C, T, H, W) f32 in [-1, 1]; rand is the
// (P, d) matrix of the normalized projections, d = C pt p p, flat channel
// q = ((c pt + dt) p + dy) p + dx.
//
// K24 computes, for every projection P, spatial location (i, j) and
// temporal position f,
//   out[P, i cw + j, f] = sum_q rand[P, q] v[c, f st + dt, i s + dy, j s + dx]
// straight into K25's column layout (P, ch cw, cf): no patch tensor in
// device memory.  An implicit GEMM (M = P rows, N = cf ch cw columns, K =
// d).  Bound: operations, 2 P d N: 93.5 GFLOP on the ref view's x (p 11,
// pt 3, s 4: 50 x 43 x 78 locations, d 1,089), 29.3 on the other view's
// (p 3, s 2: 50 x 89 x 159, d 81) at 67 TFLOP/s.
//
// Every output is one fmaf chain from 0, k ascending, whatever its place
// in the tile, so equal patches (a static region over time) give bit-equal
// projections and K25's ties break as JAX's.  f32 FMA, no tensor cores
// (TF32 is not exact).  The first design (swd_gemm_first_kernel, kept for
// comparison as vl3d_swd_project_first) padded K to a multiple of 32 with
// fmaf(0, 0, acc) steps, which turn a -0 sum into +0; the redesign
// (swd_tile_gemm_kernel) ends a chain with one such step exactly where K
// is not a multiple of 32, so both give the same bits.
//
// The redesign is a register-tiled GEMM for the FP32 pipes: a 128 x 128
// output tile per block, 256 threads of 8 x 8 outputs, the operands staged
// 16 reduction entries at a time through a ring of two stages in dynamic
// shared memory, k-major rows of 132 floats (16-byte aligned, two-way
// store conflicts at most).  A thread reads its fragments as four float4
// per entry, and a warp's 4 x 8 threads make both loads broadcasts: 64
// FMAs per 16 words read.  The contiguous operands (rand's rows here)
// arrive by 4-byte cp.async; v's gathered patch entries are loaded into
// registers one stage ahead (lanes along k, so a warp reads 16-entry runs
// of two patches' rows; v stays in L2) and stored after the current
// stage's FMAs.  A thread steps its k's offset in v by 16 entries a stage
// (no per-block offset table); the tile's column bases are one 128-entry
// table.  A short last stage runs only its real entries (K = 81 was
// padded to 96 before).  Stores are 16 bytes where the row allows (8 or 4
// otherwise), streaming, so v keeps its L2 lines.  Limits: at most 128
// registers a thread (__launch_bounds__(256, 2); ptxas gives K24 123 and
// K26 115, no spills), two blocks an SM with 33 KB of shared memory each,
// N < 2^31 - 128 columns and fewer than 2^31 tiles (losses/swd.py raises
// beyond them); d < 2^31 follows from v's 2^31 elements.
//
// K25 takes the x and y columns (cfx and cfy long), brings them to one
// length n (the shorter side through an index map of n entries shared by
// every column: its entries tiled, then those the host's permutation
// picks, _match_lengths), sorts both stably and pairs them by rank.  It
// writes
//   gx[col, src] = sum over the copies r of src of sign+(sx_r - sy_r) / N
// (sign+(0) = +1, the jnp.abs gradient at 0; N the matched element
// count), and per-block partial sums of |sx_r - sy_r|, which a second
// pass adds in a fixed order: the loss is sum / N, reproducible, with no
// float atomics, 8 columns to a partial.  Bound: bytes,
// the columns read once and gx written once (0.52 GB ref view, 2.17 GB
// other view at 3.35 TB/s).
//
// The redesign sorts keys, not values: each matched entry maps to an
// order-preserving u32 key (-0 as +0, every NaN last: csrc/swd_mask.cu's
// f2key with the NaNs moved), x's with its matched index r below it in a
// u64, so every compare is exact and the order is the stable sort's (ties
// in index order, NaNs last in index order, as torch.sort and jnp.sort);
// y's keys are u32 (a tie's order cannot change its value's |d| or sign).
// Columns of up to 64 entries (the main path: n = 50) take a bitonic
// network in registers over 64 slots, padded with keys that sort last,
// in the form without descending pairs: 8 lanes a column, 8 slots a lane
// (slot s = 8 g + j), so 15 of its 21 steps run within the lane and 6 as
// shuffles, 4 columns a warp (swd_sort_net_kernel).  Longer columns, up
// to 1,024, run a bitonic network over a power-of-two count of slots in
// shared memory, a warp per column (swd_sort_smem_kernel): chosen by
// length, not a fallback.  Rank s of x then pairs with rank s of y in the same slot;
// |d| and the sign go to x's matched index r in shared memory; a whole
// warp then sums a column's |d| over r = lane, lane + 32, ... and by the
// first design's shuffle tree, adds 8 columns' sums in order into the
// partial of the first design's block, and writes gx as it did: the loss
// and gx are bit-equal to the first design on finite inputs.
// Where x is the shorter side, a source sums its copies through the
// host's inverse of the map (its copies in r order), n reads a column
// where the first design scanned the map once a source.  The first design
// (swd_sort_l1_first_kernel, vl3d_swd_sort_l1_first, kept for
// comparison) ranked each entry by a scan of the whole column in shared
// memory, 2 n^2 compares a column, and gives every NaN rank 0.
//
// K26 is the gradient of the loss in the input x (v = 2 x - 1):
//   dL/dx[c, t, h, w] = 2 sum_{P, f, i, j covering the voxel}
//       rand[P, c, t - f st, h - i s, w - j s] gx[P, i cw + j, f],
// as two passes, deterministic, with no atomics: the patch gradients G =
// rand^T gx (one fmaf chain over P ascending each) into a scratch, then a
// fold, one thread per voxel adding its covering patches in a fixed
// order (i, j, f ascending) with __fadd_rn and doubling.  The redesign
// runs the GEMM on the same tile code (both operands by cp.async) and
// writes the scratch transposed, (d, round_up(cf ch cw, 4)) with the patch
// column fastest, so the fold (swd_fold_t_kernel) gives a warp 32
// consecutive t of one (c, h, w): at stride st = 1 the lanes read one
// contiguous run of f per covering patch, four runs in flight before
// their adds, and a block stages its 32 x 8 voxels to write them
// w-fastest.  The first design (vl3d_swd_project_grad_first) wrote (cf ch
// cw, d) and folded with w fastest, a scattered read.  Bound: operations,
// as K24's on x; the fold alone moves the scratch once (730 MB at the ref
// view, 229 MB at the other).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // rows and columns of a block's output tile
constexpr int kChunk = 32;   // reduction entries staged per pass
constexpr int kPitch = kTile + 1;
constexpr int kSortWarps = 8;  // columns of one K25 block (a warp each)

// The projection's geometry: v (C, T, H, W), patches (pt, p, p) at
// strides (st, s, s), cf x ch x cw patch positions.
struct SwdGeom {
  int C, T, H, W, pt, p, st, s, cf, ch, cw;
};

// C[m, n] = sum_k A(m, k) B(k, n), k ascending.  kProject (K24): A =
// rand (M = P rows of K = d), B(k, n) = v at patch column n's channel k,
// n = (i cw + j) cf + f.  Otherwise (K26's first pass): A(m, k) = gx[k M
// + m] (M = cf ch cw patch columns, K = P), B = rand (K x N, N = d).
template <bool kProject>
__global__ void __launch_bounds__(kThreads)
    swd_gemm_first_kernel(const float* __restrict__ a,
                          const float* __restrict__ b, int M, int N, int K,
                          SwdGeom g, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* as = smem;                     // [kChunk][kPitch]
  float* bs = as + kChunk * kPitch;     // [kChunk][kPitch]
  int* off = reinterpret_cast<int*>(bs + kChunk * kPitch);  // [K] (K24)
  int* base = off + (kProject ? K : 0);                     // [kTile]

  const int tid = threadIdx.x;
  const int tiles_m = (M + kTile - 1) / kTile;
  const int tiles_n = (N + kTile - 1) / kTile;
  // the axis with fewer tiles runs fastest over neighbouring blocks, so
  // they share their other operand's tile in L2
  int mt, nt;
  if (tiles_m <= tiles_n) {
    mt = blockIdx.x % tiles_m;
    nt = blockIdx.x / tiles_m;
  } else {
    nt = blockIdx.x % tiles_n;
    mt = blockIdx.x / tiles_n;
  }
  const int m0 = mt * kTile, n0 = nt * kTile;

  if constexpr (kProject) {
    const int hw = g.H * g.W;
    for (int q = tid; q < K; q += kThreads) {
      const int dx = q % g.p;
      const int dy = (q / g.p) % g.p;
      const int dt = (q / (g.p * g.p)) % g.pt;
      const int c = q / (g.p * g.p * g.pt);
      off[q] = (c * g.T + dt) * hw + dy * g.W + dx;
    }
    for (int r = tid; r < kTile; r += kThreads) {
      const int n = n0 + r;
      int bv = 0;
      if (n < N) {
        const int f = n % g.cf;
        const int loc = n / g.cf;
        bv = f * g.st * hw + (loc / g.cw) * g.s * g.W + (loc % g.cw) * g.s;
      }
      base[r] = bv;
    }
    __syncthreads();
  }

  const int ti = tid / 16, tj = tid % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      float av = 0.0f, bv = 0.0f;
      if constexpr (kProject) {
        // channels fastest: rand's rows and v's patch rows are contiguous
        const int r = e / kChunk, q = e % kChunk, k = k0 + q;
        if (k < K) {
          if (m0 + r < M) av = a[(long long)(m0 + r) * K + k];
          if (n0 + r < N) bv = b[base[r] + off[k]];
        }
        as[q * kPitch + r] = av;
        bs[q * kPitch + r] = bv;
      } else {
        const int r = e % kTile, q = e / kTile, k = k0 + q;
        if (k < K) {
          if (m0 + r < M) av = a[(long long)k * M + m0 + r];
          if (n0 + r < N) bv = b[(long long)k * N + n0 + r];
        }
        as[q * kPitch + r] = av;
        bs[q * kPitch + r] = bv;
      }
    }
    __syncthreads();
    for (int q = 0; q < kChunk; ++q) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[q * kPitch + ti + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[q * kPitch + tj + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ti + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tj + 16 * j;
      if (n < N) out[(long long)m * N + n] = acc[i][j];
    }
  }
}

// rank of v[i] among v[0:n] in a stable ascending sort
__device__ __forceinline__ int stable_rank(const float* v, int n, int i) {
  const float a = v[i];
  int rank = 0;
  for (int k = 0; k < n; ++k) {
    const float b = v[k];
    rank += (b < a) || (b == a && k < i);
  }
  return rank;
}

// the sum of a block's warps' |d| sums (a shuffle tree, then warp order)
__device__ __forceinline__ void sort_block_partial(float lsum, float* wsum,
                                                   float* partial) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int o = 16; o > 0; o >>= 1)
    lsum = __fadd_rn(lsum, __shfl_down_sync(0xffffffffu, lsum, o));
  if (lane == 0) wsum[warp] = lsum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kSortWarps; ++w) s = __fadd_rn(s, wsum[w]);
    partial[blockIdx.x] = s;
  }
}

// K25's first design: ranks by a scan of the column in shared memory
__global__ void __launch_bounds__(kSortWarps * 32)
    swd_sort_l1_first_kernel(const float* __restrict__ ox,
                             const float* __restrict__ oy, long long ncols,
                             int nx, int ny, int n,
                             const int* __restrict__ map_x,
                             const int* __restrict__ map_y, float count,
                             float* __restrict__ gx,
                             float* __restrict__ partial) {
  extern __shared__ float smem[];
  __shared__ float wsum[kSortWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xv = smem + warp * 4 * n;  // the matched x column
  float* yv = xv + n;               // the matched y column
  float* sy = yv + n;               // y by rank
  float* gm = sy + n;               // the gradient of each matched x entry
  const long long col = (long long)blockIdx.x * kSortWarps + warp;
  float lsum = 0.0f;
  if (col < ncols) {
    const float* cx = ox + col * nx;
    const float* cy = oy + col * ny;
    for (int r = lane; r < n; r += 32) {
      xv[r] = cx[map_x ? map_x[r] : r];
      yv[r] = cy[map_y ? map_y[r] : r];
    }
    __syncwarp();
    for (int r = lane; r < n; r += 32) sy[stable_rank(yv, n, r)] = yv[r];
    __syncwarp();
    const float inv = __fdiv_rn(1.0f, count);
    for (int r = lane; r < n; r += 32) {
      const float d = __fsub_rn(xv[r], sy[stable_rank(xv, n, r)]);
      lsum = __fadd_rn(lsum, fabsf(d));
      gm[r] = d >= 0.0f ? inv : -inv;
    }
    __syncwarp();
    float* g = gx + col * nx;
    if (map_x) {
      // a source entry's copies, r ascending
      for (int src = lane; src < nx; src += 32) {
        float acc = 0.0f;
        for (int r = 0; r < n; ++r)
          if (map_x[r] == src) acc = __fadd_rn(acc, gm[r]);
        g[src] = acc;
      }
    } else {
      for (int r = lane; r < n; r += 32) g[r] = gm[r];
    }
  }
  sort_block_partial(lsum, wsum, partial);
}

// The redesign's keys: an order-preserving u32 of an f32 (-0 as +0, every
// NaN last) and back (a NaN comes back as a NaN).  x's key carries its
// matched index r below it; the padding sorts after every entry.
constexpr unsigned long long kPadX = ~0ull;
constexpr unsigned kPadY = ~0u;
constexpr int kNetSlots = 64;    // swd_sort_net_kernel's slots a column
constexpr int kNetRegs = 8;      // its slots a lane (8 lanes a column)
constexpr int kNetCols = 32;     // its columns a block (4 a warp)
constexpr int kSmemSlotsMax = 1024;   // swd_sort_smem_kernel's

__device__ __forceinline__ unsigned sort_key(float v) {
  if (v != v) return 0xffffffffu;
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ unsigned long long x_key(float v, int r) {
  return ((unsigned long long)sort_key(v) << 32) | (unsigned)r;
}

// one compare-exchange of a bitonic step with the slot in the lane m
// lanes away: the lower slot of an ascending pair (or the upper of a
// descending one) keeps the smaller key
template <typename K>
__device__ __forceinline__ K exchange(K v, int m, bool keep_min) {
  const K p = __shfl_xor_sync(0xffffffffu, v, m);
  return (keep_min == (p < v)) ? p : v;
}

// the smaller and the larger of two keys
template <typename K>
__device__ __forceinline__ void order2(K& lo, K& hi) {
  const K a = lo < hi ? lo : hi;
  hi = lo < hi ? hi : lo;
  lo = a;
}

// A column's 64 keys in ascending order over 8 lanes (g = lane % 8) of 8
// registers, slot s = 8 g + j in a[j]: a bitonic network without
// descending pairs (each merge of 2^lk slots first pairs s with
// s ^ (2^lk - 1), then s with s ^ jd, the lower slot keeping the smaller
// key).  Pairs less than 8 slots apart run within the lane, the others as
// shuffles to lane g ^ m (the mirror pair: register 7 - j there).
template <typename K>
__device__ __forceinline__ void bitonic64(K (&a)[kNetRegs], int g) {
#pragma unroll
  for (int lk = 1; lk <= 6; ++lk) {     // merges of k = 2 .. kNetSlots
    const int k = 1 << lk;
    if (k <= kNetRegs) {
#pragma unroll
      for (int j = 0; j < kNetRegs; ++j)
        if ((j & (k >> 1)) == 0) order2(a[j], a[j ^ (k - 1)]);
    } else {
      const int m = k / kNetRegs - 1;
      const bool keep_min = (g & (k / kNetRegs / 2)) == 0;
      K b[kNetRegs];
#pragma unroll
      for (int j = 0; j < kNetRegs; ++j)
        b[j] = __shfl_xor_sync(0xffffffffu, a[kNetRegs - 1 - j], m);
#pragma unroll
      for (int j = 0; j < kNetRegs; ++j)
        a[j] = (keep_min == (b[j] < a[j])) ? b[j] : a[j];
    }
#pragma unroll
    for (int lj = lk - 2; lj >= 0; --lj) {
      const int jd = 1 << lj;
      if (jd < kNetRegs) {
#pragma unroll
        for (int j = 0; j < kNetRegs; ++j)
          if ((j & jd) == 0) order2(a[j], a[j | jd]);
      } else {
        const int m = jd / kNetRegs;
        const bool keep_min = (g & m) == 0;
#pragma unroll
        for (int j = 0; j < kNetRegs; ++j) a[j] = exchange(a[j], m, keep_min);
      }
    }
  }
}

// The column's ends: |d| and the sign by matched index (ad, gm: n each,
// written by the caller), then each lane's |d| sum over r = lane, lane +
// 32, ... and gx, as the first design.  map_x: gx of a source sums its
// copies in r order through the inverse map (inv_start: nx + 1 offsets
// into inv_order, the r of each source's copies ascending).
__device__ __forceinline__ float column_tail(
    const float* ad, const float* gm, int n, int nx, bool mapped,
    const int* __restrict__ inv_start, const int* __restrict__ inv_order,
    float* __restrict__ g, int lane) {
  float lsum = 0.0f;
  for (int r = lane; r < n; r += 32) lsum = __fadd_rn(lsum, ad[r]);
  if (mapped) {
    for (int src = lane; src < nx; src += 32) {
      float acc = 0.0f;
      const int e = __ldg(inv_start + src + 1);
      for (int k = __ldg(inv_start + src); k < e; ++k)
        acc = __fadd_rn(acc, gm[__ldg(inv_order + k)]);
      g[src] = acc;
    }
  } else {
    for (int r = lane; r < n; r += 32) g[r] = gm[r];
  }
  return lsum;
}

// |d| and the sign of rank s, to x's matched index r
__device__ __forceinline__ void pair_rank(unsigned long long xk, unsigned yk,
                                          float inv, float* ad, float* gm) {
  const int r = (int)(unsigned)xk;
  const float d = __fsub_rn(key_value((unsigned)(xk >> 32)), key_value(yk));
  ad[r] = fabsf(d);
  gm[r] = d >= 0.0f ? inv : -inv;
}

// K25 at n <= 64: the keyed network in registers, 8 lanes a column, 4
// columns a warp, 32 a block; each column's |d| sums then reduced by a
// whole warp as the first design's, and each 8 columns' sums in order
// into the partial of the first design's block.
__global__ void __launch_bounds__(kNetCols * 8)
    swd_sort_net_kernel(const float* __restrict__ ox,
                        const float* __restrict__ oy, long long ncols,
                        int nx, int ny, int n, const int* __restrict__ map_x,
                        const int* __restrict__ map_y,
                        const int* __restrict__ inv_start,
                        const int* __restrict__ inv_order, float count,
                        float* __restrict__ gx, float* __restrict__ partial,
                        long long npartial) {
  __shared__ float buf[kNetCols][2][kNetSlots];
  __shared__ float wsum[kNetCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane % kNetRegs;                 // lane within the column
  const int cw = warp * 4 + lane / kNetRegs;     // column within the block
  const long long col0 = (long long)blockIdx.x * kNetCols;
  const long long col = col0 + cw;
  unsigned long long x[kNetRegs];
  unsigned y[kNetRegs];
#pragma unroll
  for (int j = 0; j < kNetRegs; ++j) {
    const int r = g * kNetRegs + j;
    x[j] = kPadX;
    y[j] = kPadY;
    if (col < ncols && r < n) {
      x[j] = x_key(ox[col * nx + (map_x ? __ldg(map_x + r) : r)], r);
      y[j] = sort_key(oy[col * ny + (map_y ? __ldg(map_y + r) : r)]);
    }
  }
  bitonic64(x, g);
  bitonic64(y, g);
  const float inv = __fdiv_rn(1.0f, count);
  float* ad = buf[cw][0];
  float* gm = buf[cw][1];
#pragma unroll
  for (int j = 0; j < kNetRegs; ++j) {
    if (col < ncols && g * kNetRegs + j < n)
      pair_rank(x[j], y[j], inv, ad, gm);
  }
  __syncwarp();
  // the warp's 4 columns, one after another, as the first design's warps
  for (int c = 0; c < 4; ++c) {
    const int cb = warp * 4 + c;
    float lsum = 0.0f;
    if (col0 + cb < ncols) {
      lsum = column_tail(buf[cb][0], buf[cb][1], n, nx, map_x != nullptr,
                         inv_start, inv_order, gx + (col0 + cb) * nx, lane);
    }
    for (int o = 16; o > 0; o >>= 1)
      lsum = __fadd_rn(lsum, __shfl_down_sync(0xffffffffu, lsum, o));
    if (lane == 0) wsum[cb] = lsum;
  }
  __syncthreads();
  if (threadIdx.x < kNetCols / kSortWarps) {
    const long long p = (long long)blockIdx.x * (kNetCols / kSortWarps)
        + threadIdx.x;
    if (p < npartial) {
      float sum = 0.0f;
      for (int w = 0; w < kSortWarps; ++w)
        sum = __fadd_rn(sum, wsum[threadIdx.x * kSortWarps + w]);
      partial[p] = sum;
    }
  }
}

// K25 at 64 < n <= 1,024: the same network over `slots` (a power of two
// >= n) keys in shared memory, a warp a column.  Per warp: slots u64 x
// keys, slots u32 y keys, then |d| and the sign (n f32 each).
__global__ void __launch_bounds__(kSortWarps * 32)
    swd_sort_smem_kernel(const float* __restrict__ ox,
                         const float* __restrict__ oy, long long ncols,
                         int nx, int ny, int n, int slots,
                         const int* __restrict__ map_x,
                         const int* __restrict__ map_y,
                         const int* __restrict__ inv_start,
                         const int* __restrict__ inv_order, float count,
                         float* __restrict__ gx,
                         float* __restrict__ partial) {
  extern __shared__ unsigned long long sbuf[];
  __shared__ float wsum[kSortWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned long long* xs =
      sbuf + (long long)warp * (slots + slots / 2 + n);
  unsigned* ys = (unsigned*)(xs + slots);
  float* ad = (float*)(ys + slots);
  float* gm = ad + n;
  const long long col = (long long)blockIdx.x * kSortWarps + warp;
  float lsum = 0.0f;
  if (col < ncols) {
    const float* cx = ox + col * nx;
    const float* cy = oy + col * ny;
    for (int r = lane; r < slots; r += 32) {
      xs[r] = r < n ? x_key(cx[map_x ? __ldg(map_x + r) : r], r) : kPadX;
      ys[r] = r < n ? sort_key(cy[map_y ? __ldg(map_y + r) : r]) : kPadY;
    }
    __syncwarp();
    for (int k = 2; k <= slots; k <<= 1) {
      for (int jd = k >> 1; jd > 0; jd >>= 1) {
        for (int p = lane; p < slots / 2; p += 32) {
          // the pair's lower slot: p with a zero inserted at bit jd
          const int i = ((p & ~(jd - 1)) << 1) | (p & (jd - 1));
          const int l = i | jd;
          const bool up = (i & k) == 0;
          const unsigned long long a = xs[i], b = xs[l];
          if ((b < a) == up) { xs[i] = b; xs[l] = a; }
          const unsigned c = ys[i], e = ys[l];
          if ((e < c) == up) { ys[i] = e; ys[l] = c; }
        }
        __syncwarp();
      }
    }
    const float inv = __fdiv_rn(1.0f, count);
    for (int s = lane; s < n; s += 32) pair_rank(xs[s], ys[s], inv, ad, gm);
    __syncwarp();
    lsum = column_tail(ad, gm, n, nx, map_x != nullptr, inv_start,
                       inv_order, gx + col * nx, lane);
  }
  sort_block_partial(lsum, wsum, partial);
}

// loss = (sum of the partials, in a fixed order) / count
__global__ void __launch_bounds__(1024)
    swd_sum_kernel(const float* __restrict__ partial, long long nb,
                   float count, float* __restrict__ loss) {
  __shared__ float s[1024];
  float acc = 0.0f;
  for (long long i = threadIdx.x; i < nb; i += 1024)
    acc = __fadd_rn(acc, partial[i]);
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = 512; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w)
      s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[0] = __fdiv_rn(s[0], count);
}

__device__ __forceinline__ int first_patch(int pos, int p, int s) {
  // smallest i >= 0 with i * s + p > pos
  const int num = pos - p + 1;
  return num <= 0 ? 0 : (num + s - 1) / s;
}

// out[c, t, h, w] = 2 sum over the patches (f, i, j) covering the voxel of
// the patch gradient G[(i cw + j) cf + f, q(c, t - f st, h - i s, w - j s)]
__global__ void swd_fold_first_kernel(const float* __restrict__ G,
                                      SwdGeom g, float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)g.C * g.T * g.H * g.W;
  if (idx >= n) return;
  const int w = (int)(idx % g.W);
  const int h = (int)((idx / g.W) % g.H);
  const int t = (int)((idx / ((long long)g.W * g.H)) % g.T);
  const int c = (int)(idx / ((long long)g.W * g.H * g.T));
  const int d = g.C * g.pt * g.p * g.p;
  const int f_lo = first_patch(t, g.pt, g.st);
  const int f_hi = min(g.cf - 1, t / g.st);
  const int i_lo = first_patch(h, g.p, g.s);
  const int i_hi = min(g.ch - 1, h / g.s);
  const int j_lo = first_patch(w, g.p, g.s);
  const int j_hi = min(g.cw - 1, w / g.s);
  float acc = 0.0f;
  for (int i = i_lo; i <= i_hi; ++i) {
    for (int j = j_lo; j <= j_hi; ++j) {
      const long long row0 = (long long)(i * g.cw + j) * g.cf;
      const int qhw = (h - i * g.s) * g.p + (w - j * g.s);
      for (int f = f_lo; f <= f_hi; ++f) {
        const int q = (c * g.pt + (t - f * g.st)) * g.p * g.p + qhw;
        acc = __fadd_rn(acc, G[(row0 + f) * d + q]);
      }
    }
  }
  out[idx] = __fmul_rn(2.0f, acc);
}

// ---------------------------------------------------------------------------
// the redesign: swd_tile_gemm_kernel (K24, K26's first pass) and
// swd_fold_t_kernel (K26's fold)
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 256;  // 16 x 16 threads of 8 x 8 outputs
constexpr int kBM = 128;          // rows of a block's output tile
constexpr int kBN = 128;          // its columns
constexpr int kBK = 16;           // reduction entries a stage
constexpr int kLd = kBM + 4;      // floats a staged k-row (16-B aligned)
constexpr int kStageFloats = 2 * kBK * kLd;   // A and B of one stage
constexpr int kLoads = kBM * kBK / kGemmThreads;  // loads an operand
constexpr int kGemmSmem = 2 * kStageFloats * (int)sizeof(float);
static_assert(kGemmSmem <= 48 * 1024, "launch without the opt-in attribute");
constexpr int kFoldT = 32;        // a fold block: 32 t (a warp) x 8 w
constexpr int kFoldW = 8;
constexpr int kFoldBatch = 4;     // a fold thread's loads in flight

static_assert(kBM == 128 && kBN == 128 && kGemmThreads == 256
                  && kBK % 2 == 0 && kGemmThreads % kBK == 0,
              "the thread and loader maps below assume these sizes");

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// a thread's reduction entry q = ((c pt + dt) p + dy) p + dx in K24's
// gather, stepped forward by whole stages
struct KCursor {
  int dx, dy, dt, c;
  __device__ __forceinline__ void advance(int by, const SwdGeom& g) {
    dx += by;
    while (dx >= g.p) {
      dx -= g.p;
      if (++dy == g.p) {
        dy = 0;
        if (++dt == g.pt) {
          dt = 0;
          ++c;
        }
      }
    }
  }
  __device__ __forceinline__ int offset(const SwdGeom& g) const {
    return ((c * g.T + dt) * g.H + dy) * g.W + dx;
  }
};

__device__ __forceinline__ void store4(float* p, long long room, float v0,
                                       float v1, float v2, float v3) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (room >= 4 && (a & 15) == 0) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v0, v1, v2, v3));
  } else if (room >= 4 && (a & 7) == 0) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v0, v1));
    __stcs(reinterpret_cast<float2*>(p + 2), make_float2(v2, v3));
  } else {
    if (room > 0) __stcs(p, v0);
    if (room > 1) __stcs(p + 1, v1);
    if (room > 2) __stcs(p + 2, v2);
    if (room > 3) __stcs(p + 3, v3);
  }
}

// C[m, n] = sum_k A(m, k) B(k, n), one fmaf chain from 0 with k
// ascending, plus one fmaf(0, 0, .) step where K % 32 != 0 (the first
// design's padding); C row m at out + m ldc.  kProject (K24): A = rand (M
// = P rows of K = d, A(m, k) = a[m K + k]), B(k, n) = v at patch column
// n's entry k, n = (i cw + j) cf + f.  Otherwise (K26's first pass): A(m,
// k) = a[k M + m] (rand, M = d, K = P), B(k, n) = b[k N + n] (gx, N = cf
// ch cw): the scratch transposed.
template <bool kProject>
__global__ void __launch_bounds__(kGemmThreads, 2)
    swd_tile_gemm_kernel(const float* __restrict__ a,
                         const float* __restrict__ b, int M, int N, int K,
                         SwdGeom g, long long ldc, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int colbase[kBN];  // K24: v's offset of each column's patch

  const int tid = threadIdx.x;
  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + kBN - 1) / kBN;
  // the axis with fewer tiles runs fastest over neighbouring blocks, so
  // they share their other operand's tile in L2
  int mt, nt;
  if (tiles_m <= tiles_n) {
    mt = blockIdx.x % tiles_m;
    nt = blockIdx.x / tiles_m;
  } else {
    nt = blockIdx.x % tiles_n;
    mt = blockIdx.x / tiles_n;
  }
  const int m0 = mt * kBM, n0 = nt * kBN;

  // loader maps.  kProject: lanes along k (kBK entries of 32 / kBK rows
  // or columns a warp); rows / columns lr + kRowStep i.  Otherwise lanes
  // along the contiguous row: row or column lr, entries lk + kKStep i.
  constexpr int kRowStep = kGemmThreads / kBK;
  constexpr int kKStep = kGemmThreads / 128;
  const int lk = kProject ? (tid % kBK) : (tid >> 7);
  const int lr = kProject ? (tid / kBK) : (tid & 127);
  KCursor cur{lk, 0, 0, 0};
  if constexpr (kProject) {
    cur.advance(0, g);
    if (tid < kBN) {
      const int n = n0 + tid;
      int bv = -1;
      if (n < N) {
        const int f = n % g.cf;
        const int loc = n / g.cf;
        bv = f * g.st * g.H * g.W + (loc / g.cw) * g.s * g.W
            + (loc % g.cw) * g.s;
      }
      colbase[tid] = bv;
    }
    __syncthreads();
  }

  float breg[kLoads];  // kProject: the gathered B entries of a stage

  // issue stage s's copies into ring slot `slot` (cp.async) and, for K24,
  // gather its B entries into breg
  auto issue = [&](int s, int slot) {
    float* As = smem + slot * kStageFloats;
    float* Bs = As + kBK * kLd;
    const int k0 = s * kBK;
    if constexpr (kProject) {
      const int k = k0 + lk;
      const bool kin = k < K;
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int r = lr + kRowStep * i;
        const bool ok = kin && m0 + r < M;
        cp_async4(As + lk * kLd + r,
                  ok ? a + (long long)(m0 + r) * K + k : a, ok);
      }
      const int off = kin ? cur.offset(g) : 0;
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int cb = colbase[lr + kRowStep * i];
        breg[i] = (kin && cb >= 0) ? __ldg(b + cb + off) : 0.0f;
      }
      cur.advance(kBK, g);
    } else {
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int kk = lk + kKStep * i;
        const int k = k0 + kk;
        const bool oka = k < K && m0 + lr < M;
        const bool okb = k < K && n0 + lr < N;
        cp_async4(As + kk * kLd + lr,
                  oka ? a + (long long)k * M + m0 + lr : a, oka);
        cp_async4(Bs + kk * kLd + lr,
                  okb ? b + (long long)k * N + n0 + lr : b, okb);
      }
    }
    cp_async_commit();
  };
  auto stage_breg = [&](int slot) {
    if constexpr (kProject) {
      float* Bs = smem + slot * kStageFloats + kBK * kLd;
#pragma unroll
      for (int i = 0; i < kLoads; ++i)
        Bs[lk * kLd + lr + kRowStep * i] = breg[i];
    }
  };

  // compute map: warp w's 4 x 8 threads, (ty, tx) in 16 x 16; a thread's
  // rows ty 4 + {0..3} and 64 + ty 4 + {0..3}, its columns likewise
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  auto step = [&](const float* As, const float* Bs, int kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kLd + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + kk * kLd + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * kLd + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + kk * kLd + 64 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    // columns outer (measured 2-3% faster than rows outer)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  };

  const int nst = (K + kBK - 1) / kBK;
  if (nst > 0) {
    issue(0, 0);
    stage_breg(0);
    if (nst > 1) {
      issue(1, 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  }
  for (int s = 0; s < nst; ++s) {
    const float* As = smem + (s & 1) * kStageFloats;
    const float* Bs = As + kBK * kLd;
    const int kr = K - s * kBK;
    if (kr >= kBK) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) step(As, Bs, kk);
    } else {
      for (int kk = 0; kk < kr; ++kk) step(As, Bs, kk);
    }
    if (s + 1 < nst) {
      stage_breg((s + 1) & 1);
      cp_async_wait<0>();
    }
    __syncthreads();
    if (s + 2 < nst) issue(s + 2, s & 1);
  }
  // the first design's zero steps: fmaf(0, 0, acc) == acc + 0
  const bool zero_step = (K % kChunk) != 0;

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= N) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = zero_step ? __fadd_rn(acc[i][h * 4 + j], 0.0f)
                         : acc[i][h * 4 + j];
      store4(out + (long long)m * ldc + n, (long long)N - n, v[0], v[1],
             v[2], v[3]);
    }
  }
}

// out[c, t, h, w] = 2 sum over the patches (f, i, j) covering the voxel of
// the patch gradient G[q(c, t - f st, h - i s, w - j s), (i cw + j) cf + f]
// (the scratch transposed, row pitch ldg), added in (i, j, f) order as
// swd_fold_first_kernel adds them.  A block: 32 t (lanes) x 8 w (warps) of
// one (c, h); its outputs pass through shared memory to leave w-fastest.
// Bound: bytes, the scratch read once.
__global__ void __launch_bounds__(kFoldT * kFoldW)
    swd_fold_t_kernel(const float* __restrict__ G, long long ldg, SwdGeom g,
                      float* __restrict__ out) {
  __shared__ float tile[kFoldW][kFoldT + 1];
  const int tblocks = (g.T + kFoldT - 1) / kFoldT;
  const int wblocks = (g.W + kFoldW - 1) / kFoldW;
  long long bid = blockIdx.x;
  const int tb = (int)(bid % tblocks);
  bid /= tblocks;
  const int wb = (int)(bid % wblocks);
  bid /= wblocks;
  const int h = (int)(bid % g.H);
  const int c = (int)(bid / g.H);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = tb * kFoldT + lane, w = wb * kFoldW + warp;
  float acc = 0.0f;
  if (t < g.T && w < g.W) {
    const int f_lo = first_patch(t, g.pt, g.st);
    const int f_hi = min(g.cf - 1, t / g.st);
    const int i_lo = first_patch(h, g.p, g.s);
    const int i_hi = min(g.ch - 1, h / g.s);
    const int j_lo = first_patch(w, g.p, g.s);
    const int j_hi = min(g.cw - 1, w / g.s);
    const int total = max(0, i_hi - i_lo + 1) * max(0, j_hi - j_lo + 1)
        * max(0, f_hi - f_lo + 1);
    // the covering patches in (i, j, f) order, kFoldBatch loads in flight
    // before their adds
    int i = i_lo, j = j_lo, f = f_lo;
    for (int e0 = 0; e0 < total; e0 += kFoldBatch) {
      float val[kFoldBatch];
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u) {
        val[u] = 0.0f;
        if (e0 + u < total) {
          const int q = (c * g.pt + (t - f * g.st)) * g.p * g.p
              + (h - i * g.s) * g.p + (w - j * g.s);
          val[u] =
              __ldcs(G + (long long)q * ldg + (i * g.cw + j) * g.cf + f);
          if (++f > f_hi) {
            f = f_lo;
            if (++j > j_hi) {
              j = j_lo;
              ++i;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u)
        if (e0 + u < total) acc = __fadd_rn(acc, val[u]);
    }
  }
  tile[warp][lane] = __fmul_rn(2.0f, acc);
  __syncthreads();
  const int wo = threadIdx.x % kFoldW, to = threadIdx.x / kFoldW;
  const int t2 = tb * kFoldT + to, w2 = wb * kFoldW + wo;
  if (t2 < g.T && w2 < g.W)
    out[(((long long)c * g.T + t2) * g.H + h) * g.W + w2] = tile[wo][to];
}

SwdGeom make_geom(int C, int T, int H, int W, int pt, int p, int st, int s) {
  SwdGeom g{C, T, H, W, pt, p, st, s, 0, 0, 0};
  g.cf = (T - pt) / st + 1;
  g.ch = (H - p) / s + 1;
  g.cw = (W - p) / s + 1;
  return g;
}

template <bool kProject>
int launch_gemm_first(const float* a, const float* b, int M, int N, int K,
                      const SwdGeom& g, float* out, cudaStream_t s) {
  const long long blocks =
      (long long)((M + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  if (blocks <= 0) return 0;
  const int smem = (int)sizeof(float) * 2 * kChunk * kPitch
      + (int)sizeof(int) * ((kProject ? K : 0) + kTile);
  auto k = swd_gemm_first_kernel<kProject>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  k<<<(unsigned int)blocks, kThreads, smem, s>>>(a, b, M, N, K, g, out);
  return (int)cudaGetLastError();
}

template <bool kProject>
int launch_tile_gemm(const float* a, const float* b, int M, int N, int K,
                     const SwdGeom& g, long long ldc, float* out,
                     cudaStream_t s) {
  const long long blocks =
      (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL || N > 0x7fffffff - kBN)
    return (int)cudaErrorInvalidValue;
  // 33 KB of dynamic shared memory: under the 48 KB default
  swd_tile_gemm_kernel<kProject><<<(unsigned int)blocks, kGemmThreads,
                                   kGemmSmem, s>>>(a, b, M, N, K, g, ldc,
                                                   out);
  return (int)cudaGetLastError();
}

// The row pitch of K26's scratch: the patch columns rounded up to 4.
long long grad_pitch(int C, int T, int H, int W, int pt, int p, int st,
                     int s) {
  const SwdGeom g = make_geom(C, T, H, W, pt, p, st, s);
  return ((long long)g.cf * g.ch * g.cw + 3) / 4 * 4;
}

}  // namespace

// K24: out (P, ch cw, cf) f32.
VL3D_API int vl3d_swd_project(const float* v, const float* rand, int C, int T,
                              int H, int W, int pt, int p, int st, int s,
                              int P, float* out, void* stream) {
  const SwdGeom g = make_geom(C, T, H, W, pt, p, st, s);
  const int d = C * pt * p * p;
  const int N = g.cf * g.ch * g.cw;
  return launch_tile_gemm<true>(rand, v, P, N, d, g, N, out,
                                (cudaStream_t)stream);
}

// K24's first design (64 x 64 tiles of 4 x 4, one staging buffer),
// kept for comparison: the same bits as vl3d_swd_project.
VL3D_API int vl3d_swd_project_first(const float* v, const float* rand, int C,
                                    int T, int H, int W, int pt, int p,
                                    int st, int s, int P, float* out,
                                    void* stream) {
  const SwdGeom g = make_geom(C, T, H, W, pt, p, st, s);
  const int d = C * pt * p * p;
  return launch_gemm_first<true>(rand, v, P, g.cf * g.ch * g.cw, d, g, out,
                                 (cudaStream_t)stream);
}

// K25: gx (ncols, nx) and the loss (one f32); partial holds
// ceil(ncols / 8) f32.  map_x / map_y: n source indices of the side
// shorter than n, or null; with map_x, inv_start (nx + 1) and inv_order
// (n) list each source's copies in r order (losses/swd.py:match_inverse).
// n <= 64 takes the network in registers, longer columns the network in
// shared memory.
VL3D_API int vl3d_swd_sort_l1(const float* ox, const float* oy,
                              long long ncols, int nx, int ny, int n,
                              const int* map_x, const int* map_y,
                              const int* inv_start, const int* inv_order,
                              float count, float* partial, float* loss,
                              float* gx, void* stream) {
  if (ncols <= 0 || n <= 0 || n > kSmemSlotsMax
      || (map_x != nullptr && (inv_start == nullptr || inv_order == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (ncols + kSortWarps - 1) / kSortWarps;
  if (n <= kNetSlots) {
    const long long nb = (ncols + kNetCols - 1) / kNetCols;
    swd_sort_net_kernel<<<(unsigned int)nb, kNetCols * 8, 0, s>>>(
        ox, oy, ncols, nx, ny, n, map_x, map_y, inv_start, inv_order, count,
        gx, partial, blocks);
  } else {
    int slots = kNetSlots;
    while (slots < n) slots <<= 1;
    const int smem = (int)sizeof(unsigned long long) * kSortWarps
        * (slots + slots / 2 + n);
    cudaFuncSetAttribute(swd_sort_smem_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    swd_sort_smem_kernel<<<(unsigned int)blocks, kSortWarps * 32, smem, s>>>(
        ox, oy, ncols, nx, ny, n, slots, map_x, map_y, inv_start, inv_order,
        count, gx, partial);
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  swd_sum_kernel<<<1, 1024, 0, s>>>(partial, blocks, count, loss);
  return (int)cudaGetLastError();
}

// K25's first design (each entry's rank by a scan of its column in shared
// memory), kept for comparison: on finite inputs the same bits as
// vl3d_swd_sort_l1.
VL3D_API int vl3d_swd_sort_l1_first(const float* ox, const float* oy,
                                    long long ncols, int nx, int ny, int n,
                                    const int* map_x, const int* map_y,
                                    float count, float* partial, float* loss,
                                    float* gx, void* stream) {
  if (ncols <= 0 || n <= 0 || n > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (ncols + kSortWarps - 1) / kSortWarps;
  const int smem = (int)sizeof(float) * kSortWarps * 4 * n;
  cudaFuncSetAttribute(swd_sort_l1_first_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  swd_sort_l1_first_kernel<<<(unsigned int)blocks, kSortWarps * 32, smem,
                             s>>>(ox, oy, ncols, nx, ny, n, map_x, map_y,
                                  count, gx, partial);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  swd_sum_kernel<<<1, 1024, 0, s>>>(partial, blocks, count, loss);
  return (int)cudaGetLastError();
}

// K26: out (C, T, H, W) f32; scratch holds d x grad_pitch f32 (the patch
// gradients, patch column fastest).
VL3D_API int vl3d_swd_project_grad(const float* gx, const float* rand, int C,
                                   int T, int H, int W, int pt, int p, int st,
                                   int s, int P, float* scratch, float* out,
                                   void* stream) {
  const SwdGeom g = make_geom(C, T, H, W, pt, p, st, s);
  const int d = C * pt * p * p;
  const long long ld = grad_pitch(C, T, H, W, pt, p, st, s);
  cudaStream_t cs = (cudaStream_t)stream;
  int err = launch_tile_gemm<false>(rand, gx, d, g.cf * g.ch * g.cw, P, g,
                                    ld, scratch, cs);
  if (err != 0) return err;
  const long long blocks = (long long)((T + kFoldT - 1) / kFoldT)
      * ((W + kFoldW - 1) / kFoldW) * H * C;
  if (blocks <= 0) return 0;
  swd_fold_t_kernel<<<(unsigned int)blocks, kFoldT * kFoldW, 0, cs>>>(
      scratch, ld, g, out);
  return (int)cudaGetLastError();
}

// The f32 count of vl3d_swd_project_grad's scratch.
VL3D_API long long vl3d_swd_project_grad_scratch(int C, int T, int H, int W,
                                                 int pt, int p, int st,
                                                 int s) {
  return (long long)C * pt * p * p * grad_pitch(C, T, H, W, pt, p, st, s);
}

// K26's first design: the GEMM of the first design into a (cf ch cw, d)
// scratch, then the fold with w fastest (swd_fold_first_kernel), kept for
// comparison: the same bits as vl3d_swd_project_grad.
VL3D_API int vl3d_swd_project_grad_first(const float* gx, const float* rand,
                                         int C, int T, int H, int W, int pt,
                                         int p, int st, int s, int P,
                                         float* scratch, float* out,
                                         void* stream) {
  const SwdGeom g = make_geom(C, T, H, W, pt, p, st, s);
  const int d = C * pt * p * p;
  cudaStream_t cs = (cudaStream_t)stream;
  int err = launch_gemm_first<false>(gx, rand, g.cf * g.ch * g.cw, d, P, g,
                                     scratch, cs);
  if (err != 0) return err;
  const long long n = (long long)C * T * H * W;
  swd_fold_first_kernel<<<grid_for(n), kBlock, 0, cs>>>(scratch, g, out);
  return (int)cudaGetLastError();
}
