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
// d) in 64 x 64 tiles, 256 threads of 4 x 4 register tiles, the d
// channels staged through shared memory 32 at a time (pitch 65, as K11,
// csrc/nn_argmin.cu).  Every output sums its d products in one fixed
// order (q ascending, one fmaf each), whatever its place in the tile, so
// equal patches (a static region over time) give bit-equal projections
// and K25's ties break as JAX's.  f32 FMA, no tensor cores (TF32 is not
// exact).  Bound: operations, 2 P d N: 93.5 GFLOP on the ref view's x
// (p 11, pt 3, s 4: 50 x 43 x 78 locations, d 1,089), 29.3 on the other
// view's (p 3, s 2: 50 x 89 x 159, d 81) at 67 TFLOP/s.
//
// K25 takes the x and y columns (cfx and cfy long), brings them to one
// length n (the shorter side through an index map of n entries shared by
// every column: its entries tiled, then those the host's permutation
// picks, _match_lengths), sorts both stably and pairs them by rank.  The
// rank of entry i is #{k: v_k < v_i} + #{k < i: v_k == v_i}: stable by
// construction (jnp.sort's gradient routes ties in index order) and exact;
// O(n^2) compares a column in shared memory, n <= 1,024.  It writes
//   gx[col, src] = sum over the copies r of src of sign+(sx_r - sy_r) / N
// (sign+(0) = +1, the jnp.abs gradient at 0; N the matched element
// count), and per-block partial sums of |sx_r - sy_r|, which a second
// pass adds in a fixed order: the loss is sum / N, reproducible, with no
// float atomics.  One warp per column, 8 columns a block.  Bound: bytes,
// the columns read once and gx written once (0.52 GB ref view, 2.17 GB
// other view at 3.35 TB/s); it also makes 2 n^2 compares a column.
//
// K26 is the gradient of the loss in the input x (v = 2 x - 1):
//   dL/dx[c, t, h, w] = 2 sum_{P, f, i, j covering the voxel}
//       rand[P, c, t - f st, h - i s, w - j s] gx[P, i cw + j, f],
// as two passes: the (N x P) (P x d) GEMM of patch gradients (K24's tile
// code with its operands' loaders swapped) into a scratch, then a fold,
// one thread per voxel summing its covering patches in a fixed order (i,
// j, f ascending).  Deterministic, no atomics.  Bound: operations, as
// K24's on x.
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
    swd_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    int M, int N, int K, SwdGeom g, float* __restrict__ out) {
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

__global__ void __launch_bounds__(kSortWarps * 32)
    swd_sort_l1_kernel(const float* __restrict__ ox,
                       const float* __restrict__ oy, long long ncols, int nx,
                       int ny, int n, const int* __restrict__ map_x,
                       const int* __restrict__ map_y, float count,
                       float* __restrict__ gx, float* __restrict__ partial) {
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
__global__ void swd_fold_kernel(const float* __restrict__ G, SwdGeom g,
                                float* __restrict__ out) {
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

SwdGeom make_geom(int C, int T, int H, int W, int pt, int p, int st, int s) {
  SwdGeom g{C, T, H, W, pt, p, st, s, 0, 0, 0};
  g.cf = (T - pt) / st + 1;
  g.ch = (H - p) / s + 1;
  g.cw = (W - p) / s + 1;
  return g;
}

template <bool kProject>
int launch_gemm(const float* a, const float* b, int M, int N, int K,
                const SwdGeom& g, float* out, cudaStream_t s) {
  const long long blocks =
      (long long)((M + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  if (blocks <= 0) return 0;
  const int smem = (int)sizeof(float) * 2 * kChunk * kPitch
      + (int)sizeof(int) * ((kProject ? K : 0) + kTile);
  auto k = swd_gemm_kernel<kProject>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  k<<<(unsigned int)blocks, kThreads, smem, s>>>(a, b, M, N, K, g, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K24: out (P, ch cw, cf) f32.
VL3D_API int vl3d_swd_project(const float* v, const float* rand, int C, int T,
                              int H, int W, int pt, int p, int st, int s,
                              int P, float* out, void* stream) {
  const SwdGeom g = make_geom(C, T, H, W, pt, p, st, s);
  const int d = C * pt * p * p;
  return launch_gemm<true>(rand, v, P, g.cf * g.ch * g.cw, d, g, out,
                           (cudaStream_t)stream);
}

// K25: gx (ncols, nx) and the loss (one f32); partial holds
// ceil(ncols / 8) f32.  map_x / map_y: n source indices of the side
// shorter than n, or null.
VL3D_API int vl3d_swd_sort_l1(const float* ox, const float* oy,
                              long long ncols, int nx, int ny, int n,
                              const int* map_x, const int* map_y,
                              float count, float* partial, float* loss,
                              float* gx, void* stream) {
  if (ncols <= 0 || n <= 0 || n > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (ncols + kSortWarps - 1) / kSortWarps;
  const int smem = (int)sizeof(float) * kSortWarps * 4 * n;
  cudaFuncSetAttribute(swd_sort_l1_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  swd_sort_l1_kernel<<<(unsigned int)blocks, kSortWarps * 32, smem, s>>>(
      ox, oy, ncols, nx, ny, n, map_x, map_y, count, gx, partial);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  swd_sum_kernel<<<1, 1024, 0, s>>>(partial, blocks, count, loss);
  return (int)cudaGetLastError();
}

// K26: out (C, T, H, W) f32; scratch holds cf ch cw d f32.
VL3D_API int vl3d_swd_project_grad(const float* gx, const float* rand, int C,
                                   int T, int H, int W, int pt, int p, int st,
                                   int s, int P, float* scratch, float* out,
                                   void* stream) {
  const SwdGeom g = make_geom(C, T, H, W, pt, p, st, s);
  const int d = C * pt * p * p;
  cudaStream_t cs = (cudaStream_t)stream;
  int err = launch_gemm<false>(gx, rand, g.cf * g.ch * g.cw, d, P, g, scratch,
                               cs);
  if (err != 0) return err;
  const long long n = (long long)C * T * H * W;
  swd_fold_kernel<<<grid_for(n), kBlock, 0, cs>>>(scratch, g, out);
  return (int)cudaGetLastError();
}
