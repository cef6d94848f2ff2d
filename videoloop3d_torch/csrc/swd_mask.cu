// K27 swd_mask_sort and K28 swd_mask_l1: the swd loss's mask branch.
//
// Replaces videoloop3d_tpu/losses/swd.py:79-93 (with the sorts and the mean
// L1 of :98-101): with a loop mask, each of the P projections is ONE row over
// all its patches.  x's row holds its cf ch cw projected patches in the conv
// output's (cf, ch cw) order; y's row holds its patches in the mask order
// (the patches away from the mask, then those touching it, repeated
// mask_patches_factor times); `_match_lengths` brings the shorter row to the
// other's length n (tiled, then a permutation of the tiled row).  Both rows
// are sorted (stably, as jnp.sort) and the loss is mean |sx - sy| over P n
// entries; its gradient in x is sign+(sx - sy) / (P n) at each rank (+1 at
// 0, as jnp.abs's derivative), routed back through the sort's permutation
// and summed over an entry's copies.
//
// The rows come straight from K24's (P, ch cw, cf) layout through `gather`,
// an int32 map of the n matched entries to their offset in a projection's
// row of that layout (the matching, the mask order and the transpose to the
// conv order composed on the host side as index maps).  Rows run to 10^5-10^6
// entries (K25's shared-memory rank sort takes 1,024), so:
//
// K27: a per-row stable LSD radix sort of 32-bit order-preserving keys (the
// float's bits, sign-flipped; -0 taken as +0, so a comparison sort's ties
// are the radix sort's ties), four passes of 8 bits, with the matched index
// as an int32 payload (x) or without one (y).  A pass: per-(row, tile)
// digit histograms; their exclusive scan within the row, digit-major, so
// every (digit, tile) gets its output offset; a stable scatter, in which a
// tile of 2,048 keys walks rounds of 256 in order and ranks each key among
// the same digit's keys before it (warp match within a warp, per-warp
// counts across the block).  Each pass is stable, so ties keep their index
// order, as jnp.sort's and the plain version's torch.sort(stable=True).
//
// K28: the L1 over ranks in one pass (the |d| summed per block in double,
// the block sums in a fixed order: no atomics, deterministic), the sign
// written at the rank's x payload (a permutation: no conflicts), then the
// gradient of each x entry of K24's layout summed over its matched copies
// in increasing matched index: the tiled copies e, e + n_x, ... and the
// deficit's copies tiled + j for the j with perm[j] = e + q n_x (from the
// inverse permutation), as the plain version's index_add_ sums them.
//
// Bound on the H100: bytes.  Read both rows once (4 B a key) and write the
// gradient once (4 B an x entry).  The sort moves each key and payload 4
// times through device memory (8 passes of reads and writes, 16 B a
// key-payload pair a pass), plus the histograms and the signs.
#include "common.cuh"

namespace {

constexpr int kSortThreads = 256;
constexpr int kSortItems = 8;
constexpr int kSortTile = kSortThreads * kSortItems;
constexpr int kScanThreads = 1024;
constexpr int kMaxReps = 64;

__device__ __forceinline__ unsigned f2key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;               // -0 sorts as +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key2f(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// keys[p n + i] = key of src[p row + gather[i]]; pay[p n + i] = i
__global__ void sort_load_kernel(const float* __restrict__ src,
                                 long long row, const int* __restrict__ gather,
                                 long long n, unsigned* __restrict__ keys,
                                 int* __restrict__ pay) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long p = blockIdx.y;
  keys[p * n + i] = f2key(src[p * row + gather[i]]);
  if (pay != nullptr) pay[p * n + i] = (int)i;
}

// hist[(p 256 + digit) ntiles + tile] = count of the tile's keys
__global__ void sort_hist_kernel(const unsigned* __restrict__ keys,
                                 long long n, int shift, int ntiles,
                                 int* __restrict__ hist) {
  __shared__ int cnt[256];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const long long row = (long long)blockIdx.y * n;
  const long long start = (long long)blockIdx.x * kSortTile;
  for (int r = 0; r < kSortItems; ++r) {
    const long long i = start + r * kSortThreads + threadIdx.x;
    if (i < n) atomicAdd(&cnt[(keys[row + i] >> shift) & 255u], 1);
  }
  __syncthreads();
  hist[((long long)blockIdx.y * 256 + threadIdx.x) * ntiles + blockIdx.x] =
      cnt[threadIdx.x];
}

// exclusive scan of one row's 256 ntiles counts, in place (one block a row)
__global__ void sort_scan_kernel(int* __restrict__ hist, int len) {
  __shared__ int wsum[kScanThreads / 32];
  __shared__ int carry;
  int* h = hist + (long long)blockIdx.x * len;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < len; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < len ? h[i] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[w] = x;
    __syncthreads();
    if (w == 0) {
      int s = wsum[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      wsum[lane] = s;
    }
    __syncthreads();
    const int excl = carry + (w > 0 ? wsum[w - 1] : 0) + x - v;
    if (i < len) h[i] = excl;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = excl + v;
    __syncthreads();
  }
}

// the stable scatter of one tile into its digits' scanned offsets
__global__ void sort_scatter_kernel(const unsigned* __restrict__ kin,
                                    const int* __restrict__ pin,
                                    unsigned* __restrict__ kout,
                                    int* __restrict__ pout,
                                    const int* __restrict__ offs, long long n,
                                    int ntiles, int shift) {
  __shared__ int base[256];
  __shared__ int wcnt[kSortThreads / 32][256];
  const long long row = (long long)blockIdx.y * n;
  const long long start = (long long)blockIdx.x * kSortTile;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  base[threadIdx.x] =
      offs[((long long)blockIdx.y * 256 + threadIdx.x) * ntiles + blockIdx.x];
  for (int r = 0; r < kSortItems; ++r) {
    const long long first = start + r * kSortThreads;
    if (first >= n) break;                    // uniform over the block
    const long long i = first + threadIdx.x;
    const bool valid = i < n;
    const unsigned k = valid ? kin[row + i] : 0u;
    const int d = valid ? (int)((k >> shift) & 255u) : 256;
    for (int j = threadIdx.x; j < (kSortThreads / 32) * 256;
         j += kSortThreads) {
      (&wcnt[0][0])[j] = 0;
    }
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (valid && rank == 0) wcnt[w][d] = __popc(peers);
    __syncthreads();
    if (valid) {
      int off = base[d] + rank;
      for (int w2 = 0; w2 < w; ++w2) off += wcnt[w2][d];
      kout[row + off] = k;
      if (pout != nullptr) pout[row + off] = pin[row + i];
    }
    __syncthreads();
    int sum = 0;
    for (int w2 = 0; w2 < kSortThreads / 32; ++w2) sum += wcnt[w2][threadIdx.x];
    base[threadIdx.x] += sum;
    __syncthreads();
  }
}

// d = sx - sy at every rank: |d| summed per block (double), sign+ at x's
// payload
__global__ void mask_l1_kernel(const unsigned* __restrict__ kx,
                               const unsigned* __restrict__ ky,
                               const int* __restrict__ ix, long long total,
                               long long n, float inv, float* __restrict__ gm,
                               double* __restrict__ partial) {
  __shared__ double red[kSortThreads];
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  double a = 0.0;
  if (idx < total) {
    const float d = __fsub_rn(key2f(kx[idx]), key2f(ky[idx]));
    a = (double)fabsf(d);
    const long long p = idx / n;
    gm[p * n + ix[idx]] = d >= 0.0f ? inv : -inv;
  }
  red[threadIdx.x] = a;
  __syncthreads();
  for (int s = kSortThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = red[0];
}

__global__ void mask_loss_kernel(const double* __restrict__ partial, int nb,
                                 float count, float* __restrict__ loss) {
  __shared__ double red[kScanThreads];
  double a = 0.0;
  for (int i = threadIdx.x; i < nb; i += kScanThreads) a += partial[i];
  red[threadIdx.x] = a;
  __syncthreads();
  for (int s = kScanThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *loss = __fdiv_rn((float)red[0], count);
}

// gx (P, L, cf) of K24's layout: the entry e = f L + l of x's conv-order row
// sums its matched copies' signs in increasing matched index
__global__ void mask_grad_kernel(const float* __restrict__ gm, long long n,
                                 long long n_x, int L, int cf,
                                 long long tiled, long long deficit,
                                 const int* __restrict__ invp,
                                 float* __restrict__ gx) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long p = blockIdx.y;
  if (idx >= n_x) return;
  const long long e = idx;
  const float* g = gm + p * n;
  float acc = 0.0f;
  if (n_x == n) {
    acc = g[e];
  } else {
    const int reps = (int)(tiled / n_x);
    for (int k = 0; k < reps; ++k) acc = __fadd_rn(acc, g[e + k * n_x]);
    if (deficit > 0) {
      long long js[kMaxReps];
      int m = 0;
      for (int q = 0; q < reps; ++q) {
        const long long j = invp[e + q * n_x];
        if (j < deficit) {                    // insertion, ascending
          int t = m++;
          while (t > 0 && js[t - 1] > j) {
            js[t] = js[t - 1];
            --t;
          }
          js[t] = j;
        }
      }
      for (int t = 0; t < m; ++t) acc = __fadd_rn(acc, g[tiled + js[t]]);
    }
  }
  const long long f = e / L, l = e % L;
  gx[p * n_x + l * cf + f] = acc;
}

}  // namespace

// K27: sort P rows of n keys read from src (P rows of `row` floats) through
// gather (n int32 offsets).  keys/keys_alt (P n u32), pay/pay_alt (P n int32,
// or null without a payload), hist (P 256 ntiles int32) are the caller's.
// The sorted keys (and payload) end in keys (and pay).
VL3D_API int vl3d_swd_mask_sort(const float* src, long long row,
                                const int* gather, int P, long long n,
                                unsigned* keys, unsigned* keys_alt, int* pay,
                                int* pay_alt, int* hist, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (P <= 0 || n <= 0) return (int)cudaGetLastError();
  const int ntiles = (int)((n + kSortTile - 1) / kSortTile);
  sort_load_kernel<<<dim3(grid_for(n), P), kBlock, 0, s>>>(src, row, gather,
                                                          n, keys, pay);
  unsigned* kin = keys;
  unsigned* kout = keys_alt;
  int* pin = pay;
  int* pout = pay_alt;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 8 * pass;
    sort_hist_kernel<<<dim3(ntiles, P), kSortThreads, 0, s>>>(kin, n, shift,
                                                              ntiles, hist);
    sort_scan_kernel<<<P, kScanThreads, 0, s>>>(hist, 256 * ntiles);
    sort_scatter_kernel<<<dim3(ntiles, P), kSortThreads, 0, s>>>(
        kin, pin, kout, pout, hist, n, ntiles, shift);
    unsigned* kt = kin;
    kin = kout;
    kout = kt;
    int* pt = pin;
    pin = pout;
    pout = pt;
  }
  return (int)cudaGetLastError();
}

// K28: kx, ix, ky the sorted rows (P n); inv = 1 / (P n) as f32; gm (P n)
// and partial (ceil(P n / 256) doubles) scratch; invp the inverse of the
// deficit permutation (tiled int32) or null; writes loss and gx (P, L, cf).
VL3D_API int vl3d_swd_mask_l1(const unsigned* kx, const unsigned* ky,
                              const int* ix, int P, long long n,
                              long long n_x, int L, int cf, long long tiled,
                              long long deficit, const int* invp, float inv,
                              float count, float* gm, double* partial,
                              float* loss, float* gx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)P * n;
  if (total <= 0) return (int)cudaGetLastError();
  if (n_x != n && tiled / n_x > kMaxReps) return (int)cudaErrorInvalidValue;
  const unsigned nb = grid_for(total);
  mask_l1_kernel<<<nb, kSortThreads, 0, s>>>(kx, ky, ix, total, n, inv, gm,
                                             partial);
  mask_loss_kernel<<<1, kScanThreads, 0, s>>>(partial, (int)nb, count, loss);
  mask_grad_kernel<<<dim3(grid_for(n_x), P), kBlock, 0, s>>>(
      gm, n, n_x, L, cf, tiled, deficit, invp, gx);
  return (int)cudaGetLastError();
}
