// The stable bins of the deterministic gathers K17
// (bilinear_planes_tilemajor.cu) and K10 (bilinear_tiles_tilemajor.cu): a
// stable LSD radix sort of each plane's unsigned keys (8-bit digits) with
// the samples' in-plane indices as payload, then each key's first position.
//
// Per digit: bin_hist_kernel counts each sort tile's digits (2,048 keys a
// tile), bin_scan_kernel scans the counts digit-major a plane (one block a
// plane), bin_scatter_kernel ranks a tile's keys in rounds of 256 in index
// order (__match_any_sync within a warp, per-warp counts across warps) and
// writes them to their digit's scanned offset.  So the sort is stable: a
// bin lists its samples by index, and two launches give the same bits.
// bin_offsets_kernel finds each key's start in the sorted keys by binary
// search.  Included by both sources (each holds its own copy).
#pragma once

#include "common.cuh"

namespace {

constexpr int kSortThreads = 256;
constexpr int kSortItems = 8;
constexpr int kSortTile = kSortThreads * kSortItems;   // keys a sort block
constexpr int kScanThreads = 1024;

long long align256(long long b) { return (b + 255) / 256 * 256; }

// 8-bit digits of keys up to `sentinel`
int sort_passes(long long sentinel) {
  int bits = 1;
  while ((1ll << bits) <= sentinel) ++bits;
  return (bits + 7) / 8;
}

// hist[(d 256 + digit) ntiles + tile] = count of the tile's keys
__global__ void __launch_bounds__(kSortThreads) bin_hist_kernel(
    const unsigned* __restrict__ keys, long long n, int shift, int ntiles,
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

// exclusive scan of one plane's 256 ntiles counts, in place
__global__ void __launch_bounds__(kScanThreads) bin_scan_kernel(
    int* __restrict__ hist, int len) {
  __shared__ int wsum[kScanThreads / 32];
  __shared__ int carry;
  int* h = hist + (long long)blockIdx.x * len;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < len; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < len ? h[i] : 0;
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += t;
    }
    if (lane == 31) wsum[w] = inc;
    __syncthreads();
    if (w == 0) {
      int s = wsum[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += t;
      }
      wsum[lane] = s;
    }
    __syncthreads();
    const int excl = carry + (w > 0 ? wsum[w - 1] : 0) + inc - v;
    if (i < len) h[i] = excl;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = excl + v;
    __syncthreads();
  }
}

// the stable scatter of one tile into its digits' scanned offsets; the
// payload is the sample's index in its plane (pin null: the index itself)
__global__ void __launch_bounds__(kSortThreads) bin_scatter_kernel(
    const unsigned* __restrict__ kin, const int* __restrict__ pin,
    unsigned* __restrict__ kout, int* __restrict__ pout,
    const int* __restrict__ offs, long long n, int ntiles, int shift) {
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
      pout[row + off] = pin != nullptr ? pin[row + i] : (int)i;
    }
    __syncthreads();
    int sum = 0;
    for (int w2 = 0; w2 < kSortThreads / 32; ++w2) sum += wcnt[w2][threadIdx.x];
    base[threadIdx.x] += sum;
    __syncthreads();
  }
}

// off[d nk1 + k] = the first position of plane d's sorted keys >= k
__global__ void bin_offsets_kernel(const unsigned* __restrict__ skeys,
                                   long long n, int D, int nk1,
                                   int* __restrict__ off) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)D * nk1) return;
  const long long d = i / nk1;
  const unsigned k = (unsigned)(i - d * nk1);
  const unsigned* row = skeys + d * n;
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (row[mid] < k) lo = mid + 1; else hi = mid;
  }
  off[i] = (int)lo;
}

// The scratch of sort_bins: keys and payloads twice (D n each), the digit
// counts (D 256 ntiles) and the key offsets (D nk1), each 256-byte aligned.
long long bins_scratch(int D, long long n, int ntiles, int nk1) {
  return 4 * align256((long long)D * n * 4)
      + align256((long long)D * 256 * ntiles * 4)
      + align256((long long)D * nk1 * 4);
}

struct Bins {
  const int* perm;   // [D][n] in-plane sample indices, sorted by key
  const int* off;    // [D][nk1] first sorted position of each key
};

// Sorts the D x n keys that key_fill writes into its argument (unsigned*,
// D n of them), passes 8-bit digits, then finds the key offsets.
template <typename KeyFill>
Bins sort_bins(void* scratch, int D, long long n, int ntiles, int nk1,
               int passes, KeyFill key_fill, cudaStream_t st) {
  char* p = (char*)scratch;
  const long long kb = align256((long long)D * n * 4);
  unsigned* keys[2] = {(unsigned*)p, (unsigned*)(p + kb)};
  int* pay[2] = {(int*)(p + 2 * kb), (int*)(p + 3 * kb)};
  int* hist = (int*)(p + 4 * kb);
  int* off = (int*)(p + 4 * kb + align256((long long)D * 256 * ntiles * 4));
  if ((long long)D * n > 0) {
    key_fill(keys[0]);
    for (int pass = 0; pass < passes; ++pass) {
      const int a = pass & 1, b = a ^ 1;
      const dim3 g((unsigned)ntiles, (unsigned)D);
      bin_hist_kernel<<<g, kSortThreads, 0, st>>>(keys[a], n, 8 * pass,
                                                  ntiles, hist);
      bin_scan_kernel<<<D, kScanThreads, 0, st>>>(hist, 256 * ntiles);
      bin_scatter_kernel<<<g, kSortThreads, 0, st>>>(
          keys[a], pass == 0 ? nullptr : pay[a], keys[b], pay[b], hist, n,
          ntiles, 8 * pass);
    }
  }
  const int fin = passes & 1;
  const long long nk = (long long)D * nk1;
  bin_offsets_kernel<<<grid_for(nk), kBlock, 0, st>>>(keys[fin], n, D, nk1,
                                                      off);
  return {pay[fin], off};
}

}  // namespace
