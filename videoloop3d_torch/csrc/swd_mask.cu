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
// are the radix sort's ties), with the matched index as an int32 payload
// (x) or without one (y).  Each pass is stable, so ties keep their index
// order, as jnp.sort's and the plain version's torch.sort(stable=True).
//
// The redesign: one kernel a pass, after one upsweep.  The load
// gathers the row, writes the keys (and payload) and counts every pass's
// digits in the same read (per-block histograms in shared memory, split
// over kHistParts lanes' copies against conflicts, added to the row's
// counts in device memory); one small kernel scans them into each pass's
// row-global digit starts.  A pass's block takes one tile of kRankTile keys
// of one row and
//   1. ranks it once: warp w takes the tile's w-th run of kRankItems x 32
//      keys in rounds of 32, in index order; a key's rank is the count of
//      the same digit's keys before it in its warp (__match_any_sync within
//      a round, per-warp digit counts in shared memory across rounds), plus
//      the digit's keys in the warps before (one exclusive pass over the
//      warps per digit) and the tile's keys of smaller digits (one
//      exclusive scan over the digits);
//   2. stages the tile in shared memory in digit order (stable within the
//      tile);
//   3. takes each digit's offset among the row's tiles from a decoupled
//      look-back (Onesweep, Adinets & Merrill 2022): the tile publishes its
//      digit counts, then adds its predecessors' counts back to the first
//      inclusive prefix and publishes its own, one status word a digit;
//      tiles take tickets in launch order, so every tile waits only on
//      tiles that run;
//   4. writes each digit run with consecutive threads on consecutive
//      addresses.
// Digits are 8 bits (four passes).  11-bit digits and a per-pass histogram
// and scan in place of the look-back were measured slower (PERF.md).
// The first design (per-pass histograms, their scan and a scatter that
// ranked a tile in 8 rounds of 256 keys straight into device memory, a
// warp's stores landing in up to 32 digit runs) stays callable as
// vl3d_swd_mask_sort_first, for chip_smoke.py's comparison only.
//
// K28: the L1 over ranks and its gradient.  The gradient is one sign a
// matched entry, sign+(sx - sy) / (P n) at the rank's x payload (a
// permutation of the matched indices), summed over each x entry's copies
// in increasing matched index: the tiled copies e, e + n_x, ... and the
// deficit's copies tiled + j for the j with perm[j] = e + q n_x, as the
// plain version's index_add_ sums them.
//
// The redesign (mask_l1_bits_kernel) keeps the signs as bits: one block
// owns a row, its bits in shared memory.  Where the rows would not reach
// every SM (fewer than kL1FillBlocks) or a row's bits need more than one
// SM's shared memory (past 1,851,392 keys; the masked rows of the stage-2
// patch reach about 1.1 M), the bits are in device memory, zeroed, set by
// atomicOr and read back by two kernels of several blocks a row
// (mask_l1_set_kernel, mask_l1_grad_kernel): the same passes.  Pass 1 streams the row's kx, ky
// and ix once, coalesced, the next ranks' loads in flight while a
// thread's current ones run, sums |sx - sy| in double in a fixed order
// (each thread's ranks in order, then the warps' and the block's sums),
// and sets the positive signs' bits.  A copy's bit is not kept at its
// matched index but at its place in x's gradient: copy k of x's
// conv-order entry e = f L + l at k n_x + l cf + f, K24's (L, cf) layout
// (the deficit's copies at their matched index), so that pass 2, after a
// barrier, walks x's entries in the order of gx (P, L, cf): consecutive
// threads read the same bit word and write consecutive floats.  Each
// entry adds its copies' signs as +-inv in increasing matched index, as
// the first design: the tiled copies, then the deficit's in ascending j,
// found by a selection over the inverse permutation in gx's order
// (invp_t, from the host; up to kL1RegReps candidates in registers, more
// read again) with no per-thread array.  Divisions by n_x and L are by
// invariant divisors (FastDiv).  The same f32 adds
// in the same order: the gradient is the first design's, bit for bit.
// The loss's double sum runs in another fixed order than the first
// design's, so its f32 value can differ from it in a near tie (1 ulp).
// No limit on the copies of an entry.  swd_mask_l1_layout (and
// losses/swd.py:swd_mask_l1_layout) gives the route by the row length.
// The first design (mask_l1_kernel writing the sign as an f32 at x's
// payload, a scattered 4-byte store a key, then mask_grad_kernel reading
// it back and sorting an entry's deficit copies in a local array, at most
// kMaxReps) stays callable as vl3d_swd_mask_l1_first, for chip_smoke.py's
// and the card tests' comparison only.
//
// Bound on the H100: bytes.  Read both rows once (4 B a key) and write the
// gradient once (4 B an x entry).  The sort moves each key and payload
// through device memory once a pass (16 B a key-payload pair a pass), plus
// the load's gather (12 B a pair), the tile statuses (4 B a digit a tile,
// written twice) and the signs.
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

// ---------------------------------------------------------------------------
// K27's redesign: an upsweep in the load, then one ranking kernel a pass
// ---------------------------------------------------------------------------

constexpr int kRankThreads = 256;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kRankItems = 15;                          // keys a thread ranks
constexpr int kRankTile = kRankThreads * kRankItems;    // 3,840 keys
constexpr int kLoadItems = 16;                          // keys a load thread
constexpr int kLoadChunk = kRankThreads * kLoadItems;
// a tile's status word a digit: two flag bits over a 30-bit count
constexpr unsigned kFlagAgg = 1u << 30;                 // the tile's count
constexpr unsigned kFlagInc = 2u << 30;                 // its inclusive prefix
constexpr unsigned kCountMask = kFlagAgg - 1u;

constexpr int kBits = 8;
constexpr int kDigits = 1 << kBits;                     // one a thread
constexpr int kPasses = 32 / kBits;
// copies of the load's histograms, one per lane residue: a warp's keys of
// one digit add into kHistParts counters, not one
constexpr int kHistParts = 8;
// ranking kernel's dynamic shared memory: the per-warp digit counts, later
// the staged tile (keys, payload), then the tile's digit starts and the
// digits' row offsets
constexpr int kCountWords = kRankWarps * kDigits;
constexpr int kUnionWords =
    kCountWords > 2 * kRankTile ? kCountWords : 2 * kRankTile;
constexpr int kRankSmemBytes = (kUnionWords + 2 * kDigits) * 4;
static_assert(kDigits == kRankThreads, "a thread owns one digit");

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// exclusive scan over the block of one value a thread; wsum is kRankWarps
// shared ints
__device__ __forceinline__ int block_scan_excl(int v, int* wsum) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wsum[w] = inc;
  __syncthreads();
  int pre = inc - v;
  for (int w2 = 0; w2 < w; ++w2) pre += wsum[w2];
  __syncthreads();
  return pre;
}

// the load and the upsweep: keys[p n + i] = key of src[p row + gather[i]],
// pay[p n + i] = i; counts[(p kPasses + pass) kDigits + digit] += the
// chunk's keys of that digit, for every pass
__global__ void __launch_bounds__(kRankThreads) sort_load_count_kernel(
    const float* __restrict__ src, long long row,
    const int* __restrict__ gather, long long n, unsigned* __restrict__ keys,
    int* __restrict__ pay, int* __restrict__ counts) {
  constexpr int kWords = kPasses * kDigits * kHistParts;
  __shared__ int hist[kWords];
  for (int j = threadIdx.x; j < kWords; j += kRankThreads) hist[j] = 0;
  __syncthreads();
  const long long p = blockIdx.y;
  const int part = threadIdx.x % kHistParts;
  const long long start = (long long)blockIdx.x * kLoadChunk;
  for (int r = 0; r < kLoadItems; ++r) {
    const long long i = start + r * kRankThreads + threadIdx.x;
    if (i < n) {
      const unsigned k = f2key(src[p * row + gather[i]]);
      keys[p * n + i] = k;
      if (pay != nullptr) pay[p * n + i] = (int)i;
#pragma unroll
      for (int q = 0; q < kPasses; ++q) {
        const int d = (int)((k >> (q * kBits)) & (kDigits - 1));
        atomicAdd(&hist[(q * kDigits + d) * kHistParts + part], 1);
      }
    }
  }
  __syncthreads();
  int* c = counts + p * kPasses * kDigits;
  for (int j = threadIdx.x; j < kPasses * kDigits; j += kRankThreads) {
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kHistParts; ++q) sum += hist[j * kHistParts + q];
    if (sum != 0) atomicAdd(c + j, sum);
  }
}

// each (row, pass)'s digit counts scanned in place into its row-global
// digit starts (exclusive); one block a (row, pass)
__global__ void __launch_bounds__(kRankThreads) digit_scan_kernel(
    int* __restrict__ counts) {
  __shared__ int wsum[kRankWarps];
  int* c = counts + (long long)blockIdx.x * kDigits + threadIdx.x;
  *c = block_scan_excl(*c, wsum);
}

// one pass over one tile of one row (see the header): rank, stage in digit
// order, take the digits' offsets among the row's tiles from the statuses,
// write the runs.  starts: this pass's row-global digit starts, a row's
// every starts_stride ints.
__global__ void __launch_bounds__(kRankThreads) rank_pass_kernel(
    const unsigned* __restrict__ kin, const int* __restrict__ pin,
    unsigned* __restrict__ kout, int* __restrict__ pout, long long n,
    int ntiles, int shift, const int* __restrict__ starts, int starts_stride,
    unsigned* status, int* ticket) {
  extern __shared__ int smem[];
  int* wcnt = smem;                                    // [kRankWarps][kDigits]
  unsigned* skey = reinterpret_cast<unsigned*>(smem);  // [kRankTile], later
  int* spay = smem + kRankTile;                        // [kRankTile], later
  int* dstart = smem + kUnionWords;                    // [kDigits]
  int* gbase = dstart + kDigits;                       // [kDigits]
  __shared__ int wsum[kRankWarps];
  __shared__ int s_vid;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_vid = atomicAdd(ticket, 1);
  for (int j = threadIdx.x; j < kCountWords; j += kRankThreads) wcnt[j] = 0;
  __syncthreads();
  // tiles take tickets in the order they start, so a tile's predecessors
  // in its row are running or done
  const int vid = s_vid;
  const int row = vid / ntiles, tile = vid - row * ntiles;
  const long long rbase = (long long)row * n;
  const int t0 = tile * kRankTile;
  const int cnt = (int)min((long long)kRankTile, n - t0);
  const unsigned* kt = kin + rbase + t0;
  const int* pt = pin == nullptr ? nullptr : pin + rbase + t0;
  // 1. rank: warp w's run of kRankItems x 32 keys, rounds of 32 in order
  const int first = w * kRankItems * 32 + lane;
  unsigned key[kRankItems];
  int pay[kRankItems], pos[kRankItems];
#pragma unroll
  for (int r = 0; r < kRankItems; ++r) {
    const int i = first + r * 32;
    key[r] = i < cnt ? kt[i] : 0u;
    pay[r] = (pt != nullptr && i < cnt) ? pt[i] : 0;
  }
  int* wc = wcnt + w * kDigits;
#pragma unroll
  for (int r = 0; r < kRankItems; ++r) {
    const bool valid = first + r * 32 < cnt;
    const int d = valid ? (int)((key[r] >> shift) & (kDigits - 1)) : kDigits;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = __popc(peers & ((1u << lane) - 1u));
    const int c = valid ? wc[d] : 0;
    __syncwarp();
    if (valid && before == 0) wc[d] = c + __popc(peers);
    __syncwarp();
    pos[r] = c + before;
  }
  __syncthreads();
  // each digit's keys in the warps before, and the tile's count (thread t
  // owns digit t)
  const int d0 = threadIdx.x;
  int tot = 0;
  for (int w2 = 0; w2 < kRankWarps; ++w2) {
    const int v = wcnt[w2 * kDigits + d0];
    wcnt[w2 * kDigits + d0] = tot;
    tot += v;
  }
  const int ex = block_scan_excl(tot, wsum);
  // 3. the digit's offset in the row, less its start in the staged tile;
  // the tile publishes its count before it looks back
  unsigned* const st = status + (long long)vid * kDigits + d0;
  st_relaxed(st, (tile == 0 ? kFlagInc : kFlagAgg) | (unsigned)tot);
  dstart[d0] = ex;
  int before_tiles = 0;
  if (tile != 0) {
    for (const unsigned* q = st - kDigits;; q -= kDigits) {
      unsigned v;
      do {
        v = ld_relaxed(q);
      } while (v == 0u);
      before_tiles += (int)(v & kCountMask);
      if (v & kFlagInc) break;
    }
    st_relaxed(st, kFlagInc | (unsigned)(before_tiles + tot));
  }
  before_tiles += starts[(long long)row * starts_stride + d0];
  gbase[d0] = before_tiles - ex;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRankItems; ++r) {
    if (first + r * 32 < cnt) {
      const int d = (int)((key[r] >> shift) & (kDigits - 1));
      pos[r] += dstart[d] + wc[d];
    }
  }
  __syncthreads();
  // 2. stage the tile in digit order (the counts' words are free now)
#pragma unroll
  for (int r = 0; r < kRankItems; ++r) {
    if (first + r * 32 < cnt) {
      skey[pos[r]] = key[r];
      if (pt != nullptr) spay[pos[r]] = pay[r];
    }
  }
  __syncthreads();
  // 4. write each digit run, consecutive threads on consecutive addresses
  for (int i = threadIdx.x; i < cnt; i += kRankThreads) {
    const unsigned k = skey[i];
    const long long o = rbase + gbase[(k >> shift) & (kDigits - 1)] + i;
    kout[o] = k;
    if (pout != nullptr) pout[o] = spay[i];
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

// ---------------------------------------------------------------------------
// K28's redesign: the signs as bits (see the header)
// ---------------------------------------------------------------------------

constexpr int kL1Threads = 1024;
constexpr int kL1Unroll = 4;
constexpr int kL1RegReps = 4;        // copies an entry walked in registers
// the shared bytes a block gives its bit words: the H100's 227 KB a block
// less the static shared memory
constexpr long long kL1CapWords = (227LL * 1024 - 1024) / 4;
// the H100's SMs: the block route needs as many rows as this to reach
// every SM; the global route launches twice as many blocks, of at least
// kL1Chunk keys each
constexpr int kL1FillBlocks = 132;
constexpr long long kL1Chunk = (long long)kL1Threads * kL1Unroll * 4;
constexpr int kRouteBlock = 0, kRouteGlobal = 1;

struct L1Layout {
  int route, threads;
  long long words, smem, blocks, scratch;
};

// the route of P rows of n keys: a block a row (its n bits in shared
// memory) where the bits fit and the rows fill the card, else the bits in
// device memory (scratch: P rows of `words` u32) and blocks / P blocks a
// row
L1Layout l1_layout(int P, long long n) {
  const long long words = (n + 31) / 32;
  if (words <= kL1CapWords && P >= kL1FillBlocks)
    return L1Layout{kRouteBlock, kL1Threads, words, words * 4, P, 0};
  long long per_row = (2 * kL1FillBlocks + P - 1) / P;
  const long long chunks = (n + kL1Chunk - 1) / kL1Chunk;
  if (per_row > chunks) per_row = chunks;
  return L1Layout{kRouteGlobal, kL1Threads, words, 0, P * per_row,
                  P * words};
}

// n / d for n < 2^32 and 1 <= d < 2^31, by Granlund and Montgomery's
// round-up method: t = umulhi(m, n), q = (t + ((n - t) >> s1)) >> s2
struct FastDiv {
  unsigned d, m;
  int s1, s2;
};

FastDiv make_fastdiv(unsigned d) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  return FastDiv{d, (unsigned)((((1ull << l) - d) << 32) / d + 1),
                 l < 1 ? l : 1, l > 1 ? l - 1 : 0};
}

__device__ __forceinline__ unsigned fdiv(unsigned n, const FastDiv& f) {
  const unsigned t = __umulhi(f.m, n);
  return (t + ((n - t) >> f.s1)) >> f.s2;
}

// a row's shape for the passes (every index of a row is below 2^30)
struct L1Row {
  FastDiv nx, L;             // n_x and L
  unsigned n, cf, tiled, deficit, words;
};

// the bit of matched index m: copy k of x's conv-order entry e = f L + l
// at k n_x + l cf + f, the deficit's copies (m >= tiled) at m
__device__ __forceinline__ unsigned bit_pos(unsigned m, const L1Row& g) {
  if (m >= g.tiled) return m;
  const unsigned k = g.tiled == g.nx.d ? 0u : fdiv(m, g.nx);
  const unsigned e = m - k * g.nx.d;
  const unsigned f = fdiv(e, g.L);
  return k * g.nx.d + (e - f * g.L.d) * g.cf + f;
}

// the sign at bit pos of a row's words: the block's shared words (block
// route) or the row's words in device memory (global route)
template <int kRoute>
__device__ __forceinline__ float l1_sign(const unsigned* bits, unsigned pos,
                                         float inv) {
  const unsigned* wp = bits + (pos >> 5);
  const unsigned v = kRoute == kRouteGlobal ? __ldcg(wp) : *wp;
  return ((v >> (pos & 31)) & 1u) ? inv : -inv;
}

// pass 1 on ranks [r0, r1) of a row: |d| summed in double in a fixed
// order (each thread's ranks in order, the warps' shuffle trees, the warps
// in order) into *partial, the positive signs' bits set; the next
// kL1Unroll ranks' loads in flight while a thread's current ones run
template <int kRoute>
__device__ __forceinline__ void l1_pass1(
    const unsigned* __restrict__ kxr, const unsigned* __restrict__ kyr,
    const int* __restrict__ ixr, unsigned r0, unsigned r1, const L1Row& g,
    unsigned* bits, double* partial) {
  constexpr unsigned kStep = kL1Threads * kL1Unroll;
  __shared__ double wsum[kL1Threads / 32];
  double acc = 0.0;
  unsigned a[kL1Unroll], b[kL1Unroll], m[kL1Unroll];
  unsigned r = r0 + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kL1Unroll; ++u) {
    const unsigned rr = r + u * kL1Threads;
    if (rr < r1) {
      a[u] = kxr[rr];
      b[u] = kyr[rr];
      m[u] = (unsigned)ixr[rr];
    }
  }
  for (; r < r1; r += kStep) {
    unsigned a2[kL1Unroll], b2[kL1Unroll], m2[kL1Unroll];
#pragma unroll
    for (int u = 0; u < kL1Unroll; ++u) {
      const unsigned rr = r + kStep + u * kL1Threads;
      if (rr < r1) {
        a2[u] = kxr[rr];
        b2[u] = kyr[rr];
        m2[u] = (unsigned)ixr[rr];
      }
    }
#pragma unroll
    for (int u = 0; u < kL1Unroll; ++u) {
      if (r + u * kL1Threads < r1) {
        const float d = __fsub_rn(key2f(a[u]), key2f(b[u]));
        acc += (double)fabsf(d);
        if (d >= 0.0f) {
          const unsigned q = bit_pos(m[u], g);
          atomicOr(bits + (q >> 5), 1u << (q & 31));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kL1Unroll; ++u) {
      a[u] = a2[u];
      b[u] = b2[u];
      m[u] = m2[u];
    }
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) wsum[wid] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double sum = 0.0;
    for (int w2 = 0; w2 < kL1Threads / 32; ++w2) sum += wsum[w2];
    *partial = sum;
  }
}

// pass 2 on x's entries [o0, o1) of a row, in gx's order: each entry's
// copies' signs in increasing matched index, the tiled copies k n_x + o,
// then the deficit's tiled + j for j = invp_t[q n_x + o] < deficit,
// ascending (a selection over up to kL1RegReps candidates in registers,
// over more by reading them again)
template <int kRoute>
__device__ __forceinline__ void l1_pass2(unsigned* bits, unsigned o0,
                                         unsigned o1, const L1Row& g,
                                         const int* __restrict__ invp_t,
                                         float inv, float* __restrict__ gxr) {
  const unsigned n_x = g.nx.d;
  const unsigned reps = n_x == g.n ? 1u : g.tiled / n_x;
  const bool walk = n_x != g.n && g.deficit > 0;
  for (unsigned o = o0 + threadIdx.x; o < o1; o += kL1Threads * kL1Unroll) {
    unsigned cand[kL1Unroll][kL1RegReps];
#pragma unroll
    for (int u = 0; u < kL1Unroll; ++u) {
      const unsigned oo = o + u * kL1Threads;
#pragma unroll
      for (int q = 0; q < kL1RegReps; ++q) {
        cand[u][q] = (walk && q < reps && oo < o1)
                         ? (unsigned)invp_t[q * n_x + oo]
                         : 0xffffffffu;
      }
    }
#pragma unroll
    for (int u = 0; u < kL1Unroll; ++u) {
      const unsigned oo = o + u * kL1Threads;
      if (oo >= o1) continue;
      float v;
      if (n_x == g.n) {
        v = l1_sign<kRoute>(bits, oo, inv);
      } else {
        v = 0.0f;
        for (unsigned k = 0; k < reps; ++k)
          v = __fadd_rn(v, l1_sign<kRoute>(bits, k * n_x + oo, inv));
        // the deficit's copies, ascending j; prev + 1 is the least j
        // still to take
        unsigned lo = 0;
        for (unsigned t = 0; walk && t < reps; ++t) {
          unsigned best = g.deficit;
          if (reps <= kL1RegReps) {
#pragma unroll
            for (int q = 0; q < kL1RegReps; ++q) {
              const unsigned j = cand[u][q];
              if (j >= lo && j < best) best = j;
            }
          } else {
            for (unsigned q = 0; q < reps; ++q) {
              const unsigned j = (unsigned)invp_t[q * n_x + oo];
              if (j >= lo && j < best) best = j;
            }
          }
          if (best == g.deficit) break;
          v = __fadd_rn(v, l1_sign<kRoute>(bits, g.tiled + best, inv));
          lo = best + 1;
        }
      }
      gxr[oo] = v;
    }
  }
}

// the block route: a block a row, its bits in shared memory.  kx, ky,
// ix: the sorted rows (P n); invp_t: the inverse of the deficit's
// permutation in gx's order (invp_t[q n_x + l cf + f] = invp[q n_x + f L +
// l]) or null; partial: a double a block; gx (P, L, cf)
__global__ void __launch_bounds__(kL1Threads) mask_l1_bits_kernel(
    const unsigned* __restrict__ kx, const unsigned* __restrict__ ky,
    const int* __restrict__ ix, L1Row g, const int* __restrict__ invp_t,
    float inv, double* __restrict__ partial, float* __restrict__ gx) {
  extern __shared__ unsigned sbits[];
  const long long p = blockIdx.x;
  const unsigned n = g.n, n_x = g.nx.d;
  for (unsigned q = threadIdx.x; q < g.words; q += kL1Threads) sbits[q] = 0u;
  __syncthreads();
  l1_pass1<kRouteBlock>(kx + p * n, ky + p * n, ix + p * n, 0u, n, g, sbits,
                        partial + p);
  __syncthreads();
  l1_pass2<kRouteBlock>(sbits, 0u, n_x, g, invp_t, inv, gx + p * n_x);
}

// the global route, pass 1: block b of row p = blockIdx.y takes ranks
// [n b / B, n (b + 1) / B) of gridDim.x = B; gbits: P rows of
// g.words words, zeroed before
__global__ void __launch_bounds__(kL1Threads) mask_l1_set_kernel(
    const unsigned* __restrict__ kx, const unsigned* __restrict__ ky,
    const int* __restrict__ ix, L1Row g, unsigned* __restrict__ gbits,
    double* __restrict__ partial) {
  const unsigned long long p = blockIdx.y, B = gridDim.x, b = blockIdx.x;
  const unsigned long long n = g.n;
  l1_pass1<kRouteGlobal>(kx + p * n, ky + p * n, ix + p * n,
                         (unsigned)(n * b / B), (unsigned)(n * (b + 1) / B),
                         g, gbits + p * g.words, partial + p * B + b);
}

// the global route, pass 2: block b of row p takes x's entries
// [n_x b / B, n_x (b + 1) / B)
__global__ void __launch_bounds__(kL1Threads) mask_l1_grad_kernel(
    unsigned* __restrict__ gbits, L1Row g, const int* __restrict__ invp_t,
    float inv, float* __restrict__ gx) {
  const unsigned long long p = blockIdx.y, B = gridDim.x, b = blockIdx.x;
  const unsigned long long n_x = g.nx.d;
  l1_pass2<kRouteGlobal>(gbits + p * g.words, (unsigned)(n_x * b / B),
                         (unsigned)(n_x * (b + 1) / B), g, invp_t, inv,
                         gx + p * n_x);
}

}  // namespace

// K27's first design (per-pass histograms of 2,048-key tiles, their scan,
// and a scatter that ranks a tile in 8 rounds of 256 straight into device
// memory): sort P rows of n keys read from src (P rows of `row` floats)
// through gather (n int32 offsets).  keys/keys_alt (P n u32), pay/pay_alt
// (P n int32, or null without a payload), hist (P 256 ntiles int32) are
// the caller's.  The sorted keys (and payload) end in keys (and pay).  For
// chip_smoke.py's and the card tests' comparison only; no path of the port
// calls it.
VL3D_API int vl3d_swd_mask_sort_first(const float* src, long long row,
                                      const int* gather, int P, long long n,
                                      unsigned* keys, unsigned* keys_alt,
                                      int* pay, int* pay_alt, int* hist,
                                      void* stream) {
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

// K27's scratch bytes for P rows of n keys: the digit counts
// (P kPasses kDigits), one ticket a pass and the statuses (P ntiles kDigits)
VL3D_API long long vl3d_swd_mask_sort_scratch(int P, long long n) {
  const long long ntiles = (n + kRankTile - 1) / kRankTile;
  return 4LL * ((long long)P * kPasses * kDigits + kPasses
                + (long long)P * ntiles * kDigits);
}

// K27: sort P rows of n keys read from src (P rows of `row` floats) through
// gather (n int32 offsets), n < 2^30.  keys/keys_alt (P n u32), pay/pay_alt
// (P n int32, or null without a payload) and scratch
// (vl3d_swd_mask_sort_scratch bytes) are the caller's.  The sorted keys (and
// payload) end in keys (and pay), after an even number of passes.
VL3D_API int vl3d_swd_mask_sort(const float* src, long long row,
                                const int* gather, int P, long long n,
                                unsigned* keys, unsigned* keys_alt, int* pay,
                                int* pay_alt, void* scratch, void* stream) {
  static_assert(kPasses % 2 == 0, "the result ends in keys");
  cudaStream_t s = (cudaStream_t)stream;
  if (P <= 0 || n <= 0) return (int)cudaGetLastError();
  if (n >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int ntiles = (int)((n + kRankTile - 1) / kRankTile);
  unsigned* kin = keys;
  unsigned* kout = keys_alt;
  int* pin = pay;
  int* pout = pay_alt;
  int* counts = static_cast<int*>(scratch);
  int* tickets = counts + (long long)P * kPasses * kDigits;
  unsigned* status = reinterpret_cast<unsigned*>(tickets + kPasses);
  const size_t status_bytes = 4ull * P * ntiles * kDigits;
  cudaFuncSetAttribute(rank_pass_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kRankSmemBytes);
  cudaMemsetAsync(counts, 0, 4ull * ((long long)P * kPasses * kDigits + kPasses),
                  s);
  sort_load_count_kernel<<<dim3((unsigned)((n + kLoadChunk - 1) / kLoadChunk),
                                P),
                           kRankThreads, 0, s>>>(src, row, gather, n, kin, pin,
                                                 counts);
  digit_scan_kernel<<<P * kPasses, kRankThreads, 0, s>>>(counts);
  const unsigned blocks = (unsigned)((long long)P * ntiles);
  for (int pass = 0; pass < kPasses; ++pass) {
    cudaMemsetAsync(status, 0, status_bytes, s);
    rank_pass_kernel<<<blocks, kRankThreads, kRankSmemBytes, s>>>(
        kin, pin, kout, pout, n, ntiles, kBits * pass, counts + pass * kDigits,
        kPasses * kDigits, status, tickets + pass);
    unsigned* kt = kin;
    kin = kout;
    kout = kt;
    int* pt = pin;
    pin = pout;
    pout = pt;
  }
  return (int)cudaGetLastError();
}

// K28 (mask_l1_bits_kernel by swd_mask_l1_layout's route, then
// mask_loss_kernel): kx, ix, ky the sorted rows (P n), n < 2^30; inv = 1 /
// (P n) as f32; invp_t the inverse of the deficit's permutation in gx's
// order (tiled int32) or null; bits the global route's scratch
// (vl3d_swd_mask_l1_layout's scratch u32) or null; partial (its blocks
// doubles) scratch; writes loss and gx (P, L, cf).
VL3D_API int vl3d_swd_mask_l1(const unsigned* kx, const unsigned* ky,
                              const int* ix, int P, long long n,
                              long long n_x, int L, int cf, long long tiled,
                              long long deficit, const int* invp_t, float inv,
                              float count, unsigned* bits, double* partial,
                              float* loss, float* gx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (P <= 0 || n <= 0) return (int)cudaGetLastError();
  if (n >= (1LL << 30) || n_x > n || L <= 0 || cf <= 0
      || (long long)L * cf != n_x)
    return (int)cudaErrorInvalidValue;
  const L1Layout lay = l1_layout(P, n);
  if (lay.blocks > 0x7fffffffLL || (lay.route == kRouteGlobal && P > 65535))
    return (int)cudaErrorInvalidValue;
  const L1Row g{make_fastdiv((unsigned)n_x), make_fastdiv((unsigned)L),
                (unsigned)n, (unsigned)cf, (unsigned)tiled, (unsigned)deficit,
                (unsigned)lay.words};
  cudaError_t e;
  if (lay.route == kRouteBlock) {
    if (lay.smem > 48 * 1024) {
      e = cudaFuncSetAttribute(mask_l1_bits_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)lay.smem);
      if (e != cudaSuccess) return (int)e;
    }
    mask_l1_bits_kernel<<<(unsigned)lay.blocks, lay.threads,
                          (size_t)lay.smem, s>>>(
        kx, ky, ix, g, invp_t, inv, partial, gx);
    e = cudaGetLastError();
  } else {
    e = cudaMemsetAsync(bits, 0, 4ull * lay.scratch, s);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)(lay.blocks / P), (unsigned)P);
    mask_l1_set_kernel<<<grid, kL1Threads, 0, s>>>(kx, ky, ix, g, bits,
                                                    partial);
    mask_l1_grad_kernel<<<grid, kL1Threads, 0, s>>>(bits, g, invp_t, inv,
                                                     gx);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return (int)e;
  mask_loss_kernel<<<1, kScanThreads, 0, s>>>(partial, (int)lay.blocks, count,
                                              loss);
  return (int)cudaGetLastError();
}

// K28's layout for P rows of n keys: out = {route (0 block, 1 global),
// threads, words, smem, blocks, scratch}
// (losses/swd.py:swd_mask_l1_layout's keys, in order).
VL3D_API int vl3d_swd_mask_l1_layout(int P, long long n, long long* out) {
  if (P <= 0 || n <= 0 || n >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const L1Layout lay = l1_layout(P, n);
  out[0] = lay.route;
  out[1] = lay.threads;
  out[2] = lay.words;
  out[3] = lay.smem;
  out[4] = lay.blocks;
  out[5] = lay.scratch;
  return 0;
}

// K28's first design (mask_l1_kernel, mask_loss_kernel, mask_grad_kernel;
// for comparison, no wrapper calls it): kx, ix, ky the sorted rows (P n);
// inv = 1 / (P n) as f32; gm (P n) and partial (ceil(P n / 256) doubles)
// scratch; invp the inverse of the deficit permutation (tiled int32) or
// null; writes loss and gx (P, L, cf).  At most kMaxReps copies.
VL3D_API int vl3d_swd_mask_l1_first(const unsigned* kx, const unsigned* ky,
                                    const int* ix, int P, long long n,
                                    long long n_x, int L, int cf,
                                    long long tiled, long long deficit,
                                    const int* invp, float inv, float count,
                                    float* gm, double* partial, float* loss,
                                    float* gx, void* stream) {
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
