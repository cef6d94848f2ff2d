// K13 compact_sweep: hit-compaction of the sparse plane sweep.
//
// Replaces videoloop3d_tpu/render/compact.py:compact_sweep (:63).  The
// (D, P) per-plane sample arrays of one view (planes stored far first,
// slot D-1 nearest) become (S, P) slots: per pixel, the c-th hit met when
// walking from the nearest plane (D-1) to the farthest goes to slot
// S-1-c while c < S, so the slots keep the far -> near order and the
// farthest hits are dropped when a pixel has more than S.  A hit is
// k_s >= 0 || k_d >= 0.  Empty slots hold what the JAX one-hot selection
// gives them: k = -1, fu = fv = zview = 0, valid = 0.  valid is copied as
// it is.  Copies only: the kernel equals its plain version bit for bit.
//
// Bound on the H100: bytes.  It reads the two int32 tile indices of every
// (plane, pixel) (8 B) and 13 B of geometry per kept hit, and writes 21 B
// per (slot, pixel).
//
// Design (compact_bits_kernel, its layout in compact_layout, mirrored by
// render/compact.py:compact_layout): a block owns 32 pixels (a warp's
// lanes) and all D planes, with 4 warps (8 blocks an SM).
//   1. Warp w loads k_s and k_d of planes w, w + 4, ... for its 32 pixels
//      (one 128-byte row a plane, the loads of all its planes issued
//      together) and a __ballot_sync makes each plane's hit bits over the
//      pixels, kept in shared memory.
//   2. A warp a word transposes them with 32 ballots into per-pixel words:
//      bit b of word j of a pixel is its hit at plane 32 j + b.
//   3. A hit's rank is the popcount of its pixel's hits at nearer planes
//      (its word's bits above it and the nearer words' counts);
//      it is kept while rank < S, in slot S - 1 - rank.  The plane threads
//      of the kept hits load their 21 bytes (rows coalesced) into a slot
//      table in shared memory.
//   4. A warp a slot row writes each (slot, pixel) exactly once, pixels as
//      lanes: the table's entry, or the empty values below the pixel's
//      min(hits, S) kept slots.
// At most kCompactMaxPlanes planes (8 words) and as many slots.
//
// First design (compact_sweep_kernel, vl3d_compact_sweep_first): one
// thread a pixel walks its planes near to far, up to D dependent round
// trips, and stops at the S-th hit.
#include "common.cuh"

namespace {

constexpr int kCompactPix = 32;
constexpr int kCompactWarps = 4;
constexpr int kCompactMinBlocks = 8;   // blocks an SM: at most 64 registers
constexpr int kCompactMaxPlanes = 256;
constexpr int kCompactBatch = 4;   // planes a warp loads together (phase 3)

// render/compact.py:compact_layout mirrors this
struct CompactLayout {
  int pix, threads, words, smem;
};

__host__ __device__ inline CompactLayout compact_layout(int D, int S) {
  CompactLayout L;
  L.pix = kCompactPix;
  L.threads = kCompactWarps * 32;
  L.words = (D + 31) / 32;
  // plane rows, pixel words, their hits at nearer words, the slot table
  // (k_s, k_d, fu, fv, zview, valid)
  L.smem = 4 * D + 8 * 32 * L.words + S * kCompactPix * 21;
  return L;
}

__global__ void compact_sweep_kernel(
    const int* __restrict__ k_s, const int* __restrict__ k_d,
    const float* __restrict__ fu, const float* __restrict__ fv,
    const uint8_t* __restrict__ valid, const float* __restrict__ zview, int D,
    long long P, int S, int* __restrict__ o_k_s, int* __restrict__ o_k_d,
    float* __restrict__ o_fu, float* __restrict__ o_fv,
    uint8_t* __restrict__ o_valid, float* __restrict__ o_zview) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  int c = 0;
  for (int d = D - 1; d >= 0 && c < S; --d) {
    const long long i = (long long)d * P + p;
    const int ks = k_s[i], kd = k_d[i];
    if (ks >= 0 || kd >= 0) {
      const long long o = (long long)(S - 1 - c) * P + p;
      o_k_s[o] = ks;
      o_k_d[o] = kd;
      o_fu[o] = fu[i];
      o_fv[o] = fv[i];
      o_valid[o] = valid[i];
      o_zview[o] = zview[i];
      ++c;
    }
  }
  for (int s = S - 1 - c; s >= 0; --s) {
    const long long o = (long long)s * P + p;
    o_k_s[o] = -1;
    o_k_d[o] = -1;
    o_fu[o] = 0.0f;
    o_fv[o] = 0.0f;
    o_valid[o] = 0;
    o_zview[o] = 0.0f;
  }
}

// The redesign (see the file's header).
__global__ void __launch_bounds__(kCompactWarps * 32, kCompactMinBlocks)
compact_bits_kernel(
    const int* __restrict__ k_s, const int* __restrict__ k_d,
    const float* __restrict__ fu, const float* __restrict__ fv,
    const uint8_t* __restrict__ valid, const float* __restrict__ zview, int D,
    long long P, int S, int* __restrict__ o_k_s, int* __restrict__ o_k_d,
    float* __restrict__ o_fu, float* __restrict__ o_fv,
    uint8_t* __restrict__ o_valid, float* __restrict__ o_zview) {
  extern __shared__ unsigned int cm[];
  const int words = (D + 31) >> 5;
  unsigned int* rows = cm;                        // [D]
  unsigned int* pbits = rows + D;                 // [words][32]
  int* above = reinterpret_cast<int*>(pbits + 32 * words);  // [words][32]
  int* t_ks = above + 32 * words;                 // [S][32]
  int* t_kd = t_ks + S * kCompactPix;
  float* t_fu = reinterpret_cast<float*>(t_kd + S * kCompactPix);
  float* t_fv = t_fu + S * kCompactPix;
  float* t_z = t_fv + S * kCompactPix;
  uint8_t* t_v = reinterpret_cast<uint8_t*>(t_z + S * kCompactPix);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * kCompactPix + lane;
  const bool in = p < P;
  // 1. each plane's hit bits over the block's pixels
  // (both indices loaded, no short circuit: a miss has both < 0, so the
  // sign bit of their AND)
  const long long pc = in ? p : 0;
#pragma unroll 4
  for (int d = warp; d < D; d += kCompactWarps) {
    const long long i = (long long)d * P + pc;
    const bool hit = in && (k_s[i] & k_d[i]) >= 0;
    const unsigned int b = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) rows[d] = b;
  }
  __syncthreads();
  // 2. the transpose: a pixel's hit bits, 32 planes a word
  for (int j = warp; j < words; j += kCompactWarps) {
    const int d = j * 32 + lane;
    const unsigned int v = d < D ? rows[d] : 0u;
    unsigned int mine = 0u;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const unsigned int w = __ballot_sync(0xffffffffu, (v >> b) & 1u);
      if (lane == b) mine = w;
    }
    pbits[j * 32 + lane] = mine;
  }
  __syncthreads();
  // a pixel's hits at the planes of the nearer words
  if (warp == 0) {
    int acc = 0;
    for (int j = words - 1; j >= 0; --j) {
      above[j * 32 + lane] = acc;
      acc += __popc(pbits[j * 32 + lane]);
    }
  }
  __syncthreads();
  // 3. the kept hits into the slot table, kCompactBatch planes of a warp at
  // a time: their slots first, then all their loads (predicated), then the
  // stores
  for (int d0 = warp; d0 < D; d0 += kCompactBatch * kCompactWarps) {
    int slot[kCompactBatch];
#pragma unroll
    for (int m = 0; m < kCompactBatch; ++m) {
      const int d = d0 + m * kCompactWarps;
      const int j = d >> 5, b = d & 31;
      const bool on = d < D;
      const unsigned int w = on ? pbits[j * 32 + lane] : 0u;
      const int rank = (b == 31 ? 0 : __popc(w >> (b + 1)))
                       + (on ? above[j * 32 + lane] : 0);
      slot[m] = ((w >> b) & 1u) && rank < S ? S - 1 - rank : -1;
    }
    int vks[kCompactBatch], vkd[kCompactBatch];
    float vfu[kCompactBatch], vfv[kCompactBatch], vz[kCompactBatch];
    uint8_t vv[kCompactBatch];
#pragma unroll
    for (int m = 0; m < kCompactBatch; ++m) {
      if (slot[m] >= 0) {
        const long long i = (long long)(d0 + m * kCompactWarps) * P + p;
        vks[m] = k_s[i];
        vkd[m] = k_d[i];
        vfu[m] = fu[i];
        vfv[m] = fv[i];
        vz[m] = zview[i];
        vv[m] = valid[i];
      }
    }
#pragma unroll
    for (int m = 0; m < kCompactBatch; ++m) {
      if (slot[m] >= 0) {
        const int t = slot[m] * kCompactPix + lane;
        t_ks[t] = vks[m];
        t_kd[t] = vkd[m];
        t_fu[t] = vfu[m];
        t_fv[t] = vfv[m];
        t_z[t] = vz[m];
        t_v[t] = vv[m];
      }
    }
  }
  __syncthreads();
  // 4. every (slot, pixel) written once, a slot row a warp
  if (!in) return;
  const int hits = above[lane] + __popc(pbits[lane]);
  const int first = S - min(hits, S);   // the pixel's first kept slot
  for (int s = warp; s < S; s += kCompactWarps) {
    const long long o = (long long)s * P + p;
    const int t = s * kCompactPix + lane;
    const bool kept = s >= first;
    o_k_s[o] = kept ? t_ks[t] : -1;
    o_k_d[o] = kept ? t_kd[t] : -1;
    o_fu[o] = kept ? t_fu[t] : 0.0f;
    o_fv[o] = kept ? t_fv[t] : 0.0f;
    o_zview[o] = kept ? t_z[t] : 0.0f;
    o_valid[o] = kept ? t_v[t] : (uint8_t)0;
  }
}

}  // namespace

// K13's layout for D planes and S slots: pixels a block, threads a block,
// bit words a pixel, dynamic shared bytes (for the card's checks against
// render/compact.py:compact_layout)
VL3D_API int vl3d_compact_layout(int D, int S, long long* out) {
  const CompactLayout L = compact_layout(D, S);
  out[0] = L.pix;
  out[1] = L.threads;
  out[2] = L.words;
  out[3] = L.smem;
  return 0;
}

VL3D_API int vl3d_compact_sweep(const int* k_s, const int* k_d,
                                const float* fu, const float* fv,
                                const uint8_t* valid, const float* zview,
                                int D, long long P, int S, int* o_k_s,
                                int* o_k_d, float* o_fu, float* o_fv,
                                uint8_t* o_valid, float* o_zview,
                                void* stream) {
  if (D > kCompactMaxPlanes || S > kCompactMaxPlanes)
    return (int)cudaErrorInvalidValue;
  if (P > 0 && S > 0) {
    const CompactLayout L = compact_layout(D, S);
    if (L.smem > 48 * 1024)
      cudaFuncSetAttribute(compact_bits_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L.smem);
    const unsigned int blocks =
        (unsigned int)((P + kCompactPix - 1) / kCompactPix);
    compact_bits_kernel<<<blocks, L.threads, L.smem, (cudaStream_t)stream>>>(
        k_s, k_d, fu, fv, valid, zview, D, P, S, o_k_s, o_k_d, o_fu, o_fv,
        o_valid, o_zview);
  }
  return (int)cudaGetLastError();
}

// The first design (see the file's header), for chip_smoke.py and the
// card tests: first_designs.py:compact_sweep_first
VL3D_API int vl3d_compact_sweep_first(const int* k_s, const int* k_d,
                                      const float* fu, const float* fv,
                                      const uint8_t* valid,
                                      const float* zview, int D, long long P,
                                      int S, int* o_k_s, int* o_k_d,
                                      float* o_fu, float* o_fv,
                                      uint8_t* o_valid, float* o_zview,
                                      void* stream) {
  if (P > 0 && S > 0) {
    compact_sweep_kernel<<<grid_for(P), kBlock, 0, (cudaStream_t)stream>>>(
        k_s, k_d, fu, fv, valid, zview, D, P, S, o_k_s, o_k_d, o_fu, o_fv,
        o_valid, o_zview);
  }
  return (int)cudaGetLastError();
}
