// K11 nn_argmin on the tensor cores: the GPNN nearest-temporal-patch search
// for bf16 inputs under the "mse" distance (the shipped --fp16 route).
//
// Replaces videoloop3d_tpu/losses/patch_nn.py:_pairwise_sqdist (:274) and
// nn_indices_from_dist (:330) as gpnn_lowmem_retarget (:470) runs them per
// crop, with the function of nn_argmin.cu's header:
//   dist(i, j) = ((|X_i|^2 + |Y_j|^2) - 2 X_i.Y_j) / d   in f32,
//   with alpha: dist(i, j) / (alpha + min_i dist(i, j))  (NaN propagates),
//   nn(i) = the first j whose dist is NaN, else the first minimum,
// for every crop and spatial patch column, X_i the ntx temporal patches of
// the render x and Y_j the nty of the video y at that column.  f32 inputs,
// the ssim mode and bf16 videos too long to stage run on nn_argmin.cu's
// CUDA-core search, nn_tile_search_kernel (TF32 is not exact, and the
// tensor cores would sum the bf16 products in another order than its fmaf
// chains), and vl3d_nn_argmin dispatches here.
//
// Bound on the H100: bytes at both shipped views (x and y read once, the
// indices written).  The least products are those of the frame Gram
// below, 2 nfx nfy C ph pw per column (9.3 GFLOP in all at the ref view:
// 24 crops x 196 columns, nfx 52, nfy 50, C ph pw = 3*11*11), pt times
// fewer than the patch Gram's 2 ntx nty d (24.6 GFLOP), and at 989
// TFLOP/s of bf16 products with f32 sums they take less time than the
// bytes (chip_smoke.py:nn_search_ops).  The first CUDA-core template ran the
// patch Gram: no tensor cores, 8 shared-memory reads for 16 FMAs, 64 x 64
// tiles for a 50 x 48 problem and every row gathered anew (~3x each
// column's footprint, consecutive temporal patches sharing pt - 1
// frames).
//
// Design.  One block of 256 threads takes ncb columns (1 at the ref view,
// 4 at the other; 8 / ncb warps each).
// * Staging: a column's footprint, the nfx = (ntx - 1) st + pt frames of x
//   and nfy of y over its ph x pw window, is loaded once into shared
//   memory, frame-major, each frame's C ph pw values in (c, dy, dx) order
//   and zero-padded to fp = 8 x an odd number of bf16 (363 -> 376 at the
//   ref view, 27 -> 40 at the other): rows 16-byte aligned, and the eight
//   rows of an ldmatrix fall in eight distinct bank groups.  With the flat
//   channel taken as (dt, c, dy, dx) (JAX orders (c, dt, dy, dx); the dot
//   product does not depend on the order), temporal patch i is the pt fp
//   values from frame i st on (76.7 KB staged at the ref view).
// * Gram on the tensor cores, of the frames or of the patches.  Frames:
//   G(f, g) = F_x(f).F_y(g) for the nfx x nfy frames, then X_i.Y_j = the
//   sum over dt of G(i st + dt, j st + dt) in dt order; consecutive
//   patches share pt - 1 frames, so this takes pt times fewer products
//   (K18's decomposition, here inside one sum).  Patches: the pt fp values
//   from frame i st on are patch i (a Hankel view of the stage, rows
//   pitch st fp), G(i, j) = X_i.Y_j.  mma_layout takes the one that needs
//   fewer rounds of warp tasks, then the shorter mma chain: frames at the
//   ref view (one round, chains of 12 k16 steps against 18), patches at
//   the other (one round against two: 50 frames take two 48-row tiles).
//   mma.sync.m16n8k16 (bf16 in, f32 sums) with operands from ldmatrix, A
//   the y rows, B the x rows; a warp tile is 48 x 32 (3 m16 x 4 n8 tiles,
//   48 accumulators a thread); row lengths are multiples of 8, and a last
//   k8 step (m16n8k8) takes the rest.  wgmma is not used: its descriptors
//   address shared memory in its own core-matrix layout (eight contiguous
//   16-byte rows), which the padded frames (pitch fp, the pitch that keeps
//   ldmatrix conflict-free) and the overlapping patch rows are not; a
//   second copy into that layout would cost the staging traffic again for
//   products that take a small share of the time.
// * Sums: the tensor cores add without rounding each product, so a long
//   accumulator chain drifts (truncation, one-sided); each warp sums at
//   most kChunkSteps k16 steps in one chain, and the chains' partials (the
//   row split in ksplit parts, 2 at the ref view) are added in f32 in
//   split order into the column's Gram in shared memory.
// * Ties: every distance comes from the same sequence of operations,
//   whatever its place in a tile: the same k splits and chains for every
//   Gram entry, the same dt order, and the norms from one fixed routine per
//   frame (a group of lanes' strided sums of squares, then a butterfly)
//   summed over dt in order.  Equal patches give bit-equal distances, and
//   the first-minimum rule decides their ties as in the plain version.
//   The dot products are summed in another order than cuBLAS's, so the
//   indices agree with the plain version except on near ties
//   (chip_smoke.py:nn_flips).
// * Epilogue from shared memory: the expanded distance by every thread of
//   the column (into the staged frames' place); with alpha the column
//   minima, a group of lanes a column (the NaN-propagating minimum does
//   not depend on the order); the first NaN, else the first minimum, of
//   each row over its alpha-normalized values, a group of lanes a row,
//   each a contiguous run of columns, combined in run order by a butterfly.
// What bounds it now: the staging gathers (each column's 37 K values at
// the ref view arrive as 2-byte loads of 11-value runs, some 190 KB of L2
// sectors a column, and neighbouring columns' windows, which share 7 of
// 11 values, are loaded again); loading 32 frames an item instead of 16
// changed nothing.  A staged window shared between neighbouring columns
// is later work.
#include "nn_crops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpJ = 48;        // y rows of a warp tile (3 m16 tiles)
constexpr int kWarpI = 32;        // x rows of a warp tile (4 n8 tiles)
constexpr int kChunkSteps = 24;   // k16 steps summed in one mma chain
constexpr int kColBudget = 88 * 1024;   // shared bytes before ncb stops
constexpr int kColSlots = 8;      // column bases kept in shared memory
constexpr int kStageFrames = 16;  // frames a staging item loads at once

// The staged layout of one launch; patch_nn.py:mma_layout computes the
// same numbers (its smem is checked against this one's).
struct MmaLayout {
  int cpp, fp;           // values of a frame's window; staged pitch
  int nfx, nfy;          // footprint frames of x and y
  int nrx, nry, rp;      // Gram rows (x, y) and their pitch in the stage
  int band, bs;          // X_i.Y_j = sum_{k < band} G(i bs + k, j bs + k)
  int nk16, tail8;       // k16 steps of a Gram row; a last k8 step
  int ncb, wpc;          // columns a block, warps a column
  int gw;                // lanes that sum one frame's squares
  int gc, gr;            // lanes a column's minimum, a row's argmin
  int n_wi, n_wt;        // warp tiles along i; warp tiles in all
  int ksplit, n_tasks;   // k splits; warp tiles x splits
  int stage_bytes, col_bytes, smem;
};

MmaLayout mma_layout(const NnCrops& cr, int C) {
  MmaLayout L;
  L.cpp = C * cr.ph * cr.pw;
  const int u = (L.cpp + 7) / 8;
  L.fp = 8 * (u + 1 - u % 2);
  L.nfx = (cr.ntx - 1) * cr.st + cr.pt;
  L.nfy = (cr.nty - 1) * cr.st + cr.pt;
  L.gw = 1;
  while (L.gw < 32 && 8 * L.gw <= L.fp) L.gw *= 2;
  const int nf = L.nfx + L.nfy;
  // the staged frames (later the distances), the frame sums, the norms,
  // the column minima and the Gram (the frame Gram's size, the larger)
  L.stage_bytes = max(2 * nf * L.fp, 4 * cr.ntx * cr.nty);
  const int col = L.stage_bytes
      + 4 * (nf + cr.ntx + 2 * cr.nty + L.nfx * L.nfy);
  L.col_bytes = (col + 15) / 16 * 16;
  const int shared = 8 * kColSlots + 8 * L.cpp;
  L.ncb = 1;
  while (L.ncb < kColSlots && 2 * L.ncb * L.col_bytes + shared <= kColBudget)
    L.ncb *= 2;
  L.wpc = kWarps / L.ncb;
  // the Gram of the frames (rows pitch fp, length fp; pt times fewer
  // products) or of the patches (rows pitch st fp, length pt fp): the one
  // with fewer rounds of warp tasks, then the shorter mma chain
  int best_rounds = 0, best_chain = 0;
  for (int frames = 1; frames >= 0; --frames) {
    MmaLayout M = L;
    M.nrx = frames ? L.nfx : cr.ntx;
    M.nry = frames ? L.nfy : cr.nty;
    M.rp = frames ? L.fp : cr.st * L.fp;
    M.band = frames ? cr.pt : 1;
    M.bs = frames ? cr.st : 1;
    const int len = frames ? L.fp : cr.pt * L.fp;
    M.nk16 = len / 16;
    M.tail8 = (len % 16) != 0;
    M.n_wi = (M.nrx + kWarpI - 1) / kWarpI;
    M.n_wt = M.n_wi * ((M.nry + kWarpJ - 1) / kWarpJ);
    int ks = (M.nk16 + kChunkSteps - 1) / kChunkSteps;
    if (M.n_wt <= M.wpc && M.wpc / M.n_wt > ks) ks = M.wpc / M.n_wt;
    M.ksplit = ks < 1 ? 1 : (ks > M.nk16 && M.nk16 > 0 ? M.nk16 : ks);
    if (M.nk16 == 0) M.ksplit = 1;
    M.n_tasks = M.n_wt * M.ksplit;
    const int rounds = (M.n_tasks + M.wpc - 1) / M.wpc;
    const int chain = (M.nk16 + M.ksplit - 1) / M.ksplit;
    if (frames || rounds < best_rounds
        || (rounds == best_rounds && chain < best_chain)) {
      L = M;
      best_rounds = rounds;
      best_chain = chain;
    }
  }
  const int cn = L.wpc * 32;          // threads a column
  L.gc = 1;
  while (L.gc < 32 && 2 * L.gc * cr.nty <= cn) L.gc *= 2;
  L.gr = 1;
  while (L.gr < 32 && 2 * L.gr * cr.ntx <= cn) L.gr *= 2;
  L.smem = L.ncb * L.col_bytes + 8 * kColSlots + 8 * L.cpp;
  return L;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned a, unsigned* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(unsigned a, unsigned* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void mma16(float* c, const unsigned* a,
                                      unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma8(float* c, const unsigned* a,
                                     unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__global__ void __launch_bounds__(kThreads, 2)
    nn_mma_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ y, int C, int Tx, int Ty,
                  int H, int W, NnCrops cr, NnStarts so, MmaLayout L,
                  int has_alpha, float alpha, int* __restrict__ nn,
                  const float* __restrict__ cmin_in,
                  float* __restrict__ cmin_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ntx = cr.ntx, nty = cr.nty, st = cr.st;
  const int fp = L.fp, cpp = L.cpp, nf = L.nfx + L.nfy;
  const long long hw = (long long)H * W;
  const int per_crop = cr.nh * cr.nw;
  const long long n_cols = (long long)cr.n_h * cr.n_w * per_crop;
  const long long col0 = (long long)blockIdx.x * L.ncb;
  long long* colpix = reinterpret_cast<long long*>(smem + L.ncb * L.col_bytes);
  int* offx = reinterpret_cast<int*>(colpix + kColSlots);
  int* offy = offx + cpp;

  // within-frame offsets, q = (c ph + dy) pw + dx; column bases (-1: past
  // the last column)
  for (int q = tid; q < cpp; q += kThreads) {
    const int dx = q % cr.pw, dy = (q / cr.pw) % cr.ph;
    const int c = q / (cr.pw * cr.ph);
    offx[q] = c * Tx * (int)hw + dy * W + dx;
    offy[q] = c * Ty * (int)hw + dy * W + dx;
  }
  if (tid < L.ncb) {
    const long long g = col0 + tid;
    long long pix = -1;
    if (g < n_cols) {
      const int crop = (int)(g / per_crop), col = (int)(g % per_crop);
      pix = (long long)(so.h0[crop / cr.n_w] + (col / cr.nw) * cr.sh) * W
          + so.w0[crop % cr.n_w] + (col % cr.nw) * cr.sw;
    }
    colpix[tid] = pix;
  }
  __syncthreads();

  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  // staging: items of (slot (column, q), kStageFrames frames), slots
  // fastest so that a warp reads runs of dx; each thread keeps an item's
  // loads in flight together.  Zeros in the padding and past the last
  // column.
  const int slots = L.ncb * fp;
  const int n_items = slots * ((nf + kStageFrames - 1) / kStageFrames);
  for (int it = tid; it < n_items; it += kThreads) {
    const int s = it % slots, g0 = it / slots * kStageFrames;
    const int lc = s / fp, q = s % fp;
    __nv_bfloat16* dst =
        reinterpret_cast<__nv_bfloat16*>(smem + lc * L.col_bytes) + q;
    const long long pix = colpix[lc];
    const bool live = q < cpp && pix >= 0;
    const __nv_bfloat16* sx = x + (live ? pix + offx[q] : 0);
    const __nv_bfloat16* sy = y + (live ? pix + offy[q] : 0);
    // every load issued (a dead one reads x[0]), then the zeros chosen
    __nv_bfloat16 v[kStageFrames];
#pragma unroll
    for (int u = 0; u < kStageFrames; ++u) {
      const int g = g0 + u;
      const __nv_bfloat16* src = !live || g >= nf ? x
          : g < L.nfx ? sx + g * hw : sy + (g - L.nfx) * hw;
      v[u] = *src;
    }
#pragma unroll
    for (int u = 0; u < kStageFrames; ++u)
      if (g0 + u < nf) dst[(g0 + u) * fp] = live ? v[u] : zero;
  }
  __syncthreads();

  const int lc = warp / L.wpc, wc = warp % L.wpc;
  unsigned char* cb = smem + lc * L.col_bytes;
  const __nv_bfloat16* fx = reinterpret_cast<const __nv_bfloat16*>(cb);
  const __nv_bfloat16* fy = fx + L.nfx * fp;
  float* dist = reinterpret_cast<float*>(cb);   // [ntx][nty], after the Gram
  float* fs = reinterpret_cast<float*>(cb + L.stage_bytes);  // [nf]
  float* xx = fs + nf;                                       // [ntx]
  float* yy = xx + ntx;                                      // [nty]
  float* cmin = yy + nty;                                    // [nty]
  float* gram = cmin + nty;                                  // [nrx][nry]
  const int nrx = L.nrx, nry = L.nry, rp = L.rp;
  const int ct = wc * 32 + lane, cn = L.wpc * 32;   // thread in the column

  // every frame's sum of squares by one routine: a group of L.gw lanes a
  // frame, each summing groups of four values (8-byte reads) lane-strided
  // with fmaf, then a butterfly within the group whose lanes all end with
  // the same value
  {
    const int gl = lane % L.gw, per_warp = 32 / L.gw;
    const int n_rounds = (nf + L.wpc * per_warp - 1) / (L.wpc * per_warp);
    for (int r = 0; r < n_rounds; ++r) {
      const int g = (r * L.wpc + wc) * per_warp + lane / L.gw;
      const uint2* f = reinterpret_cast<const uint2*>(fx + min(g, nf - 1) * fp);
      float s = 0.0f;
      for (int q = gl; q < fp / 4; q += L.gw) {
        const uint2 w = f[q];
        const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float v = __bfloat162float(b[t]);
          s = fmaf(v, v, s);
        }
      }
      for (int o = L.gw / 2; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      if (gl == 0 && g < nf) fs[g] = s;
    }
  }
  __syncthreads();
  for (int r = ct; r < ntx + nty; r += cn) {
    const bool is_x = r < ntx;
    const float* f = fs + (is_x ? r * st : L.nfx + (r - ntx) * st);
    float s = f[0];
    for (int k = 1; k < cr.pt; ++k) s = __fadd_rn(s, f[k]);
    (is_x ? xx[r] : yy[r - ntx]) = s;
  }

  // the Gram of the frames or the patches: warp tasks (warp tile, k
  // split), split-major; each split's partial added into gram in split
  // order
  const int last = L.ksplit - 1;
  for (int base = 0; base < L.n_tasks; base += L.wpc) {
    const int task = base + wc;
    const bool has = task < L.n_tasks;
    const int t = has ? task % L.n_wt : 0, sp = has ? task / L.n_wt : -1;
    const int j0 = (t / L.n_wi) * kWarpJ, i0 = (t % L.n_wi) * kWarpI;
    float acc[3][4][4];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[a][b][r] = 0.0f;
    if (has) {
      // row addresses: A (y) lanes 0-15 rows, 16-31 the k8-15 half; B (x)
      // lanes 0-7 / 8-15 the first n8 tile's k halves, 16-31 the second's
      unsigned a_at[3], b_at[2];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int j = min(j0 + 16 * m + (lane & 15), nry - 1);
        a_at[m] = smem_addr(fy + j * rp + (lane >> 4) * 8);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int i = min(i0 + 16 * p + (lane >> 4) * 8 + (lane & 7), nrx - 1);
        b_at[p] = smem_addr(fx + i * rp + ((lane >> 3) & 1) * 8);
      }
      const int mt = min(3, (nry - j0 + 15) / 16);   // live m16 tiles
      const int nt = min(4, (nrx - i0 + 7) / 8);     // live n8 tiles
      const int k_lo = L.nk16 * sp / L.ksplit;
      const int k_hi = L.nk16 * (sp + 1) / L.ksplit;
      for (int k = k_lo; k < k_hi; ++k) {
        const unsigned ko = k * 32;
        unsigned a[3][4], b[2][4];
#pragma unroll
        for (int m = 0; m < 3; ++m)
          if (m < mt) ldsm_x4(a_at[m] + ko, a[m]);
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (2 * p < nt) ldsm_x4(b_at[p] + ko, b[p]);
#pragma unroll
        for (int m = 0; m < 3; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            if (m < mt && n < nt)
              mma16(acc[m][n], a[m], b[n / 2][(n % 2) * 2],
                    b[n / 2][(n % 2) * 2 + 1]);
      }
      if (L.tail8 && sp == last) {
        // k8: A rows from lanes 0-15 (as above); B rows i from lanes 0-7
        // (first n8 tile) and 8-15 (second), the k0-7 half
        const unsigned ko = L.nk16 * 32;
        unsigned a[3][2], b[2][2];
#pragma unroll
        for (int m = 0; m < 3; ++m)
          if (m < mt) ldsm_x2(a_at[m] + ko, a[m]);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int i = min(i0 + 16 * p + ((lane >> 3) & 1) * 8 + (lane & 7),
                            nrx - 1);
          if (2 * p < nt) ldsm_x2(smem_addr(fx + i * rp) + ko, b[p]);
        }
#pragma unroll
        for (int m = 0; m < 3; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            if (m < mt && n < nt) mma8(acc[m][n], a[m], b[n / 2][n % 2]);
      }
    }
    const int s_lo = base / L.n_wt;
    const int s_hi = (min(L.n_tasks, base + L.wpc) - 1) / L.n_wt;
    for (int ss = s_lo; ss <= s_hi; ++ss) {
      __syncthreads();
      if (sp != ss) continue;
      // accumulator (m, n, r): j = j0 + 16 m + lane / 4 + 8 (r / 2),
      // i = i0 + 8 n + 2 (lane % 4) + r % 2
#pragma unroll
      for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = j0 + 16 * m + lane / 4 + 8 * (r / 2);
            const int i = i0 + 8 * n + 2 * (lane % 4) + r % 2;
            if (i < nrx && j < nry) {
              float* p = gram + i * nry + j;
              *p = ss == 0 ? acc[m][n][r] : __fadd_rn(*p, acc[m][n][r]);
            }
          }
    }
  }
  __syncthreads();

  // the expanded distance, the dot product X_i.Y_j the sum over k of
  // G(i bs + k, j bs + k) in order (the frame Gram's band), every thread
  // of the column stepping (i, j) without a division; dist takes the
  // staged frames' place
  {
    const float fd = (float)(C * cr.pt * cr.ph * cr.pw);
    const int di = cn / nty, dj = cn % nty;
    int i = ct / nty, j = ct % nty;
    for (int e = ct; e < ntx * nty; e += cn) {
      const float* g = gram + (i * L.bs) * nry + j * L.bs;
      float dot = g[0];
      for (int k = 1; k < L.band; ++k) dot = __fadd_rn(dot, g[k * (nry + 1)]);
      dist[e] = __fdiv_rn(__fsub_rn(__fadd_rn(xx[i], yy[j]),
                                    __fmul_rn(2.0f, dot)), fd);
      i += di;
      j += dj;
      if (j >= nty) { j -= nty; ++i; }
    }
  }
  __syncthreads();
  // column minima (with alpha): L.gc lanes a column, lane-strided rows,
  // then a butterfly (a NaN minimum stays NaN; the minimum of the values
  // does not depend on their order)
  if (has_alpha && cmin_in != nullptr) {
    // the given minima mode (nn_argmin.cu:vl3d_nn_argmin_given)
    for (int j = ct; j < nty; j += cn)
      if (colpix[lc] >= 0)
        cmin[j] = __fadd_rn(alpha, cmin_in[(col0 + lc) * nty + j]);
    __syncthreads();
  } else if (has_alpha) {
    const int n_rounds = (nty * L.gc + cn - 1) / cn;
    for (int r = 0; r < n_rounds; ++r) {
      const int slot = r * cn + ct, j = slot / L.gc, gl = slot % L.gc;
      float m = INFINITY;
      if (j < nty)
        for (int i = gl; i < ntx; i += L.gc) {
          const float v = dist[i * nty + j];
          if (isnan(v) || v < m) m = v;
        }
      for (int o = L.gc / 2; o > 0; o >>= 1) {
        const float v = __shfl_xor_sync(0xffffffffu, m, o);
        if (isnan(v) || v < m) m = v;
      }
      if (gl == 0 && j < nty) {
        // the minima mode (nn_argmin.cu:vl3d_nn_argmin_colmin) writes m
        if (cmin_out == nullptr)
          cmin[j] = __fadd_rn(alpha, m);
        else if (colpix[lc] >= 0)
          cmin_out[(col0 + lc) * nty + j] = m;
      }
    }
    __syncthreads();
    if (cmin_out != nullptr) return;
  }
  // the first NaN, else the first minimum, of every row of dist (divided
  // by the column's alpha + minimum): L.gr lanes a row, each a contiguous
  // run of the columns, then a butterfly that keeps the lower run's
  // choice unless the upper run has the first NaN or a smaller value
  {
    const int seg = (nty + L.gr - 1) / L.gr;
    const int n_rounds = (ntx * L.gr + cn - 1) / cn;
    for (int r = 0; r < n_rounds; ++r) {
      const int slot = r * cn + ct, i = slot / L.gr, gl = slot % L.gr;
      int best = -1;            // -1: no column yet
      bool is_nan = false;
      float bv = 0.0f;
      if (i < ntx) {
        const float* row = dist + i * nty;
        for (int j = gl * seg; j < min(nty, (gl + 1) * seg); ++j) {
          const float v = has_alpha ? __fdiv_rn(row[j], cmin[j]) : row[j];
          if (isnan(v)) { best = j; is_nan = true; break; }
          if (best < 0 || v < bv) { bv = v; best = j; }
        }
      }
      for (int o = 1; o < L.gr; o <<= 1) {
        const int ob = __shfl_xor_sync(0xffffffffu, best, o);
        const bool on = __shfl_xor_sync(0xffffffffu, is_nan, o);
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const bool upper = (gl & o) == 0;     // the partner's run is later
        const bool take = upper
            ? !is_nan && ob >= 0 && (on || best < 0 || ov < bv)
            : on || (!is_nan && ob >= 0 && !(bv < ov && best >= 0));
        if (take) { best = ob; is_nan = on; bv = ov; }
      }
      if (gl == 0 && i < ntx && colpix[lc] >= 0)
        nn[(col0 + lc) * ntx + i] = best;
    }
  }
}

}  // namespace

bool nn_mma_fits(const int* plan, int C) {
  NnCrops cr;
  NnStarts so;
  return unpack_crops(plan, &cr, &so) && mma_layout(cr, C).smem <= kSmemLimit;
}

// x (C, Tx, H, W), y (C, Ty, H, W) bf16; smem must equal the layout's
// (patch_nn.py:_argmin_smem).  Called by nn_argmin.cu:vl3d_nn_argmin.
int nn_argmin_mma(const void* x, const void* y, int C, int Tx, int Ty, int H,
                  int W, const int* plan, int has_alpha, float alpha,
                  int smem, int* nn, void* stream, const float* cmin_in,
                  float* cmin_out) {
  NnCrops cr;
  NnStarts so;
  if (!unpack_crops(plan, &cr, &so)) return (int)cudaErrorInvalidValue;
  const long long cols = (long long)cr.n_h * cr.n_w * cr.nh * cr.nw;
  if (cols <= 0 || cr.ntx <= 0 || cr.nty <= 0) return 0;
  const MmaLayout L = mma_layout(cr, C);
  if (smem != L.smem) return (int)cudaErrorInvalidValue;
  const long long blocks = (cols + L.ncb - 1) / L.ncb;
  cudaFuncSetAttribute(nn_mma_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(nn_mma_kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  nn_mma_kernel<<<(unsigned int)blocks, kThreads, smem,
                  (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)y, C, Tx, Ty, H, W, cr,
      so, L, has_alpha, alpha, nn, cmin_in, cmin_out);
  return (int)cudaGetLastError();
}
