// K11 nn_argmin (with its ssim mode) and K18 nn_band_argmin: the GPNN
// nearest-temporal-patch searches on the CUDA cores.
//
// K11 replaces videoloop3d_tpu/losses/patch_nn.py:_pairwise_sqdist (:274)
// and nn_indices_from_dist (:330) as gpnn_lowmem_retarget (:470) and
// gpnn_direct_loss run them per crop: for every crop and spatial patch
// column, each of the ntx temporal patches X_i of the render x finds the
// index j of its nearest among the nty temporal patches Y_j of the video y
// at the same column.  Patch element (c, dt, dy, dx) of temporal patch i
// is x[c, i*st + dt, h0 + hb*sh + dy, w0 + wb*sw + dx], read straight
// from x and y: no patch tensor and no (B, n, m) distance matrix reach
// device memory.  The function is the JAX package's:
//   dist(i, j) = ((|X_i|^2 + |Y_j|^2) - 2 X_i.Y_j) / d       in f32,
//   with alpha: dist(i, j) / (alpha + min_i dist(i, j))    (NaN propagates
//   through the minimum; alpha = 0 may divide by 0 or a negative minimum,
//   and that is reproduced, not guarded),
//   nn(i) = the first j whose dist is NaN, else the first minimum.
// Two modes serve the frame-parallel gpnn loss, whose column minima run
// over every rank's x (JAX parallel/fp_step.py:126-131):
// vl3d_nn_argmin_colmin writes min_i dist(i, j) of every column and
// searches nothing, vl3d_nn_argmin_given searches with alpha + the
// caller's minima in place of its own.
// K11's ssim mode replaces _pairwise_ssim_dist (:292), the "ssim" patch
// distance (--swd_dist_fn ssim) under the same alpha and argmin rule:
//   dist(i, j) = 1 - (2 mx my + C1)(2 (X_i.Y_j / d - mx my) + C2)
//                    / ((mx^2 + my^2 + C1)(vx + vy + C2)),
// with mx, vx the mean and variance of X_i's d entries (two passes, the
// variance the mean of the squared deviations, as jnp.var), C1 = 0.01^2,
// C2 = 0.03^2, each operation rounded as the JAX package orders them.
//
// K18 replaces the temporally decomposed search of the same file,
// banded_temporal_dist (:338) as _nn_retarget_temporal (:350) runs it
// under --fast_nn_dist, and the eval's (videoloop3d_tpu/eval/nnmse.py:90
// _block_err_fn): per column it computes the per-frame (1, ph, pw) patch
// distances d1(f, g) of every frame f < fx of x and g < fy of y in the
// expanded form above (d = C ph pw), then
//   dist(i, j) = sum_{k < pt} d1(i*st + k, j*st + k)   (k ascending),
//   divided by pt when asked (training), alpha-normalized as above, and
//   writes the row argmin nn(i) (K11's layout, for K12) and, when asked,
//   the column argmin of every j over i (the eval's reverse direction).
//
// Both are one Gram per column: rows r (K11: temporal patches, nx = ntx;
// K18: frames, nx = fx) against columns s (ny = nty or fy) over a chain of
// d entries, q = ((c pt + dt) ph + dy) pw + dx for K11 and (c ph + dy) pw
// + dx per frame for K18.  Every dot product and norm is one fmaf chain
// from 0 over q ascending, whatever its place in a tile; bf16 inputs are
// widened to f32 (exactly; for the redesign by its wrappers) and summed in
// f32.  So equal patches give bit-equal distances, and the first-minimum
// rule decides their ties as the plain versions do; the plain versions sum
// in another order, so the indices agree with them except on near ties.
//
// Bound on the H100: operations, 2 nx ny d a column at 67 TFLOP/s of f32
// outside the tensor cores (TF32 is not exact, and a 3xTF32 split rounds
// otherwise; bf16 products on the tensor cores would sum in another order
// than this chain): 16-19 GFLOP per eval pair of 50 frames at 280x560
// (e.g. 45 crops x 961 columns, d = 75), 24.6 GFLOP for the ssim ref view
// (24 crops x 196 columns, d = 1,089), 6.0 for the other view (15 x 1,024,
// d = 81).  bf16 "mse" searches (the shipped --fp16 route) run on the
// tensor cores instead (nn_argmin_mma.cu), where their staged frames fit.
//
// The redesign (nn_tile_search_kernel; the first design,
// nn_search_first_kernel, stays for comparison as vl3d_nn_argmin_simt,
// vl3d_nn_argmin_ssim_first and vl3d_nn_band_argmin_first):
// * What held the first design: 4 x 4 register tiles (8 scalar shared
//   loads for 16 FMAs: the shared-memory pipe capped it near half the f32
//   peak), one 64 x 64 tile for a ~50 x 50 Gram (39-41% of its FMAs on
//   padding), one column a block with its chunks gathered element by
//   element (each column's window, and for K11 each frame pt times) and no
//   overlap of loads and FMAs, and epilogues of one thread a row or column
//   with 44-50 of 256 threads busy.
// * Register tiles sized to the Gram: an output tile has 8 x 8 threads,
//   thread (ti, tj) holding ra rows and rb columns, (ra, rb) the least of
//   6 x 6, 7 x 6, 7 x 7, 8 x 8 (template instances) that covers it: 7 x 7
//   for K18's 50 (52) x 50 frames (56 x 56, 20% padding), 7 x 6 for K11's
//   50 x 48 patches (12%).  Tiles of at most 64 x 64, looped inside the
//   block for longer videos.  Thread t's rows are the pairs 16 p + 2 t,
//   16 p + 2 t + 1, then 16 (ra / 2) + t where ra is odd (slot_row): a
//   chain entry takes ceil(ra / 2) + ceil(rb / 2) shared loads (float2
//   but one) for ra rb FMAs (8 for 49), and a warp's 8 x 4 threads read
//   8 and 4 consecutive pairs, no bank conflict.  (8 x 8 tiles read as
//   float4, tried first, were slower: a quarter-warp's 16-byte reads
//   cross 128-byte lines, and a 16-byte read takes a wavefront a
//   quarter-warp.)
// * A block takes up to 4 neighbouring columns of one row of a crop's
//   columns (64 threads each; the row split into chunks as even as they
//   allow), and they share one staged window: stage (c, dt, dy0) holds nb
//   dy rows (nb pw >= 24 chain entries where ph allows) of the window's
//   wb = pw + (ncb - 1) sw positions for every row of the tile (K18: frame
//   r; K11: frame r st + dt), position-major, rows at pitch 8 ra + 4 (8 rb
//   + 4 for y); column g's entry (dy, dx) is position (dy - dy0) wb + g sw
//   + dx.  The stages run q-ascending through a ring of two, the next one's
//   4-byte cp.async copies in flight during the FMAs (a warp's lanes take
//   8 positions x 4 rows: runs of 8 floats in device memory, no bank
//   conflict in shared memory).  Each value of a block's window is loaded
//   once a stage, about half of the first design's traffic for K18; K11
//   still loads a frame once for each dt it appears at.
// * Bit-equality: every chain is one register's fmaf over q ascending and
//   reads only real entries; where d % 32 != 0 the first design's last
//   chunk of 32 padded zeros (fmaf(0, 0, acc): -0 -> +0), so one +0 step
//   ends the chain there.  Norms ("mse", K18): one thread a row, fmaf from
//   the stage beside the FMAs.  ssim statistics: as the first design, a
//   warp a row, lane-strided sums then the xor tree 16..1, the variance in
//   a second pass, read from x and y (four rows a warp, eight entries a
//   lane in flight).  The distances are computed from the registers at the
//   end of a tile (the same operations in the same order) into the
//   column's Gram in shared memory, which lies over the ring when a column
//   is one tile.
// * Epilogues over every column of the block at once: K18's band sums,
//   then the column minima (alpha), the row argmins and K18's column
//   argmins by groups of gr (gc) lanes, gr the largest power of two with
//   ncb ntx gr <= threads: each lane a contiguous run, four entries in
//   flight, divided by alpha + the column minimum on the fly, then a
//   butterfly on (is NaN, value, index), which returns the serial loop's
//   index and value (the first NaN, else the first least value; -0 and +0
//   tie to the first).  The Gram's pitch ny | 1 and the band's nty | 1 keep
//   a row-per-lane scan free of bank conflicts.
// * Occupancy: up to 128 registers a thread (__launch_bounds__(256, 2):
//   ptxas reports the count and any spill in chip_smoke.py's build), and
//   the most columns whose shared memory leaves room for two blocks an SM
//   (113 KB each), else one; the L1 keeps the rest of the SM's 256 KB.
// Limits: a block needs the ring (2 nb wb (8 ra + 8 rb + 8) floats), per
// column the (nx, ny | 1) Gram, K18's (ntx, nty | 1) band and the row
// statistics, and for ssim 8 d bytes of offsets, within 227 KB: 217 frames
// a side for the ssim mode and 223 for "mse" at the ref view (3 x 11 x 11,
// d = 1,089; the first design 228), 157-163 for K18 at the eval's scales
// and the ref view (the first design about 160); the wrappers
// raise beyond (losses/patch_nn.py:tile_layout computes the same bytes,
// vl3d_nn_tile_smem returns this file's).
#include <climits>

#include "nn_crops.cuh"

namespace {

constexpr int kMse = 0;    // K11
constexpr int kBand = 1;   // K18
constexpr int kSsim = 2;   // K11's ssim mode
// 0.01 ** 2 and 0.03 ** 2, squared in double and rounded once, as the
// JAX package's Python constants reach f32
constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);

// ---------------------------------------------------------------------------
// the first design: 64 x 64 tiles of 4 x 4, one column a block
// ---------------------------------------------------------------------------

constexpr int kFirstThreads = 256;
constexpr int kFirstTile = 64;    // rows and columns of a register-tiled pass
constexpr int kFirstChunk = 32;   // channels staged per pass
constexpr int kFirstPitch = kFirstTile + 1;

// K11 (kMse, kSsim): rows are the ntx x nty temporal patches of dim
// C pt ph pw, nn the row argmins.  K18 (kBand): rows are the fx x fy
// frames' (1, ph, pw) patches; their distances are then summed over the
// band (divided by pt with scale_by_pt) into the (ntx, nty) distances;
// nn the row argmins and nn_cols (if not null) the column argmins.
template <typename T, int kMode>
__global__ void __launch_bounds__(kFirstThreads, 4)
    nn_search_first_kernel(const T* __restrict__ x,
                           const T* __restrict__ y, int C, int Tx, int Ty,
                           int H, int W, NnCrops cr, NnStarts so,
                           int scale_by_pt, int has_alpha, float alpha,
                           int* __restrict__ nn, int* __restrict__ nn_cols) {
  extern __shared__ float smem[];
  const int ntx = cr.ntx, nty = cr.nty, nw = cr.nw;
  constexpr bool kIsBand = kMode == kBand;
  const int ptd = kIsBand ? 1 : cr.pt;     // frames in a row's patch
  const int rst = kIsBand ? 1 : cr.st;     // frames from row to row
  const int nx = kIsBand ? (ntx - 1) * cr.st + cr.pt : ntx;
  const int ny = kIsBand ? (nty - 1) * cr.st + cr.pt : nty;
  const int d = C * ptd * cr.ph * cr.pw;
  int* offx = reinterpret_cast<int*>(smem);
  int* offy = offx + d;
  float* xs = reinterpret_cast<float*>(offy + d);  // [chunk][pitch]
  float* ys = xs + kFirstChunk * kFirstPitch;
  float* xx = ys + kFirstChunk * kFirstPitch;      // [nx] (ssim: means)
  float* yy = xx + nx;                             // [ny]
  float* cmin = yy + ny;                           // [nty]
  float* dist = cmin + nty;                        // [nx][ny]
  float* vx = dist + nx * ny;                      // [nx] (ssim: variances)
  float* vy = vx + nx;                             // [ny]

  const int tid = threadIdx.x;
  const int ncols = cr.nh * nw;
  const int crop = blockIdx.x / ncols;
  const int col = blockIdx.x % ncols;
  const int h0 = so.h0[crop / cr.n_w];
  const int w0 = so.w0[crop % cr.n_w];
  const long long hw = (long long)H * W;
  const long long pix = (long long)(h0 + (col / nw) * cr.sh) * W
      + (w0 + (col % nw) * cr.sw);

  // flat channel q = ((c * pt + dt) * ph + dy) * pw + dx -> offset
  for (int q = tid; q < d; q += kFirstThreads) {
    const int dx = q % cr.pw;
    const int dy = (q / cr.pw) % cr.ph;
    const int dt = (q / (cr.pw * cr.ph)) % ptd;
    const int c = q / (cr.pw * cr.ph * ptd);
    const int in_plane = dt * (int)hw + dy * W + dx;
    offx[q] = c * Tx * (int)hw + in_plane;
    offy[q] = c * Ty * (int)hw + in_plane;
  }
  __syncthreads();

  const float fd = (float)d;
  if constexpr (kMode == kSsim) {
    // every row's mean and (two-pass) variance, a warp a row, each
    // summed lane-strided and then over the lanes in a fixed order
    const int lane = tid % 32;
    for (int r = tid / 32; r < nx + ny; r += kFirstThreads / 32) {
      const bool is_x = r < nx;
      const T* src = is_x ? x : y;
      const int* off = is_x ? offx : offy;
      const long long row = (long long)(is_x ? r : r - nx) * rst * hw + pix;
      float s = 0.0f;
      for (int q = lane; q < d; q += 32)
        s = __fadd_rn(s, to_f32(src[row + off[q]]));
      for (int o = 16; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      const float mean = __fdiv_rn(s, fd);
      float v = 0.0f;
      for (int q = lane; q < d; q += 32) {
        const float e = __fsub_rn(to_f32(src[row + off[q]]), mean);
        v = __fadd_rn(v, __fmul_rn(e, e));
      }
      for (int o = 16; o > 0; o >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0) {
        (is_x ? xx : yy)[is_x ? r : r - nx] = mean;
        (is_x ? vx : vy)[is_x ? r : r - nx] = __fdiv_rn(v, fd);
      }
    }
  }

  // every dot product and norm sums its d products in one order (q
  // ascending), whatever its place in the tile
  const int ti = tid % 16, tj = tid / 16;
  for (int i0 = 0; i0 < nx; i0 += kFirstTile) {
    for (int j0 = 0; j0 < ny; j0 += kFirstTile) {
      float acc[4][4] = {};
      float norm = 0.0f;
      for (int q0 = 0; q0 < d; q0 += kFirstChunk) {
        for (int e = tid; e < kFirstTile * kFirstChunk; e += kFirstThreads) {
          const int r = e / kFirstChunk, q = e % kFirstChunk;
          const int qq = q0 + q;
          float xv = 0.0f, yv = 0.0f;
          if (qq < d) {
            if (i0 + r < nx)
              xv = to_f32(x[(long long)(i0 + r) * rst * hw + pix + offx[qq]]);
            if (j0 + r < ny)
              yv = to_f32(y[(long long)(j0 + r) * rst * hw + pix + offy[qq]]);
          }
          xs[q * kFirstPitch + r] = xv;
          ys[q * kFirstPitch + r] = yv;
        }
        __syncthreads();
        // the norms (the ssim mode has its rows' statistics already):
        // rows of this x tile on the first column tile, columns of this y
        // tile on the first row tile
        if (kMode != kSsim && tid < kFirstTile && j0 == 0) {
          for (int q = 0; q < kFirstChunk; ++q) {
            const float v = xs[q * kFirstPitch + tid];
            norm = fmaf(v, v, norm);
          }
        } else if (kMode != kSsim && tid >= kFirstTile && tid < 2 * kFirstTile
                   && i0 == 0) {
          for (int q = 0; q < kFirstChunk; ++q) {
            const float v = ys[q * kFirstPitch + tid - kFirstTile];
            norm = fmaf(v, v, norm);
          }
        }
        for (int q = 0; q < kFirstChunk; ++q) {
          float xv[4], yv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) xv[a] = xs[q * kFirstPitch + ti + 16 * a];
#pragma unroll
          for (int b = 0; b < 4; ++b) yv[b] = ys[q * kFirstPitch + tj + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a][b] = fmaf(xv[a], yv[b], acc[a][b]);
        }
        __syncthreads();
      }
      if (kMode != kSsim) {
        if (tid < kFirstTile && j0 == 0 && i0 + tid < nx) xx[i0 + tid] = norm;
        if (tid >= kFirstTile && tid < 2 * kFirstTile && i0 == 0
            && j0 + tid - kFirstTile < ny)
          yy[j0 + tid - kFirstTile] = norm;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ti + 16 * a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = j0 + tj + 16 * b;
          if (i < nx && j < ny) dist[i * ny + j] = acc[a][b];
        }
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < nx * ny; e += kFirstThreads) {
    const int i = e / ny, j = e % ny;
    if constexpr (kMode == kSsim) {
      const float mx = xx[i], my = yy[j];
      const float mxy = __fmul_rn(mx, my);
      const float cov = __fsub_rn(__fdiv_rn(dist[e], fd), mxy);
      const float num = __fmul_rn(__fadd_rn(__fmul_rn(2.0f, mxy), kC1),
                                  __fadd_rn(__fmul_rn(2.0f, cov), kC2));
      const float den = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(mx, mx), __fmul_rn(my, my)), kC1),
          __fadd_rn(__fadd_rn(vx[i], vy[j]), kC2));
      dist[e] = __fsub_rn(1.0f, __fdiv_rn(num, den));
    } else {
      dist[e] = __fdiv_rn(__fsub_rn(__fadd_rn(xx[i], yy[j]),
                                    __fmul_rn(2.0f, dist[e])), fd);
    }
  }
  __syncthreads();
  if constexpr (kIsBand) {
    // dist(i, j) = sum_{k < pt} d1(i st + k, j st + k), k ascending
    float* band = dist + nx * ny;                  // [ntx][nty]
    const float fpt = (float)cr.pt;
    for (int e = tid; e < ntx * nty; e += kFirstThreads) {
      const float* diag = dist + (e / nty) * cr.st * ny + (e % nty) * cr.st;
      float s = diag[0];
      for (int k = 1; k < cr.pt; ++k) s = __fadd_rn(s, diag[k * (ny + 1)]);
      band[e] = scale_by_pt ? __fdiv_rn(s, fpt) : s;
    }
    __syncthreads();
    dist = band;
  }
  if (has_alpha) {
    for (int j = tid; j < nty; j += kFirstThreads) {
      float m = dist[j];
      for (int i = 1; i < ntx; ++i) {
        const float v = dist[i * nty + j];
        if (isnan(v) || v < m) m = v;     // a NaN minimum stays NaN
      }
      cmin[j] = __fadd_rn(alpha, m);
    }
    __syncthreads();
    for (int e = tid; e < ntx * nty; e += kFirstThreads)
      dist[e] = __fdiv_rn(dist[e], cmin[e % nty]);
    __syncthreads();
  }
  // the first NaN, else the first minimum, of every row (and column)
  for (int i = tid; i < ntx; i += kFirstThreads) {
    const float* row = dist + i * nty;
    int best = 0;
    float bv = row[0];
    if (!isnan(bv)) {
      for (int j = 1; j < nty; ++j) {
        const float v = row[j];
        if (isnan(v)) { best = j; break; }
        if (v < bv) { bv = v; best = j; }
      }
    }
    nn[(long long)blockIdx.x * ntx + i] = best;
  }
  if constexpr (kIsBand) {
    if (nn_cols == nullptr) return;
    for (int j = tid; j < nty; j += kFirstThreads) {
      int best = 0;
      float bv = dist[j];
      if (!isnan(bv)) {
        for (int i = 1; i < ntx; ++i) {
          const float v = dist[i * nty + j];
          if (isnan(v)) { best = i; break; }
          if (v < bv) { bv = v; best = i; }
        }
      }
      nn_cols[(long long)blockIdx.x * nty + j] = best;
    }
  }
}

template <int kMode>
int launch_first(const void* x, const void* y, int is_bf16, int C, int Tx,
                 int Ty, int H, int W, const int* plan, int scale_by_pt,
                 int has_alpha, float alpha, int smem, int* nn, int* nn_cols,
                 void* stream) {
  NnCrops cr;
  NnStarts so;
  if (!unpack_crops(plan, &cr, &so)) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)cr.n_h * cr.n_w * cr.nh * cr.nw;
  if (blocks <= 0 || cr.ntx <= 0 || cr.nty <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    auto k = nn_search_first_kernel<__nv_bfloat16, kMode>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    k<<<(unsigned int)blocks, kFirstThreads, smem, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)y, C, Tx, Ty, H, W,
        cr, so, scale_by_pt, has_alpha, alpha, nn, nn_cols);
  } else {
    auto k = nn_search_first_kernel<float, kMode>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    k<<<(unsigned int)blocks, kFirstThreads, smem, s>>>(
        (const float*)x, (const float*)y, C, Tx, Ty, H, W, cr, so,
        scale_by_pt, has_alpha, alpha, nn, nn_cols);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the redesign: register tiles sized to the Gram, neighbouring columns of a
// block on one staged window, two stages in flight
// ---------------------------------------------------------------------------

constexpr int kColThreads = 64;  // an output tile's threads: 8 x 8
constexpr int kMaxCols = 4;      // columns a block
constexpr int kTThreads = kColThreads * kMaxCols;   // threads a block
constexpr int kStageMin = 24;    // chain entries a stage at least, where ph
                                 // allows (whole dy rows of pw entries)
constexpr int kTileRows = 64;    // Gram rows (columns) of an output tile
constexpr int kStatRows = 4;     // rows a warp's ssim statistics sum at once
constexpr int kStatLoads = 8;    // a lane's entries in flight a row
// two blocks an SM: 228 KB of shared memory, 1 KB reserved a block
constexpr int kSmemHalf = 113 * 1024;
// the register tiles compiled (rows x columns a thread), smallest first
constexpr int kTiles[4][2] = {{6, 6}, {7, 6}, {7, 7}, {8, 8}};

// The layout of one launch; losses/patch_nn.py:tile_layout computes the
// same numbers, and the launch refuses a shared size other than smem.
struct TileLayout {
  int nx, ny;        // Gram rows (x) and columns (y)
  int ra, rb;        // a thread's rows and columns (kTiles): thread (ti, tj)
                     // of 8 x 8 holds rows slot_row(ti, a), columns
                     // slot_row(tj, b)
  int n_ti, n_tj;    // output tiles (8 ra x 8 rb) along i and j
  int px, py;        // staged pitches of a window position: 8 ra + 4,
                     // 8 rb + 4 floats
  int dp, bp;        // pitches of the Gram (ny | 1) and K18's band (nty | 1)
  int nb;            // dy rows a stage
  int ncb, chunks;   // columns a block; blocks a row of a crop's columns
  int wb;            // window positions a dy row: pw + (ncb - 1) sw
  int stage;         // floats of one stage: nb wb (px + py)
  int gram;          // floats of a column's Gram, padded to 16 bytes
  int rest;          // a column's other floats, padded to 16 bytes
  int o_gram;        // where the Grams start: over the ring when a column
                     // is one output tile, else after it
  int o_rest;        // where the columns' other floats start, after both
  int threads;       // threads a block
  int gr, gc;        // lanes that search a row, a column
  int smem;
};

// Thread rows of an output tile for n Gram rows: tiles of at most 64 rows,
// as even as 8-row steps allow.
int tile_split(int n, int* n_tiles) {
  *n_tiles = (n + kTileRows - 1) / kTileRows;
  const int per = (n + *n_tiles - 1) / *n_tiles;
  return (per + 7) / 8;
}

TileLayout tile_layout(const NnCrops& cr, int d, int mode) {
  TileLayout L;
  const bool band = mode == kBand;
  L.nx = band ? (cr.ntx - 1) * cr.st + cr.pt : cr.ntx;
  L.ny = band ? (cr.nty - 1) * cr.st + cr.pt : cr.nty;
  const int ra = tile_split(L.nx, &L.n_ti), rb = tile_split(L.ny, &L.n_tj);
  for (int t = 0; t < 4; ++t) {
    L.ra = kTiles[t][0];
    L.rb = kTiles[t][1];
    if (L.ra >= ra && L.rb >= rb) break;
  }
  L.px = 8 * L.ra + 4;
  L.py = 8 * L.rb + 4;
  L.dp = L.ny | 1;
  L.bp = cr.nty | 1;
  L.nb = (kStageMin + cr.pw - 1) / cr.pw;
  if (L.nb > cr.ph) L.nb = cr.ph;
  L.gram = (L.nx * L.dp + 3) / 4 * 4;
  // a column's other floats: K18's band, the norms (ssim: means), the
  // ssim variances, the column minima
  L.rest = ((band ? cr.ntx * L.bp : 0) + L.nx + L.ny
            + (mode == kSsim ? L.nx + L.ny : 0) + cr.nty + 3) / 4 * 4;
  const bool one = L.n_ti * L.n_tj == 1;
  // for the ssim statistics, the offsets of x and y.  The most columns (in
  // chunks as even as they allow) that leave room for two blocks an SM,
  // else for one
  const int shared = mode == kSsim ? 8 * d : 0;
  for (int pass = 0; pass < 2; ++pass) {
    const int limit = pass == 0 ? kSmemHalf : kSmemLimit;
    for (int n = kMaxCols; n >= 1; --n) {
      L.chunks = (cr.nw + n - 1) / n;
      L.ncb = (cr.nw + L.chunks - 1) / L.chunks;
      L.wb = cr.pw + (L.ncb - 1) * cr.sw;
      L.stage = L.nb * L.wb * (L.px + L.py);
      const int ring = 2 * L.stage, grams = L.ncb * L.gram;
      L.o_gram = one ? 0 : ring;
      L.o_rest = one ? (ring > grams ? ring : grams) : ring + grams;
      L.smem = 4 * (L.o_rest + L.ncb * L.rest) + shared;
      if (L.smem <= limit) break;
    }
    if (L.smem <= kSmemHalf) break;
  }
  L.threads = L.ncb * kColThreads;
  L.gr = 1;
  while (L.gr < 32 && 2 * L.gr * L.ncb * cr.ntx <= L.threads) L.gr *= 2;
  L.gc = 1;
  while (L.gc < 32 && 2 * L.gc * L.ncb * cr.nty <= L.threads) L.gc *= 2;
  return L;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// (v2, i2) replaces (v1, i1) in a search for the first NaN, else the first
// least value: NaN first, then value, then index (-0 and +0 are equal
// values); an empty slot is (+inf, INT_MAX).
__device__ __forceinline__ bool takes(float v1, int i1, float v2, int i2) {
  const bool n1 = isnan(v1), n2 = isnan(v2);
  if (n1 || n2) return n2 && (!n1 || i2 < i1);
  return v2 < v1 || (!(v1 < v2) && i2 < i1);
}

// The best (takes) of p[k * stride] / div(k) over k in [lo, hi), k
// ascending, into (v, i); four loads in flight.  div: the alpha
// normalization's divisor of entry k, used when divide.
template <typename Div>
__device__ __forceinline__ void scan_run(const float* p, int stride, int lo,
                                         int hi, bool divide, Div div,
                                         float& v, int& i) {
  int k = lo;
  for (; k + 4 <= hi; k += 4) {
    float u[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) u[t] = p[(k + t) * stride];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float w = divide ? __fdiv_rn(u[t], div(k + t)) : u[t];
      if (takes(v, i, w, k + t)) {
        v = w;
        i = k + t;
      }
    }
  }
  for (; k < hi; ++k) {
    const float w = divide ? __fdiv_rn(p[k * stride], div(k)) : p[k * stride];
    if (takes(v, i, w, k)) {
      v = w;
      i = k;
    }
  }
}

// The search over the groups of gsz lanes (aligned, a power of two): each
// lane's best of its run, then a butterfly; every lane of a group ends
// with the group's best.
__device__ __forceinline__ void group_best(float& v, int& i, int gsz) {
  for (int o = 1; o < gsz; o <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (takes(v, i, ov, oi)) {
      v = ov;
      i = oi;
    }
  }
}

// Row a of thread t's kR rows (t < 8): pairs {16 p + 2 t, 16 p + 2 t + 1}
// (a = 2 p, 2 p + 1), read as one float2, then a last single row 16 (kR /
// 2) + t where kR is odd; the 8 threads' rows cover 8 kR once.
template <int kR>
__device__ __forceinline__ int slot_row(int t, int a) {
  return a < kR / 2 * 2 ? 16 * (a / 2) + 2 * t + a % 2 : 16 * (kR / 2) + t;
}

// Thread t's kR rows of a staged position p, in slot_row order.
template <int kR>
__device__ __forceinline__ void load_rows(const float* p, int t,
                                          float* v) {
#pragma unroll
  for (int q = 0; q < kR / 2; ++q) {
    const float2 w = *reinterpret_cast<const float2*>(p + 16 * q + 2 * t);
    v[2 * q] = w.x;
    v[2 * q + 1] = w.y;
  }
  if (kR % 2) v[kR - 1] = p[16 * (kR / 2) + t];
}

template <int kMode, int kRA, int kRB>
__global__ void __launch_bounds__(kTThreads, 2)
    nn_tile_search_kernel(const float* __restrict__ x,
                          const float* __restrict__ y, int C, int Tx, int Ty,
                          int H, int W, NnCrops cr, NnStarts so, TileLayout L,
                          int scale_by_pt, int has_alpha, float alpha,
                          int* __restrict__ nn, int* __restrict__ nn_cols,
                          const float* __restrict__ cmin_in,
                          float* __restrict__ cmin_out) {
  extern __shared__ __align__(16) float sm[];
  constexpr bool kIsBand = kMode == kBand;
  constexpr bool kNorms = kMode != kSsim;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nthreads = L.threads, nwarps = nthreads / 32;
  const int ntx = cr.ntx, nty = cr.nty, nx = L.nx, ny = L.ny, ncb = L.ncb;
  const int ph = cr.ph, pw = cr.pw, sw = cr.sw;
  const int ptd = kIsBand ? 1 : cr.pt;        // frames in a row's patch
  const int rst = kIsBand ? 1 : cr.st;        // frames from row to row
  const int d = C * ptd * ph * pw;
  const long long hw = (long long)H * W;
  // the block: crop, row b of its columns, chunk k of that row; columns
  // k ncb + g, g < cnt, share the window from wpix
  const int per_crop = cr.nh * L.chunks;
  const int crop = blockIdx.x / per_crop;
  const int b_row = (blockIdx.x % per_crop) / L.chunks;
  const int chunk = blockIdx.x % L.chunks;
  const int cnt = min(ncb, cr.nw - chunk * ncb);
  const long long wpix =
      (long long)(so.h0[crop / cr.n_w] + b_row * cr.sh) * W
      + so.w0[crop % cr.n_w] + chunk * ncb * sw;
  const long long out0 = (long long)crop * cr.nh * cr.nw
      + (long long)b_row * cr.nw + chunk * ncb;   // the block's first column
  const int wreal = pw + (cnt - 1) * sw;       // window positions loaded
  float* ring = sm;                            // [2][stage]
  const int o_gram = L.o_gram;
  // column g: its Gram [nx][dp] from sm + o_gram + g gram, its other
  // floats from sm + o_rest + g rest
  const int o_band = 0;                              // [ntx][bp] (K18)
  const int o_xx = kIsBand ? ntx * L.bp : 0;         // [nx]
  const int o_yy = o_xx + nx;                        // [ny]
  const int o_vx = o_yy + ny;                        // [nx], [ny] (ssim)
  const int o_cmin = o_vx + (kMode == kSsim ? nx + ny : 0);   // [nty]
  auto gram = [&](int g) { return sm + o_gram + g * L.gram; };
  auto rest = [&](int g) { return sm + L.o_rest + g * L.rest; };
  // the searched matrix of column g: K18's band, else the distances
  auto srch = [&](int g) { return kIsBand ? rest(g) + o_band : gram(g); };
  const int sp = kIsBand ? L.bp : L.dp;
  int* offx = reinterpret_cast<int*>(sm + L.o_rest + ncb * L.rest);
  int* offy = offx + d;
  const float fd = (float)d;

  // the chain's stages: stage s is (c, dt, dy0), s = (c ptd + dt) n_bands
  // + dy0 / nb; it holds, for every dy row dy0 + l (l < nb, within ph) and
  // window position u, the values of a tile's x rows (frames (i0 + r) rst
  // + dt) at [l wb + u][px] and its y rows at [l wb + u][py]; column g's
  // chain entry (dy, dx) is position l wb + g sw + dx
  const int n_bands = (ph + L.nb - 1) / L.nb;
  const int n_st = C * ptd * n_bands;
  const int n_ug = (wreal + 7) / 8;       // groups of 8 window positions
  // stage s of the tile's rows from i0 (nxr of x) and j0 (nyr of y) into
  // ring buffer b: warp tasks (side, dy row, group of 8 positions), lanes 8
  // positions x 4 rows, rows stepped by 4; pad rows and positions past the
  // block's columns are not loaded
  auto issue = [&](int s, int b, int i0, int j0, int nxr, int nyr) {
    const int c = s / (ptd * n_bands);
    const int dt = (s / n_bands) % ptd;
    const int dy0 = (s % n_bands) * L.nb;
    const int nbr = min(L.nb, ph - dy0);
    const int n_tasks = 2 * nbr * n_ug;
    const int ul = lane % 8, rl = lane / 8;
    for (int t = warp; t < n_tasks; t += nwarps) {
      const bool is_y = t % 2;
      const int l = (t / 2) / n_ug, u = ((t / 2) % n_ug) * 8 + ul;
      if (u >= wreal) continue;
      const int nrows = is_y ? nyr : nxr;
      const int pitch = is_y ? L.py : L.px;
      const float* src = (is_y ? y : x)
          + (long long)c * (is_y ? Ty : Tx) * hw
          + ((long long)((is_y ? j0 : i0) + rl) * rst + dt) * hw + wpix
          + (long long)(dy0 + l) * W + u;
      float* dst = ring + b * L.stage + (is_y ? L.nb * L.wb * L.px : 0)
          + (l * L.wb + u) * pitch + rl;
      const long long step = 4 * rst * hw;
      for (int r = rl; r < nrows; r += 4) {
        cp_async4(dst, src);
        dst += 4;
        src += step;
      }
    }
    cp_async_commit();
  };
  // every stage through the ring, the next one's copies in flight:
  // body(s, x stage, y stage, its dy rows) between two barriers
  auto stages = [&](int i0, int j0, int nxr, int nyr, auto&& body) {
    issue(0, 0, i0, j0, nxr, nyr);
    for (int s = 0; s < n_st; ++s) {
      const int b = s & 1;
      if (s + 1 < n_st) {
        issue(s + 1, b ^ 1, i0, j0, nxr, nyr);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* xst = ring + b * L.stage;
      body(s, xst, xst + L.nb * L.wb * L.px,
           min(L.nb, ph - (s % n_bands) * L.nb));
      __syncthreads();
    }
  };

  if constexpr (kMode == kSsim) {
    // flat channel q = ((c * pt + dt) * ph + dy) * pw + dx -> offset
    for (int q = tid; q < d; q += nthreads) {
      const int dx = q % pw;
      const int dy = (q / pw) % ph;
      const int dt = (q / (pw * ph)) % ptd;
      const int c = q / (pw * ph * ptd);
      const int in_plane = dt * (int)hw + dy * W + dx;
      offx[q] = c * Tx * (int)hw + in_plane;
      offy[q] = c * Ty * (int)hw + in_plane;
    }
    __syncthreads();
    // every row's mean and (two-pass) variance, a warp a row, each summed
    // lane-strided from x or y and then over the lanes in a fixed order; a
    // warp takes kStatRows rows at once (x rows, then y rows, of every
    // column), a lane's next kStatLoads entries of each in flight
    const int n_rows = ncb * (nx + ny);
    for (int t0 = warp * kStatRows; t0 < n_rows;
         t0 += nwarps * kStatRows) {
      const float* src[kStatRows];
      const int* off[kStatRows];
      bool live[kStatRows];
      float s[kStatRows], v[kStatRows];
#pragma unroll
      for (int u = 0; u < kStatRows; ++u) {
        const int t = t0 + u;
        const int g = t / (nx + ny), r = t % (nx + ny);
        live[u] = t < n_rows && g < cnt;
        const bool is_x = r < nx;
        off[u] = is_x ? offx : offy;
        src[u] = live[u] ? (is_x ? x : y) + wpix + g * sw
                     + (long long)(is_x ? r : r - nx) * rst * hw
                         : x;
        s[u] = 0.0f;
        v[u] = 0.0f;
      }
      for (int q0 = lane; q0 < d; q0 += 32 * kStatLoads) {
        float e[kStatLoads][kStatRows];
#pragma unroll
        for (int k = 0; k < kStatLoads; ++k)
#pragma unroll
          for (int u = 0; u < kStatRows; ++u) {
            const int q = q0 + 32 * k;
            e[k][u] = q < d && live[u] ? src[u][off[u][q]] : 0.0f;
          }
#pragma unroll
        for (int k = 0; k < kStatLoads; ++k)
#pragma unroll
          for (int u = 0; u < kStatRows; ++u)
            if (q0 + 32 * k < d) s[u] = __fadd_rn(s[u], e[k][u]);
      }
#pragma unroll
      for (int u = 0; u < kStatRows; ++u) {
        for (int o = 16; o > 0; o >>= 1)
          s[u] = __fadd_rn(s[u],
                           __shfl_xor_sync(0xffffffffu, s[u], o));
        s[u] = __fdiv_rn(s[u], fd);               // the mean
      }
      for (int q0 = lane; q0 < d; q0 += 32 * kStatLoads) {
        float e[kStatLoads][kStatRows];
#pragma unroll
        for (int k = 0; k < kStatLoads; ++k)
#pragma unroll
          for (int u = 0; u < kStatRows; ++u) {
            const int q = q0 + 32 * k;
            e[k][u] = q < d && live[u] ? src[u][off[u][q]] : 0.0f;
          }
#pragma unroll
        for (int k = 0; k < kStatLoads; ++k)
#pragma unroll
          for (int u = 0; u < kStatRows; ++u)
            if (q0 + 32 * k < d) {
              const float dev = __fsub_rn(e[k][u], s[u]);
              v[u] = __fadd_rn(v[u], __fmul_rn(dev, dev));
            }
      }
#pragma unroll
      for (int u = 0; u < kStatRows; ++u) {
        for (int o = 16; o > 0; o >>= 1)
          v[u] = __fadd_rn(v[u],
                           __shfl_xor_sync(0xffffffffu, v[u], o));
        const int t = t0 + u;
        if (lane == 0 && live[u]) {
          // x rows, then y rows: xx, yy (means); vx, vy (variances)
          float* cb = rest(t / (nx + ny));
          cb[o_xx + t % (nx + ny)] = s[u];
          cb[o_vx + t % (nx + ny)] = __fdiv_rn(v[u], fd);
        }
      }
    }
  }

  // the Gram: FMA thread (gm, ti, tj) holds rows slot_row(ti, a) (a <
  // kRA) x columns slot_row(tj, b) (b < kRB) of column gm's tile
  const int gm = tid / kColThreads;
  const int ti = tid % 8, tj = (tid % kColThreads) / 8;
  for (int t_i = 0; t_i < L.n_ti; ++t_i) {
    for (int t_j = 0; t_j < L.n_tj; ++t_j) {
      const int i0 = t_i * 8 * kRA, j0 = t_j * 8 * kRB;
      const int nxr = min(8 * kRA, nx - i0), nyr = min(8 * kRB, ny - j0);
      // norm chains: (column, x row) on the first column tile, (column, y
      // row) on the first row tile, summed in place in xx and yy
      const int nxn = kNorms && t_j == 0 ? nxr : 0;
      const int nyn = kNorms && t_i == 0 ? nyr : 0;
      const int n_norms = ncb * (nxn + nyn);
      if constexpr (kNorms) {
        for (int t = tid; t < n_norms; t += nthreads) {
          const int g = t / (nxn + nyn), r = t % (nxn + nyn);
          rest(g)[r < nxn ? o_xx + i0 + r : o_yy + j0 + r - nxn] = 0.0f;
        }
      }
      float acc[kRA][kRB];
#pragma unroll
      for (int a = 0; a < kRA; ++a)
#pragma unroll
        for (int c = 0; c < kRB; ++c) acc[a][c] = 0.0f;
      stages(i0, j0, nxr, nyr, [&](int s, const float* xst,
                                   const float* yst, int nbr) {
        if constexpr (kNorms) {
          for (int t = tid; t < n_norms; t += nthreads) {
            const int g = t / (nxn + nyn), r = t % (nxn + nyn);
            const bool is_x = r < nxn;
            const int pitch = is_x ? L.px : L.py;
            const float* v = (is_x ? xst + r : yst + r - nxn)
                + g * sw * pitch;
            float* out =
                rest(g) + (is_x ? o_xx + i0 + r : o_yy + j0 + r - nxn);
            float n = *out;
            for (int l = 0; l < nbr; ++l) {
              const float* vl = v + l * L.wb * pitch;
#pragma unroll 4
              for (int dx = 0; dx < pw; ++dx) {
                const float e = vl[dx * pitch];
                n = fmaf(e, e, n);
              }
            }
            *out = n;
          }
        }
        if (gm < ncb) {
          for (int l = 0; l < nbr; ++l) {
            const float* xs = xst + (l * L.wb + gm * sw) * L.px;
            const float* ys = yst + (l * L.wb + gm * sw) * L.py;
#pragma unroll 2
            for (int dx = 0; dx < pw; ++dx) {
              float av[kRA], bv[kRB];
              load_rows<kRA>(xs + dx * L.px, ti, av);
              load_rows<kRB>(ys + dx * L.py, tj, bv);
#pragma unroll
              for (int a = 0; a < kRA; ++a)
#pragma unroll
                for (int c = 0; c < kRB; ++c)
                  acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
            }
          }
        }
      });
      // the distances of the tile from the registers (its rows' norms were
      // summed on this tile or an earlier one); the first design's chunks
      // of 32 ended the chain with zeros where d % 32 != 0: one +0 step
      if (gm < ncb) {
        const bool pad = d % 32 != 0;
        const float* cb = rest(gm);
        float* gp = gram(gm);
        float xi[kRA], vi[kRA], yj[kRB], vj[kRB];
#pragma unroll
        for (int a = 0; a < kRA; ++a) {
          const int i = i0 + slot_row<kRA>(ti, a);
          xi[a] = i < nx ? cb[o_xx + i] : 0.0f;
          if constexpr (kMode == kSsim) vi[a] = i < nx ? cb[o_vx + i] : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < kRB; ++c) {
          const int j = j0 + slot_row<kRB>(tj, c);
          yj[c] = j < ny ? cb[o_yy + j] : 0.0f;
          if constexpr (kMode == kSsim)
            vj[c] = j < ny ? cb[o_vx + nx + j] : 0.0f;
        }
#pragma unroll
        for (int a = 0; a < kRA; ++a) {
#pragma unroll
          for (int c = 0; c < kRB; ++c) {
            const int i = i0 + slot_row<kRA>(ti, a);
            const int j = j0 + slot_row<kRB>(tj, c);
            const float dot = pad ? __fadd_rn(acc[a][c], 0.0f) : acc[a][c];
            float dist;
            if constexpr (kMode == kSsim) {
              const float mx = xi[a], my = yj[c];
              const float mxy = __fmul_rn(mx, my);
              const float cov = __fsub_rn(__fdiv_rn(dot, fd), mxy);
              const float num =
                  __fmul_rn(__fadd_rn(__fmul_rn(2.0f, mxy), kC1),
                            __fadd_rn(__fmul_rn(2.0f, cov), kC2));
              const float den = __fmul_rn(
                  __fadd_rn(__fadd_rn(__fmul_rn(mx, mx), __fmul_rn(my, my)),
                            kC1),
                  __fadd_rn(__fadd_rn(vi[a], vj[c]), kC2));
              dist = __fsub_rn(1.0f, __fdiv_rn(num, den));
            } else {
              dist = __fdiv_rn(__fsub_rn(__fadd_rn(xi[a], yj[c]),
                                         __fmul_rn(2.0f, dot)), fd);
            }
            if (i < nx && j < ny) gp[i * L.dp + j] = dist;
          }
        }
      }
    }
  }
  __syncthreads();

  if constexpr (kIsBand) {
    // dist(i, j) = sum_{k < pt} d1(i st + k, j st + k), k ascending; four
    // entries a thread at once
    const float fpt = (float)cr.pt;
    const int n = ntx * nty;
    for (int g = 0; g < cnt; ++g) {
      const float* gp = gram(g);
      float* bd = rest(g) + o_band;
      for (int e0 = tid; e0 < n; e0 += 4 * nthreads) {
        float sum[4];
        int at[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = min(e0 + u * nthreads, n - 1);
          const int i = e / nty, j = e % nty;
          const float* diag = gp + i * cr.st * L.dp + j * cr.st;
          at[u] = i * L.bp + j;
          sum[u] = diag[0];
          for (int k = 1; k < cr.pt; ++k)
            sum[u] = __fadd_rn(sum[u], diag[k * (L.dp + 1)]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (e0 + u * nthreads < n)
            bd[at[u]] = scale_by_pt ? __fdiv_rn(sum[u], fpt) : sum[u];
      }
    }
    __syncthreads();
  }
  const auto none = [](int) { return 1.0f; };
  if (has_alpha && cmin_in != nullptr) {
    // the given minima mode: alpha + the caller's minimum of every column
    // (another launch's cmin_out, reduced over the frame-parallel ranks)
    for (int e = tid; e < cnt * nty; e += nthreads)
      rest(e / nty)[o_cmin + e % nty] =
          __fadd_rn(alpha, cmin_in[(out0 + e / nty) * nty + e % nty]);
    __syncthreads();
  } else if (has_alpha) {
    // alpha + the minimum of every column (a NaN minimum stays NaN), gc
    // lanes a column; the minima mode writes the minimum itself and ends
    const int n_slots = cnt * nty * L.gc;
    const int seg = (ntx + L.gc - 1) / L.gc;
    for (int base = 0; base < n_slots; base += nthreads) {
      const int slot = base + tid;
      const int task = slot / L.gc, gl = slot % L.gc;
      const int g = task / nty, j = task % nty;
      float bv = INFINITY;
      int bi = INT_MAX;
      if (slot < n_slots)
        scan_run(srch(g) + j, sp, gl * seg, min(ntx, (gl + 1) * seg), false,
                 none, bv, bi);
      group_best(bv, bi, L.gc);
      if (slot < n_slots && gl == 0) {
        if (cmin_out != nullptr)
          cmin_out[(out0 + g) * nty + j] = bv;
        else
          rest(g)[o_cmin + j] = __fadd_rn(alpha, bv);
      }
    }
    __syncthreads();
    if (cmin_out != nullptr) return;
  }
  // the first NaN, else the first minimum, of every row of the distances
  // divided by alpha + their column's minimum, gr lanes a row
  {
    const int n_slots = cnt * ntx * L.gr;
    const int seg = (nty + L.gr - 1) / L.gr;
    for (int base = 0; base < n_slots; base += nthreads) {
      const int slot = base + tid;
      const int task = slot / L.gr, gl = slot % L.gr;
      const int g = task / ntx, i = task % ntx;
      float bv = INFINITY;
      int bi = INT_MAX;
      if (slot < n_slots) {
        const float* cmin = rest(g) + o_cmin;
        scan_run(srch(g) + i * sp, 1, gl * seg, min(nty, (gl + 1) * seg),
                 has_alpha, [cmin](int j) { return cmin[j]; }, bv, bi);
      }
      group_best(bv, bi, L.gr);
      if (slot < n_slots && gl == 0) nn[(out0 + g) * ntx + i] = bi;
    }
  }
  if constexpr (kIsBand) {
    // and of every column (the eval's reverse direction), gc lanes each
    if (nn_cols == nullptr) return;
    const int n_slots = cnt * nty * L.gc;
    const int seg = (ntx + L.gc - 1) / L.gc;
    for (int base = 0; base < n_slots; base += nthreads) {
      const int slot = base + tid;
      const int task = slot / L.gc, gl = slot % L.gc;
      const int g = task / nty, j = task % nty;
      float bv = INFINITY;
      int bi = INT_MAX;
      if (slot < n_slots) {
        const float cm = rest(g)[o_cmin + j];
        scan_run(srch(g) + j, sp, gl * seg, min(ntx, (gl + 1) * seg),
                 has_alpha, [cm](int) { return cm; }, bv, bi);
      }
      group_best(bv, bi, L.gc);
      if (slot < n_slots && gl == 0) nn_cols[(out0 + g) * nty + j] = bi;
    }
  }
}

template <int kMode, int kRA, int kRB>
void launch_one(const float* x, const float* y, int C, int Tx, int Ty, int H,
                int W, const NnCrops& cr, const NnStarts& so,
                const TileLayout& L, long long blocks, int scale_by_pt,
                int has_alpha, float alpha, int* nn, int* nn_cols,
                const float* cmin_in, float* cmin_out, cudaStream_t s) {
  auto k = nn_tile_search_kernel<kMode, kRA, kRB>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       L.smem);
  // shared memory for two blocks (or one), the rest of the SM's 256 KB
  // L1, which keeps the rows that neighbouring patches share
  const int carve = 2 * (L.smem + 1024) <= 228 * 1024
      ? (200 * (L.smem + 1024) + 228 * 1024 - 1) / (228 * 1024)
      : 100;
  cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                       carve);
  k<<<(unsigned int)blocks, L.threads, L.smem, s>>>(
      x, y, C, Tx, Ty, H, W, cr, so, L, scale_by_pt, has_alpha, alpha, nn,
      nn_cols, cmin_in, cmin_out);
}

template <int kMode>
int launch_tile(const void* x, const void* y, int is_bf16, int C, int Tx,
                int Ty, int H, int W, const int* plan, int scale_by_pt,
                int has_alpha, float alpha, int smem, int* nn, int* nn_cols,
                void* stream, const float* cmin_in = nullptr,
                float* cmin_out = nullptr) {
  NnCrops cr;
  NnStarts so;
  // f32 inputs only: the wrappers widen bf16 (exactly) beforehand
  if (is_bf16 || !unpack_crops(plan, &cr, &so))
    return (int)cudaErrorInvalidValue;
  if ((long long)cr.n_h * cr.n_w * cr.nh * cr.nw <= 0 || cr.ntx <= 0
      || cr.nty <= 0)
    return 0;
  const int d = C * (kMode == kBand ? 1 : cr.pt) * cr.ph * cr.pw;
  const TileLayout L = tile_layout(cr, d, kMode);
  if (smem != L.smem || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)cr.n_h * cr.n_w * cr.nh * L.chunks;
  const float* fx = (const float*)x;
  const float* fy = (const float*)y;
  cudaStream_t s = (cudaStream_t)stream;
#define VL3D_TILE(A, B)                                                    \
  if (L.ra == A && L.rb == B)                                              \
    launch_one<kMode, A, B>(fx, fy, C, Tx, Ty, H, W, cr, so, L, blocks,    \
                            scale_by_pt, has_alpha, alpha, nn, nn_cols,    \
                            cmin_in, cmin_out, s)
  VL3D_TILE(6, 6);
  VL3D_TILE(7, 6);
  VL3D_TILE(7, 7);
  VL3D_TILE(8, 8);
#undef VL3D_TILE
  return (int)cudaGetLastError();
}

}  // namespace

// ssim: 1 for the "ssim" distance, 0 for "mse"; bf16 "mse" runs on the
// tensor cores (nn_argmin_mma.cu) where its staged layout fits shared
// memory, the rest on the redesign above; smem as
// losses/patch_nn.py:_argmin_smem gives it
VL3D_API int vl3d_nn_argmin(const void* x, const void* y, int is_bf16, int C,
                            int Tx, int Ty, int H, int W, const int* plan,
                            int ssim, int has_alpha, float alpha, int smem,
                            int* nn, void* stream) {
  if (ssim)
    return launch_tile<kSsim>(x, y, is_bf16, C, Tx, Ty, H, W, plan, 0,
                              has_alpha, alpha, smem, nn, nullptr, stream);
  if (is_bf16 && nn_mma_fits(plan, C))
    return nn_argmin_mma(x, y, C, Tx, Ty, H, W, plan, has_alpha, alpha, smem,
                         nn, stream);
  return launch_tile<kMse>(x, y, is_bf16, C, Tx, Ty, H, W, plan, 0,
                           has_alpha, alpha, smem, nn, nullptr, stream);
}

// K11's two modes for the frame-parallel gpnn loss, where the column
// minima run over the x patches of every rank: vl3d_nn_argmin_colmin
// writes this launch's minimum over x of every (crop, column, y patch)
// column of the distances, cmin (n_crops, nh nw, nty) f32, and searches
// nothing; vl3d_nn_argmin_given searches with alpha + cmin_in in place of
// alpha + its own minima.  Both take vl3d_nn_argmin's kernel for the
// inputs ("mse"; bf16 on the tensor cores where it fits), so a rank that
// passes its own minima gets vl3d_nn_argmin's indices bit for bit.
VL3D_API int vl3d_nn_argmin_colmin(const void* x, const void* y, int is_bf16,
                                   int C, int Tx, int Ty, int H, int W,
                                   const int* plan, int smem, float* cmin,
                                   void* stream) {
  if (is_bf16 && nn_mma_fits(plan, C))
    return nn_argmin_mma(x, y, C, Tx, Ty, H, W, plan, 1, 0.0f, smem, nullptr,
                         stream, nullptr, cmin);
  return launch_tile<kMse>(x, y, is_bf16, C, Tx, Ty, H, W, plan, 0, 1, 0.0f,
                           smem, nullptr, nullptr, stream, nullptr, cmin);
}

VL3D_API int vl3d_nn_argmin_given(const void* x, const void* y, int is_bf16,
                                  int C, int Tx, int Ty, int H, int W,
                                  const int* plan, float alpha,
                                  const float* cmin, int smem, int* nn,
                                  void* stream) {
  if (is_bf16 && nn_mma_fits(plan, C))
    return nn_argmin_mma(x, y, C, Tx, Ty, H, W, plan, 1, alpha, smem, nn,
                         stream, cmin, nullptr);
  return launch_tile<kMse>(x, y, is_bf16, C, Tx, Ty, H, W, plan, 0, 1, alpha,
                           smem, nn, nullptr, stream, cmin, nullptr);
}

VL3D_API int vl3d_nn_band_argmin(const void* x, const void* y, int is_bf16,
                                 int C, int Tx, int Ty, int H, int W,
                                 const int* plan, int scale_by_pt,
                                 int has_alpha, float alpha, int smem,
                                 int* nn_rows, int* nn_cols, void* stream) {
  return launch_tile<kBand>(x, y, is_bf16, C, Tx, Ty, H, W, plan,
                            scale_by_pt, has_alpha, alpha, smem, nn_rows,
                            nn_cols, stream);
}

// The CUDA-core search's shared bytes for a plan (mode 0 "mse", 1 K18, 2
// "ssim"): losses/patch_nn.py:tile_layout's, which chip_smoke.py checks
// against this one at every shape it runs.
VL3D_API int vl3d_nn_tile_smem(const int* plan, int C, int mode) {
  NnCrops cr;
  NnStarts so;
  if (!unpack_crops(plan, &cr, &so)) return -1;
  const int d = C * (mode == kBand ? 1 : cr.pt) * cr.ph * cr.pw;
  return tile_layout(cr, d, mode).smem;
}

// The first designs, which chip_smoke.py and the card tests time and hold
// bit for bit beside the redesign (through first_designs.py); no path of
// the port calls them.  smem: first_designs.py:first_search_smem.
// The template's "mse" search, f32 or bf16 (K11's first design on both)
VL3D_API int vl3d_nn_argmin_simt(const void* x, const void* y, int is_bf16,
                                 int C, int Tx, int Ty, int H, int W,
                                 const int* plan, int has_alpha, float alpha,
                                 int smem, int* nn, void* stream) {
  return launch_first<kMse>(x, y, is_bf16, C, Tx, Ty, H, W, plan, 0,
                            has_alpha, alpha, smem, nn, nullptr, stream);
}

VL3D_API int vl3d_nn_argmin_ssim_first(const void* x, const void* y,
                                       int is_bf16, int C, int Tx, int Ty,
                                       int H, int W, const int* plan,
                                       int has_alpha, float alpha, int smem,
                                       int* nn, void* stream) {
  return launch_first<kSsim>(x, y, is_bf16, C, Tx, Ty, H, W, plan, 0,
                             has_alpha, alpha, smem, nn, nullptr, stream);
}

VL3D_API int vl3d_nn_band_argmin_first(const void* x, const void* y,
                                       int is_bf16, int C, int Tx, int Ty,
                                       int H, int W, const int* plan,
                                       int scale_by_pt, int has_alpha,
                                       float alpha, int smem, int* nn_rows,
                                       int* nn_cols, void* stream) {
  return launch_first<kBand>(x, y, is_bf16, C, Tx, Ty, H, W, plan,
                             scale_by_pt, has_alpha, alpha, smem, nn_rows,
                             nn_cols, stream);
}
