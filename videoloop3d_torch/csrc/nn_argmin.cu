// K11 nn_argmin and K18 nn_band_argmin: the GPNN nearest-temporal-patch
// searches.
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
// bf16 inputs are widened per product (exact in f32); sums are f32.  Every
// dot product and norm sums its d products in one fixed order (q
// ascending, one fmaf each), whatever its place in the tile, so equal
// patches give bit-equal distances and the first-minimum rule decides
// their ties as in the plain versions.  The dot products are summed in
// another order than XLA's or cuBLAS's, so the indices agree with the
// plain versions except on near ties.
//
// Bound on the H100: operations.  K11: 2 ntx nty d flops per column: 6.0
// GFLOP for the other-view config (15 crops x 1,024 columns, d = 81) and
// 24.6 GFLOP for the ref view (24 x 196, d = 1,089) at production size.
// K18: 2 fx fy d per column, 16-19 GFLOP per eval pair of 50 frames at
// 280x560 (e.g. 45 crops x 961 columns, d = 75).  f32 inputs: at 67
// TFLOP/s of f32 outside the tensor cores (TF32 is not exact).  bf16
// inputs: their products are exact in f32 and the sums f32, which is what
// the bf16 tensor cores compute, at 989 TFLOP/s: bytes bound the other
// view there, operations the ref view.
// Design: one kernel template, K11 and K18 its two instantiations (kBand);
// one block of 256 threads per (crop, column).  Rows (K11: temporal
// patches; K18: frames) are staged through shared memory in chunks of 32
// of the d channels (64 rows each, pitch 65 so that neither the staging
// writes nor the reads conflict); each thread keeps a 4 x 4 register tile
// of the 64 x 64 dot products (rows ti + 16a, columns tj + 16b); the norms
// are summed while the first tiles stream by; the column's distances (K18:
// d1 and the banded sums) stay in shared memory for the column minima and
// the argmins.  At 256 threads a block, 64 registers a thread keep 4
// blocks on an SM (K11 took 63; helper functions in its place took 72
// and 8% more time), hence the launch bounds.  Tensor cores are later
// work.
#include "nn_crops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // rows and columns of one register-tiled pass
constexpr int kChunk = 32;   // channels staged per pass
constexpr int kPitch = kTile + 1;

// K11 (kBand false): rows are the ntx x nty temporal patches of dim
// C pt ph pw, nn the row argmins.  K18 (kBand true): rows are the fx x fy
// frames' (1, ph, pw) patches; their distances are then summed over the
// band (divided by pt with scale_by_pt) into the (ntx, nty) distances;
// nn the row argmins and nn_cols (if not null) the column argmins.
template <typename T, bool kBand>
__global__ void __launch_bounds__(kThreads, 4)
    nn_search_kernel(const T* __restrict__ x, const T* __restrict__ y, int C,
                     int Tx, int Ty, int H, int W, NnCrops cr, NnStarts so,
                     int scale_by_pt, int has_alpha, float alpha,
                     int* __restrict__ nn, int* __restrict__ nn_cols) {
  extern __shared__ float smem[];
  const int ntx = cr.ntx, nty = cr.nty, nw = cr.nw;
  const int ptd = kBand ? 1 : cr.pt;     // frames in a row's patch
  const int rst = kBand ? 1 : cr.st;     // frames from row to row
  const int nx = kBand ? (ntx - 1) * cr.st + cr.pt : ntx;
  const int ny = kBand ? (nty - 1) * cr.st + cr.pt : nty;
  const int d = C * ptd * cr.ph * cr.pw;
  int* offx = reinterpret_cast<int*>(smem);
  int* offy = offx + d;
  float* xs = reinterpret_cast<float*>(offy + d);  // [kChunk][kPitch]
  float* ys = xs + kChunk * kPitch;
  float* xx = ys + kChunk * kPitch;                // [nx]
  float* yy = xx + nx;                             // [ny]
  float* cmin = yy + ny;                           // [nty]
  float* dist = cmin + nty;                        // [nx][ny]

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
  for (int q = tid; q < d; q += kThreads) {
    const int dx = q % cr.pw;
    const int dy = (q / cr.pw) % cr.ph;
    const int dt = (q / (cr.pw * cr.ph)) % ptd;
    const int c = q / (cr.pw * cr.ph * ptd);
    const int in_plane = dt * (int)hw + dy * W + dx;
    offx[q] = c * Tx * (int)hw + in_plane;
    offy[q] = c * Ty * (int)hw + in_plane;
  }
  __syncthreads();

  // every dot product and norm sums its d products in one order (q
  // ascending), whatever its place in the tile
  const int ti = tid % 16, tj = tid / 16;
  for (int i0 = 0; i0 < nx; i0 += kTile) {
    for (int j0 = 0; j0 < ny; j0 += kTile) {
      float acc[4][4] = {};
      float norm = 0.0f;
      for (int q0 = 0; q0 < d; q0 += kChunk) {
        for (int e = tid; e < kTile * kChunk; e += kThreads) {
          const int r = e / kChunk, q = e % kChunk;
          const int qq = q0 + q;
          float xv = 0.0f, yv = 0.0f;
          if (qq < d) {
            if (i0 + r < nx)
              xv = to_f32(x[(long long)(i0 + r) * rst * hw + pix + offx[qq]]);
            if (j0 + r < ny)
              yv = to_f32(y[(long long)(j0 + r) * rst * hw + pix + offy[qq]]);
          }
          xs[q * kPitch + r] = xv;
          ys[q * kPitch + r] = yv;
        }
        __syncthreads();
        // the norms: rows of this x tile on the first column tile,
        // columns of this y tile on the first row tile
        if (tid < kTile && j0 == 0) {
          for (int q = 0; q < kChunk; ++q) {
            const float v = xs[q * kPitch + tid];
            norm = fmaf(v, v, norm);
          }
        } else if (tid >= kTile && tid < 2 * kTile && i0 == 0) {
          for (int q = 0; q < kChunk; ++q) {
            const float v = ys[q * kPitch + tid - kTile];
            norm = fmaf(v, v, norm);
          }
        }
        for (int q = 0; q < kChunk; ++q) {
          float xv[4], yv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) xv[a] = xs[q * kPitch + ti + 16 * a];
#pragma unroll
          for (int b = 0; b < 4; ++b) yv[b] = ys[q * kPitch + tj + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a][b] = fmaf(xv[a], yv[b], acc[a][b]);
        }
        __syncthreads();
      }
      if (tid < kTile && j0 == 0 && i0 + tid < nx) xx[i0 + tid] = norm;
      if (tid >= kTile && tid < 2 * kTile && i0 == 0 && j0 + tid - kTile < ny)
        yy[j0 + tid - kTile] = norm;
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

  const float fd = (float)d;
  for (int e = tid; e < nx * ny; e += kThreads) {
    const int i = e / ny, j = e % ny;
    dist[e] = __fdiv_rn(__fsub_rn(__fadd_rn(xx[i], yy[j]),
                                  __fmul_rn(2.0f, dist[e])), fd);
  }
  __syncthreads();
  if constexpr (kBand) {
    // dist(i, j) = sum_{k < pt} d1(i st + k, j st + k), k ascending
    float* band = dist + nx * ny;                  // [ntx][nty]
    const float fpt = (float)cr.pt;
    for (int e = tid; e < ntx * nty; e += kThreads) {
      const float* diag = dist + (e / nty) * cr.st * ny + (e % nty) * cr.st;
      float s = diag[0];
      for (int k = 1; k < cr.pt; ++k) s = __fadd_rn(s, diag[k * (ny + 1)]);
      band[e] = scale_by_pt ? __fdiv_rn(s, fpt) : s;
    }
    __syncthreads();
    dist = band;
  }
  if (has_alpha) {
    for (int j = tid; j < nty; j += kThreads) {
      float m = dist[j];
      for (int i = 1; i < ntx; ++i) {
        const float v = dist[i * nty + j];
        if (isnan(v) || v < m) m = v;     // a NaN minimum stays NaN
      }
      cmin[j] = __fadd_rn(alpha, m);
    }
    __syncthreads();
    for (int e = tid; e < ntx * nty; e += kThreads)
      dist[e] = __fdiv_rn(dist[e], cmin[e % nty]);
    __syncthreads();
  }
  // the first NaN, else the first minimum, of every row (and column)
  for (int i = tid; i < ntx; i += kThreads) {
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
  if constexpr (kBand) {
    if (nn_cols == nullptr) return;
    for (int j = tid; j < nty; j += kThreads) {
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

template <bool kBand>
int launch(const void* x, const void* y, int is_bf16, int C, int Tx, int Ty,
           int H, int W, const int* plan, int scale_by_pt, int has_alpha,
           float alpha, int smem, int* nn, int* nn_cols, void* stream) {
  NnCrops cr;
  NnStarts so;
  if (!unpack_crops(plan, &cr, &so)) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)cr.n_h * cr.n_w * cr.nh * cr.nw;
  if (blocks <= 0 || cr.ntx <= 0 || cr.nty <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    auto k = nn_search_kernel<__nv_bfloat16, kBand>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    k<<<(unsigned int)blocks, kThreads, smem, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)y, C, Tx, Ty, H, W,
        cr, so, scale_by_pt, has_alpha, alpha, nn, nn_cols);
  } else {
    auto k = nn_search_kernel<float, kBand>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    k<<<(unsigned int)blocks, kThreads, smem, s>>>(
        (const float*)x, (const float*)y, C, Tx, Ty, H, W, cr, so,
        scale_by_pt, has_alpha, alpha, nn, nn_cols);
  }
  return (int)cudaGetLastError();
}

}  // namespace

VL3D_API int vl3d_nn_argmin(const void* x, const void* y, int is_bf16, int C,
                            int Tx, int Ty, int H, int W, const int* plan,
                            int has_alpha, float alpha, int smem, int* nn,
                            void* stream) {
  return launch<false>(x, y, is_bf16, C, Tx, Ty, H, W, plan, 0, has_alpha,
                       alpha, smem, nn, nullptr, stream);
}

VL3D_API int vl3d_nn_band_argmin(const void* x, const void* y, int is_bf16,
                                 int C, int Tx, int Ty, int H, int W,
                                 const int* plan, int scale_by_pt,
                                 int has_alpha, float alpha, int smem,
                                 int* nn_rows, int* nn_cols, void* stream) {
  return launch<true>(x, y, is_bf16, C, Tx, Ty, H, W, plan, scale_by_pt,
                      has_alpha, alpha, smem, nn_rows, nn_cols, stream);
}
