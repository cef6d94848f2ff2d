// K12 nn_fold: select, fold, crop overlap-add and weight division of the
// GPNN target.
//
// Replaces, in videoloop3d_tpu/losses/patch_nn.py, the selection
// (take_along_axis, :428), the fold (fold_patches_flat :219 /
// fold_patches_3d :96) and gpnn_lowmem_retarget's crop overlap-add and
// division by the fold weight (:525-532).  The NN is temporal only: the
// selected patch of column (ih, iw) lies at the same pixels, so each
// output voxel reads y at its own pixel:
//   y2x[c, t, h, w] = sum over the crops covering (h, w), and the patches
//     (it, ih, iw) of that crop covering (t, h - h0, w - w0), of
//     y[c, nn[crop, ih * nw + iw, it] * st + (t - it * st), h, w],
//   divided by the number of those patches (the fold of ones, the JAX
//   package's weight; a voxel no patch covers gets 0 / 1e-10 = 0).
// bf16 y is read as bf16 and summed in f32; the output is f32.  Each
// voxel's terms are added in one fixed order (crops row-major, then ih,
// iw, it), so the result is deterministic, with no atomics and no patch
// tensor.
//
// The parent mode (parent factor f > 1) replaces gpnn_downsample_loss's
// fold (:682-722): the crops are the full-resolution ones (hs_full,
// ws_full, span wide), and patch column (ih, iw) of a crop takes the index
// its low-resolution parent found, nn[crop, (ih / f) (nw / f) + iw / f,
// it] (the JAX package's repeat of the indices over both axes).  A voxel
// no patch covers gets 0 (the loss masks it out).  f is a launch argument:
// in NnCrops it would cost K11 registers (nn_crops.cuh).  f = 1 is K12
// itself.
//
// The numerator mode (vl3d_nn_fold_numer) writes each voxel's sum
// undivided: the frame-parallel gpnn loss
// (videoloop3d_torch/parallel/fp_step.py, JAX parallel/fp_step.py:110-170)
// adds the previous rank's spill to it before it divides.
//
// Bound on the H100: bytes.  It writes the (C, fit_tx, fit_h, fit_w) f32
// target (35.6 MB at production size) and reads the indices and, per
// voxel, up to pt/st * (p/s)^2 covering patches' voxels of y (those of a
// column share its pixel, and mostly hit L1/L2).
//
// Design (nn_fold_tile_kernel).  A block holds one output row h, 32
// neighbouring w (a warp's lanes) and tb neighbouring t (the warps take
// them in turn).  Every output voxel reads y only at its own pixel, so the
// block stages y[:, :, h, w0 : w0 + 32] once in shared memory, widened to
// f32 ([channel][frame][lane]: a lane reads its own bank whatever frame
// it selects).  It lists the (crop, ih) rows covering h and the (crop, iw)
// columns covering any of its 32 w and stages once the indices of those
// columns at the temporal patches its t need.  Each lane lists once, in
// the first design's order, the (row, column) pairs that cover its pixel;
// a thread then walks that list for its voxel's t, all C channels at once
// (in groups of kFoldCg) sharing each term's index and frame, from shared
// memory only; a pair's loads over up to three temporal patches are issued
// before they are added.  The divisor is the plan's fold weight, the
// product of the patches covering t, h and w (n_span), not a count kept
// in the loop.  Each voxel's sum runs in the first design's order, so the
// output equals it bit for bit (nn_fold_kernel, one thread per voxel and
// channel that reads each term's index and value from device memory,
// kept as vl3d_nn_fold_first).  The staged y and indices must fit a
// block's shared memory (fold_layout; losses/patch_nn.py:nn_fold_layout
// mirrors it): tb, then the channels staged at once, shrink until they
// do.
#include "nn_crops.cuh"

namespace {

__host__ __device__ inline int first_patch(int pos, int p, int s) {
  // smallest i >= 0 with i * s + p > pos
  const int num = pos - p + 1;
  return num <= 0 ? 0 : (num + s - 1) / s;
}

// K12's first design: one thread per output voxel and channel.
template <typename T>
__global__ void nn_fold_kernel(const T* __restrict__ y,
                               const int* __restrict__ nn, int C, int Ty,
                               int H, int W, NnCrops cr, NnStarts so,
                               int parent, int ft, int fh, int fw,
                               float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)C * ft * fh * fw;
  if (idx >= n) return;
  const int w = (int)(idx % fw);
  const int h = (int)((idx / fw) % fh);
  const int t = (int)((idx / ((long long)fw * fh)) % ft);
  const int c = (int)(idx / ((long long)fw * fh * ft));
  const int pt = cr.pt, ph = cr.ph, pw = cr.pw;
  const int st = cr.st, sh = cr.sh, sw = cr.sw;
  const int nh = cr.nh, nw = cr.nw, ntx = cr.ntx;
  const long long hw = (long long)H * W;
  const T* yc = y + (long long)c * Ty * hw + (long long)h * W + w;
  const int it_lo = first_patch(t, pt, st);
  const int it_hi = min(ntx - 1, t / st);
  float acc = 0.0f;
  int count = 0;
  for (int a = 0; a < cr.n_h; ++a) {
    const int hh = h - so.h0[a];
    if (hh < 0 || hh >= cr.mh) continue;
    const int ih_lo = first_patch(hh, ph, sh);
    const int ih_hi = min(nh - 1, hh / sh);
    for (int b = 0; b < cr.n_w; ++b) {
      const int ww = w - so.w0[b];
      if (ww < 0 || ww >= cr.mw) continue;
      const int iw_lo = first_patch(ww, pw, sw);
      const int iw_hi = min(nw - 1, ww / sw);
      // the index grid of a crop: nh / parent x nw / parent columns
      const int gw = nw / parent;
      const int* nn_crop = nn + (long long)(a * cr.n_w + b) * (nh / parent)
          * gw * ntx;
      for (int ih = ih_lo; ih <= ih_hi; ++ih) {
        for (int iw = iw_lo; iw <= iw_hi; ++iw) {
          const int* nn_col = nn_crop
              + (long long)((ih / parent) * gw + iw / parent) * ntx;
          for (int it = it_lo; it <= it_hi; ++it) {
            const int frame = nn_col[it] * st + (t - it * st);
            acc = __fadd_rn(acc, to_f32(yc[(long long)frame * hw]));
            ++count;
          }
        }
      }
    }
  }
  out[idx] = __fdiv_rn(acc, count > 0 ? (float)count : 1e-10f);
}

// Patches of size p at stride s (n of them, in an extent m) covering
// some position of [lo, hi].
__host__ __device__ inline int n_span(int lo, int hi, int p, int s, int n,
                                      int m) {
  lo = lo < 0 ? 0 : lo;
  hi = hi > m - 1 ? m - 1 : hi;
  if (lo > hi) return 0;
  const int first = first_patch(lo, p, s);
  const int last = (n - 1 < hi / s) ? n - 1 : hi / s;
  return last >= first ? last - first + 1 : 0;
}

constexpr int kFoldW = 32;                // w a block (a warp's lanes)
constexpr int kFoldWarps = 8;             // warps a block
constexpr int kFoldCg = 4;                // channels a thread sums at once
constexpr int kFoldIt = 3;                // temporal patches loaded at once
constexpr long long kFoldSmemLimit = 232448;

struct FoldLayout {
  int tb;            // t a block
  int cg;            // channels staged at once (at most kFoldCg)
  int rmax, qmax;    // the most (crop, ih) rows and (crop, iw) columns
  int pmax;          // the most (row, column) pairs covering one voxel
  int ntmax;         // the most temporal patches a block stages
  long long smem;    // staged y and indices, rows, columns and pairs
};

// losses/patch_nn.py:nn_fold_layout mirrors this.  tb starts at ft (one
// t block) and cg at min(C, kFoldCg); while the block's shared memory
// exceeds the limit, tb halves (not below kFoldWarps), then cg, then tb.
inline FoldLayout fold_layout(const NnCrops& cr, const NnStarts& so, int C,
                              int Ty, int ft, int fh, int fw) {
  FoldLayout L = {ft, C < kFoldCg ? C : kFoldCg, 0, 0, 0, 0, 0};
  int cwmax = 0;
  for (int w = 0; w < fw; ++w) {
    int c = 0;
    for (int b = 0; b < cr.n_w; ++b)
      c += n_span(w - so.w0[b], w - so.w0[b], cr.pw, cr.sw, cr.nw, cr.mw);
    cwmax = c > cwmax ? c : cwmax;
  }
  for (int h = 0; h < fh; ++h) {
    int r = 0;
    for (int a = 0; a < cr.n_h; ++a)
      r += n_span(h - so.h0[a], h - so.h0[a], cr.ph, cr.sh, cr.nh, cr.mh);
    L.rmax = r > L.rmax ? r : L.rmax;
  }
  for (int x0 = 0; x0 < fw; x0 += kFoldW) {
    const int x1 = (x0 + kFoldW < fw ? x0 + kFoldW : fw) - 1;
    int q = 0;
    for (int b = 0; b < cr.n_w; ++b)
      q += n_span(x0 - so.w0[b], x1 - so.w0[b], cr.pw, cr.sw, cr.nw, cr.mw);
    L.qmax = q > L.qmax ? q : L.qmax;
  }
  L.pmax = L.rmax * cwmax;
  for (;;) {
    L.ntmax = 0;
    for (int t0 = 0; t0 < ft; t0 += L.tb) {
      const int t1 = (t0 + L.tb < ft ? t0 + L.tb : ft) - 1;
      const int nt = n_span(t0, t1, cr.pt, cr.st, cr.ntx, ft);
      L.ntmax = nt > L.ntmax ? nt : L.ntmax;
    }
    L.smem = 4LL * ((long long)L.cg * Ty * kFoldW
                    + (long long)L.rmax * L.qmax * L.ntmax + 2LL * L.rmax
                    + 2LL * L.qmax + (long long)L.pmax * kFoldW);
    if (L.smem <= kFoldSmemLimit) return L;
    if (L.tb > kFoldWarps) {
      L.tb = (L.tb + 1) / 2 > kFoldWarps ? (L.tb + 1) / 2 : kFoldWarps;
    } else if (L.cg > 1) {
      L.cg = (L.cg + 1) / 2;
    } else if (L.tb > 1) {
      L.tb = (L.tb + 1) / 2;
    } else {
      return L;
    }
  }
}

// One warp lists, in crop order, the (crop, index) entries of the patches
// (size p, stride s, n a crop of extent m) covering some position of
// [lo, hi] of the crops starting at starts[0..n_crops); returns the count.
__device__ int list_patches(int lane, int n_crops, const int* starts, int lo,
                            int hi, int p, int s, int n, int m, int* crop,
                            int* index) {
  int base = 0;
  for (int r = 0; r < n_crops; r += 32) {
    const int a = r + lane;
    int cnt = 0, first = 0;
    if (a < n_crops) {
      cnt = n_span(lo - starts[a], hi - starts[a], p, s, n, m);
      if (cnt > 0) first = first_patch(max(lo - starts[a], 0), p, s);
    }
    int inc = cnt;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += v;
    }
    for (int q = 0; q < cnt; ++q) {
      crop[base + inc - cnt + q] = a;
      index[base + inc - cnt + q] = first + q;
    }
    base += __shfl_sync(0xffffffffu, inc, 31);
  }
  return base;
}

template <typename T>
__global__ void nn_fold_tile_kernel(const T* __restrict__ y,
                                    const int* __restrict__ nn, int C, int Ty,
                                    int H, int W, NnCrops cr, NnStarts so,
                                    int parent, int ft, int fh, int fw,
                                    int tb, int cg, int rmax, int qmax,
                                    int pmax, int numer,
                                    float* __restrict__ out) {
  extern __shared__ float fsm[];
  __shared__ int n_rows, n_cols;
  float* ys = fsm;                     // [cg][Ty][32] the tile's y, as f32
  int* row_crop = reinterpret_cast<int*>(ys + cg * Ty * kFoldW);
  int* row_ih = row_crop + rmax;       // [rmax] (crop a, ih) rows
  int* col_crop = row_ih + rmax;       // [qmax] (crop b, iw) columns
  int* col_iw = col_crop + qmax;
  int* pairs = col_iw + qmax;          // [pmax][32] a lane's index rows
  int* sidx = pairs + pmax * kFoldW;   // [rows][cols][nt] indices
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int w0 = blockIdx.x * kFoldW, h = blockIdx.y, t0 = blockIdx.z * tb;
  const int pt = cr.pt, ph = cr.ph, pw = cr.pw;
  const int st = cr.st, sh = cr.sh, sw = cr.sw;
  const int ntx = cr.ntx;
  const int w1 = min(w0 + kFoldW, fw) - 1, t1 = min(t0 + tb, ft) - 1;
  const int it0 = first_patch(t0, pt, st);
  const int nt = n_span(t0, t1, pt, st, ntx, ft);

  // the block's rows and columns (warps 0 and 1, or warp 0 alone)
  if (warp == 0) {
    const int r = list_patches(lane, cr.n_h, so.h0, h, h, ph, sh, cr.nh,
                               cr.mh, row_crop, row_ih);
    if (lane == 0) n_rows = r;
  }
  if (warp == (nwarps > 1 ? 1 : 0)) {
    const int q = list_patches(lane, cr.n_w, so.w0, w0, w1, pw, sw, cr.nw,
                               cr.mw, col_crop, col_iw);
    if (lane == 0) n_cols = q;
  }
  __syncthreads();
  const int R = n_rows, Q = n_cols;
  // the index grid of a crop: nh / parent x nw / parent columns
  const int gw = cr.nw / parent;
  const long long crop_len = (long long)(cr.nh / parent) * gw * ntx;
  for (int rq = warp; rq < R * Q; rq += nwarps) {   // a warp a column
    const int r = rq / Q, q = rq - r * Q;
    const int* col = nn + (row_crop[r] * cr.n_w + col_crop[q]) * crop_len
        + (long long)((row_ih[r] / parent) * gw + col_iw[q] / parent) * ntx
        + it0;
    for (int k = lane; k < nt; k += 32) sidx[rq * nt + k] = col[k];
  }

  const int w = w0 + lane;
  const bool lane_ok = w <= w1;
  // the lane's (row, column) pairs in the first design's order (crops a,
  // then b, then ih, iw), each as the offset of its staged indices
  int np = 0;
  for (int r0 = 0; r0 < R && lane_ok;) {     // crops a
    int r1 = r0 + 1;
    while (r1 < R && row_crop[r1] == row_crop[r0]) ++r1;
    for (int q0 = 0; q0 < Q;) {              // crops b
      int q1 = q0 + 1;
      while (q1 < Q && col_crop[q1] == col_crop[q0]) ++q1;
      const int ww = w - so.w0[col_crop[q0]];
      if (ww >= 0 && ww < cr.mw) {
        const int iw_lo = first_patch(ww, pw, sw);
        const int iw_hi = min(cr.nw - 1, ww / sw);
        for (int r = r0; r < r1; ++r)              // ih
          for (int iw = iw_lo; iw <= iw_hi; ++iw)  // iw
            pairs[np++ * kFoldW + lane] =
                (r * Q + q0 + iw - col_iw[q0]) * nt - it0;
      }
      q0 = q1;
    }
    r0 = r1;
  }
  // the fold weight from the plan: patches covering h and w (and t below)
  int ch = 0, cw = 0;
  for (int a = 0; a < cr.n_h; ++a)
    ch += n_span(h - so.h0[a], h - so.h0[a], ph, sh, cr.nh, cr.mh);
  for (int b = 0; b < cr.n_w; ++b)
    cw += n_span(w - so.w0[b], w - so.w0[b], pw, sw, cr.nw, cr.mw);
  const long long hw = (long long)H * W;

  for (int c0 = 0; c0 < C; c0 += cg) {
    const int nc = min(cg, C - c0);
    __syncthreads();   // the indices staged; the last group's y read
    const T* yrow = y + (long long)c0 * Ty * hw + (long long)h * W + w;
#pragma unroll 4
    for (int row = warp; row < nc * Ty; row += nwarps)   // a warp a frame
      ys[row * kFoldW + lane] = lane_ok ? to_f32(yrow[row * hw]) : 0.0f;
    __syncthreads();
    for (int t = t0 + warp; t <= t1; t += nwarps) {
      const int it_lo = first_patch(t, pt, st);
      const int it_hi = min(ntx - 1, t / st);
      float acc[kFoldCg] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int n = 0; n < np; ++n) {
        const int* ix = sidx + pairs[n * kFoldW + lane];
        for (int itb = it_lo; itb <= it_hi; itb += kFoldIt) {   // it
          float v[kFoldIt][kFoldCg];
#pragma unroll
          for (int u = 0; u < kFoldIt; ++u) {
            const int it = itb + u;
            const int fo = it <= it_hi
                ? (ix[it] * st + (t - it * st)) * kFoldW + lane : 0;
#pragma unroll
            for (int k = 0; k < kFoldCg; ++k)
              v[u][k] = (it <= it_hi && k < nc) ? ys[k * Ty * kFoldW + fo]
                                                : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kFoldIt; ++u) {
            if (itb + u > it_hi) continue;
#pragma unroll
            for (int k = 0; k < kFoldCg; ++k)
              if (k < nc) acc[k] = __fadd_rn(acc[k], v[u][k]);
          }
        }
      }
      if (!lane_ok) continue;
      const int count = n_span(t, t, pt, st, ntx, ft) * ch * cw;
      const float div = count > 0 ? (float)count : 1e-10f;
#pragma unroll
      for (int k = 0; k < kFoldCg; ++k) {
        if (k < nc) {
          out[(((long long)(c0 + k) * ft + t) * fh + h) * fw + w] =
              numer ? acc[k] : __fdiv_rn(acc[k], div);
        }
      }
    }
  }
}

int launch_fold(const void* y, const int* nn, int is_bf16, int C, int Ty,
                int H, int W, const int* plan, int parent, int ft, int fh,
                int fw, int numer, float* out, void* stream) {
  NnCrops cr;
  NnStarts so;
  if (!unpack_crops(plan, &cr, &so) || parent < 1 || cr.nh % parent
      || cr.nw % parent)
    return (int)cudaErrorInvalidValue;
  if ((long long)C * ft * fh * fw <= 0) return 0;
  const FoldLayout L = fold_layout(cr, so, C, Ty, ft, fh, fw);
  if (L.smem > kFoldSmemLimit || fh > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((fw + kFoldW - 1) / kFoldW, fh, (ft + L.tb - 1) / L.tb);
  if (grid.z > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 32 * (L.tb < kFoldWarps ? L.tb : kFoldWarps);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    auto k = nn_fold_tile_kernel<__nv_bfloat16>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)L.smem);
    k<<<grid, threads, L.smem, s>>>((const __nv_bfloat16*)y, nn, C, Ty, H, W,
                                    cr, so, parent, ft, fh, fw, L.tb, L.cg,
                                    L.rmax, L.qmax, L.pmax, numer, out);
  } else {
    auto k = nn_fold_tile_kernel<float>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)L.smem);
    k<<<grid, threads, L.smem, s>>>((const float*)y, nn, C, Ty, H, W, cr, so,
                                    parent, ft, fh, fw, L.tb, L.cg, L.rmax,
                                    L.qmax, L.pmax, numer, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// parent: 1 for K12, f for gpnn_down's parent fold (nh and nw multiples
// of f)
VL3D_API int vl3d_nn_fold(const void* y, const int* nn, int is_bf16, int C,
                          int Ty, int H, int W, const int* plan, int parent,
                          int ft, int fh, int fw, float* out, void* stream) {
  return launch_fold(y, nn, is_bf16, C, Ty, H, W, plan, parent, ft, fh, fw,
                     0, out, stream);
}

// K12's numerator mode for the frame-parallel gpnn loss: the same sums,
// each voxel's written undivided (the caller divides after the fold's
// spill from the previous rank has been added)
VL3D_API int vl3d_nn_fold_numer(const void* y, const int* nn, int is_bf16,
                                int C, int Ty, int H, int W, const int* plan,
                                int parent, int ft, int fh, int fw, float* out,
                                void* stream) {
  return launch_fold(y, nn, is_bf16, C, Ty, H, W, plan, parent, ft, fh, fw,
                     1, out, stream);
}

// K12's layout for a plan, C channels, Ty frames of y and the (ft, fh,
// fw) output: out = {tb, cg, rmax, qmax, pmax, ntmax, smem}
// (losses/patch_nn.py:nn_fold_layout's keys, in order).
VL3D_API int vl3d_nn_fold_layout(const int* plan, int C, int Ty, int ft,
                                 int fh, int fw, long long* out) {
  NnCrops cr;
  NnStarts so;
  if (!unpack_crops(plan, &cr, &so)) return (int)cudaErrorInvalidValue;
  const FoldLayout L = fold_layout(cr, so, C, Ty, ft, fh, fw);
  out[0] = L.tb;
  out[1] = L.cg;
  out[2] = L.rmax;
  out[3] = L.qmax;
  out[4] = L.pmax;
  out[5] = L.ntmax;
  out[6] = L.smem;
  return 0;
}

// K12's first design (for comparison; no wrapper calls it).
VL3D_API int vl3d_nn_fold_first(const void* y, const int* nn, int is_bf16,
                                int C, int Ty, int H, int W, const int* plan,
                                int parent, int ft, int fh, int fw, float* out,
                                void* stream) {
  NnCrops cr;
  NnStarts so;
  if (!unpack_crops(plan, &cr, &so) || parent < 1 || cr.nh % parent
      || cr.nw % parent)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)C * ft * fh * fw;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    nn_fold_kernel<<<grid_for(n), kBlock, 0, s>>>(
        (const __nv_bfloat16*)y, nn, C, Ty, H, W, cr, so, parent, ft, fh, fw,
        out);
  } else {
    nn_fold_kernel<<<grid_for(n), kBlock, 0, s>>>(
        (const float*)y, nn, C, Ty, H, W, cr, so, parent, ft, fh, fw, out);
  }
  return (int)cudaGetLastError();
}
