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
// bf16 y is read as bf16 and summed in f32; the output is f32.
//
// The parent mode (parent factor f > 1) replaces gpnn_downsample_loss's
// fold (:682-722): the crops are the full-resolution ones (hs_full,
// ws_full, span wide), and patch column (ih, iw) of a crop takes the index
// its low-resolution parent found, nn[crop, (ih / f) (nw / f) + iw / f,
// it] (the JAX package's repeat of the indices over both axes).  A voxel
// no patch covers gets 0 (the loss masks it out).  f is a launch argument:
// in NnCrops it would cost K11 registers (nn_crops.cuh).
//
// Bound on the H100: bytes.  It writes the (C, fit_tx, fit_h, fit_w) f32
// target (35.6 MB at production size) and reads the indices and, per
// voxel, up to pt/st * (p/s)^2 covering patches' voxels of y (those of a
// column share its pixel, and mostly hit L1/L2).
// Design: one thread per output voxel (w fastest) and a fixed loop order
// (crops row-major, then ih, iw, it): deterministic, with no atomics and
// no patch tensor.  f = 1 is K12 itself.
#include "nn_crops.cuh"

namespace {

__device__ __forceinline__ int first_patch(int pos, int p, int s) {
  // smallest i >= 0 with i * s + p > pos
  const int num = pos - p + 1;
  return num <= 0 ? 0 : (num + s - 1) / s;
}

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

}  // namespace

// parent: 1 for K12, f for gpnn_down's parent fold (nh and nw multiples
// of f)
VL3D_API int vl3d_nn_fold(const void* y, const int* nn, int is_bf16, int C,
                          int Ty, int H, int W, const int* plan, int parent,
                          int ft, int fh, int fw, float* out, void* stream) {
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
