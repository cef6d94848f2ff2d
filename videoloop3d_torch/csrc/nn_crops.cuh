// The crops of one GPNN retarget, as losses/patch_nn.py:CropPlan holds
// them, passed by value to K11 and K18 (nn_argmin.cu, nn_argmin_mma.cu),
// K12 (nn_fold.cu) and K19 (nn_band_err.cu).  The
// host packs them into one int array (patch_nn.py:_plan_ints): the
// members of NnCrops in order, then the starts; crop (a, b), row-major,
// starts at (h0[a], w0[b]).  The starts are a parameter of their own: in
// the same struct as the scalars, they take K11 from 63 registers a
// thread to 96.
#pragma once

#include "common.cuh"

constexpr int kMaxStarts = 64;   // crop starts per axis
constexpr int kCropHeader = 14;  // ints before the starts

struct NnCrops {
  int pt, ph, pw, st, sh, sw;  // patch size and strides (t, h, w)
  int mh, mw;                  // crop size
  int ntx, nty, nh, nw;        // temporal patches of x and y; spatial
                               // patches of a crop
  int n_h, n_w;                // crop starts per axis
};

struct NnStarts {
  int h0[kMaxStarts], w0[kMaxStarts];
};

// False if the array holds more starts per axis than NnStarts does.
inline bool unpack_crops(const int* a, NnCrops* cr, NnStarts* so) {
  int* head[kCropHeader] = {&cr->pt, &cr->ph, &cr->pw, &cr->st, &cr->sh,
                            &cr->sw, &cr->mh, &cr->mw, &cr->ntx, &cr->nty,
                            &cr->nh, &cr->nw, &cr->n_h, &cr->n_w};
  for (int i = 0; i < kCropHeader; ++i) *head[i] = a[i];
  if (cr->n_h < 1 || cr->n_h > kMaxStarts || cr->n_w < 1
      || cr->n_w > kMaxStarts)
    return false;
  for (int i = 0; i < cr->n_h; ++i) so->h0[i] = a[kCropHeader + i];
  for (int i = 0; i < cr->n_w; ++i) so->w0[i] = a[kCropHeader + cr->n_h + i];
  return true;
}

// K11 on the tensor cores (nn_argmin_mma.cu): bf16 inputs, the "mse"
// distance; smem as losses/patch_nn.py:_argmin_smem gives it.  Shapes whose
// staged layout needs more than kSmemLimit bytes (long videos) stay on
// nn_argmin.cu's CUDA-core search: nn_mma_fits says which.
constexpr int kSmemLimit = 227 * 1024;   // patch_nn.py:_SMEM_LIMIT
bool nn_mma_fits(const int* plan, int C);
// cmin_in / cmin_out: K11's given-minima and minima modes
// (nn_argmin.cu:vl3d_nn_argmin_given, vl3d_nn_argmin_colmin), else null
int nn_argmin_mma(const void* x, const void* y, int C, int Tx, int Ty, int H,
                  int W, const int* plan, int has_alpha, float alpha,
                  int smem, int* nn, void* stream,
                  const float* cmin_in = nullptr, float* cmin_out = nullptr);
