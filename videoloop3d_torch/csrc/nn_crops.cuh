// The crops of one GPNN retarget, as losses/patch_nn.py:CropPlan holds
// them, passed by value to K11 and K18 (nn_argmin.cu), K12 (nn_fold.cu)
// and K19 (nn_band_err.cu).  The
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
