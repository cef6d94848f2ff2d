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
// per (slot, pixel).  Design: one thread per pixel, pixels fastest, so each
// plane step of a warp reads one contiguous run; the walk stops at the S-th
// hit and never reads the dropped planes' geometry.
#include "common.cuh"

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

VL3D_API int vl3d_compact_sweep(const int* k_s, const int* k_d,
                                const float* fu, const float* fv,
                                const uint8_t* valid, const float* zview,
                                int D, long long P, int S, int* o_k_s,
                                int* o_k_d, float* o_fu, float* o_fv,
                                uint8_t* o_valid, float* o_zview,
                                void* stream) {
  if (P > 0 && S > 0) {
    compact_sweep_kernel<<<grid_for(P), kBlock, 0, (cudaStream_t)stream>>>(
        k_s, k_d, fu, fv, valid, zview, D, P, S, o_k_s, o_k_d, o_fu, o_fv,
        o_valid, o_zview);
  }
  return (int)cudaGetLastError();
}
