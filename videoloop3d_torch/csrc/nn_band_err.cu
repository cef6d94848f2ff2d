// K19 nn_band_err: the eval's NN error of one direction of K18's search.
//
// Replaces videoloop3d_tpu/eval/nnmse.py:_block_err_fn's sel_err
// (:132-145): for every crop, the sum over its spatial patch columns, the
// ns temporal patches i of the source, the frames k < pt of a patch and the
// (c, dy, dx) channels of a per-frame patch of
//   |tar[c, nn(i)*st + k, h, w] - src[c, i*st + k, h, w]|
// with nn the source's nearest target patch from K18 (its row argmin for
// x -> y, its column argmin for y -> x; the wrapper swaps src and tar).
// eval/nnmse.py divides the sums by pt * columns * ns * d and averages the
// crops, as sel_err's means and np.mean do.
//
// Bound on the H100: bytes (each input read once: the two (3, 50, 280, 560)
// f32 clips of an eval pair, 188 MB, ~0.06 ms), though the pt-fold reuse of
// each frame and the gather of the selected patches read up to 2 pt times
// that through L1/L2.
// Design: one block of 256 threads per (crop, column); each thread sums a
// strided share of the column's ns * pt * d terms in f32, the block adds
// the 256 partial sums in a fixed tree; a second kernel adds each crop's
// column sums the same way.  Fixed order throughout, no atomics.
#include "nn_crops.cuh"

namespace {

constexpr int kThreads = 256;

// offs / offt[q]: the offset of channel q = (c * ph + dy) * pw + dx of a
// per-frame (1, ph, pw) patch in src (C, Ts, H, W) / tar (C, Tt, H, W)
__device__ __forceinline__ void frame_offsets(int* offs, int* offt, int C,
                                              int ph, int pw, int Ts, int Tt,
                                              int H, int W) {
  const int hw = H * W;
  for (int q = threadIdx.x; q < C * ph * pw; q += kThreads) {
    const int in_plane = ((q / pw) % ph) * W + q % pw;
    const int c = q / (pw * ph);
    offs[q] = c * Ts * hw + in_plane;
    offt[q] = c * Tt * hw + in_plane;
  }
}

// the fixed-order tree sum of v over the block's kThreads threads
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  return red[0];
}

template <typename T>
__global__ void nn_band_err_kernel(const T* __restrict__ src,
                                   const T* __restrict__ tar, int C, int Ts,
                                   int Tt, int H, int W, NnCrops cr,
                                   NnStarts so, int ns,
                                   const int* __restrict__ nn,
                                   float* __restrict__ partial) {
  extern __shared__ int sm[];
  const int d = C * cr.ph * cr.pw;
  int* offs = sm;                                     // [d]
  int* offt = offs + d;                               // [d]
  int* sel = offt + d;                                // [ns]
  float* red = reinterpret_cast<float*>(sel + ns);    // [kThreads]
  const int ncols = cr.nh * cr.nw;
  const int crop = blockIdx.x / ncols, col = blockIdx.x % ncols;
  const long long hw = (long long)H * W;
  const long long pix =
      (long long)(so.h0[crop / cr.n_w] + (col / cr.nw) * cr.sh) * W
      + (so.w0[crop % cr.n_w] + (col % cr.nw) * cr.sw);
  frame_offsets(offs, offt, C, cr.ph, cr.pw, Ts, Tt, H, W);
  for (int i = threadIdx.x; i < ns; i += kThreads)
    sel[i] = nn[(long long)blockIdx.x * ns + i];
  __syncthreads();
  const int pt = cr.pt, st = cr.st;
  const int n = ns * pt * d;
  float acc = 0.0f;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int q = e % d;
    const int k = (e / d) % pt;
    const int i = e / (d * pt);
    const float a = to_f32(src[(i * st + k) * hw + pix + offs[q]]);
    const float b = to_f32(tar[(sel[i] * st + k) * hw + pix + offt[q]]);
    acc = __fadd_rn(acc, fabsf(__fsub_rn(b, a)));
  }
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void crop_sums_kernel(const float* __restrict__ partial,
                                 int ncols, float* __restrict__ out) {
  __shared__ float red[kThreads];
  float acc = 0.0f;
  for (int c = threadIdx.x; c < ncols; c += kThreads)
    acc = __fadd_rn(acc, partial[(long long)blockIdx.x * ncols + c]);
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

}  // namespace

// partial: (crops * columns) f32 scratch; out: (crops,) f32
VL3D_API int vl3d_nn_band_err(const void* src, const void* tar, int is_bf16,
                              int C, int Ts, int Tt, int H, int W,
                              const int* plan, int ns, const int* nn,
                              float* partial, float* out, void* stream) {
  NnCrops cr;
  NnStarts so;
  if (!unpack_crops(plan, &cr, &so)) return (int)cudaErrorInvalidValue;
  const int crops = cr.n_h * cr.n_w;
  const int ncols = cr.nh * cr.nw;
  if (crops <= 0 || ncols <= 0) return 0;
  const int d = C * cr.ph * cr.pw;
  const int smem = (int)sizeof(int) * (2 * d + ns + kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int blocks = (unsigned int)crops * ncols;
  if (is_bf16) {
    nn_band_err_kernel<<<blocks, kThreads, smem, s>>>(
        (const __nv_bfloat16*)src, (const __nv_bfloat16*)tar, C, Ts, Tt, H,
        W, cr, so, ns, nn, partial);
  } else {
    nn_band_err_kernel<<<blocks, kThreads, smem, s>>>(
        (const float*)src, (const float*)tar, C, Ts, Tt, H, W, cr, so, ns,
        nn, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  crop_sums_kernel<<<crops, kThreads, 0, s>>>(partial, ncols, out);
  return (int)cudaGetLastError();
}
