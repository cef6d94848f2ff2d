// K2 bilinear_tiles: bilinear sample of packed (N, th, tw, C) tiles, and
// K9 bilinear_tiles_grad: its gradient into f32 tiles.
//
// Replaces videoloop3d_tpu/render/sample.py:bilinear_tiles (the forward
// of render/adjoint.py:make_tile_adjoint on 4-D tiles).  Per sample:
//   k < 0 -> zeros;  u, v clamped to [0, tw-1] x [0, th-1];
//   corners (u0, v0) and (u0+1, v0+1) clamped to the tile;
//   out = lerp(lerp(t00, t01, fu), lerp(t10, t11, fu), fv)  in f32.
// The TPU version packs each 2x2 neighbourhood into one gather row
// because the TPU gather engine is descriptor-bound; a +1 corner that
// falls off the tile there reads a foreign texel with weight exactly 0.
// Clamping that corner to the tile gives the same values, so no packed
// copy is built here.  Texels may be bf16: loaded, widened to f32 and
// lerped in f32 (JAX promotes bf16 x f32 the same way); the output is f32.
// In the rounding mode (--fp16: the static atlas's astype(gather_dtype) of
// videoloop3d_tpu/models/mpv.py:284) f32 texels are read and each rounded
// to bf16 (to nearest even, as .to(torch.bfloat16)) in registers, so no
// bf16 copy of the atlas is made: the samples are bit for bit those of
// the copy.
//
// Bound on the H100: bytes.  Per sample it reads k, u, v (12 B) and
// writes C f32 (16 B); the referenced tiles (~22 MB at production
// size in f32) are read once from device memory and then mostly hit L2.
// Design at the direct decoder's C = 4 (bilinear_tiles_kernel): one
// thread per sample writing its C channels.
// At C != 4 (the SH and NeX decoders: 13, 36, 8 channels) that design
// stores C scalars a sample C floats apart across a warp (a store touches
// 32 sectors at C = 13), so there K2 is bilinear_tiles_sweep_kernel: a
// block takes a run of samples (bilinear_tiles_layout: 256, or 512 / 1024
// at C < 4 so that every thread has a float4 of outputs), finds each
// sample's corners once (the four corners' element offsets and fu, fv;
// a miss flagged) into shared memory, then its threads sweep the run's
// count x C outputs in output order, four consecutive outputs a thread
// (one float4 store where out is 16-byte aligned, else four scalars), so
// a warp writes 512 contiguous bytes and reads consecutive channels of
// the same corner texels.  A thread's (sample, channel) steps by 4 x 256
// outputs with a carry (no division per output).  Every output is the
// same lerp_rn chain of the same texels as in the first design, which
// stays callable as vl3d_bilinear_tiles_first (bilinear_tiles_kernel at
// any C; chip_smoke.py and the card tests only).  Element offsets are
// 32-bit: the launcher refuses tiles of 2^31 elements or more at C != 4.
//
// K9 replaces videoloop3d_tpu/render/adjoint.py:_packed_tile_grad (the
// backward of make_tile_adjoint on 4-D tiles).  The TPU version avoids
// XLA's scatter-add: per packed tile it cuts a pixel window out of the
// (k, u, v, cotangent) stack and contracts it with tent weights on the
// MXU, exact only while the window covers every pixel of the tile.  Here
// each sample scatters its four corner weights with atomicAdd, exact for
// any warp, so no window, projection or active-tile bound is needed.
// Per sample with k >= 0: u, v clamped as in K2, the +1 corners clamped
// to the tile, grad[k, v_i, u_i, c] += ct[c] * w_corner.  Samples with
// k < 0 read nothing beyond k.
// Bound on the H100: bytes.  It reads k for every sample and u, v and C
// f32 cotangents for the valid ones, and writes the (N, th, tw, C)
// gradient once; the atomics mostly hit L2.
// Design at the direct decoder's C = 4 (vl3d_bilinear_tiles_grad): a zero
// fill of the gradient (zero_grad_kernel, float4 stores that leave the
// lines in L2 for the atomics), then one thread per sample; each corner
// adds its 4 products with one 128-bit atomicAdd(float4*) (sm_90; 2 or 1
// floats where the cotangent or the gradient is not so aligned: the
// wrapper picks the width).  Atomics add in no fixed order: reproducible
// to roundoff, not bit for bit.  In the rounding mode (the gradient of
// the f32 atlas through --fp16's bf16 gather, JAX's .astype(tiles_dtype)
// at adjoint.py:660) the scatter also flags each tile it adds to, and
// round_bf16_kernel rounds each f32 sum of the flagged tiles to bf16 and
// widens it in place (the other tiles hold zeros), so no bf16 gradient is
// made and cast back.
// At C != 4 (the SH and NeX decoders: 13, 36, 8 channels) a sample's 4 x C
// scalar or float2/float4 atomics, with a run-time channel loop, and the
// whole-atlas fill cost 7x the bound (PERF.md), so K9 there is K10's
// deterministic binned gather at F = 1 (csrc/bilinear_tiles_tilemajor.cu:
// vl3d_bilinear_tiles_grad_gather): the samples binned by tile with the
// stable sort of bins.cuh, each tile with samples gathered once, every
// texel written once, the tiles no sample reads zero-filled, each sum in
// bin order then corner q = 0..3, rounded to bf16 inside the gather under
// --fp16; the same bits on every call.  The atomic route it replaced stays
// callable as vl3d_bilinear_tiles_grad_atomic (the same zero fill, C / kV
// vector atomics a corner, flags and rounding pass).
// The first design (bilinear_tiles_grad_first_kernel,
// vl3d_bilinear_tiles_grad_first; chip_smoke.py and the card tests only):
// 4 x C scalar atomicAdds a sample into a gradient the caller zero-fills.
//
// K23 bilinear_tiles_coord_grad: the gradient of K2's samples with
// respect to u and v (--optimize_geo_start in the sparse phase: JAX takes
// it by autodiff of render/sample.py:bilinear_tiles).  As in JAX:
//   - the clip of u to [0, tw-1] passes 1 inside, 0.5 at exactly 0 and
//     at tw-1 (jnp.clip's maximum/minimum split a tie), 0 outside; v alike;
//   - the corners are JAX's quad-packed rows: flat texel indices r, r+1,
//     r+tw, r+tw+1 of the (N*th*tw, C) tiles (zero past the end), so at
//     u = tw-1 (fu = 0) the +1 corner is the next row's first texel,
//     whose weight in the value is 0 but whose difference enters d/du;
//   - g_u = clip'(u) sum_c ct_c ((1-fv)(t01-t00) + fv(t11-t10))_c,
//     g_v = clip'(v) sum_c ct_c ((1-fu)(t10-t00) + fu(t11-t01))_c, and
//     zero where k < 0.
// Bound: bytes; per sample k, u, v (12 B) and C f32 cotangents read, 8 B
// written, plus the touched texels.
// First design (bilinear_tiles_coord_grad_kernel): one thread per sample
// with a run-time channel loop of scalar loads, into outputs its wrapper
// zero-fills first (three launches; it writes every sample, the misses'
// zeros too).  It stays callable as vl3d_bilinear_tiles_coord_grad_first
// (chip_smoke.py and the card tests only).
// Design at the direct decoder's C = 4 (coord_grad_c4_kernel), the only C
// with launches: no fill (the kernel writes every sample, a miss's zeros
// included), one launch where the first design made three; one sample a
// thread, a miss reading nothing past k, a hit's corners read as one
// float4 (f32) or 8 bytes (bf16) each and its cotangent row as one float4.
// Several samples a thread with all their loads issued together (two and
// four, a block's width apart) were measured slower (PERF.md, PR 24).  The
// sums are the first design's, channel c = 0..3 in order, through the one
// function both kernels inline (coord_grad_terms), whose FMAs are spelled
// out as nvcc contracted the first design's loop: bit for bit the first
// design.  At other C, or where a pointer is not aligned to the vectors,
// the same launch runs the first design's per-sample loop.
#include "vec.cuh"

// kRound: f32 texels rounded to bf16 before the lerps
template <typename T, bool kRound>
__global__ void bilinear_tiles_kernel(const T* __restrict__ tiles,
                                      const int* __restrict__ k,
                                      const float* __restrict__ u,
                                      const float* __restrict__ v,
                                      long long n, int N, int th, int tw,
                                      int C, float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float* o = out + idx * C;
  const int kk = k[idx];
  if (kk < 0) {
    for (int c = 0; c < C; ++c) o[c] = 0.0f;
    return;
  }
  const long long tile = min(kk, N - 1);
  const float uu = fminf(fmaxf(u[idx], 0.0f), (float)(tw - 1));
  const float vv = fminf(fmaxf(v[idx], 0.0f), (float)(th - 1));
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float fu = __fsub_rn(uu, u0), fv = __fsub_rn(vv, v0);
  const int u0i = (int)u0, v0i = (int)v0;
  const int u1i = min(u0i + 1, tw - 1), v1i = min(v0i + 1, th - 1);
  const T* t0 = tiles + ((tile * th + v0i) * tw) * C;
  const T* t1 = tiles + ((tile * th + v1i) * tw) * C;
  auto tex = [&](const T* r) {
    const float x = to_f32(*r);
    return kRound ? round_bf16(x) : x;
  };
  for (int c = 0; c < C; ++c) {
    const float top = lerp_rn(tex(t0 + u0i * C + c), tex(t0 + u1i * C + c),
                              fu);
    const float bot = lerp_rn(tex(t1 + u0i * C + c), tex(t1 + u1i * C + c),
                              fu);
    o[c] = lerp_rn(top, bot, fv);
  }
}

namespace {

// K2's redesign at C != 4 (see the header): the layout of a launch over
// n samples of C channels, or false beyond its limits (1 <= C <= 1024,
// n >= 0, at most 2^31 - 1 blocks).  render/sample.py:bilinear_tiles_layout
// mirrors it.
struct SweepLayout {
  int samples;          // samples a block
  long long blocks;
  int threads;
  int smem;             // dynamic shared bytes: int4 offsets, float2 fu, fv
};

constexpr int kSweepMaxC = 1024;

bool sweep_layout(long long n, int C, SweepLayout* lay) {
  if (C < 1 || C > kSweepMaxC || n < 0) return false;
  lay->samples = kBlock * ((4 + C - 1) / C);
  lay->blocks = (n + lay->samples - 1) / lay->samples;
  lay->threads = kBlock;
  lay->smem = lay->samples * (int)(sizeof(int4) + sizeof(float2));
  return lay->blocks <= 0x7fffffffLL;
}

// kRound: f32 texels rounded to bf16 before the lerps.  q[s]: the element
// offsets of sample s's corners (u0, v0), (u1, v0), (u0, v1), (u1, v1) at
// channel 0, q[s].x = -1 for a miss; f[s]: fu, fv.  vec4: out is 16-byte
// aligned (a block's span starts at a multiple of 4 floats: samples is).
template <typename T, bool kRound>
__global__ void __launch_bounds__(kBlock) bilinear_tiles_sweep_kernel(
    const T* __restrict__ tiles, const int* __restrict__ k,
    const float* __restrict__ u, const float* __restrict__ v, long long n,
    int N, int th, int tw, int C, int samples, int vec4,
    float* __restrict__ out) {
  extern __shared__ int4 sweep_q[];
  float2* sweep_f = reinterpret_cast<float2*>(sweep_q + samples);
  const long long first = (long long)blockIdx.x * samples;
  const int count = (int)min((long long)samples, n - first);
  for (int i = threadIdx.x; i < count; i += kBlock) {
    const long long idx = first + i;
    const int kk = k[idx];
    if (kk < 0) {
      sweep_q[i] = make_int4(-1, 0, 0, 0);
      sweep_f[i] = make_float2(0.0f, 0.0f);
      continue;
    }
    const int tile = min(kk, N - 1);
    const float uu = fminf(fmaxf(u[idx], 0.0f), (float)(tw - 1));
    const float vv = fminf(fmaxf(v[idx], 0.0f), (float)(th - 1));
    const float u0 = floorf(uu), v0 = floorf(vv);
    const int u0i = (int)u0, v0i = (int)v0;
    const int u1i = min(u0i + 1, tw - 1), v1i = min(v0i + 1, th - 1);
    const int r0 = (tile * th + v0i) * tw, r1 = (tile * th + v1i) * tw;
    sweep_q[i] = make_int4((r0 + u0i) * C, (r0 + u1i) * C, (r1 + u0i) * C,
                           (r1 + u1i) * C);
    sweep_f[i] = make_float2(__fsub_rn(uu, u0), __fsub_rn(vv, v0));
  }
  __syncthreads();
  auto tex = [&](int e) {
    const float x = to_f32(tiles[e]);
    return kRound ? round_bf16(x) : x;
  };
  const int total = count * C;
  float* __restrict__ dst = out + first * C;
  constexpr int kStep = 4 * kBlock;
  const int ds = kStep / C, dk = kStep - ds * C;
  int s = 4 * (int)threadIdx.x / C;
  int c = 4 * (int)threadIdx.x - s * C;
  for (int o = 4 * threadIdx.x; o < total; o += kStep) {
    float r[4];
    int ss = s, cc = c;
    int4 q = make_int4(-1, 0, 0, 0);
    float2 f = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      r[e] = 0.0f;
      if (o + e < total) {
        if (e == 0 || cc == 0) {
          q = sweep_q[ss];
          f = sweep_f[ss];
        }
        if (q.x >= 0) {
          const float top = lerp_rn(tex(q.x + cc), tex(q.y + cc), f.x);
          const float bot = lerp_rn(tex(q.z + cc), tex(q.w + cc), f.x);
          r[e] = lerp_rn(top, bot, f.y);
        }
      }
      if (++cc == C) {
        cc = 0;
        ++ss;
      }
    }
    if (vec4 && o + 4 <= total) {
      *reinterpret_cast<float4*>(dst + o) = make_float4(r[0], r[1], r[2],
                                                        r[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (o + e < total) dst[o + e] = r[e];
      }
    }
    s += ds;
    c += dk;
    if (c >= C) {
      c -= C;
      ++s;
    }
  }
}

int launch_first(const void* tiles, int is_bf16, int round_bf16,
                 const int* k, const float* u, const float* v, long long n,
                 int N, int th, int tw, int C, float* out, cudaStream_t s) {
  if (n > 0) {
    if (is_bf16) {
      bilinear_tiles_kernel<__nv_bfloat16, false><<<grid_for(n), kBlock, 0,
                                                    s>>>(
          (const __nv_bfloat16*)tiles, k, u, v, n, N, th, tw, C, out);
    } else if (round_bf16) {
      bilinear_tiles_kernel<float, true><<<grid_for(n), kBlock, 0, s>>>(
          (const float*)tiles, k, u, v, n, N, th, tw, C, out);
    } else {
      bilinear_tiles_kernel<float, false><<<grid_for(n), kBlock, 0, s>>>(
          (const float*)tiles, k, u, v, n, N, th, tw, C, out);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K2.  tiles: f32 (is_bf16 0) or bf16 texels; round_bf16: f32 texels
// rounded to bf16 before the lerps (the --fp16 gather of the f32 atlas).
// C = 4: bilinear_tiles_kernel; other C: bilinear_tiles_sweep_kernel.
VL3D_API int vl3d_bilinear_tiles(const void* tiles, int is_bf16,
                                 int round_bf16, const int* k,
                                 const float* u, const float* v, long long n,
                                 int N, int th, int tw, int C, float* out,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 4) {
    return launch_first(tiles, is_bf16, round_bf16, k, u, v, n, N, th, tw,
                         C, out, s);
  }
  SweepLayout lay;
  if (!sweep_layout(n, C, &lay) || (long long)N * th * tw * C > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int vec4 = (uintptr_t)out % 16 == 0;
    const dim3 grid((unsigned)lay.blocks);
    if (is_bf16) {
      bilinear_tiles_sweep_kernel<__nv_bfloat16, false>
          <<<grid, lay.threads, lay.smem, s>>>(
              (const __nv_bfloat16*)tiles, k, u, v, n, N, th, tw, C,
              lay.samples, vec4, out);
    } else if (round_bf16) {
      bilinear_tiles_sweep_kernel<float, true>
          <<<grid, lay.threads, lay.smem, s>>>(
              (const float*)tiles, k, u, v, n, N, th, tw, C, lay.samples,
              vec4, out);
    } else {
      bilinear_tiles_sweep_kernel<float, false>
          <<<grid, lay.threads, lay.smem, s>>>(
              (const float*)tiles, k, u, v, n, N, th, tw, C, lay.samples,
              vec4, out);
    }
  }
  return (int)cudaGetLastError();
}

// K2's first design at any C: one thread per sample (bilinear_tiles_kernel;
// chip_smoke.py and the card tests only); arguments as vl3d_bilinear_tiles'.
VL3D_API int vl3d_bilinear_tiles_first(const void* tiles, int is_bf16,
                                       int round_bf16, const int* k,
                                       const float* u, const float* v,
                                       long long n, int N, int th, int tw,
                                       int C, float* out, void* stream) {
  return launch_first(tiles, is_bf16, round_bf16, k, u, v, n, N, th, tw, C,
                      out, (cudaStream_t)stream);
}

// K2's redesign's layout over n samples of C channels: out = {samples,
// blocks, threads, smem} (render/sample.py:bilinear_tiles_layout's keys,
// in order); cudaErrorInvalidValue beyond its limits.
VL3D_API int vl3d_bilinear_tiles_layout(long long n, int C, long long* out) {
  SweepLayout lay;
  if (!sweep_layout(n, C, &lay)) return (int)cudaErrorInvalidValue;
  out[0] = lay.samples;
  out[1] = lay.blocks;
  out[2] = lay.threads;
  out[3] = lay.smem;
  return 0;
}

namespace {

// K9's first design (see the header)
__global__ void bilinear_tiles_grad_first_kernel(
    const float* __restrict__ ct, const int* __restrict__ k,
    const float* __restrict__ u, const float* __restrict__ v, long long n,
    int N, int th, int tw, int C, float* __restrict__ grad) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int kk = k[idx];
  if (kk < 0) return;
  const long long tile = min(kk, N - 1);
  const float uu = fminf(fmaxf(u[idx], 0.0f), (float)(tw - 1));
  const float vv = fminf(fmaxf(v[idx], 0.0f), (float)(th - 1));
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float fu = __fsub_rn(uu, u0), fv = __fsub_rn(vv, v0);
  const int u0i = (int)u0, v0i = (int)v0;
  const int u1i = min(u0i + 1, tw - 1), v1i = min(v0i + 1, th - 1);
  const float wu0 = __fsub_rn(1.0f, fu), wv0 = __fsub_rn(1.0f, fv);
  const float w00 = __fmul_rn(wv0, wu0), w01 = __fmul_rn(wv0, fu);
  const float w10 = __fmul_rn(fv, wu0), w11 = __fmul_rn(fv, fu);
  float* g0 = grad + ((tile * th + v0i) * tw) * C;
  float* g1 = grad + ((tile * th + v1i) * tw) * C;
  const float* c_in = ct + idx * C;
  for (int c = 0; c < C; ++c) {
    const float g = c_in[c];
    atomicAdd(g0 + u0i * C + c, __fmul_rn(g, w00));
    atomicAdd(g0 + u1i * C + c, __fmul_rn(g, w01));
    atomicAdd(g1 + u0i * C + c, __fmul_rn(g, w10));
    atomicAdd(g1 + u1i * C + c, __fmul_rn(g, w11));
  }
}

}  // namespace

// K9's first design; grad must be zero-filled by the caller.
VL3D_API int vl3d_bilinear_tiles_grad_first(const float* ct, const int* k,
                                            const float* u, const float* v,
                                            long long n, int N, int th,
                                            int tw, int C, float* grad,
                                            void* stream) {
  if (n > 0) {
    bilinear_tiles_grad_first_kernel<<<grid_for(n), kBlock, 0,
                                       (cudaStream_t)stream>>>(
        ct, k, u, v, n, N, th, tw, C, grad);
  }
  return (int)cudaGetLastError();
}

namespace {

// kV consecutive floats added to device memory with one vector atomic
// (float4 / float2 atomicAdd: sm_90, global memory)
template <int kV>
__device__ __forceinline__ void atomic_add_vec(float* dst, const VecF<kV>& a) {
  if constexpr (kV == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(a.v[0], a.v[1], a.v[2], a.v[3]));
  } else if constexpr (kV == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a.v[0], a.v[1]));
  } else {
    atomicAdd(dst, a.v[0]);
  }
}

// flags (or null): each tile a sample adds to set to 1.  kC: the channel
// count where it is known when compiling (4: the direct decoder, one
// straight-line vector a corner), else 0 and C at run time.
template <int kV, int kC>
__global__ void bilinear_tiles_grad_kernel(const float* __restrict__ ct,
                                           const int* __restrict__ k,
                                           const float* __restrict__ u,
                                           const float* __restrict__ v,
                                           long long n, int N, int th,
                                           int tw, int C_,
                                           uint8_t* __restrict__ flags,
                                           float* __restrict__ grad) {
  const int C = kC ? kC : C_;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int kk = k[idx];
  if (kk < 0) return;
  const long long tile = min(kk, N - 1);
  if (flags) flags[tile] = 1;
  const float uu = fminf(fmaxf(u[idx], 0.0f), (float)(tw - 1));
  const float vv = fminf(fmaxf(v[idx], 0.0f), (float)(th - 1));
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float fu = __fsub_rn(uu, u0), fv = __fsub_rn(vv, v0);
  const int u0i = (int)u0, v0i = (int)v0;
  const int u1i = min(u0i + 1, tw - 1), v1i = min(v0i + 1, th - 1);
  const float wu0 = __fsub_rn(1.0f, fu), wv0 = __fsub_rn(1.0f, fv);
  const float w[4] = {__fmul_rn(wv0, wu0), __fmul_rn(wv0, fu),
                      __fmul_rn(fv, wu0), __fmul_rn(fv, fu)};
  float* g0 = grad + ((tile * th + v0i) * tw) * C;
  float* g1 = grad + ((tile * th + v1i) * tw) * C;
  float* dst[4] = {g0 + u0i * C, g0 + u1i * C, g1 + u0i * C, g1 + u1i * C};
  const float* c_in = ct + idx * C;
  for (int c = 0; c < C; c += kV) {
    const VecF<kV> g = ld_vec<kV>(c_in + c);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      VecF<kV> a;
#pragma unroll
      for (int x = 0; x < kV; ++x) a.v[x] = __fmul_rn(g.v[x], w[q]);
      atomic_add_vec<kV>(dst[q] + c, a);
    }
  }
}

// grid-stride launches of kBlock threads, at most 16 blocks an SM of the
// H100's 132
unsigned stride_grid(long long items) {
  const long long b = (items + kBlock - 1) / kBlock;
  return (unsigned)(b < 132 * 16 ? b : 132 * 16);
}

// the gradient's n floats and, with flags, its N tiles' flags set to 0
// (float4 stores where n is a multiple of 4 and g 16-byte aligned)
__global__ void zero_grad_kernel(float* __restrict__ g, long long n,
                                 int vec4, uint8_t* __restrict__ flags,
                                 int N) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec4) {
    float4* g4 = reinterpret_cast<float4*>(g);
    for (long long i = t; i < n / 4; i += stride) {
      g4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (long long i = t; i < n; i += stride) g[i] = 0.0f;
  }
  if (flags) {
    for (long long i = t; i < N; i += stride) flags[i] = 0;
  }
}

// each of n floats rounded to bf16 and widened, in place; with flags only
// those of the tiles (tile_elems floats each) whose flag is set, the
// others being zeros (float4 where n and tile_elems are multiples of 4
// and g 16-byte aligned)
__global__ void round_bf16_kernel(float* __restrict__ g, long long n,
                                  int vec4, const uint8_t* __restrict__ flags,
                                  int tile_elems) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec4) {
    float4* g4 = reinterpret_cast<float4*>(g);
    for (; i < n / 4; i += stride) {
      if (flags && !flags[4 * i / tile_elems]) continue;
      float4 a = g4[i];
      a.x = round_bf16(a.x);
      a.y = round_bf16(a.y);
      a.z = round_bf16(a.z);
      a.w = round_bf16(a.w);
      g4[i] = a;
    }
  } else {
    for (; i < n; i += stride) {
      if (flags && !flags[i / tile_elems]) continue;
      g[i] = round_bf16(g[i]);
    }
  }
}

void launch_round_bf16(float* g, long long n, const uint8_t* flags,
                       int tile_elems, cudaStream_t s) {
  if (n <= 0) return;
  const int vec4 = n % 4 == 0 && (uintptr_t)g % 16 == 0
                   && (!flags || tile_elems % 4 == 0);
  round_bf16_kernel<<<stride_grid(vec4 ? n / 4 : n), kBlock, 0, s>>>(
      g, n, vec4, flags, tile_elems);
}

// The zero fill, the scatter of vector atomics and, with round_bf16, the
// rounding pass.  vec (4, 2 or 1) divides C and ct and grad are aligned to
// it; flags: N bytes of scratch, which the rounding mode needs (the
// scatter flags each tile it adds to, and only those tiles are rounded).
int atomic_grad(const float* ct, const int* k, const float* u, const float* v,
                long long n, int N, int th, int tw, int C, int vec,
                int round_bf16, uint8_t* flags, float* grad,
                cudaStream_t s) {
  if (C % vec != 0 || (round_bf16 && !flags)) {
    return (int)cudaErrorInvalidValue;
  }
  uint8_t* f = round_bf16 ? flags : nullptr;
  const long long total = (long long)N * th * tw * C;
  if (total > 0) {
    const int vec4 = total % 4 == 0 && (uintptr_t)grad % 16 == 0;
    const long long items = vec4 ? total / 4 : total;
    zero_grad_kernel<<<stride_grid(items > N ? items : N), kBlock, 0, s>>>(
        grad, total, vec4, f, N);
  }
  if (n > 0 && total > 0) {
    if (vec == 4 && C == 4) {
      bilinear_tiles_grad_kernel<4, 4><<<grid_for(n), kBlock, 0, s>>>(
          ct, k, u, v, n, N, th, tw, C, f, grad);
    } else if (vec == 4) {
      bilinear_tiles_grad_kernel<4, 0><<<grid_for(n), kBlock, 0, s>>>(
          ct, k, u, v, n, N, th, tw, C, f, grad);
    } else if (vec == 2) {
      bilinear_tiles_grad_kernel<2, 0><<<grid_for(n), kBlock, 0, s>>>(
          ct, k, u, v, n, N, th, tw, C, f, grad);
    } else {
      bilinear_tiles_grad_kernel<1, 0><<<grid_for(n), kBlock, 0, s>>>(
          ct, k, u, v, n, N, th, tw, C, f, grad);
    }
  }
  if (round_bf16) launch_round_bf16(grad, total, f, th * tw * C, s);
  return (int)cudaGetLastError();
}

}  // namespace

// K9 at C = 4: the zero fill, the scatter and, with round_bf16, the
// rounding pass (atomic_grad).  Other C: vl3d_bilinear_tiles_grad_gather.
VL3D_API int vl3d_bilinear_tiles_grad(const float* ct, const int* k,
                                      const float* u, const float* v,
                                      long long n, int N, int th, int tw,
                                      int C, int vec, int round_bf16,
                                      uint8_t* flags, float* grad,
                                      void* stream) {
  if (C != 4) return (int)cudaErrorInvalidValue;
  return atomic_grad(ct, k, u, v, n, N, th, tw, C, vec, round_bf16, flags,
                     grad, (cudaStream_t)stream);
}

// K9's atomic route at any C, the design the gather replaced at C != 4
// (chip_smoke.py and the card tests only); arguments as
// vl3d_bilinear_tiles_grad's.
VL3D_API int vl3d_bilinear_tiles_grad_atomic(const float* ct, const int* k,
                                             const float* u, const float* v,
                                             long long n, int N, int th,
                                             int tw, int C, int vec,
                                             int round_bf16, uint8_t* flags,
                                             float* grad, void* stream) {
  return atomic_grad(ct, k, u, v, n, N, th, tw, C, vec, round_bf16, flags,
                     grad, (cudaStream_t)stream);
}

// K9's rounding pass on its own over n floats, with flags (or null) over
// tiles of tile_elems floats (the card's checks)
VL3D_API int vl3d_round_bf16(float* g, long long n, const uint8_t* flags,
                             int tile_elems, void* stream) {
  launch_round_bf16(g, n, flags, tile_elems, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// d clip(u, 0, hi) / du as jax.grad gives it
__device__ __forceinline__ float clip_grad(float u, float hi) {
  if (u == 0.0f || u == hi) return 0.5f;
  return (u > 0.0f && u < hi) ? 1.0f : 0.0f;
}

namespace {

// one channel's terms of K23's sums, as both designs run them: each
// operation rounded once, the contraction into FMAs spelled out as nvcc
// made it in the first design's loop (fma(1 - fv, t01 - t00, fv (t11 -
// t10)), then fma(g, that, su); v alike), so a new code shape cannot
// contract it otherwise
__device__ __forceinline__ void coord_grad_terms(float t00, float t01,
                                                 float t10, float t11,
                                                 float g, float fu, float fv,
                                                 float& su, float& sv) {
  const float du = __fmaf_rn(__fsub_rn(1.0f, fv), __fsub_rn(t01, t00),
                             __fmul_rn(fv, __fsub_rn(t11, t10)));
  const float dv = __fmaf_rn(__fsub_rn(1.0f, fu), __fsub_rn(t10, t00),
                             __fmul_rn(fu, __fsub_rn(t11, t01)));
  su = __fmaf_rn(g, du, su);
  sv = __fmaf_rn(g, dv, sv);
}

// K23's first design, and the redesign's route at C != 4
template <typename T>
__global__ void bilinear_tiles_coord_grad_kernel(
    const T* __restrict__ tiles, const float* __restrict__ ct,
    const int* __restrict__ k, const float* __restrict__ u,
    const float* __restrict__ v, long long n, int N, int th, int tw, int C,
    float* __restrict__ gu, float* __restrict__ gv) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int kk = k[idx];
  if (kk < 0) {
    gu[idx] = 0.0f;
    gv[idx] = 0.0f;
    return;
  }
  const long long tile = min(kk, N - 1);
  const float u_in = u[idx], v_in = v[idx];
  const float uu = fminf(fmaxf(u_in, 0.0f), (float)(tw - 1));
  const float vv = fminf(fmaxf(v_in, 0.0f), (float)(th - 1));
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float fu = uu - u0, fv = vv - v0;
  const long long total = (long long)N * th * tw;
  const long long r = (tile * th + (int)v0) * tw + (int)u0;
  const long long rs[4] = {r, r + 1, r + tw, r + tw + 1};
  const float* c_in = ct + idx * C;
  float su = 0.0f, sv = 0.0f;
  for (int c = 0; c < C; ++c) {
    float t[4];
    for (int q = 0; q < 4; ++q) {
      t[q] = rs[q] < total ? to_f32(tiles[rs[q] * C + c]) : 0.0f;
    }
    coord_grad_terms(t[0], t[1], t[2], t[3], c_in[c], fu, fv, su, sv);
  }
  gu[idx] = clip_grad(u_in, (float)(tw - 1)) * su;
  gv[idx] = clip_grad(v_in, (float)(th - 1)) * sv;
}

// K23's redesign at C = 4 (see the header): one sample a thread, its
// corners and cotangent row as vectors; every sample written
template <typename T>
__global__ void __launch_bounds__(kBlock) coord_grad_c4_kernel(
    const T* __restrict__ tiles, const float* __restrict__ ct,
    const int* __restrict__ k, const float* __restrict__ u,
    const float* __restrict__ v, long long n, int N, int th, int tw,
    float* __restrict__ gu, float* __restrict__ gv) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int kk = k[idx];
  if (kk < 0) {
    gu[idx] = 0.0f;
    gv[idx] = 0.0f;
    return;
  }
  const long long tile = min(kk, N - 1);
  const float u_in = u[idx], v_in = v[idx];
  const float uu = fminf(fmaxf(u_in, 0.0f), (float)(tw - 1));
  const float vv = fminf(fmaxf(v_in, 0.0f), (float)(th - 1));
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float fu = uu - u0, fv = vv - v0;
  const long long total = (long long)N * th * tw;
  const long long r = (tile * th + (int)v0) * tw + (int)u0;
  const long long rs[4] = {r, r + 1, r + tw, r + tw + 1};
  VecF<4> t[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (rs[q] < total) {
      t[q] = ld_vec<4>(tiles + rs[q] * 4);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) t[q].v[c] = 0.0f;
    }
  }
  const VecF<4> g = ld_vec<4>(ct + idx * 4);
  float su = 0.0f, sv = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    coord_grad_terms(t[0].v[c], t[1].v[c], t[2].v[c], t[3].v[c], g.v[c], fu,
                     fv, su, sv);
  }
  gu[idx] = clip_grad(u_in, (float)(tw - 1)) * su;
  gv[idx] = clip_grad(v_in, (float)(th - 1)) * sv;
}

int launch_coord_first(const void* tiles, int is_bf16, const float* ct,
                       const int* k, const float* u, const float* v,
                       long long n, int N, int th, int tw, int C, float* gu,
                       float* gv, cudaStream_t s) {
  if (n > 0) {
    if (is_bf16) {
      bilinear_tiles_coord_grad_kernel<<<grid_for(n), kBlock, 0, s>>>(
          (const __nv_bfloat16*)tiles, ct, k, u, v, n, N, th, tw, C, gu, gv);
    } else {
      bilinear_tiles_coord_grad_kernel<<<grid_for(n), kBlock, 0, s>>>(
          (const float*)tiles, ct, k, u, v, n, N, th, tw, C, gu, gv);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K23: every sample of gu, gv written (no fill).  C = 4 with tiles
// aligned to a texel's vector and ct to 16 bytes: coord_grad_c4_kernel;
// otherwise the first design's per-sample loop.
VL3D_API int vl3d_bilinear_tiles_coord_grad(const void* tiles, int is_bf16,
                                            const float* ct, const int* k,
                                            const float* u, const float* v,
                                            long long n, int N, int th,
                                            int tw, int C, float* gu,
                                            float* gv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (uintptr_t)tiles % (is_bf16 ? 8 : 16) == 0
                       && (uintptr_t)ct % 16 == 0;
  if (C != 4 || !aligned) {
    return launch_coord_first(tiles, is_bf16, ct, k, u, v, n, N, th, tw, C,
                              gu, gv, s);
  }
  if (n > 0) {
    if (is_bf16) {
      coord_grad_c4_kernel<<<grid_for(n), kBlock, 0, s>>>(
          (const __nv_bfloat16*)tiles, ct, k, u, v, n, N, th, tw, gu, gv);
    } else {
      coord_grad_c4_kernel<<<grid_for(n), kBlock, 0, s>>>(
          (const float*)tiles, ct, k, u, v, n, N, th, tw, gu, gv);
    }
  }
  return (int)cudaGetLastError();
}

// K23's first design at any C (chip_smoke.py and the card tests only; its
// wrapper zero-fills gu and gv first, as the first design's did);
// arguments as vl3d_bilinear_tiles_coord_grad's.
VL3D_API int vl3d_bilinear_tiles_coord_grad_first(
    const void* tiles, int is_bf16, const float* ct, const int* k,
    const float* u, const float* v, long long n, int N, int th, int tw,
    int C, float* gu, float* gv, void* stream) {
  return launch_coord_first(tiles, is_bf16, ct, k, u, v, n, N, th, tw, C, gu,
                            gv, (cudaStream_t)stream);
}
