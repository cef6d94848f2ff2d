// K4 composite: sigmoid decode + static/dynamic select + near-to-far
// over-composite.
//
// Replaces the forward of videoloop3d_tpu/render/fused.py:fused_composite
// (fused.py:120-166) at S = D slots, with the regularizer sums and the
// disparity off; it equals the eval path's unfused chain
// (models/mpv.py:376-404) up to float reassociation.  Per (pixel, frame),
// over planes s = D-1 (nearest) down to 0 (planes are stored far first):
//   dynamic where hit_d[s]:  rgb = sigmoid(vd[:3]) * m_d,  a = m_d ? sigmoid(vd[3]) : 0
//   else static:             rgb = sigmoid(vs[:3]) * m_s,  a = m_s ? sigmoid(vs[3]) : 0
//   bw = a * T;  out += rgb * bw;  alpha_sum += bw;  T *= 1 - a
// Outputs: out (P, F, 3) and alpha_sum (P, F), f32.
//
// Bound on the H100: bytes.  It reads the (D, P, 4) static samples, three
// (D, P) u8 masks and, of the (D, P, F, 4) f32 dynamic sample stack (1.18
// GB for a 10-frame chunk at production size), only the hit planes'
// samples (about 6% at the render's MTV), and writes 16 B per
// (pixel, frame); ~40 flops and 4 exponentials per (plane, pixel, frame)
// are far below the card's f32 rate.
//
// Design (composite_tile_kernel, its layout in composite_layout, mirrored
// by render/fused.py:composite_layout): a block owns `pix` consecutive
// pixels and all of the chunk's frames.
//   Stage 1, one thread per (plane, pixel) of the block, kBatch of them
//   loaded at once: the three mask bytes and the static sample as one
//   16-byte load (read whether or not the plane hits, so no load waits on
//   another).  hit_d and m_d go into one bit word per 32 planes and pixel.
//   A static sample is decoded once into a shared table unless it
//   decodes to exact zeros (masked off with finite rgb: sigmoid of a
//   finite value times 0 is +0 and alpha is 0), which takes no
//   exponential; the others set the pixel's live bit (a non-finite
//   masked-off sample is decoded as the first design decodes it).
//   Stage 2, one thread per (pixel, frame), frames fastest: each word's
//   hit samples (highest plane first) loaded kBuf at a time as 16-byte
//   loads before the walk needs the first of them; then the live and hit
//   planes near to far (their set bits, highest first), static ones read
//   from the table.  The composite runs in the first design's order and
//   rounding (__fmul_rn / __fadd_rn, no FMA contraction).  A plane it
//   skips decodes to exact zeros, and with such a sample the first
//   design's step leaves T, out and alpha_sum as they are (bw = 0 * T =
//   +0 for the finite T >= 0, out += 0 * bw, T *= 1 - 0; a NaN T comes
//   with NaN outputs, which stay NaN), so out and alpha_sum are bit for
//   bit the first design's.
// Plane limit: kTable / D >= 1 pixel a block, D <= kTable = 2048.
//
// The first design (composite_first_kernel, vl3d_composite_first; called
// by chip_smoke.py and the card tests only): one thread per
// (pixel, frame), frames fastest, each plane's hit byte, then its sample
// as four scalar loads, decoded per frame.
#include "common.cuh"

namespace {

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// one sample's decode as the first design computes it; m is 0 or 1
__device__ __forceinline__ float4 decode(float x0, float x1, float x2,
                                         float x3, float m) {
  float4 d;
  d.x = __fmul_rn(sigmoid_f(x0), m);
  d.y = __fmul_rn(sigmoid_f(x1), m);
  d.z = __fmul_rn(sigmoid_f(x2), m);
  d.w = m != 0.0f ? sigmoid_f(x3) : 0.0f;
  return d;
}

// the same values with no exponential where the sample is masked off and
// its rgb finite (sigmoid of a finite value times 0 is +0; alpha is 0)
__device__ __forceinline__ float4 decode_skip(float4 x, bool m) {
  if (!m && isfinite(x.x) && isfinite(x.y) && isfinite(x.z)) {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return decode(x.x, x.y, x.z, x.w, m ? 1.0f : 0.0f);
}

constexpr int kTable = 2048;     // shared table entries (32 KB) a block
constexpr int kMaxPix = 32;      // pixels a block
constexpr int kMinThreads = 128;
constexpr int kMaxThreads = 512;
constexpr int kBatch = 4;        // stage 1: samples a thread loads at once
constexpr int kBuf = 4;          // stage 2: hit samples a thread loads at once

struct CompositeLayout {
  int pix;       // pixels a block
  int words;     // bit words a pixel (32 planes each)
  int threads;   // a block
  int smem;      // dynamic shared bytes
};

__host__ __device__ inline CompositeLayout composite_layout(int D, int F) {
  CompositeLayout L;
  L.pix = D > kTable ? 0 : (kTable / D < kMaxPix ? kTable / D : kMaxPix);
  L.words = (D + 31) / 32;
  const int work = L.pix * F;
  int t = (work + 31) / 32 * 32;
  t = t < kMinThreads ? kMinThreads : (t > kMaxThreads ? kMaxThreads : t);
  L.threads = t;
  L.smem = 16 * L.pix * D + 12 * L.pix * L.words;
  return L;
}

__global__ void __launch_bounds__(kMaxThreads)
composite_tile_kernel(const float* __restrict__ vals_s,
                      const float* __restrict__ vals_d,
                      const uint8_t* __restrict__ m_s,
                      const uint8_t* __restrict__ hit_d,
                      const uint8_t* __restrict__ m_d, int D, long long P,
                      int F, int pix, int words, float* __restrict__ out,
                      float* __restrict__ asum) {
  extern __shared__ float4 smem4[];
  float4* table = smem4;                                   // [D][pix]
  unsigned* hitw = reinterpret_cast<unsigned*>(smem4 + (long long)D * pix);
  unsigned* mdw = hitw + pix * words;                      // [pix][words]
  unsigned* livew = mdw + pix * words;                     // [pix][words]
  const long long p0 = (long long)blockIdx.x * pix;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < 3 * pix * words; i += nt) hitw[i] = 0u;
  __syncthreads();

  // stage 1: one thread per (plane, pixel), kBatch of them loaded at once
  // (the static sample read whether or not the plane hits, so no load
  // waits on another)
  const float4* vs4 = reinterpret_cast<const float4*>(vals_s);
  for (int i0 = tid; i0 < D * pix; i0 += kBatch * nt) {
    uint8_t hb[kBatch], sb[kBatch], db[kBatch];
    float4 x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * nt;
      const int s = i / pix, pl = i - s * pix;
      hb[b] = 2;                                           // nothing here
      if (i < D * pix && p0 + pl < P) {
        const long long sp = (long long)s * P + p0 + pl;
        hb[b] = hit_d[sp];
        sb[b] = m_s[sp];
        db[b] = m_d[sp];
        x[b] = __ldg(vs4 + sp);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (hb[b] > 1) continue;
      const int i = i0 + b * nt;
      const int s = i / pix, pl = i - s * pix;
      const unsigned bit = 1u << (s & 31);
      if (hb[b]) {
        atomicOr(&hitw[pl * words + (s >> 5)], bit);
        if (db[b]) atomicOr(&mdw[pl * words + (s >> 5)], bit);
      } else if (sb[b] || !(isfinite(x[b].x) && isfinite(x[b].y)
                            && isfinite(x[b].z))) {
        // a static sample that is not exactly zeros once decoded
        table[i] = decode(x[b].x, x[b].y, x[b].z, x[b].w, sb[b] ? 1.0f
                                                                : 0.0f);
        atomicOr(&livew[pl * words + (s >> 5)], bit);
      }
    }
  }
  __syncthreads();

  // stage 2: one thread per (pixel, frame), frames fastest; a word's hit
  // samples loaded kBuf at a time, highest plane first, as the walk
  // reaches the first of them
  const float4* vd4 = reinterpret_cast<const float4*>(vals_d);
  for (int j = tid; j < pix * F; j += nt) {
    const int pl = j / F, f = j - pl * F;
    const long long p = p0 + pl;
    if (p >= P) continue;
    const float4* src = vd4 + p * F + f;            // plane s at s * P * F
    const long long plane = P * F;
    float T = 1.0f, o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, as = 0.0f;
    for (int w = words - 1; w >= 0; --w) {
      const unsigned hw = hitw[pl * words + w], mw = mdw[pl * words + w];
      const int base = 32 * w;
      unsigned pend = hw;                           // hits not loaded yet
      int left = 0;                                 // loaded, not used
      float4 buf[kBuf];
      auto refill = [&]() {
#pragma unroll
        for (int g = 0; g < kBuf; ++g) {
          if (pend) {
            const int b = 31 - __clz(pend);
            pend ^= 1u << b;
            buf[g] = __ldg(src + (base + b) * plane);
            ++left;
          }
        }
      };
      if (hw) refill();
      unsigned live = hw | livew[pl * words + w];
      while (live) {
        const int s = base + 31 - __clz(live);
        const unsigned bit = 1u << (s - base);
        live ^= bit;
        float4 d;
        if (hw & bit) {
          if (left == 0) refill();
          d = decode_skip(buf[0], (mw & bit) != 0);
#pragma unroll
          for (int g = 0; g + 1 < kBuf; ++g) buf[g] = buf[g + 1];
          --left;
        } else {
          d = table[s * pix + pl];
        }
        const float bw = __fmul_rn(d.w, T);
        o0 = __fadd_rn(o0, __fmul_rn(d.x, bw));
        o1 = __fadd_rn(o1, __fmul_rn(d.y, bw));
        o2 = __fadd_rn(o2, __fmul_rn(d.z, bw));
        as = __fadd_rn(as, bw);
        T = __fmul_rn(T, __fsub_rn(1.0f, d.w));
      }
    }
    const long long o = p * F + f;
    out[o * 3 + 0] = o0;
    out[o * 3 + 1] = o1;
    out[o * 3 + 2] = o2;
    asum[o] = as;
  }
}

// K4's first design (see the header)
__global__ void composite_first_kernel(const float* __restrict__ vals_s,
                                       const float* __restrict__ vals_d,
                                       const uint8_t* __restrict__ m_s,
                                       const uint8_t* __restrict__ hit_d,
                                       const uint8_t* __restrict__ m_d, int D,
                                       long long P, int F, int C,
                                       float* __restrict__ out,
                                       float* __restrict__ asum) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P * F) return;
  const long long p = idx / F;
  const int f = (int)(idx % F);
  float T = 1.0f, o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, as = 0.0f;
  for (int s = D - 1; s >= 0; --s) {
    const long long sp = (long long)s * P + p;
    const float* val;
    float m;
    if (hit_d[sp]) {
      val = vals_d + (sp * F + f) * C;
      m = m_d[sp] ? 1.0f : 0.0f;
    } else {
      val = vals_s + sp * C;
      m = m_s[sp] ? 1.0f : 0.0f;
    }
    const float4 d = decode(val[0], val[1], val[2], val[3], m);
    const float bw = __fmul_rn(d.w, T);
    o0 = __fadd_rn(o0, __fmul_rn(d.x, bw));
    o1 = __fadd_rn(o1, __fmul_rn(d.y, bw));
    o2 = __fadd_rn(o2, __fmul_rn(d.z, bw));
    as = __fadd_rn(as, bw);
    T = __fmul_rn(T, __fsub_rn(1.0f, d.w));
  }
  out[idx * 3 + 0] = o0;
  out[idx * 3 + 1] = o1;
  out[idx * 3 + 2] = o2;
  asum[idx] = as;
}

}  // namespace

// K4.  vals_s 16-byte aligned (the wrapper checks), C = 4; returns
// cudaErrorInvalidValue past the plane limit.
VL3D_API int vl3d_composite(const float* vals_s, const float* vals_d,
                            const uint8_t* m_s, const uint8_t* hit_d,
                            const uint8_t* m_d, int D, long long P, int F,
                            int C, float* out, float* alpha_sum,
                            void* stream) {
  const CompositeLayout L = composite_layout(D, F);
  if (C != 4 || L.pix < 1) return (int)cudaErrorInvalidValue;
  if (P > 0 && F > 0) {
    const long long blocks = (P + L.pix - 1) / L.pix;
    composite_tile_kernel<<<(unsigned)blocks, L.threads, L.smem,
                            (cudaStream_t)stream>>>(
        vals_s, vals_d, m_s, hit_d, m_d, D, P, F, L.pix, L.words, out,
        alpha_sum);
  }
  return (int)cudaGetLastError();
}

// K4's layout for D planes and F frames: pixels a block, bit words a
// pixel, threads a block, dynamic shared bytes (for the card's checks
// against render/fused.py:composite_layout)
VL3D_API int vl3d_composite_layout(int D, int F, long long* out) {
  const CompositeLayout L = composite_layout(D, F);
  out[0] = L.pix;
  out[1] = L.words;
  out[2] = L.threads;
  out[3] = L.smem;
  return 0;
}

VL3D_API int vl3d_composite_first(const float* vals_s, const float* vals_d,
                                  const uint8_t* m_s, const uint8_t* hit_d,
                                  const uint8_t* m_d, int D, long long P,
                                  int F, int C, float* out, float* alpha_sum,
                                  void* stream) {
  const long long n = P * F;
  if (n > 0) {
    composite_first_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
        vals_s, vals_d, m_s, hit_d, m_d, D, P, F, C, out, alpha_sum);
  }
  return (int)cudaGetLastError();
}
