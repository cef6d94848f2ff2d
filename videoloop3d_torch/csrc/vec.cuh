// Vector loads and stores of kV = 4, 2 or 1 consecutive floats (or bf16
// texels widened to f32), shared by the gathers of
// bilinear_planes_tilemajor.cu (K16, K17), bilinear_tiles_tilemajor.cu
// (K10) and bilinear_tiles.cu (K9).  Included by each source (each holds
// its own copy).
#pragma once

#include "common.cuh"

namespace {

// kV consecutive floats (kV = 4, 2, 1), loaded and stored as one vector
template <int kV> struct VecF { float v[kV]; };

template <int kV>
__device__ __forceinline__ VecF<kV> ld_vec(const float* __restrict__ p) {
  VecF<kV> r;
  if constexpr (kV == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  } else if constexpr (kV == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    r.v[0] = a.x; r.v[1] = a.y;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

// kV consecutive bf16 texels widened to f32 (4: one 8-byte load, 2: one
// 4-byte load)
template <int kV>
__device__ __forceinline__ VecF<kV> ld_vec(
    const __nv_bfloat16* __restrict__ p) {
  VecF<kV> r;
  if constexpr (kV == 4) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    r.v[0] = __uint_as_float(a.x << 16);
    r.v[1] = __uint_as_float(a.x & 0xffff0000u);
    r.v[2] = __uint_as_float(a.y << 16);
    r.v[3] = __uint_as_float(a.y & 0xffff0000u);
  } else if constexpr (kV == 2) {
    const unsigned a = __ldg(reinterpret_cast<const unsigned*>(p));
    r.v[0] = __uint_as_float(a << 16);
    r.v[1] = __uint_as_float(a & 0xffff0000u);
  } else {
    r.v[0] = __bfloat162float(p[0]);
  }
  return r;
}

// kV consecutive floats of shared memory (or any plain pointer)
template <int kV>
__device__ __forceinline__ VecF<kV> ld_vec_plain(const float* p) {
  VecF<kV> r;
  if constexpr (kV == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  } else if constexpr (kV == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    r.v[0] = a.x; r.v[1] = a.y;
  } else {
    r.v[0] = p[0];
  }
  return r;
}

template <int kV>
__device__ __forceinline__ void st_vec(float* p, const VecF<kV>& a) {
  if constexpr (kV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  } else if constexpr (kV == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a.v[0], a.v[1]);
  } else {
    p[0] = a.v[0];
  }
}

// streaming store (evict first): K16's samples and K17's 7 GB gradient
// pass through L2 once
template <int kV>
__device__ __forceinline__ void st_vec_cs(float* p, const VecF<kV>& a) {
  if constexpr (kV == 4) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(a.v[0], a.v[1], a.v[2], a.v[3]));
  } else if constexpr (kV == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(a.v[0], a.v[1]));
  } else {
    __stcs(p, a.v[0]);
  }
}

}  // namespace
