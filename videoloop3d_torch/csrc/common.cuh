// Shared helpers for the render kernels (plain C interface, loaded with
// ctypes by videoloop3d_torch/kernels.py).
//
// Every kernel here runs one thread per output element and computes with
// 64-bit offsets.  Arithmetic uses the explicit round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, ...) so nvcc contracts nothing into
// an FMA: each operation rounds once, in the same order as the plain
// PyTorch version beside the wrapper, so kernel and plain version agree
// to the last bit wherever the inputs agree.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define VL3D_API extern "C" __attribute__((visibility("default")))

constexpr int kBlock = 256;

inline unsigned int grid_for(long long n) {
  return static_cast<unsigned int>((n + kBlock - 1) / kBlock);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// f32 rounded to bf16 (to nearest even, as .to(torch.bfloat16)) and
// widened back
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a * (1 - f) + b * f, rounded per operation (the JAX package's lerp)
__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}
