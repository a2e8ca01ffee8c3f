// Helpers shared by the port's CUDA kernels: element conversion, vector
// loads and warp reductions.  Every kernel library includes this header
// once, so the C entry below exists once per library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

// dtype codes passed from Python (kernels/_build.py callers)
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int BYTES> struct Raw;
template <> struct Raw<1> { using type = unsigned char; };
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// Load N consecutive elements of T (address aligned to N * sizeof(T), or
// to 16 bytes when that is larger) as floats, in loads of up to 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kChunk = kBytes >= 16 ? 16 : kBytes;
  constexpr int kPer = kChunk / (int)sizeof(T);
  using R = typename Raw<kChunk>::type;
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    R raw = reinterpret_cast<const R*>(p)[c];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_f32(e[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Per-row int8 absmax quantization of the transport packet, shared by the
// quantize and exit_quant kernels so both give the same bytes:
//   scale = max(absmax / 127, 1e-12); q = clip(rint(x / scale), -127, 127)
// rintf rounds half to even (as jnp.round does) and x / scale is a true
// division (no reciprocal), so codes match the reference exactly.
__device__ __forceinline__ float int8_scale(float absmax) {
  return fmaxf(absmax / 127.0f, 1e-12f);
}
__device__ __forceinline__ int8_t int8_code(float x, float scale) {
  return (int8_t)fminf(fmaxf(rintf(x / scale), -127.0f), 127.0f);
}

// The int8 codes of N consecutive floats under one scale, written in one
// store of N bytes (dst aligned to N).
template <int N>
__device__ __forceinline__ void store_codes(int8_t* __restrict__ dst,
                                            const float* x, float scale) {
  using R = typename Raw<N>::type;
  union {
    R raw;
    int8_t code[N];
  } u;
#pragma unroll
  for (int i = 0; i < N; ++i) u.code[i] = int8_code(x[i], scale);
  *reinterpret_cast<R*>(dst) = u.raw;
}

}  // namespace rt

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
