// Per-row int8 absmax quantizer of the edge->cloud wire packet.
//
// Replaces the Pallas TPU kernel repro/kernels/quantize/kernel.py
// (quantize_int8_pallas, body _quantize_kernel):
//   scale = max(max|x| / 127, 1e-12);  q = clip(round(x / scale), -127, 127)
// per row of an (N, d) tensor, rounding half to even (rintf) and dividing
// by the scale, exactly as the reference does.
//
// What bounds it on the H100: for the decode upload, (1, 4096), launch
// latency; the bytes (N * d * (sizeof(T) + 1) + 4 N) take nanoseconds.
// Design: one block per row; 256 threads reduce the absmax through warp
// shuffles and shared memory, then write the codes in the same pass over
// the row (the second read of the row hits L1/L2).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, int D) {
  const T* xr = x + (size_t)blockIdx.x * D;
  int8_t* qr = q + (size_t)blockIdx.x * D;
  float amax = 0.f;
  for (int j = threadIdx.x; j < D; j += kThreads)
    amax = fmaxf(amax, fabsf(rt::to_f32(xr[j])));
  __shared__ float part[kThreads / 32];
  amax = rt::warp_max(amax);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) amax = fmaxf(amax, part[w]);
  const float s = rt::int8_scale(amax);
  for (int j = threadIdx.x; j < D; j += kThreads)
    qr[j] = rt::int8_code(rt::to_f32(xr[j]), s);
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
}

}  // namespace

// x (N, D) f32 or bf16 -> q (N, D) int8, scale (N, 1) f32.
extern "C" int quantize_launch(int device, int dtype, const void* x, void* q,
                               void* scale, int N, int D, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    quantize_kernel<float><<<N, kThreads, 0, st>>>(
        (const float*)x, (int8_t*)q, (float*)scale, D);
  else if (dtype == rt::kBF16)
    quantize_kernel<__nv_bfloat16><<<N, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (int8_t*)q, (float*)scale, D);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
