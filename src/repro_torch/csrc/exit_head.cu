// Fused early-exit confidence head.
//
// Replaces the Pallas TPU kernel repro/kernels/exit_head/kernel.py
// (exit_head_pallas, body _exit_head_kernel).  The computation, what bounds
// it on the H100 (the bytes of W) and the two-pass design are described in
// exit_common.cuh, which this file shares with exit_quant.cu.
#include "exit_common.cuh"

// hidden (B, D), weight (V, D), norm_scale (D,) all of one dtype;
// part_m / part_l (B, exit_tiles(V)) f32 and part_a int32 scratch;
// conf, lse (B,) f32; tok (B,) int32.
extern "C" int exit_head_launch(int device, int dtype, const void* hidden,
                                const void* weight, const void* norm_scale,
                                float eps, int B, int V, int D, void* part_m,
                                void* part_l, void* part_a, void* conf,
                                void* tok, void* lse, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    err = rt::exit_launch<float, false>(
        hidden, weight, norm_scale, eps, B, V, D, (float*)part_m,
        (float*)part_l, (int*)part_a, (float*)conf, (int*)tok, (float*)lse,
        nullptr, nullptr, st);
  else if (dtype == rt::kBF16)
    err = rt::exit_launch<__nv_bfloat16, false>(
        hidden, weight, norm_scale, eps, B, V, D, (float*)part_m,
        (float*)part_l, (int*)part_a, (float*)conf, (int*)tok, (float*)lse,
        nullptr, nullptr, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
