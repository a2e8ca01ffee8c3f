// Fused early-exit confidence head + int8 wire quantization.
//
// Replaces the Pallas TPU kernel repro/kernels/exit_quant/kernel.py
// (exit_quant_pallas, body _exit_quant_kernel): the exit decision of
// exit_head.cu and, in the same launch, the int8 packet of the RAW
// (pre-norm) hidden, q = clip(rint(h / scale), -127, 127) with
// scale = max(absmax / 127, 1e-12) per row.  The blocks of V tile 0
// quantize the rows they already hold; the rest is exit_common.cuh's
// two-pass exit head, whose notes give the bound (the bytes of W; the
// packet adds B * D reads it shares and B * (D + 4) bytes of writes).
#include "exit_common.cuh"

// As exit_head_launch, plus q (B, D) int8 and scale (B, 1) f32 outputs.
extern "C" int exit_quant_launch(int device, int dtype, const void* hidden,
                                 const void* weight, const void* norm_scale,
                                 float eps, int B, int V, int D, void* part_m,
                                 void* part_l, void* part_a, void* conf,
                                 void* tok, void* lse, void* q, void* scale,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    err = rt::exit_launch<float, true>(
        hidden, weight, norm_scale, eps, B, V, D, (float*)part_m,
        (float*)part_l, (int*)part_a, (float*)conf, (int*)tok, (float*)lse,
        (int8_t*)q, (float*)scale, st);
  else if (dtype == rt::kBF16)
    err = rt::exit_launch<__nv_bfloat16, true>(
        hidden, weight, norm_scale, eps, B, V, D, (float*)part_m,
        (float*)part_l, (int*)part_a, (float*)conf, (int*)tok, (float*)lse,
        (int8_t*)q, (float*)scale, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
