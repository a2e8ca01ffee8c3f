// Fused early-exit confidence head + int8 wire quantization.
//
// Replaces the Pallas TPU kernel repro/kernels/exit_quant/kernel.py
// (exit_quant_pallas, body _exit_quant_kernel): the exit decision of
// exit_head.cu and, in the same launch, the int8 packet of the RAW
// (pre-norm) hidden, q = clip(rint(h / scale), -127, 127) with
// scale = max(absmax / 127, 1e-12) per row.  It is exit_common.cuh's
// kernel with one exit whose rows are also quantized (the blocks share
// the packet rows out while their first W loads are in flight); the
// bound is the bytes of W, the packet adds B * (D + 4) bytes of writes.
#include "exit_common.cuh"

// hidden (B, D), weight (V, D), norm_scale (D,); q (B, D) int8, scale (B, 1)
// f32; ws, cap, conf, tok, lse as exit_heads_launch in exit_head.cu.
extern "C" int exit_quant_launch(int device, int dtype, const void* hidden,
                                 const void* weight, const void* norm_scale,
                                 float eps, int B, int V, int D, void* q,
                                 void* scale, void* ws, int cap, void* conf,
                                 void* tok, void* lse, void* stream) {
  return rt::exit_heads_entry(device, dtype, hidden, weight, norm_scale, eps,
                              1, B, V, D, 0, q, scale, ws, cap, conf, tok,
                              lse, 0, 0, stream, nullptr);
}
