// Fused early-exit confidence head, for one exit or several in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/exit_head/kernel.py
// (exit_head_pallas, body _exit_head_kernel), evaluated for E exits of B
// slots at once.  The computation, what bounds it on the H100 (the bytes of
// W, read once a launch) and the design (a persistent grid, a TMA ring,
// one producer warp, the merge in the last block) are described in
// exit_common.cuh, which this file shares with exit_quant.cu.
#include "exit_common.cuh"

// hidden (E * B, D), weight (V, D), norm_scales (E, D), all of one dtype;
// quant_exit: the exit whose raw rows also get the int8 packet q (B, D)
// int8 and qscale (B,) f32, or -1; ws: rt::kExitPartials * cap f32 of
// partials and then the completion counter (0 at the first launch, left
// 0 by each); conf, lse, mx (E * B,) f32, tok (E * B,) int32, mx each
// row's raw max logit (what a vocabulary split over ranks merges on).  stages and
// per_sm (0 for the defaults) set the ring's depth and the blocks a SM;
// *grid receives the blocks launched.
extern "C" int exit_heads_launch(int device, int dtype, const void* hidden,
                                 const void* weight, const void* norm_scales,
                                 float eps, int E, int B, int V, int D,
                                 int quant_exit, void* q, void* qscale,
                                 void* ws, int cap, void* conf, void* tok,
                                 void* lse, void* mx, int stages, int per_sm,
                                 void* stream, int* grid) {
  return rt::exit_heads_entry(device, dtype, hidden, weight, norm_scales, eps,
                              E, B, V, D, quant_exit, q, qscale, ws, cap,
                              conf, tok, lse, mx, stages, per_sm, stream,
                              grid);
}
