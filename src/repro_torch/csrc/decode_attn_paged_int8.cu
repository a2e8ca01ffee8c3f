// GQA flash-decode attention over a block-paged KV pool of int8 pages with
// per-(slot, kv head) float32 scales, dequantized after the load.  The
// kernel, what bounds it and its design are in decode_attn_paged.cuh,
// shared with the float pages of decode_attn_paged.cu.
#include "decode_attn_paged.cuh"

// As paged_entry in decode_attn_paged.cuh, with quantized = 1.
extern "C" int decode_attn_paged_int8_launch(
    int device, int dtype, int quantized, const void* q, const void* kp,
    const void* vp, const void* ks, const void* vs, const void* pos,
    const void* tbl, const void* cur, void* out, int B, int H,
    int KV, int ps, int n_lp, int D, int window, int splits, int per,
    void* stream) {
  return paged_entry<true>(device, dtype, quantized, q, kp, vp, ks, vs,
                            pos, tbl, cur, out, B, H, KV, ps, n_lp, D,
                            window, splits, per, stream);
}
