// GQA flash-decode attention over a block-paged KV pool, float or int8 pages:
// the body of decode_attn_paged.cu (pages in q's dtype) and
// decode_attn_paged_int8.cu (int8 pages), two libraries that build in
// parallel.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn/kernel.py
// (decode_attn_paged_pallas, body _decode_attn_paged_kernel) in both its
// variants.  One new query token per row attends over the pages its block
// table maps, with an online softmax in float32.  Page (P, ps, KV, D) keys
// are valid when the table entry is >= 0 (an unmapped entry is skipped
// without reading page 0), pos >= 0, pos <= cur[b] and, with a window,
// cur[b] - pos < window; a row with no valid key gives 0.  int8 pages carry
// one float32 scale per (page slot, kv head) in ks / vs and are
// dequantized after the load, so the read stays int8-sized.
//
// What bounds it on the H100: bytes.  One call reads each mapped page's
// K and V slice of its kv head once (int8: one byte an element plus the
// scales); the arithmetic is ~4 flops per element read.  What kept the
// earlier design from that bound was latency: each warp walked its pages
// one after another, and on each page loaded the position markers before
// it could start the K/V loads that depended on them (29 us for a 12.6 us
// bound at 8 slots, and int8 pages no faster).  Design: one block per
// (split, kv head, row) runs the shared body of decode_attn_common.cuh in
// the "table -> page" address mode.  A page's K/V, markers and scales are
// copied together (a mapped page is read whatever its markers say, and
// masked after), by cp.async into each warp's ring of shared-memory
// stages, two tiles ahead of the one being computed; the table entry of
// the tile after those is read into a register one tile earlier still.
// Wide lanes and the byte-permute int8 conversion keep the instructions
// per key low, so int8 pages, half the bytes, are faster than bf16 pages.
// Where the (row, kv head) pairs cannot fill the card the logical pages
// are cut in splits (ops.split_plan) that a thread block cluster merges,
// as in decode_attn.cu.  One call is one launch.
#pragma once

#include <type_traits>

#include "decode_attn_common.cuh"

namespace {

// tiles of kTile keys of the logical pages of one split, tpp tiles a page
template <typename P, int kTile>
struct PagedSrc {
  const P* kp;      // page 0, at the block's kv head
  const P* vp;
  const int* pos;   // page 0's markers
  const float* ks;  // page 0's scales at the kv head (int8 pages)
  const float* vs;
  const int* trow;  // the split's first table entry
  int ps, tpp, KV;
  size_t kstride;   // elements between two keys
  __device__ __forceinline__ int ahead(int t) const {
    return __ldg(trow + t / tpp);
  }
  __device__ __forceinline__ da::Tile<P> tile(int t, int page) const {
    if (page < 0) return da::Tile<P>{kp, vp, pos, ks, vs, 0};  // unmapped
    const int off = (t % tpp) * kTile;
    const size_t key0 = (size_t)page * ps + off;
    const int n = ps - off < kTile ? ps - off : kTile;
    return da::Tile<P>{kp + key0 * kstride, vp + key0 * kstride, pos + key0,
                       ks == nullptr ? nullptr : ks + key0 * KV,
                       vs == nullptr ? nullptr : vs + key0 * KV, n};
  }
};

template <typename T, typename P, int D, int G>
__global__ void __launch_bounds__(da::kWarps * 32)
decode_attn_paged_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                         const P* __restrict__ vp,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ pos,
                         const int* __restrict__ tbl,
                         const int* __restrict__ cur, T* __restrict__ out,
                         int KV, int ps, int n_lp, int per, int window,
                         float scale) {
  using L = da::Layout<T, P, D, G>;
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int lp0 = sp * per;
  const int pages = n_lp - lp0 < per ? n_lp - lp0 : per;
  const int tpp = (ps + L::kTile - 1) / L::kTile;
  const size_t kstride = (size_t)KV * D;
  const PagedSrc<P, L::kTile> src{
      kp + (size_t)kvh * D, vp + (size_t)kvh * D, pos,
      ks == nullptr ? nullptr : ks + kvh, vs == nullptr ? nullptr : vs + kvh,
      tbl + (size_t)b * n_lp + lp0, ps, tpp, KV, kstride};
  const size_t pair = (size_t)b * KV + kvh;  // q rows pair * G .. + G - 1
  da::attend<T, P, D, G>(src, pages * tpp, q + pair * G * D, cur[b], window,
                         scale, KV, out + pair * G * D);
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *pos, *tbl, *cur;
  void* out;
  int B, KV, ps, n_lp, per, splits, window;
  float scale;
};

template <typename T, typename P, int D, int G>
cudaError_t launch(const Args& a, cudaStream_t st) {
  return da::launch_split(
      decode_attn_paged_kernel<T, P, D, G>, da::Layout<T, P, D, G>::kSmem,
      a.splits, a.KV, a.B, st, (const T*)a.q, (const P*)a.kp, (const P*)a.vp,
      a.ks, a.vs, a.pos, a.tbl, a.cur, (T*)a.out, a.KV, a.ps, a.n_lp, a.per,
      a.window, a.scale);
}

template <typename T, typename P, int D>
cudaError_t launch_g(int G, const Args& a, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, P, D, 1>(a, st);
    case 2: return launch<T, P, D, 2>(a, st);
    case 3: return launch<T, P, D, 3>(a, st);
    case 4: return launch<T, P, D, 4>(a, st);
    case 8: return launch<T, P, D, 8>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename P>
cudaError_t launch_d(int D, int G, const Args& a, cudaStream_t st) {
  switch (D) {
    case 32: return launch_g<T, P, 32>(G, a, st);
    case 64: return launch_g<T, P, 64>(G, a, st);
    case 128: return launch_g<T, P, 128>(G, a, st);
    case 160: return launch_g<T, P, 160>(G, a, st);
    case 256: return launch_g<T, P, 256>(G, a, st);
  }
  return cudaErrorInvalidValue;
}

// The C entry of one page type (kInt8: int8 pages with their scales,
// else pages in q's dtype); ``quantized`` must say the same.
//
// q (B, H, D) in float32 (dtype 0), bfloat16 (1) or float16 (2); kp, vp
// (P, ps, KV, D) in q's dtype, or int8 with quantized = 1 and ks, vs
// (P, ps, KV) float32 scales; pos (P, ps) int32; tbl (B, n_lp) int32, -1 =
// unmapped; cur (B,) int32; out (B, H, D) in q's dtype.  D in {32, 64,
// 128, 160, 256}, H / KV in {1, 2, 3, 4, 8}.  Layouts above 48 KB of
// shared memory (float32 pages at D = 160: 123,264 bytes at G = 1 or 2)
// are raised to it in da::launch_split.  Split s covers logical pages
// [s * per, min(n_lp, (s + 1) * per)), 1 <= splits <= 8.
template <bool kInt8>
int paged_entry(int device, int dtype, int quantized, const void* q,
                const void* kp, const void* vp, const void* ks,
                const void* vs, const void* pos, const void* tbl,
                const void* cur, void* out, int B, int H, int KV, int ps,
                int n_lp, int D, int window, int splits, int per,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || KV <= 0 || ps <= 0 || n_lp <= 0 || H % KV || splits <= 0 ||
      per <= 0 || (long long)(splits - 1) * per >= n_lp ||
      (long long)splits * per < n_lp || quantized != (int)kInt8)
    return cudaErrorInvalidValue;
  if (kInt8 && (ks == nullptr || vs == nullptr)) return cudaErrorInvalidValue;
  const Args a{q, kp, vp, (const float*)ks, (const float*)vs,
               (const int*)pos, (const int*)tbl, (const int*)cur, out, B, KV,
               ps, n_lp, per, splits, window,
               1.0f / sqrtf((float)D)};
  const int G = H / KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    err = launch_d<float, std::conditional_t<kInt8, int8_t, float>>(D, G, a,
                                                                     st);
  else if (dtype == rt::kBF16)
    err = launch_d<__nv_bfloat16,
                   std::conditional_t<kInt8, int8_t, __nv_bfloat16>>(D, G, a,
                                                                      st);
  else if (dtype == rt::kF16)
    err = launch_d<__half, std::conditional_t<kInt8, int8_t, __half>>(D, G, a,
                                                                      st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
