// GQA flash-decode attention over a dense (ring) KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn/kernel.py
// (decode_attn_pallas, body _decode_attn_kernel): one new query token per
// row attends over a (B, S, KV, d) cache with an online softmax in float32.
// A key is valid when pos >= 0, pos <= cur[b] and, with a window,
// cur[b] - pos < window; a row with no valid key gives 0.  Unlike the
// Pallas version, cur is per row (B,) and S need not be a multiple of any
// tile: keys past S are not read.
//
// What bounds it on the H100: bytes.  One call reads K and V once
// (2 * B * S * KV * d * sizeof(T)); the arithmetic is ~4 flops per element
// read.  At B = 1 that is 9 MB for ee-llm-7b (2.7 us at 3.35 TB/s), and
// the earlier design (one block per (kv head, row), 32 of 132 SMs, each
// warp's keys a chain of dependent loads four at a time) took 53 us.
// Design: when the (row, kv head) pairs cannot fill the card, the S axis
// is cut in splits (ops.split_plan), one block per (split, kv head, row),
// the splits of a pair forming one thread block cluster; every block runs
// the shared body of decode_attn_common.cuh in the "ring row" address
// mode (wide lanes, each warp's next tiles copied to shared memory by
// cp.async while it computes the current one), and the cluster merges its
// partials through distributed shared memory.  One call is one launch.
#include "decode_attn_common.cuh"

namespace {

// tiles of kTile keys of one ring row, from the split's first key
template <typename P, int kTile>
struct RingSrc {
  const P* k;  // the split's first key, at its kv head
  const P* v;
  const int* pos;  // its marker
  int len;         // keys of the split
  size_t kstride;  // elements between two keys
  __device__ __forceinline__ int ahead(int) const { return 0; }
  __device__ __forceinline__ da::Tile<P> tile(int t, int) const {
    const int s0 = t * kTile;
    const int n = len - s0 < kTile ? len - s0 : kTile;
    return da::Tile<P>{k + s0 * kstride, v + s0 * kstride, pos + s0, nullptr,
                       nullptr, n};
  }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(da::kWarps * 32)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ pos,
                   const int* __restrict__ cur, T* __restrict__ out, int S,
                   int KV, int per, int window, float scale) {
  using L = da::Layout<T, T, D, G>;
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int lo = sp * per;
  const int len = S - lo < per ? S - lo : per;
  const size_t kstride = (size_t)KV * D;
  const size_t k0 = ((size_t)b * S + lo) * kstride + (size_t)kvh * D;
  const RingSrc<T, L::kTile> src{k + k0, v + k0, pos + (size_t)b * S + lo,
                                 len, kstride};
  const size_t pair = (size_t)b * KV + kvh;  // q rows pair * G .. + G - 1
  da::attend<T, T, D, G>(src, (len + L::kTile - 1) / L::kTile,
                         q + pair * G * D, cur[b], window, scale, KV,
                         out + pair * G * D);
}

struct Args {
  const void *q, *k, *v;
  const int *pos, *cur;
  void* out;
  int B, KV, S, per, splits, window;
  float scale;
};

template <typename T, int D, int G>
cudaError_t launch(const Args& a, cudaStream_t st) {
  return da::launch_split(decode_attn_kernel<T, D, G>,
                          da::Layout<T, T, D, G>::kSmem, a.splits, a.KV, a.B,
                          st, (const T*)a.q, (const T*)a.k, (const T*)a.v,
                          a.pos, a.cur, (T*)a.out, a.S, a.KV, a.per,
                          a.window, a.scale);
}

template <typename T, int D>
cudaError_t launch_g(int G, const Args& a, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, D, 1>(a, st);
    case 2: return launch<T, D, 2>(a, st);
    case 4: return launch<T, D, 4>(a, st);
    case 8: return launch<T, D, 8>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_t(int D, int G, const Args& a, cudaStream_t st) {
  switch (D) {
    case 32: return launch_g<T, 32>(G, a, st);
    case 64: return launch_g<T, 64>(G, a, st);
    case 128: return launch_g<T, 128>(G, a, st);
    case 256: return launch_g<T, 256>(G, a, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, D); k, v (B, S, KV, D); pos (B, S) int32; cur (B,) int32;
// out (B, H, D) in q's dtype.  D in {32, 64, 128, 256}, H / KV in
// {1, 2, 4, 8}.  Split s covers keys [s * per, min(S, (s + 1) * per)),
// 1 <= splits <= 8.
extern "C" int decode_attn_launch(int device, int dtype, const void* q,
                                  const void* k, const void* v,
                                  const void* pos, const void* cur, void* out,
                                  int B, int H, int KV, int S, int D,
                                  int window, int splits, int per,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || KV <= 0 || S <= 0 || H % KV || splits <= 0 || per <= 0 ||
      (long long)(splits - 1) * per >= S || (long long)splits * per < S)
    return cudaErrorInvalidValue;
  const Args a{q,   k,   v,      (const int*)pos, (const int*)cur,
               out, B,   KV,     S,               per,
               splits, window, 1.0f / sqrtf((float)D)};
  const int G = H / KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    err = launch_t<float>(D, G, a, st);
  else if (dtype == rt::kBF16)
    err = launch_t<__nv_bfloat16>(D, G, a, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
