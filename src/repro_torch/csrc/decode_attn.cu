// GQA flash-decode attention over a dense (ring) KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn/kernel.py
// (decode_attn_pallas, body _decode_attn_kernel): one new query token per
// row attends over a (B, S, KV, d) cache with an online softmax in float32.
// A key is valid when pos >= 0, pos <= cur[b] and, with a window,
// cur[b] - pos < window; a row with no valid key gives 0.  Unlike the
// Pallas version, cur is per row (B,) and S need not be a multiple of any
// tile: keys past S are masked here.
//
// What bounds it on the H100: bytes.  One call reads K and V once
// (2 * B * S * KV * d * sizeof(T)); the arithmetic is ~4 flops per element
// read.  Design: one block per (kv head, row) keeps the G query heads of
// the group in registers and reads its K/V slice once.  Eight warps stride
// over S, four keys per step with their loads issued together, each warp
// keeping its own (m, l, acc[d]) per head; the warps' states are merged
// through shared memory at the end.  At B = 1 this uses only KV blocks
// (32 of 132 SMs for ee-llm-7b); splitting S across blocks is later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;

template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ pos,
                   const int* __restrict__ cur, T* __restrict__ out, int S,
                   int KV, int window, float scale) {
  constexpr int D = VEC * 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = KV * G;
  const int c = cur[b];

  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      qr[g][j] = rt::to_f32(q[((size_t)b * H + kvh * G + g) * D + lane * VEC + j]);

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
  }

  const size_t srow = (size_t)KV * D;  // elements between keys s and s + 1
  const T* kb = k + (size_t)b * S * srow + (size_t)kvh * D + lane * VEC;
  const T* vb = v + (size_t)b * S * srow + (size_t)kvh * D + lane * VEC;
  const int* pb = pos + (size_t)b * S;

  for (int s0 = warp * kUnroll; s0 < S; s0 += kWarps * kUnroll) {
    float kr[kUnroll][VEC], vr[kUnroll][VEC];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      const int p = s < S ? pb[s] : -1;
      ok[u] = p >= 0 && p <= c && (window == 0 || c - p < window);
      if (ok[u]) {
        rt::load_vec<T, VEC>(kb + s * srow, kr[u]);
        rt::load_vec<T, VEC>(vb + s * srow, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;  // uniform across the warp: one key per step
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) dot += qr[g][j] * kr[u][j];
        dot = rt::warp_sum(dot) * scale;
        const float m_new = fmaxf(m[g], dot);
        const float corr = expf(m[g] - m_new);  // 0 while m is -inf
        const float p = expf(dot - m_new);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] = acc[g][j] * corr + p * vr[u][j];
        m[g] = m_new;
      }
    }
  }

  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp] = m[g];
      sm_l[warp] = l[g];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) sm_acc[warp][lane * VEC + j] = acc[g][j];
    __syncthreads();
    const int t = threadIdx.x;
    if (t < D) {
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
      float o = 0.f;  // a row with no valid key gives 0
      if (mx != -INFINITY) {
        float den = 0.f, num = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float e = expf(sm_m[w] - mx);  // 0 for a warp with no key
          den += sm_l[w] * e;
          num += sm_acc[w][t] * e;
        }
        o = num / fmaxf(den, 1e-30f);
      }
      out[((size_t)b * H + kvh * G + g) * D + t] = rt::from_f32<T>(o);
    }
    __syncthreads();
  }
}

template <typename T, int VEC>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v,
                     const int* pos, const int* cur, void* out, int B, int S,
                     int KV, int window, float scale, cudaStream_t st) {
  const dim3 grid(KV, B), block(kWarps * 32);
#define DA_CASE(GG)                                                          \
  case GG:                                                                   \
    decode_attn_kernel<T, VEC, GG><<<grid, block, 0, st>>>(                  \
        (const T*)q, (const T*)k, (const T*)v, pos, cur, (T*)out, S, KV,     \
        window, scale);                                                      \
    return cudaSuccess;
  switch (G) {
    DA_CASE(1)
    DA_CASE(2)
    DA_CASE(4)
    DA_CASE(8)
  }
#undef DA_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_t(int D, int G, const void* q, const void* k,
                     const void* v, const int* pos, const int* cur, void* out,
                     int B, int S, int KV, int window, float scale,
                     cudaStream_t st) {
  switch (D) {
    case 32: return launch_g<T, 1>(G, q, k, v, pos, cur, out, B, S, KV, window, scale, st);
    case 64: return launch_g<T, 2>(G, q, k, v, pos, cur, out, B, S, KV, window, scale, st);
    case 128: return launch_g<T, 4>(G, q, k, v, pos, cur, out, B, S, KV, window, scale, st);
    case 256: return launch_g<T, 8>(G, q, k, v, pos, cur, out, B, S, KV, window, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, D); k, v (B, S, KV, D); pos (B, S) int32; cur (B,) int32;
// out (B, H, D) in q's dtype.  D in {32, 64, 128, 256}, H / KV in {1, 2, 4, 8}.
extern "C" int decode_attn_launch(int device, int dtype, const void* q,
                                  const void* k, const void* v,
                                  const void* pos, const void* cur, void* out,
                                  int B, int H, int KV, int S, int D,
                                  int window, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || KV <= 0 || S <= 0 || H % KV) return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)D);
  const int G = H / KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    err = launch_t<float>(D, G, q, k, v, (const int*)pos, (const int*)cur,
                          out, B, S, KV, window, scale, st);
  else if (dtype == rt::kBF16)
    err = launch_t<__nv_bfloat16>(D, G, q, k, v, (const int*)pos,
                                  (const int*)cur, out, B, S, KV, window,
                                  scale, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
