// The early-exit confidence head, shared by exit_head.cu and exit_quant.cu
// (which adds the int8 wire packet of the raw hidden to the same launch).
//
// Computes, per row b of a (B, d) hidden:
//   hn = h * rsqrt(mean(h^2) + eps) * (1 + ns)           (float32)
//   logits = hn @ W^T over the (V, d) unembedding W
//   lse = logsumexp(logits), conf = exp(max - lse), tok = argmax(logits)
// without writing the (B, V) logits anywhere.
//
// What bounds it on the H100: bytes.  W is read once (V * d * sizeof(T):
// 262 MB for ee-llm-7b in bf16); the product is 2 * B * V * d flops, far
// under the card's peak at the batch sizes of decode.  Design: the TPU
// kernel walks V tiles in order and carries (max, sum-exp, argmax) in
// scratch; blocks on the H100 run in no order, so this is two passes.
// Pass 1: one block per (64-row V tile, group of up to 8 rows) recomputes
// the rms-norm of its rows into shared memory (d floats per row, cheap
// beside the tile of W), streams its W rows with 16-byte loads (one warp
// per W row, all of the block's hidden rows at once), and writes one
// partial (max, sum-exp, argmax) per (row, tile).  The ragged last tile
// masks rows past V.  Pass 2: one warp per row merges the tiles.  The
// argmax merge keeps the larger value and, on equal values, the lower
// index, so ties go to the lowest index as jnp.argmax does, in any merge
// order.
#pragma once

#include <limits.h>

#include "common.cuh"

namespace rt {

constexpr int kExitThreads = 256;
constexpr int kExitWarps = kExitThreads / 32;
constexpr int kExitTileV = 64;
constexpr int kExitMaxRows = 8;
constexpr size_t kMaxSharedBytes = 227 * 1024;

__host__ __device__ inline int exit_tiles(int V) {
  return (V + kExitTileV - 1) / kExitTileV;
}

template <typename T, bool QUANT>
__global__ void __launch_bounds__(kExitThreads)
exit_tile_kernel(const T* __restrict__ h, const T* __restrict__ w,
                 const T* __restrict__ ns, float eps, int B, int V, int D,
                 int rows_per_block, float* __restrict__ part_m,
                 float* __restrict__ part_l, int* __restrict__ part_a,
                 int8_t* __restrict__ q, float* __restrict__ qscale) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int b0 = blockIdx.y * rows_per_block;
  const int nb = min(rows_per_block, B - b0);
  float* hn = smem;                               // [rows][D]
  float* lg = smem + (size_t)rows_per_block * D;  // [rows][kExitTileV]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // 1. rms-norm of the block's rows (and, for exit_quant, the int8 packet
  //    of the raw rows, written by the blocks of tile 0 only)
  for (int r = warp; r < nb; r += kExitWarps) {
    const T* hr = h + (size_t)(b0 + r) * D;
    float ss = 0.f, amax = 0.f;
    for (int j = lane; j < D; j += 32) {
      const float x = to_f32(hr[j]);
      ss += x * x;
      amax = fmaxf(amax, fabsf(x));
    }
    ss = warp_sum(ss);
    const float inv = 1.0f / sqrtf(ss / (float)D + eps);
    for (int j = lane; j < D; j += 32)
      hn[(size_t)r * D + j] = to_f32(hr[j]) * inv * (1.0f + to_f32(ns[j]));
    if (QUANT && tile == 0) {
      const float scale = int8_scale(warp_max(amax));
      int8_t* qr = q + (size_t)(b0 + r) * D;
      for (int j = lane; j < D; j += 32) qr[j] = int8_code(to_f32(hr[j]), scale);
      if (lane == 0) qscale[b0 + r] = scale;
    }
  }
  __syncthreads();

  // 2. logits of the tile: one warp per W row, 16-byte loads
  constexpr int N = 16 / (int)sizeof(T);
  for (int i = warp; i < kExitTileV; i += kExitWarps) {
    const int vi = tile * kExitTileV + i;
    if (vi >= V) {  // ragged last tile
      if (lane < nb) lg[lane * kExitTileV + i] = -INFINITY;
      continue;
    }
    float acc[kExitMaxRows];
#pragma unroll
    for (int r = 0; r < kExitMaxRows; ++r) acc[r] = 0.f;
    const T* wr = w + (size_t)vi * D;
#pragma unroll 4
    for (int j0 = lane * N; j0 < D; j0 += 32 * N) {
      float wv[N];
      load_vec<T, N>(wr + j0, wv);
#pragma unroll
      for (int r = 0; r < kExitMaxRows; ++r) {
        if (r < nb) {
          // 16-byte shared-memory reads: consecutive lanes read
          // consecutive float4s (no 8-way bank conflict of scalar reads)
          const float4* hr =
              reinterpret_cast<const float4*>(hn + (size_t)r * D + j0);
#pragma unroll
          for (int e = 0; e < N / 4; ++e) {
            const float4 hv = hr[e];
            acc[r] += wv[4 * e] * hv.x + wv[4 * e + 1] * hv.y +
                      wv[4 * e + 2] * hv.z + wv[4 * e + 3] * hv.w;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kExitMaxRows; ++r) {
      if (r < nb) {
        const float s = warp_sum(acc[r]);
        if (lane == 0) lg[r * kExitTileV + i] = s;
      }
    }
  }
  __syncthreads();

  // 3. the tile's (max, sum-exp, argmax) per row
  for (int r = warp; r < nb; r += kExitWarps) {
    const float* lr = lg + r * kExitTileV;
    float mx = -INFINITY;
    int arg = INT_MAX;
    for (int i = lane; i < kExitTileV; i += 32) {
      if (lr[i] > mx) {
        mx = lr[i];
        arg = i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx, o);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
      if (om > mx || (om == mx && oa < arg)) {
        mx = om;
        arg = oa;
      }
    }
    float se = 0.f;
    for (int i = lane; i < kExitTileV; i += 32) se += expf(lr[i] - mx);
    se = warp_sum(se);
    if (lane == 0) {
      const size_t o = (size_t)(b0 + r) * n_tiles + tile;
      part_m[o] = mx;
      part_l[o] = se;
      part_a[o] = tile * kExitTileV + arg;
    }
  }
}

__device__ __forceinline__ void merge_partial(float& m, float& l, int& a,
                                              float m2, float l2, int a2) {
  if (m2 > m || (m2 == m && a2 < a)) a = a2;
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both sides empty
  l = l * expf(m - mx) + l2 * expf(m2 - mx);
  m = mx;
}

// Pass 2: one warp per row merges the row's tile partials.
__global__ void exit_merge_kernel(const float* __restrict__ part_m,
                                  const float* __restrict__ part_l,
                                  const int* __restrict__ part_a, int n_tiles,
                                  float* __restrict__ conf,
                                  int* __restrict__ tok,
                                  float* __restrict__ lse) {
  const int b = blockIdx.x, lane = threadIdx.x;
  float m = -INFINITY, l = 0.f;
  int a = INT_MAX;
  for (int t = lane; t < n_tiles; t += 32) {
    const size_t o = (size_t)b * n_tiles + t;
    merge_partial(m, l, a, part_m[o], part_l[o], part_a[o]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const int a2 = __shfl_xor_sync(0xffffffffu, a, o);
    merge_partial(m, l, a, m2, l2, a2);
  }
  if (lane == 0) {
    const float ls = m + logf(l);
    lse[b] = ls;
    conf[b] = expf(m - ls);
    tok[b] = a;
  }
}

// Both passes on one stream.  part_* hold B * exit_tiles(V) partials.
template <typename T, bool QUANT>
cudaError_t exit_launch(const void* h, const void* w, const void* ns,
                        float eps, int B, int V, int D, float* part_m,
                        float* part_l, int* part_a, float* conf, int* tok,
                        float* lse, int8_t* q, float* qscale,
                        cudaStream_t st) {
  if (B <= 0 || V <= 0 || D <= 0 || D % (16 / (int)sizeof(T)))
    return cudaErrorInvalidValue;
  int rows = (int)(kMaxSharedBytes / ((size_t)(D + kExitTileV) * sizeof(float)));
  rows = min(min(rows, kExitMaxRows), B);
  if (rows < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)rows * (D + kExitTileV) * sizeof(float);
  auto kern = exit_tile_kernel<T, QUANT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_tiles = exit_tiles(V);
  const dim3 grid(n_tiles, (B + rows - 1) / rows);
  kern<<<grid, kExitThreads, smem, st>>>((const T*)h, (const T*)w,
                                         (const T*)ns, eps, B, V, D, rows,
                                         part_m, part_l, part_a, q, qscale);
  exit_merge_kernel<<<B, 32, 0, st>>>(part_m, part_l, part_a, n_tiles, conf,
                                      tok, lse);
  return cudaSuccess;
}

}  // namespace rt

extern "C" int exit_tiles(int V) { return rt::exit_tiles(V); }
