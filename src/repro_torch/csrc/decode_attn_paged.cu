// GQA flash-decode attention over a block-paged KV pool, float or int8 pages.
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
// scales); the arithmetic is ~4 flops per element read.  Design: one block
// per (kv head, row), four warps.  The warps split the row's logical pages
// among them.  Within a warp, D / 8 lanes share one key (8 elements a
// lane: one 16-byte load for 16-bit types, two for float32, one 8-byte
// load for int8), so a warp loads 32 / (D / 8) keys per step and issues
// the loads of U steps (a whole 16-key page for bf16 at D = 128) before it
// uses any of them.  Dot products are reduced with shuffles inside each
// key's lane group; each group keeps its own (m, l, acc) per query head
// and rescales once per U steps.  The groups merge with shuffles, the
// warps through shared memory.  TMA and wgmma are later work.
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kEpl = 8;  // elements of one key (or value) row a lane holds

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float f32(int8_t x) { return (float)x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// kEpl consecutive elements of P, loaded in 16-byte words (int8: 8 bytes)
template <typename P>
struct Chunk {
  uint4 w[sizeof(P) * kEpl / 16];
};
template <>
struct Chunk<int8_t> {
  uint2 w[1];
};

template <typename P>
__device__ __forceinline__ void unpack(const Chunk<P>& c, float* out) {
  const P* e = reinterpret_cast<const P*>(&c);
#pragma unroll
  for (int i = 0; i < kEpl; ++i) out[i] = f32(e[i]);
}

template <typename T, typename P, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_paged_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                         const P* __restrict__ vp,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ pos,
                         const int* __restrict__ tbl,
                         const int* __restrict__ cur, T* __restrict__ out,
                         int KV, int ps, int n_lp, int window, float scale) {
  constexpr int kLanes = D / kEpl;     // lanes that share one key
  constexpr int kKeys = 32 / kLanes;   // keys a warp loads per step
  // steps whose loads go out together: a 16-key page for 16-bit and int8
  // pages at D = 128, fewer where registers run short
  constexpr int U = (sizeof(P) == 4 ? 4 : 8) / (G == 8 ? 2 : 1);
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / kLanes;            // which key of a step
  const int col = (lane % kLanes) * kEpl;   // first element this lane holds
  const int H = KV * G;
  const int c = cur[b];

  float qr[G][kEpl];
#pragma unroll
  for (int g = 0; g < G; ++g)
    unpack(*reinterpret_cast<const Chunk<T>*>(
               q + ((size_t)b * H + kvh * G + g) * D + col),
           qr[g]);

  float m[G], l[G], acc[G][kEpl];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kEpl; ++i) acc[g][i] = 0.f;
  }

  const size_t kstride = (size_t)KV * D;  // elements between two keys
  const int* trow = tbl + (size_t)b * n_lp;
  for (int lp = warp; lp < n_lp; lp += kWarps) {
    const int page = trow[lp];
    if (page < 0) continue;  // unmapped: nothing to read (warp-uniform)
    const size_t key0 = (size_t)page * ps;  // flat index of its first key
    for (int s0 = 0; s0 < ps; s0 += kKeys * U) {
      Chunk<P> kc[U], vc[U];
      float ksc[U], vsc[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = s0 + u * kKeys + sub;
        const int p = s < ps ? pos[key0 + s] : -1;
        ok[u] = p >= 0 && p <= c && (window == 0 || c - p < window);
        kc[u] = Chunk<P>{};
        vc[u] = Chunk<P>{};
        ksc[u] = vsc[u] = 0.f;
        if (ok[u]) {
          const size_t off = (key0 + s) * kstride + (size_t)kvh * D + col;
          kc[u] = *reinterpret_cast<const Chunk<P>*>(kp + off);
          vc[u] = *reinterpret_cast<const Chunk<P>*>(vp + off);
          if (kQuant) {
            ksc[u] = ks[(key0 + s) * KV + kvh];
            vsc[u] = vs[(key0 + s) * KV + kvh];
          }
        }
      }
      // logits of this lane group's U keys, per query head; every lane
      // takes part in the shuffles, invalid keys are masked afterwards
      float lg[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[kEpl];
        unpack(kc[u], kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < kEpl; ++i) dot += qr[g][i] * kf[i];
#pragma unroll
          for (int o = kLanes / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (kQuant) dot *= ksc[u];
          lg[u][g] = ok[u] ? dot * scale : -INFINITY;
        }
      }
      // one rescale per U keys; lg becomes the softmax numerators
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) mx = fmaxf(mx, lg[u][g]);
        if (mx == -INFINITY) continue;  // no valid key yet
        const float corr = expf(m[g] - mx);  // 0 while m is -inf
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          lg[u][g] = expf(lg[u][g] - mx);  // 0 for an invalid key
          sum += lg[u][g];
        }
        l[g] = l[g] * corr + sum;
#pragma unroll
        for (int i = 0; i < kEpl; ++i) acc[g][i] *= corr;
        m[g] = mx;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        float vf[kEpl];
        unpack(vc[u], vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float w = kQuant ? lg[u][g] * vsc[u] : lg[u][g];
#pragma unroll
          for (int i = 0; i < kEpl; ++i) acc[g][i] += w * vf[i];
        }
      }
    }
  }

  // merge the warp's lane groups (lanes kLanes apart hold the same columns)
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float ea = m[g] == -INFINITY ? 0.f : expf(m[g] - mn);
      const float eb = mo == -INFINITY ? 0.f : expf(mo - mn);
      l[g] = l[g] * ea + lo * eb;
#pragma unroll
      for (int i = 0; i < kEpl; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        acc[g][i] = acc[g][i] * ea + ao * eb;
      }
      m[g] = mn;
    }
  }

  // merge the warps through shared memory
  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
  if (lane < kLanes) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < kEpl; ++i) sm_acc[warp][g][col + i] = acc[g][i];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < G * D; t += kWarps * 32) {
    const int g = t / D, e = t % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float o = 0.f;  // a row with no valid key gives 0
    if (mx != -INFINITY) {
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float ew =
            sm_m[w][g] == -INFINITY ? 0.f : expf(sm_m[w][g] - mx);
        den += sm_l[w][g] * ew;
        num += sm_acc[w][g][e] * ew;
      }
      o = num / fmaxf(den, 1e-30f);
    }
    store(out + ((size_t)b * H + kvh * G + g) * D + e, o);
  }
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *pos, *tbl, *cur;
  void* out;
  int B, KV, ps, n_lp, window;
  float scale;
};

template <typename T, typename P, int D, int G>
void launch(const Args& a, cudaStream_t st) {
  decode_attn_paged_kernel<T, P, D, G><<<dim3(a.KV, a.B), kWarps * 32, 0,
                                         st>>>(
      (const T*)a.q, (const P*)a.kp, (const P*)a.vp, a.ks, a.vs, a.pos,
      a.tbl, a.cur, (T*)a.out, a.KV, a.ps, a.n_lp, a.window, a.scale);
}

template <typename T, typename P, int D>
cudaError_t launch_g(int G, const Args& a, cudaStream_t st) {
  switch (G) {
    case 1: launch<T, P, D, 1>(a, st); return cudaSuccess;
    case 2: launch<T, P, D, 2>(a, st); return cudaSuccess;
    case 4: launch<T, P, D, 4>(a, st); return cudaSuccess;
    case 8: launch<T, P, D, 8>(a, st); return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename P>
cudaError_t launch_d(int D, int G, const Args& a, cudaStream_t st) {
  switch (D) {
    case 64: return launch_g<T, P, 64>(G, a, st);
    case 128: return launch_g<T, P, 128>(G, a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_t(int quantized, int D, int G, const Args& a,
                     cudaStream_t st) {
  return quantized ? launch_d<T, int8_t>(D, G, a, st)
                   : launch_d<T, T>(D, G, a, st);
}

}  // namespace

// q (B, H, D) in float32 (dtype 0), bfloat16 (1) or float16 (2); kp, vp
// (P, ps, KV, D) in q's dtype, or int8 with quantized = 1 and ks, vs
// (P, ps, KV) float32 scales; pos (P, ps) int32; tbl (B, n_lp) int32, -1 =
// unmapped; cur (B,) int32; out (B, H, D) in q's dtype.  D in {64, 128},
// H / KV in {1, 2, 4, 8}.
extern "C" int decode_attn_paged_launch(
    int device, int dtype, int quantized, const void* q, const void* kp,
    const void* vp, const void* ks, const void* vs, const void* pos,
    const void* tbl, const void* cur, void* out, int B, int H, int KV, int ps,
    int n_lp, int D, int window, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || KV <= 0 || ps <= 0 || n_lp <= 0 || H % KV)
    return cudaErrorInvalidValue;
  if (quantized && (ks == nullptr || vs == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, kp, vp, (const float*)ks, (const float*)vs,
               (const int*)pos, (const int*)tbl, (const int*)cur, out, B, KV,
               ps, n_lp, window, 1.0f / sqrtf((float)D)};
  const int G = H / KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    err = launch_t<float>(quantized, D, G, a, st);
  else if (dtype == rt::kBF16)
    err = launch_t<__nv_bfloat16>(quantized, D, G, a, st);
  else if (dtype == rt::kF16)
    err = launch_t<__half>(quantized, D, G, a, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
