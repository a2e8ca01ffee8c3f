// Per-row int8 absmax quantizer: the edge->cloud wire packet, and the int8
// K/V page writes of the paged cache (a decode step's new K/V rows, and a
// prefilled row scattered into its pages).
//
// Replaces the Pallas TPU kernel repro/kernels/quantize/kernel.py:31
// (quantize_int8_pallas, body _quantize_kernel):
//   scale = max(max|x| / 127, 1e-12);  q = clip(round(x / scale), -127, 127)
// per row, rounding half to even (rintf) and dividing by the scale, exactly
// as the reference does (rt::int8_scale, rt::int8_code).  The JAX package's
// int8 page writes (repro/models/attention.py, decode_attention_paged and
// paged_scatter_prefill) quantize their rows the same way and then scatter
// them with .at[dest, slot].set; here the scatter happens in the kernel.
//
// What bounds each entry on the H100: launch latency first, then bytes.
// The wire row (1, 4096) bf16 moves 12 KB (0.004 us at 3.35 TB/s); a decode
// step's page write at 8 rows x 32 kv heads x 128 moves ~0.2 MB (0.06 us);
// a 512-token prefill scatter ~12.7 MB (~3.8 us), the only one whose bytes
// matter at all.  So the design makes each entry ONE launch with nothing
// around it: page lookup, the trash-page redirect of unmapped or masked
// rows, the position markers and the padding fills of a short ring are all
// computed in the kernel, where the PyTorch sequence it replaces took about
// twenty small launches.  Each element is read once, into registers, with
// the widest aligned vector load; the absmax reduces by shuffles; the codes
// come from the registers and leave as packed stores.
//  - quantize_launch (wire packet, any (N, d) up to 32768 elements a row):
//    one warp a row for d <= 256 (8 rows a block), else one block a row
//    (256 threads up to 8192 elements, 1024 up to 32768) with one
//    shared-memory step after the shuffles.  Loads are 16 bytes where d
//    allows, narrower (down to one element) where d is not a multiple of
//    16 bytes, so every row starts aligned.
//  - quantize_kv_write_launch / quantize_kv_scatter_launch: one warp per
//    (token, kv head, K or V), d / 32 elements a lane (4 at d = 128: one
//    8-byte load of bf16, one 4-byte store of codes), 5 shuffles.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpRowMax = 256;     // wire rows up to this: one warp each
constexpr int kPerThread = 32;       // wire elements a thread, at most

// A wire row of D elements in vectors of VEC, owned by W warps (W = 1: a
// warp, 8 rows to a block; else the block).
template <typename T, int VEC, int W>
__global__ void __launch_bounds__(W == 1 ? kThreads : 32 * W)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, int N, int D) {
  constexpr int kPer = (W == 1 ? kWarpRowMax / 32 : kPerThread) / VEC;
  constexpr int kRowThreads = 32 * W;
  const int row = W == 1 ? blockIdx.x * (kThreads / 32) + threadIdx.x / 32
                         : blockIdx.x;
  const int t = W == 1 ? threadIdx.x % 32 : threadIdx.x;
  if (W == 1 && row >= N) return;    // whole warps; no block barrier here
  const int n_vec = D / VEC;
  const T* xr = x + (size_t)row * D;
  float v[kPer * VEC];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = t + i * kRowThreads;
    if (j < n_vec) {
      rt::load_vec<T, VEC>(xr + (size_t)j * VEC, v + i * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(v[i * VEC + e]));
    }
  }
  amax = rt::warp_max(amax);
  if constexpr (W > 1) {
    __shared__ float part[W];
    if (t % 32 == 0) part[t / 32] = amax;
    __syncthreads();
    amax = part[0];
#pragma unroll
    for (int w = 1; w < W; ++w) amax = fmaxf(amax, part[w]);
  }
  const float s = rt::int8_scale(amax);
  int8_t* qr = q + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = t + i * kRowThreads;
    if (j < n_vec) rt::store_codes<VEC>(qr + (size_t)j * VEC, v + i * VEC, s);
  }
  if (t == 0) scale[row] = s;
}

template <typename T, int VEC>
cudaError_t launch_rows(const T* x, int8_t* q, float* scale, int N, int D,
                        cudaStream_t st) {
  if (D <= kWarpRowMax)
    quantize_kernel<T, VEC, 1><<<(N + kThreads / 32 - 1) / (kThreads / 32),
                                 kThreads, 0, st>>>(x, q, scale, N, D);
  else if (D <= kThreads * kPerThread)
    quantize_kernel<T, VEC, kThreads / 32><<<N, kThreads, 0, st>>>(
        x, q, scale, N, D);
  else if (D <= 1024 * kPerThread)
    quantize_kernel<T, VEC, 32><<<N, 1024, 0, st>>>(x, q, scale, N, D);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// The widest vector (at most 16 bytes) that divides D, so each row of the
// (N, D) tensor starts on a vector boundary.
template <typename T>
cudaError_t launch_wire(const void* x, void* q, void* scale, int N, int D,
                        cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(scale);
  if constexpr (sizeof(T) == 2) {
    if (D % 8 == 0) return launch_rows<T, 8>(xt, qt, s, N, D, st);
  }
  if (D % 4 == 0) return launch_rows<T, 4>(xt, qt, s, N, D, st);
  if (D % 2 == 0) return launch_rows<T, 2>(xt, qt, s, N, D, st);
  return launch_rows<T, 1>(xt, qt, s, N, D, st);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int d = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? d - 1 : d;
}

// One K or V row (d = 32 * EPL elements of one token and kv head) coded by
// one warp into its page slot: codes and scale.  An invalid row (past the
// end of a prefill ring) stores code 0 and scale 0.0.
template <typename T, int EPL>
__device__ __forceinline__ void code_row(const T* __restrict__ src,
                                         int8_t* __restrict__ dst,
                                         float* __restrict__ scale_dst,
                                         bool valid, int lane) {
  float v[EPL];
  if (valid) {
    rt::load_vec<T, EPL>(src + lane * EPL, v);
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e) v[e] = 0.f;
  }
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) amax = fmaxf(amax, fabsf(v[e]));
  const float s = rt::int8_scale(rt::warp_max(amax));
  rt::store_codes<EPL>(dst + lane * EPL, v, s);
  if (lane == 0) *scale_dst = valid ? s : 0.f;
}

// A decode step's write: warp w < B*KV codes K of (row w / KV, head w % KV),
// the next B*KV warps V.  Row b goes to page tbl[b, min(pos // ps, n_lp-1)]
// at slot pos % ps (floor division and modulo, as torch and jnp take them;
// a negative logical page counts from the end of the row, as torch
// indexes), or to page 0 with marker -1 where that entry is unmapped or
// mask[b] is false.
template <typename T, int EPL>
__global__ void __launch_bounds__(kThreads)
kv_write_kernel(const T* __restrict__ knew, const T* __restrict__ vnew,
                const int* __restrict__ pos, const int* __restrict__ tbl,
                const bool* __restrict__ mask, int8_t* __restrict__ kp,
                int8_t* __restrict__ vp, float* __restrict__ ks,
                float* __restrict__ vs, int* __restrict__ ppos, int B, int KV,
                int n_lp, int ps) {
  const int warp = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 2 * B * KV) return;
  const bool is_v = warp >= B * KV;
  const int bh = is_v ? warp - B * KV : warp;
  const int b = bh / KV, h = bh % KV;
  const int p = pos[b];
  const int q = floor_div(p, ps);
  int lp = min(q, n_lp - 1);
  if (lp < 0) lp = max(lp + n_lp, 0);
  const int page = tbl[(size_t)b * n_lp + lp];
  const bool ok = page >= 0 && (mask == nullptr || mask[b]);
  // (page, slot) as one index into ppos
  const size_t cell = (size_t)(ok ? page : 0) * ps + (p - q * ps);
  constexpr int D = 32 * EPL;
  code_row<T, EPL>((is_v ? vnew : knew) + (size_t)bh * D,
                   (is_v ? vp : kp) + (cell * KV + h) * D,
                   (is_v ? vs : ks) + cell * KV + h, true, lane);
  if (!is_v && h == 0 && lane == 0) ppos[cell] = ok ? p : -1;
}

// A prefilled row scattered into its pages: warp w < n_tok*KV codes K of
// (token w / KV, head w % KV), the next n_tok*KV warps V.  Token t goes to
// page pages[t / ps] (page 0 where that entry is < 0) at slot t % ps;
// tokens at or past the ring's length L take code 0, scale 0.0, marker -1.
template <typename T, int EPL>
__global__ void __launch_bounds__(kThreads)
kv_scatter_kernel(const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ row_pos,
                  const int* __restrict__ pages, int8_t* __restrict__ kp,
                  int8_t* __restrict__ vp, float* __restrict__ ks,
                  float* __restrict__ vs, int* __restrict__ ppos, int L,
                  int n_tok, int KV, int ps) {
  const int warp = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 2 * n_tok * KV) return;
  const bool is_v = warp >= n_tok * KV;
  const int th = is_v ? warp - n_tok * KV : warp;
  const int t = th / KV, h = th % KV;
  const int page = pages[t / ps];
  const size_t cell = (size_t)(page >= 0 ? page : 0) * ps + t % ps;
  const bool valid = t < L;
  constexpr int D = 32 * EPL;
  code_row<T, EPL>((is_v ? v : k) + (size_t)th * D,
                   (is_v ? vp : kp) + (cell * KV + h) * D,
                   (is_v ? vs : ks) + cell * KV + h, valid, lane);
  if (!is_v && h == 0 && lane == 0) ppos[cell] = valid ? row_pos[t] : -1;
}

int blocks_for_warps(long long warps) {
  return (int)((warps + kThreads / 32 - 1) / (kThreads / 32));
}

template <typename T, int EPL>
void launch_write(const void* knew, const void* vnew, const void* pos,
                  const void* tbl, const void* mask, void* kp, void* vp,
                  void* ks, void* vs, void* ppos, int B, int KV, int n_lp,
                  int ps, cudaStream_t st) {
  kv_write_kernel<T, EPL><<<blocks_for_warps(2LL * B * KV), kThreads, 0,
                            st>>>(
      (const T*)knew, (const T*)vnew, (const int*)pos, (const int*)tbl,
      (const bool*)mask, (int8_t*)kp, (int8_t*)vp, (float*)ks, (float*)vs,
      (int*)ppos, B, KV, n_lp, ps);
}

template <typename T, int EPL>
void launch_scatter(const void* k, const void* v, const void* row_pos,
                    const void* pages, void* kp, void* vp, void* ks, void* vs,
                    void* ppos, int L, int n_tok, int KV, int ps,
                    cudaStream_t st) {
  kv_scatter_kernel<T, EPL><<<blocks_for_warps(2LL * n_tok * KV), kThreads,
                              0, st>>>(
      (const T*)k, (const T*)v, (const int*)row_pos, (const int*)pages,
      (int8_t*)kp, (int8_t*)vp, (float*)ks, (float*)vs, (int*)ppos, L, n_tok,
      KV, ps);
}

using WriteFn = void (*)(const void*, const void*, const void*, const void*,
                        const void*, void*, void*, void*, void*, void*, int,
                        int, int, int, cudaStream_t);
using ScatterFn = void (*)(const void*, const void*, const void*,
                           const void*, void*, void*, void*, void*, void*, int,
                           int, int, int, cudaStream_t);

// [dtype code][D = 32, 64, 128, 256]
constexpr WriteFn kWrite[2][4] = {
    {launch_write<float, 1>, launch_write<float, 2>, launch_write<float, 4>,
     launch_write<float, 8>},
    {launch_write<__nv_bfloat16, 1>, launch_write<__nv_bfloat16, 2>,
     launch_write<__nv_bfloat16, 4>, launch_write<__nv_bfloat16, 8>}};
constexpr ScatterFn kScatter[2][4] = {
    {launch_scatter<float, 1>, launch_scatter<float, 2>,
     launch_scatter<float, 4>, launch_scatter<float, 8>},
    {launch_scatter<__nv_bfloat16, 1>, launch_scatter<__nv_bfloat16, 2>,
     launch_scatter<__nv_bfloat16, 4>, launch_scatter<__nv_bfloat16, 8>}};

// The column of D in kWrite / kScatter, or -1.
int head_dim_index(int D) {
  switch (D) {
    case 32: return 0;
    case 64: return 1;
    case 128: return 2;
    case 256: return 3;
    default: return -1;
  }
}

}  // namespace

// x (N, D) f32 or bf16 -> q (N, D) int8, scale (N, 1) f32.
extern "C" int quantize_launch(int device, int dtype, const void* x, void* q,
                               void* scale, int N, int D, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32) return launch_wire<float>(x, q, scale, N, D, st);
  if (dtype == rt::kBF16)
    return launch_wire<__nv_bfloat16>(x, q, scale, N, D, st);
  return cudaErrorInvalidValue;
}

// One decode step's int8 page write, in place: knew/vnew (B, KV, D) f32 or
// bf16; pos (B,) int32; tbl (B, n_lp) int32; mask (B,) bool or null; pool
// kp/vp (P, ps, KV, D) int8, ks/vs (P, ps, KV) f32, ppos (P, ps) int32.
extern "C" int quantize_kv_write_launch(int device, int dtype,
                                        const void* knew, const void* vnew,
                                        const void* pos, const void* tbl,
                                        const void* mask, void* kp, void* vp,
                                        void* ks, void* vs, void* ppos, int B,
                                        int KV, int D, int n_lp, int ps,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int d = head_dim_index(D);
  if (B <= 0 || KV <= 0 || n_lp <= 0 || ps <= 0 || d < 0 ||
      (dtype != rt::kF32 && dtype != rt::kBF16))
    return cudaErrorInvalidValue;
  kWrite[dtype][d](knew, vnew, pos, tbl, mask, kp, vp, ks, vs, ppos, B, KV,
                   n_lp, ps, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// A prefilled row's int8 scatter into n_tok / ps pages, in place: k/v
// (L, KV, D) f32 or bf16, row_pos (L,) int32, pages (n_tok / ps,) int32;
// the pool as above.
extern "C" int quantize_kv_scatter_launch(int device, int dtype,
                                          const void* k, const void* v,
                                          const void* row_pos,
                                          const void* pages, void* kp,
                                          void* vp, void* ks, void* vs,
                                          void* ppos, int L, int n_tok,
                                          int KV, int D, int ps,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int d = head_dim_index(D);
  if (L < 0 || n_tok <= 0 || KV <= 0 || ps <= 0 || n_tok % ps || d < 0 ||
      (dtype != rt::kF32 && dtype != rt::kBF16))
    return cudaErrorInvalidValue;
  kScatter[dtype][d](k, v, row_pos, pages, kp, vp, ks, vs, ppos, L, n_tok, KV,
                     ps, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}
