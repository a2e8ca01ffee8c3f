// The body shared by the two GQA flash-decode kernels (decode_attn.cu over
// a dense ring, decode_attn_paged.cu over a block-paged pool).
//
// One block attends one query token's G heads of one kv head over a range
// of keys (one split), with an online softmax in float32.  The keys come
// in tiles that an address mode (a "source") describes: a ring row cut in
// tiles, or table entry -> page.  Each of the block's warps walks every
// kWarps-th tile through its own ring of kStages shared-memory stages fed
// by cp.async, so the K/V, markers and int8 scales of the next tiles are
// in flight while the current one computes; a paged source reads the next
// table entry one tile ahead in a register.
//
// Lane layout: kLanes = D / kEpl lanes share one key (a power of two that
// divides D), each holding kEpl of its elements: the fewest that are at
// least the register budget (32, or 16 / 8 where G query heads need the
// registers) and a whole number of 4-byte words (D = 160: 40, 20 or 10
// elements over 4, 8 or 16 lanes), in pieces of the widest of 16, 8 or 4
// bytes that divides a lane's share; piece c of lane l holds columns
// (c * kLanes + l) * kPE .. + kPE, so that every copy instruction reads
// kLanes * kPB contiguous bytes of each key.  A warp
// covers 32 / kLanes keys a step and U steps a tile (~4 KB of K and V).
// Each lane copies and later reads its own pieces; the first lane of each
// key copies the key's marker (and scales), read by the group after a
// __syncwarp.  Wide lanes keep the instructions per key low: a key's dot
// product reduces with log2(kLanes) shuffles, and each lane group keeps
// (m, l, acc) per head with an online softmax that rescales acc only when
// the running max grows.  int8 codes become floats by a byte permute and
// one subtraction.  At the end the groups merge with shuffles and the
// warps through shared memory, in a fixed order.
//
// Splits: the blocks of one (row, kv head) are one thread block cluster.
// Each keeps its partial (m, l, acc) in float32 in its shared memory, and
// after a cluster barrier every block reads all partials through
// distributed shared memory, in rank order, for its share of the outputs.
// No second launch, no scratch in device memory, no atomics: the result
// is the same from run to run.
#pragma once

#include <cooperative_groups.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

namespace da {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;      // warps of a block
constexpr int kStages = 3;     // shared-memory stages of a warp's copy ring
constexpr int kMaxSplits = 8;  // blocks of a cluster (the portable limit)

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

template <int BYTES> struct Raw;
template <> struct Raw<4> { using type = unsigned; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// N consecutive elements of P at p (aligned to their size, or to 16 bytes
// when that is smaller), as floats; int8 through a byte permute:
// 0x4B0000xx is the float 2^23 + xx, exact for every byte xx.
template <typename P, int N>
__device__ __forceinline__ void to_f32(const P* p, float* out) {
  constexpr int kBytes = N * (int)sizeof(P) < 16 ? N * (int)sizeof(P) : 16;
  constexpr int kPer = kBytes / (int)sizeof(P);
  using R = typename Raw<kBytes>::type;
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    const R raw = reinterpret_cast<const R*>(p)[c];
    if constexpr (std::is_same<P, int8_t>::value) {
      const unsigned* w = reinterpret_cast<const unsigned*>(&raw);
#pragma unroll
      for (int i = 0; i < kBytes / 4; ++i) {
        const unsigned biased = w[i] ^ 0x80808080u;  // x + 128 per byte
#pragma unroll
        for (int j = 0; j < 4; ++j)
          out[c * kPer + 4 * i + j] =
              __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | j)) -
              8388736.f;  // 2^23 + 128
      }
    } else {
      const P* e = reinterpret_cast<const P*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[c * kPer + i] = f32(e[i]);
    }
  }
}

// ---- cp.async: global -> shared without a register round trip ----------
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else if constexpr (N == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One tile of keys as a source hands it out.  Key j of the tile lies at
// k + j * kstride (kstride = KV * D elements), its marker at pos + j, its
// int8 scales at ks + j * KV and vs + j * KV.  Keys j >= n are not read.
template <typename P>
struct Tile {
  const P* k;
  const P* v;
  const int* pos;
  const float* ks;
  const float* vs;
  int n;
};

// Lanes that share one key: the most (a power of two up to 32 dividing
// D) whose share of the key is at least the register budget of a lane
// (or all of D) and a whole number of 4-byte words of P.
template <typename P, int D, int G>
__host__ __device__ constexpr int lanes_for() {
  const int budget = G <= 2 ? 32 : G <= 4 ? 16 : 8;  // elements a lane
  const int least = budget < D ? budget : D;
  int lanes = 1;
  for (int l = 2; l <= 32 && D % l == 0 && D / l >= least; l *= 2)
    if (D / l * (int)sizeof(P) % 4 == 0) lanes = l;
  return lanes;
}

// The widest of 16, 8 or 4 bytes that divides a lane's share of a key.
__host__ __device__ constexpr int piece_bytes(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : 4;
}

// Compile-time shape of the body for one (q type, page type, D, G).
template <typename T, typename P, int D, int G>
struct Layout {
  static constexpr bool kQuant = std::is_same<P, int8_t>::value;
  static constexpr int kLanes = lanes_for<P, D, G>();  // lanes sharing a key
  static constexpr int kEpl = D / kLanes;             // elements a lane holds
  static constexpr int kKeys = 32 / kLanes;           // keys of a warp step
  static constexpr int kPB = piece_bytes(kEpl * (int)sizeof(P));  // a piece
  static constexpr int kPE = kPB / (int)sizeof(P);    // elements of a piece
  static constexpr int kPieces = kEpl / kPE;          // pieces a lane holds
  static constexpr int kKV = 32 * kEpl * (int)sizeof(P);  // K bytes a step
  static constexpr int U = 2 * kKV < 4096 ? 4096 / (2 * kKV) : 1;  // steps
  static constexpr int kTile = kKeys * U;             // keys of a tile
  // a step in shared memory: K pieces, V pieces, markers (+ k, v scales)
  static constexpr int kStep =
      (2 * kKV + kKeys * 4 * (kQuant ? 3 : 1) + 15) / 16 * 16;
  static constexpr int kStage = U * kStep;
  static constexpr int kWarpBytes = kStages * kStage;
  // the warps' merge area, then the block's partial for the cluster merge
  static constexpr int kMerge = (kWarps + 1) * G * (D + 2) * 4;
  static constexpr int kSmem =
      kWarps * kWarpBytes > kMerge ? kWarps * kWarpBytes : kMerge;
  static_assert(32 % kLanes == 0 && kLanes * kEpl == D, "lanes of a key");
  static_assert(kPieces * kPE == kEpl && kEpl * (int)sizeof(P) % 4 == 0,
                "a lane's share is whole pieces");
  static_assert(kSmem <= 227 * 1024, "shared memory of a block");
};

// Attend the G query heads at qrow (G * D elements) over the tiles
// [0, n_tiles) of src and write the G * D outputs to orow.  A block that
// is one of a cluster's splits merges its partial with the others' first.
// A key is valid when its marker p has p >= 0, p <= cur and, with a
// window, cur - p < window.
template <typename T, typename P, int D, int G, typename Src>
__device__ __forceinline__ void attend(const Src& src, int n_tiles,
                                       const T* __restrict__ qrow, int cur,
                                       int window, float scale, int KV,
                                       T* __restrict__ orow) {
  using L = Layout<T, P, D, G>;
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / L::kLanes;          // which key of a step
  const int gl = lane % L::kLanes;           // lane within the key's group
  const bool lead = gl == 0;                 // copies its key's marker
  const size_t kstride = (size_t)KV * D;
  char* wsm = smem + warp * L::kWarpBytes;
  // piece c of this lane starts at column (c * kLanes + gl) * kPE
  auto column = [&](int c) { return (c * L::kLanes + gl) * L::kPE; };

  float qr[G][L::kEpl];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < L::kPieces; ++c)
      to_f32<T, L::kPE>(qrow + g * D + column(c), qr[g] + c * L::kPE);
  float m[G], l[G], acc[G][L::kEpl];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < L::kEpl; ++i) acc[g][i] = 0.f;
  }

  auto fetch = [&](const Tile<P>& t, char* stage) {
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      const int j = u * L::kKeys + sub;
      char* st = stage + u * L::kStep;
      int* mk = reinterpret_cast<int*>(st + 2 * L::kKV);
      if (j < t.n) {
        const P* kj = t.k + j * kstride;
        const P* vj = t.v + j * kstride;
#pragma unroll
        for (int c = 0; c < L::kPieces; ++c) {
          const int off = (c * 32 + lane) * L::kPB;
          cp_async<L::kPB>(st + off, kj + column(c));
          cp_async<L::kPB>(st + L::kKV + off, vj + column(c));
        }
        if (lead) {
          cp_async<4>(mk + sub, t.pos + j);
          if constexpr (L::kQuant) {
            cp_async<4>(mk + L::kKeys + sub, t.ks + (size_t)j * KV);
            cp_async<4>(mk + 2 * L::kKeys + sub, t.vs + (size_t)j * KV);
          }
        }
      } else if (lead) {
        mk[sub] = -1;  // not read: masked
      }
    }
  };

  auto compute = [&](const char* stage) {
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      const char* st = stage + u * L::kStep;
      const int* mk = reinterpret_cast<const int*>(st + 2 * L::kKV);
      const int p = mk[sub];
      const bool ok =
          p >= 0 && p <= cur && (window == 0 || cur - p < window);
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
#pragma unroll
      for (int pc = 0; pc < L::kPieces; ++pc) {
        float kf[L::kPE];
        to_f32<P, L::kPE>(
            reinterpret_cast<const P*>(st + (pc * 32 + lane) * L::kPB), kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < L::kPE; ++i)
            dot[g] += qr[g][pc * L::kPE + i] * kf[i];
      }
      // every lane takes part in the shuffles; an invalid key's pieces
      // (which may hold anything) are never used after them
#pragma unroll
      for (int o = L::kLanes / 2; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
      if (!ok) continue;
      float ksc = scale, vsc = 1.f;
      if constexpr (L::kQuant) {
        ksc *= reinterpret_cast<const float*>(mk)[L::kKeys + sub];
        vsc = reinterpret_cast<const float*>(mk)[2 * L::kKeys + sub];
      }
      float w[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float s = dot[g] * ksc;
        if (s > m[g]) {  // the running max grows: rescale (0 while m = -inf)
          const float corr = expf(m[g] - s);
          l[g] *= corr;
#pragma unroll
          for (int i = 0; i < L::kEpl; ++i) acc[g][i] *= corr;
          m[g] = s;
        }
        const float e = expf(s - m[g]);
        l[g] += e;
        w[g] = e * vsc;
      }
#pragma unroll
      for (int pc = 0; pc < L::kPieces; ++pc) {
        float vf[L::kPE];
        to_f32<P, L::kPE>(reinterpret_cast<const P*>(
                              st + L::kKV + (pc * 32 + lane) * L::kPB),
                          vf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < L::kPE; ++i)
            acc[g][pc * L::kPE + i] += w[g] * vf[i];
      }
    }
  };

  // the warp's tiles are warp, warp + kWarps, ...; tk holds the first
  // kStages tiles' lookahead (a paged source's table entries), read at once
  const int nw = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  int tk[kStages];
#pragma unroll
  for (int s = 0; s < kStages; ++s)
    tk[s] = s < nw ? src.ahead(warp + s * kWarps) : 0;
  unsigned live = 0;  // bit s: stage s holds a tile with keys to read
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nw) {
      const Tile<P> t = src.tile(warp + s * kWarps, tk[s]);
      fetch(t, wsm + s * L::kStage);
      if (t.n > 0) live |= 1u << s;
    }
    cp_commit();
  }
  int next = tk[kStages - 1];
  for (int i = 0; i < nw; ++i) {
    const int j = i + kStages - 1;  // the tile whose copies go out now
    const int sj = j % kStages;
    __syncwarp();  // every lane is done reading stage sj (tile i - 1)
    live &= ~(1u << sj);
    if (j < nw) {
      const Tile<P> t = src.tile(warp + j * kWarps, next);
      fetch(t, wsm + sj * L::kStage);
      if (t.n > 0) live |= 1u << sj;
    }
    cp_commit();
    if (j + 1 < nw) next = src.ahead(warp + (j + 1) * kWarps);
    cp_wait<kStages - 1>();  // tile i has landed
    __syncwarp();            // and the lead lanes' markers are visible
    const int si = i % kStages;
    if (live >> si & 1u) compute(wsm + si * L::kStage);
  }
  cp_wait<0>();

  // merge the warp's lane groups (lanes kLanes apart hold the same columns)
#pragma unroll
  for (int o = L::kLanes; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float ea = m[g] == -INFINITY ? 0.f : expf(m[g] - mn);
      const float eb = mo == -INFINITY ? 0.f : expf(mo - mn);
      l[g] = l[g] * ea + lo * eb;
#pragma unroll
      for (int i = 0; i < L::kEpl; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        acc[g][i] = acc[g][i] * ea + ao * eb;
      }
      m[g] = mn;
    }
  }

  // merge the warps through shared memory (the copy rings are done)
  __syncthreads();
  float* sm_acc = reinterpret_cast<float*>(smem);  // [kWarps][G][D]
  float* sm_m = sm_acc + kWarps * G * D;            // [kWarps][G]
  float* sm_l = sm_m + kWarps * G;                  // [kWarps][G]
  if (lane < L::kLanes) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < L::kEpl; ++i)
        sm_acc[(warp * G + g) * D + column(i / L::kPE) + i % L::kPE] =
            acc[g][i];
      if (lane == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();
  // the block's (m, l, acc): its output, or its split's partial, kept in
  // shared memory behind the merge area for the cluster's merge
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  float* cl_acc = sm_l + kWarps * G;  // [G][D]
  float* cl_m = cl_acc + G * D;       // [G]
  float* cl_l = cl_m + G;             // [G]
  for (int t = threadIdx.x; t < G * D; t += kWarps * 32) {
    const int g = t / D, e = t % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float den = 0.f, num = 0.f;  // stay 0 where no key was valid
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = sm_m[w * G + g];
        const float ew = mw == -INFINITY ? 0.f : expf(mw - mx);
        den += sm_l[w * G + g] * ew;
        num += sm_acc[(w * G + g) * D + e] * ew;
      }
    }
    if (splits == 1) {
      store(orow + t, mx == -INFINITY ? 0.f : num / fmaxf(den, 1e-30f));
    } else {
      cl_acc[t] = num;
      if (e == 0) {
        cl_m[g] = mx;
        cl_l[g] = den;
      }
    }
  }
  if (splits == 1) return;
  // merge the splits: every block of the cluster reads the partials of all
  // of them from distributed shared memory, in rank order, for its share
  // of the G * D outputs; the second barrier keeps each block's shared
  // memory alive until the others have read it
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  for (int t = rank * kWarps * 32 + threadIdx.x; t < G * D;
       t += splits * kWarps * 32) {
    const int g = t / D;
    float mx = -INFINITY;
    for (int r = 0; r < splits; ++r)
      mx = fmaxf(mx, *cluster.map_shared_rank(cl_m + g, r));
    float o = 0.f;  // a row with no valid key gives 0
    if (mx != -INFINITY) {
      float den = 0.f, num = 0.f;
      for (int r = 0; r < splits; ++r) {
        const float mr = *cluster.map_shared_rank(cl_m + g, r);
        const float er = mr == -INFINITY ? 0.f : expf(mr - mx);
        den += *cluster.map_shared_rank(cl_l + g, r) * er;
        num += *cluster.map_shared_rank(cl_acc + t, r) * er;
      }
      o = num / fmaxf(den, 1e-30f);
    }
    store(orow + t, o);
  }
  cluster.sync();
}

// Launch a split kernel on grid (splits, KV, B) with dynamic shared memory
// smem bytes, the splits of each (row, kv head) as one thread block
// cluster (at most kMaxSplits blocks).
template <typename Kernel, typename... Args>
cudaError_t launch_split(Kernel kernel, int smem, int splits, int KV, int B,
                         cudaStream_t st, Args... args) {
  if (splits < 1 || splits > kMaxSplits) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KV, B);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace da
