// The early-exit confidence head, shared by exit_head.cu and exit_quant.cu
// (which adds the int8 wire packet of the raw hidden to the same launch).
//
// Computes, per row r of an (R, D) hidden whose R = E * B rows are B slots
// of each of E exits (row r reads exit r / B's norm scale):
//   hn = h * rsqrt(mean(h^2) + eps) * (1 + ns[r / B])       (float32)
//   logits = hn @ W^T over the (V, D) unembedding W
//   lse = logsumexp(logits), conf = exp(max - lse), tok = argmax(logits)
// without writing the (R, V) logits anywhere, and optionally the int8
// packet q = clip(rint(h / scale), -127, 127), scale = max(absmax / 127,
// 1e-12) of the B raw rows of one exit.
//
// What bounds it on the H100: bytes.  W is V * D * sizeof(T) (2.01 GB for
// gemma3-12b in bf16, 262 MB for ee-llm-7b); the product is 2 * R * V * D
// flops.  Every launch reads W from device memory once, for all R <= 16
// rows, so an edge tick's two exits (and 8 slots of them) cost one pass.
//
// Design, one launch:
//  * Grid: persistent, one block per SM (at most what the occupancy of the
//    chosen ring allows).  V is cut in boxes of 256 W rows; block b takes
//    the contiguous boxes [b * nbox / G, (b + 1) * nbox / G) and walks them
//    in groups of kBoxes boxes (one W row a consumer thread per box).
//  * Ring: a group is streamed in chunks of 128 bytes of every row (64
//    bf16 or 32 float32 columns), one TMA box load (cp.async.bulk.tensor,
//    128-byte swizzle, zero fill past V and D, W marked first to leave L2)
//    a box, into an S-stage ring of shared memory whose full / empty
//    mbarriers pace a loader warp against eight consumer warps.  Rows are
//    never whole in shared memory, so R = 16 rows at D = 4096 fit beside
//    the ring: only the chunk's normalized rows (R * 64 floats) sit in
//    each stage.
//  * Rows: the loader warp also requests, with each stage, the chunk of
//    every raw row and norm scale (one bulk copy a row, on a third
//    mbarrier), and an hn warp turns them into the stage's hn as soon as
//    they land, with the rows' rms factors that the consumers compute once
//    at the start.  It works up to S - 1 stages ahead of the consumers, so
//    the latency of those loads is hidden; a single producer warp that
//    waited on them stage by stage held R = 16 at 1.3x its bound.
//  * Products: consumer thread t owns W row t of each box of the group and
//    keeps R float32 dot products a box in registers across the chunks;
//    every hn value it needs is a shared-memory broadcast, every W value
//    a conflict-free 16-byte load thanks to the swizzle.  Sums stay float32
//    on the CUDA cores up to R = 8, where they are not the limit.  bf16
//    above 8 rows goes to the tensor cores (mma.sync m16n8k16, float32
//    accumulate; on the CUDA cores R = 16 took twice the bound, about 19
//    instructions a W element): hn enters as three bf16 parts (high, middle
//    and low), so all 24 of its bits count and each product is exact, W
//    fragments come from the swizzled rows by ldmatrix.  (Two parts, 16
//    bits, left logits near 20 up to 1e-4 off float32.)  float32 W stays
//    on the CUDA cores.
//  * Softmax: each thread carries (max, sum-exp, first argmax) per row over
//    all its W rows in increasing index order, as the TPU kernel carries
//    its scratch across V tiles; at the end the block merges its threads
//    (warp butterflies, then the warps in order) into one partial per row.
//  * Merge: each block writes its partials, fences, and takes a ticket from
//    a completion counter in the scratch; the block that draws the last
//    ticket merges all partials per row, in block order, writes conf / tok
//    / lse and resets the counter to 0 for the next launch, so there is no
//    second kernel and no memset.  The merge keeps the larger value and, on
//    equal values, the lower index, so ties go to the lowest index as
//    jnp.argmax does, in any order; the fixed order makes every result
//    deterministic: exit_quant's decision is exit_head's bit for bit, and
//    so is each exit's share of a launch over several where both take the
//    same path (CUDA cores or tensor cores).
//  * The packet: block b quantizes packet rows b, b + G, ... from the raw
//    rows while the loader's first loads are in flight.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <limits.h>

#include "common.cuh"

namespace rt {
// Internal linkage: exit_head.cu and exit_quant.cu are two libraries in one
// process, and shared template instances (with their static caches of the
// shared-memory attribute and occupancy) would bind across them.
namespace {

constexpr int kExitConsumerWarps = 8;
constexpr int kExitHnWarps = 2;
// + a loader warp (TMA) and the hn warps
constexpr int kExitThreads = (kExitConsumerWarps + 1 + kExitHnWarps) * 32;
constexpr int kExitHnThreads = (kExitConsumerWarps + kExitHnWarps) * 32;
constexpr int kExitBoxRows = kExitConsumerWarps * 32;        // 256
constexpr int kExitChunkBytes = 128;                         // per W row
constexpr int kExitBoxBytes = kExitBoxRows * kExitChunkBytes;
constexpr int kBoxes = 2;                  // boxes (W rows a thread) a stage
constexpr int kExitStageBytes = kBoxes * kExitBoxBytes;      // 64 KB
constexpr int kExitMaxRows = 16;
constexpr int kExitDefaultBlocksPerSm = 1;
constexpr size_t kMaxSharedBytes = 227 * 1024;
// scratch floats per block slot: m, s, a for kExitMaxRows rows
constexpr int kExitPartials = 3 * kExitMaxRows;

// ---- PTX wrappers -------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// W is read once: its loads go first out of L2, so the raw rows and norm
// scales that every block reads again stay there
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int x, int y, uint32_t bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar),
      "l"(policy)
      : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// barrier 1: the 256 consumer threads; barrier 2: them and the hn warps
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// 16 raw bytes -> float32 elements (8 bf16 or 4 float)
template <typename T>
__device__ __forceinline__ void unpack16(uint4 raw, float* out);
template <>
__device__ __forceinline__ void unpack16<float>(uint4 raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(uint4 raw,
                                                        float* out) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(u[i] << 16);
    out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// (m, l, a) <- merge with (m2, l2, a2): larger max wins the argmax, equal
// maxima keep the lower index.
__device__ __forceinline__ void merge_partial(float& m, float& l, int& a,
                                              float m2, float l2, int a2) {
  if (m2 > m || (m2 == m && a2 < a)) a = a2;
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both sides empty
  l = l * expf(m - mx) + l2 * expf(m2 - mx);
  m = mx;
}

__device__ __forceinline__ void warp_merge(float& m, float& l, int& a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const int a2 = __shfl_xor_sync(0xffffffffu, a, o);
    merge_partial(m, l, a, m2, l2, a2);
  }
}

// One stage's products: KB boxes of W rows (row t of each) against the
// chunk's RT normalized rows.  W chunk q of row t sits at 16-byte slot
// q ^ (t % 8) of the row's 128 bytes (the TMA's 128-byte swizzle).
template <typename T, int RT, int KB>
__device__ __forceinline__ void stage_products(const unsigned char* wst,
                                               const float* hn, int t,
                                               float (&acc)[kBoxes][RT]) {
  constexpr int EPC = 16 / (int)sizeof(T);      // elements a 16-byte chunk
  constexpr int DK = kExitChunkBytes / (int)sizeof(T);
  const unsigned char* row = wst + t * kExitChunkBytes;
  const int sw = t & 7;
#pragma unroll
  for (int q = 0; q < kExitChunkBytes / 16; ++q) {
    float wv[KB][EPC];
#pragma unroll
    for (int k = 0; k < KB; ++k)
      unpack16<T>(*reinterpret_cast<const uint4*>(row + k * kExitBoxBytes +
                                                  ((q ^ sw) << 4)),
                  wv[k]);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int e4 = 0; e4 < EPC / 4; ++e4) {
        const float4 hv =
            *reinterpret_cast<const float4*>(hn + r * DK + q * EPC + 4 * e4);
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          float a = acc[k][r];
          a = fmaf(wv[k][4 * e4], hv.x, a);
          a = fmaf(wv[k][4 * e4 + 1], hv.y, a);
          a = fmaf(wv[k][4 * e4 + 2], hv.z, a);
          a = fmaf(wv[k][4 * e4 + 3], hv.w, a);
          acc[k][r] = a;
        }
      }
    }
  }
}

struct ExitArgs {
  const void* h;       // (R, D) raw rows
  const void* ns;      // (E, D) norm scales
  float eps;
  int R, B, V, D;
  int stages;
  int quant_exit;      // exit whose B raw rows get the int8 packet, or -1
  int8_t* q;           // (B, D)
  float* qscale;       // (B,)
  float* part;         // [kExitPartials][cap] partials
  unsigned* counter;   // completion counter, 0 between launches
  int cap;
  float* conf;
  int* tok;
  float* lse;
};

// Tensor-core helpers of the bf16 path at R > 8 (mma.sync m16n8k16, bf16
// in, float32 accumulate).
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = hi + mid + lo in three bf16 (each the rounded rest of the parts
// before it): all 24 bits of x reach the tensor cores, and each product is
// exact in float32.  part[i] packs part i of x0 (low half) and x1.
__device__ __forceinline__ void split_bf16(float x0, float x1,
                                           uint32_t (&part)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat16 p0 = __float2bfloat16_rn(x0);
    const __nv_bfloat16 p1 = __float2bfloat16_rn(x1);
    part[i] = (uint32_t)__bfloat16_as_ushort(p0) |
              ((uint32_t)__bfloat16_as_ushort(p1) << 16);
    x0 -= __bfloat162float(p0);
    x1 -= __bfloat162float(p1);
  }
}
constexpr int kSplitParts = 3;

// floats of a stage's hn in shared memory: RT x DK values, or on the
// tensor cores their A fragments (kSplitParts bf16 values each)
template <typename T, int RT, bool MMA>
__host__ __device__ constexpr int hn_floats() {
  constexpr int DK = kExitChunkBytes / (int)sizeof(T);
  return MMA ? RT * DK * kSplitParts * 2 / 4 : RT * DK;
}

// One stage's products on the tensor cores: NJ n-tiles of 8 W rows from
// ``rows`` (the warp's first row of the stage), KSTEPS k-steps of 16
// columns.  B fragments by ldmatrix: matrix i of tile pair jp is tile
// 2 jp + i / 2, columns 8 (i % 2) to 8 (i % 2) + 7 of the k-step, and row n
// of a box keeps its 16-byte chunk q at slot q ^ (n % 8) (the swizzle; the
// warp's first row is a multiple of 8).
template <int NJ, int KSTEPS>
__device__ __forceinline__ void mma_stage(uint32_t rows, const uint4* frag,
                                          int lane, float (&acc)[8][4]) {
  const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    uint32_t a[kSplitParts][4];
#pragma unroll
    for (int i = 0; i < kSplitParts; ++i) {
      const uint4 v4 = frag[(ks * 32 + lane) * kSplitParts + i];
      a[i][0] = v4.x, a[i][1] = v4.y, a[i][2] = v4.z, a[i][3] = v4.w;
    }
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      const int n = 8 * (2 * jp + (mi >> 1)) + r8;
      const int q = 2 * ks + (mi & 1);
      uint32_t b[4];
      ldmatrix_x4(rows + n * kExitChunkBytes + ((q ^ r8) << 4), b);
#pragma unroll
      for (int i = 0; i < kSplitParts; ++i) {
        mma_bf16(acc[2 * jp], a[i], b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a[i], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ void fold(float x, int v, float& m, float& l,
                                     int& a) {
  if (x > m) {
    l = l * expf(m - x) + 1.0f;
    m = x;
    a = v;
  } else {
    l += expf(x - m);
  }
}

// MMA = true (bf16, RT = 16): per stage the hn warps write hn as the
// mma A fragments of 4 k-steps of 16 columns, three bf16 parts
// ([k-step][lane][part][a0..a3]); consumer warp w takes 32 kb of
// the stage's 256 kb W rows (kb boxes: 4 kb n-tiles of 8 rows) and thread
// (g, t) = (lane / 4, lane % 4) holds the logits of rows g and g + 8
// against W rows 8j + 2t, 8j + 2t + 1 of its tiles.
template <typename T, int RT, bool MMA>
__global__ void __launch_bounds__(kExitThreads, 1)
exit_heads_kernel(const __grid_constant__ CUtensorMap wmap, const ExitArgs p) {
  static_assert(!MMA || (RT == 16 && sizeof(T) == 2), "mma: bf16, 16 rows");
  constexpr int DK = kExitChunkBytes / (int)sizeof(T);
  constexpr int EPC = 16 / (int)sizeof(T);
  constexpr int VECS = RT * (kExitChunkBytes / 16);   // 16-byte hn vectors
  constexpr int MV = (VECS + 32 * kExitHnWarps - 1) / (32 * kExitHnWarps);
  constexpr int KSTEPS = DK / 16;                     // mma k-steps a chunk
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment of the ring (the 128-byte swizzle's period)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // ring (S stages of kBoxes boxes) | full[S], empty[S], raw[S] mbarriers
  // | raw rows (S stages of RT rows and RT scales, 128 bytes each) | hn (S
  // stages of RT x DK floats, or their A fragments) | rms factors |
  // per-warp partials | flag
  const int S = p.stages;
  constexpr int HN = hn_floats<T, RT, MMA>();           // a stage's hn
  unsigned char* ring = smem;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + (size_t)S * kExitStageBytes);
  unsigned char* raw_ring = reinterpret_cast<unsigned char*>(bars + 4 * S);
  float* hn_ring = reinterpret_cast<float*>(
      raw_ring + (size_t)S * 2 * RT * kExitChunkBytes);
  float* inv = hn_ring + S * HN;                        // [RT]
  float* red = inv + RT;                                // [8][3][RT]
  int* flag = reinterpret_cast<int*>(red + kExitConsumerWarps * 3 * RT);
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + S);
  const uint32_t raw0 = smem_addr(bars + 2 * S);
  const CUtensorMap* map = &wmap;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = gridDim.x, blk = blockIdx.x;
  const int nbox = (p.V + kExitBoxRows - 1) / kExitBoxRows;
  const int box0 = (int)((long long)blk * nbox / G);
  const int box1 = (int)((long long)(blk + 1) * nbox / G);
  const int ngroups = (box1 - box0 + kBoxes - 1) / kBoxes;
  const int nchunks = (p.D + DK - 1) / DK;
  const int nstages = ngroups * nchunks;
  const T* h = static_cast<const T*>(p.h);
  const T* ns = static_cast<const T*>(p.ns);
  const int g8 = lane >> 2, t4 = lane & 3;              // mma fragment coords

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32 * kExitHnWarps);  // W's tx + hn lanes
      mbar_init(empty0 + 8 * s, kExitConsumerWarps);
      mbar_init(raw0 + 8 * s, 1);         // the raw rows' expect_tx
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto group_boxes = [&](int g) {
    return min(kBoxes, box1 - box0 - g * kBoxes);
  };

  if (warp == kExitConsumerWarps) {
    // ---------------- loader warp ----------------
    // Each stage: the W boxes by TMA, and the chunk of every raw row and
    // norm scale by one bulk copy a row (lane r: row r, lane R + e: the
    // scale of exit e), as soon as the consumers free the slot.
    const uint64_t policy = evict_first_policy();
    const int E = p.R / p.B;
    for (int i = 0; i < nstages; ++i) {
      const int slot = i % S, g = i / nchunks, c = i % nchunks;
      if (i >= S) mbar_wait(empty0 + 8 * slot, ((i / S) - 1) & 1);
      const int kb = group_boxes(g);
      const uint32_t bytes =
          (uint32_t)(min(DK, p.D - c * DK) * (int)sizeof(T));
      if (lane == 0) {
        const uint32_t full = full0 + 8 * slot;
        mbar_expect_tx(full, kb * kExitBoxBytes);
        for (int k = 0; k < kb; ++k)
          tma_load_2d(smem_addr(ring + (size_t)slot * kExitStageBytes +
                                k * kExitBoxBytes),
                      map, c * DK, (box0 + g * kBoxes + k) * kExitBoxRows,
                      full, policy);
        mbar_expect_tx(raw0 + 8 * slot, (p.R + E) * bytes);
      }
      __syncwarp();
      if (lane < p.R + E) {
        const T* src = lane < p.R ? h + (size_t)lane * p.D
                                  : ns + (size_t)(lane - p.R) * p.D;
        const int row = lane < p.R ? lane : RT + lane - p.R;
        bulk_load(smem_addr(raw_ring + ((size_t)slot * 2 * RT + row) *
                                           kExitChunkBytes),
                  src + c * DK, bytes, raw0 + 8 * slot);
      }
    }
    return;
  }
  if (warp > kExitConsumerWarps) {
    // ---------------- hn warps ----------------
    // Each stage: hn of the chunk from its raw rows once they land, in the
    // consumers' layout (floats, or the mma A fragments; the two warps
    // take alternate k-steps or vectors), then each lane's arrival on the
    // stage's full barrier.  The slot is free: the raw rows were requested
    // after the consumers had left the slot's previous stage.
    const int hw = warp - kExitConsumerWarps - 1;
    named_sync(2, kExitHnThreads);         // the consumers' rms factors
    for (int j = 0; j < nstages; ++j) {
      const int slot = j % S, c = j % nchunks;
      mbar_wait(raw0 + 8 * slot, (j / S) & 1);
      const unsigned char* raw =
          raw_ring + (size_t)slot * 2 * RT * kExitChunkBytes;
      float* hn = hn_ring + slot * HN;
      if constexpr (MMA) {
        uint4* frag = reinterpret_cast<uint4*>(hn);
#pragma unroll
        for (int k2 = 0; k2 < KSTEPS / kExitHnWarps; ++k2) {
          const int ks = kExitHnWarps * k2 + hw;
          uint32_t part[4][kSplitParts];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // a0..a3: rows g8, g8 + 8, at columns 2 t4 and 2 t4 + 8
            const int r = g8 + 8 * (q & 1);
            const int jc = 16 * ks + 2 * t4 + 8 * (q >> 1);
            float x0 = 0.f, x1 = 0.f;
            if (r < p.R && c * DK + jc < p.D) {
              const uint32_t hv = *reinterpret_cast<const uint32_t*>(
                  raw + r * kExitChunkBytes + 2 * jc);
              const uint32_t nv = *reinterpret_cast<const uint32_t*>(
                  raw + (RT + r / p.B) * kExitChunkBytes + 2 * jc);
              x0 = __uint_as_float(hv << 16) * inv[r] *
                   (1.0f + __uint_as_float(nv << 16));
              x1 = __uint_as_float(hv & 0xffff0000u) * inv[r] *
                   (1.0f + __uint_as_float(nv & 0xffff0000u));
            }
            split_bf16(x0, x1, part[q]);
          }
#pragma unroll
          for (int i = 0; i < kSplitParts; ++i)
            frag[(ks * 32 + lane) * kSplitParts + i] =
                make_uint4(part[0][i], part[1][i], part[2][i], part[3][i]);
        }
      } else {
#pragma unroll
        for (int m = 0; m < MV; ++m) {
          const int vi = lane + 32 * (kExitHnWarps * m + hw);
          const int r = vi / 8, q = vi % 8;
          if (vi < VECS) {
            float hv[EPC], nv[EPC];
            if (r < p.R && c * DK + q * EPC < p.D) {
              unpack16<T>(*reinterpret_cast<const uint4*>(
                              raw + r * kExitChunkBytes + 16 * q), hv);
              unpack16<T>(*reinterpret_cast<const uint4*>(
                              raw + (RT + r / p.B) * kExitChunkBytes + 16 * q),
                          nv);
#pragma unroll
              for (int e = 0; e < EPC; ++e)
                hv[e] = hv[e] * inv[r] * (1.0f + nv[e]);
            } else {
#pragma unroll
              for (int e = 0; e < EPC; ++e) hv[e] = 0.f;
            }
            float4* dst = reinterpret_cast<float4*>(hn + r * DK + q * EPC);
#pragma unroll
            for (int e4 = 0; e4 < EPC / 4; ++e4)
              dst[e4] = make_float4(hv[4 * e4], hv[4 * e4 + 1],
                                    hv[4 * e4 + 2], hv[4 * e4 + 3]);
          }
        }
      }
      mbar_arrive(full0 + 8 * slot);
    }
    return;
  }

  // ---------------- consumer warps ----------------
  const int t = threadIdx.x;   // W row t of each box (FMA path)
  // rms factor of every row (warp per row) and this block's packet rows
  for (int r = warp; r < RT; r += kExitConsumerWarps) {
    float ss = 0.f;
    if (r < p.R) {
      const T* hr = h + (size_t)r * p.D;
      for (int j = lane * EPC; j < p.D; j += 32 * EPC) {
        float x[EPC];
        unpack16<T>(*reinterpret_cast<const uint4*>(hr + j), x);
#pragma unroll
        for (int e = 0; e < EPC; ++e) ss += x[e] * x[e];
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) inv[r] = r < p.R ? 1.0f / sqrtf(ss / (float)p.D + p.eps) : 0.f;
  }
  if (p.quant_exit >= 0) {
    for (int b = blk + warp * G; b < p.B; b += kExitConsumerWarps * G) {
      const T* hr = h + (size_t)(p.quant_exit * p.B + b) * p.D;
      float amax = 0.f;
      for (int j = lane; j < p.D; j += 32) amax = fmaxf(amax, fabsf(to_f32(hr[j])));
      const float scale = int8_scale(warp_max(amax));
      int8_t* qr = p.q + (size_t)b * p.D;
      for (int j = lane; j < p.D; j += 32) qr[j] = int8_code(to_f32(hr[j]), scale);
      if (lane == 0) p.qscale[b] = scale;
    }
  }
  named_sync(2, kExitHnThreads);

  // running (max, sum-exp, first argmax): FMA, every row; MMA, rows g8
  // and g8 + 8
  constexpr int NS = MMA ? 2 : RT;
  float m[NS], l[NS];
  int a[NS];
#pragma unroll
  for (int r = 0; r < NS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    a[r] = INT_MAX;
  }
  int i = 0;
  for (int g = 0; g < ngroups; ++g) {
    const int kb = group_boxes(g);
    if constexpr (MMA) {
      // warp w: stage rows [32 kb w, 32 kb (w + 1)), 4 kb n-tiles of 8
      const int row0 = 32 * kb * warp;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int c = 0; c < nchunks; ++c, ++i) {
        const int slot = i % S;
        mbar_wait(full0 + 8 * slot, (i / S) & 1);
        const uint32_t rows = smem_addr(ring + (size_t)slot * kExitStageBytes +
                                        row0 * kExitChunkBytes);
        const uint4* frag =
            reinterpret_cast<const uint4*>(hn_ring + slot * HN);
        if (kb == kBoxes)
          mma_stage<4 * kBoxes, KSTEPS>(rows, frag, lane, acc);
        else
          mma_stage<4, KSTEPS>(rows, frag, lane, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * slot);
      }
      const int v0 = (box0 + g * kBoxes) * kExitBoxRows + row0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int v = v0 + 8 * j + (e & 1);
          if (j < 4 * kb && v < p.V)
            fold(acc[j][e], v, m[e >> 1], l[e >> 1], a[e >> 1]);
        }
    } else {
      float acc[kBoxes][RT];
#pragma unroll
      for (int k = 0; k < kBoxes; ++k)
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[k][r] = 0.f;
      for (int c = 0; c < nchunks; ++c, ++i) {
        const int slot = i % S;
        mbar_wait(full0 + 8 * slot, (i / S) & 1);
        const unsigned char* wst = ring + (size_t)slot * kExitStageBytes;
        const float* hn = hn_ring + slot * HN;
        if (kb == kBoxes)
          stage_products<T, RT, kBoxes>(wst, hn, t, acc);
        else
          stage_products<T, RT, 1>(wst, hn, t, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * slot);
      }
      // fold the group's logits into the running (max, sum-exp, argmax)
#pragma unroll
      for (int k = 0; k < kBoxes; ++k) {
        const int v = (box0 + g * kBoxes + k) * kExitBoxRows + t;
        if (k < kb && v < p.V) {
#pragma unroll
          for (int r = 0; r < RT; ++r) fold(acc[k][r], v, m[r], l[r], a[r]);
        }
      }
    }
  }

  // the block's partial per row: each warp's, then the warps in order
  if constexpr (MMA) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {      // the four lanes of a row
        const float m2 = __shfl_xor_sync(0xffffffffu, m[s], o);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[s], o);
        const int a2 = __shfl_xor_sync(0xffffffffu, a[s], o);
        merge_partial(m[s], l[s], a[s], m2, l2, a2);
      }
      if (t4 == 0) {
        const int r = g8 + 8 * s;
        red[(warp * 3 + 0) * RT + r] = m[s];
        red[(warp * 3 + 1) * RT + r] = l[s];
        red[(warp * 3 + 2) * RT + r] = __int_as_float(a[s]);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      warp_merge(m[r], l[r], a[r]);
      if (lane == 0) {
        red[(warp * 3 + 0) * RT + r] = m[r];
        red[(warp * 3 + 1) * RT + r] = l[r];
        red[(warp * 3 + 2) * RT + r] = __int_as_float(a[r]);
      }
    }
  }
  named_sync(1, kExitConsumerWarps * 32);
  const int cap = p.cap;
  if (warp == 0 && lane < p.R) {
    float bm = -INFINITY, bl = 0.f;
    int ba = INT_MAX;
    for (int w = 0; w < kExitConsumerWarps; ++w)
      merge_partial(bm, bl, ba, red[(w * 3 + 0) * RT + lane],
                    red[(w * 3 + 1) * RT + lane],
                    __float_as_int(red[(w * 3 + 2) * RT + lane]));
    p.part[(size_t)lane * cap + blk] = bm;
    p.part[(size_t)(kExitMaxRows + lane) * cap + blk] = bl;
    p.part[(size_t)(2 * kExitMaxRows + lane) * cap + blk] = __int_as_float(ba);
    __threadfence();
  }
  named_sync(1, kExitConsumerWarps * 32);
  if (t == 0) *flag = atomicAdd(p.counter, 1u) == (unsigned)(G - 1);
  named_sync(1, kExitConsumerWarps * 32);
  if (!*flag) return;

  // the last block: merge every block's partial, in block order
  __threadfence();
  for (int r = warp; r < p.R; r += kExitConsumerWarps) {
    float bm = -INFINITY, bl = 0.f;
    int ba = INT_MAX;
    for (int b = lane; b < G; b += 32)
      merge_partial(bm, bl, ba, __ldcg(p.part + (size_t)r * cap + b),
                    __ldcg(p.part + (size_t)(kExitMaxRows + r) * cap + b),
                    __float_as_int(__ldcg(
                        p.part + (size_t)(2 * kExitMaxRows + r) * cap + b)));
    warp_merge(bm, bl, ba);
    if (lane == 0) {
      const float ls = bm + logf(bl);
      p.lse[r] = ls;
      p.conf[r] = expf(bm - ls);
      p.tok[r] = ba;
    }
  }
  if (t == 0) *p.counter = 0u;
}

template <typename T, int RT, bool MMA>
size_t exit_smem_bytes(int stages) {
  return 1024 + (size_t)stages * kExitStageBytes +
         sizeof(uint64_t) * 4 * stages +
         (size_t)stages * 2 * RT * kExitChunkBytes +
         sizeof(float) * ((size_t)stages * hn_floats<T, RT, MMA>() + RT +
                          kExitConsumerWarps * 3 * RT) +
         sizeof(int);
}

inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The blocks of a launch: min(boxes of V, blocks a SM * SMs, cap), where
// the blocks a SM are what was asked for and the occupancy allows.
template <typename T, int RT, bool MMA>
cudaError_t exit_grid(int device, int sms, int V, int stages, int per_sm,
                      int cap, size_t smem, int* grid) {
  // per kernel and device, kept across calls: SMs, the dynamic shared
  // memory limit raised once to the card's maximum, occupancy per depth
  static bool raised[16] = {false};
  static int occ[16][8] = {{0}};
  auto kern = exit_heads_kernel<T, RT, MMA>;
  if (device < 0 || device >= 16 || stages < 1 || stages > 8)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (!raised[device]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSharedBytes);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  if (!occ[device][stages - 1]) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ[device][stages - 1], kern, kExitThreads, smem);
    if (err != cudaSuccess) return err;
    if (occ[device][stages - 1] < 1) return cudaErrorInvalidConfiguration;
  }
  const int nbox = (V + kExitBoxRows - 1) / kExitBoxRows;
  *grid = min(min(nbox, min(per_sm, occ[device][stages - 1]) * sms), cap);
  return cudaSuccess;
}

template <typename T, int RT, bool MMA = false>
cudaError_t exit_heads_rt(int device, int sms, const CUtensorMap& map,
                          ExitArgs a, int per_sm, cudaStream_t st, int* grid) {
  const size_t smem = exit_smem_bytes<T, RT, MMA>(a.stages);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = exit_grid<T, RT, MMA>(device, sms, a.V, a.stages, per_sm,
                                          a.cap, smem, grid);
  if (err != cudaSuccess) return err;
  exit_heads_kernel<T, RT, MMA><<<*grid, kExitThreads, smem, st>>>(map, a);
  return cudaGetLastError();
}

// One launch over R = E * B rows (E exits of B slots).  ws holds
// kExitPartials * cap floats of partials and then the completion counter,
// which must be 0 before the first launch (each launch leaves it 0).
// stages / per_sm: the ring's depth and the blocks a SM (0: defaults).
// *grid (may be null) receives the number of blocks launched.
template <typename T>
cudaError_t exit_heads_launch_t(int device, const void* h, const void* w,
                                const void* ns, float eps, int E, int B,
                                int V, int D, int quant_exit, int8_t* q,
                                float* qscale, float* ws, int cap,
                                float* conf, int* tok, float* lse, int stages,
                                int per_sm, cudaStream_t st, int* grid) {
  const int R = E * B;
  if (E < 1 || B < 1 || R > kExitMaxRows || V < 1 || D < 8 || D % 8 ||
      cap < 1 || quant_exit >= E || (quant_exit >= 0 && (!q || !qscale)))
    return cudaErrorInvalidValue;
  static int sm_counts[16] = {0};
  if (device < 0 || device >= 16) return cudaErrorInvalidValue;
  if (!sm_counts[device]) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &sm_counts[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const int sms = sm_counts[device];
  // the default ring: 2 stages where every block gets two boxes or more
  // (64 KB stages, 128 KB in flight an SM), else 3 (most blocks hold one
  // box: 32 KB stages); on the H100 these beat a third 64 KB stage by 3%
  // and a second 32 KB one by 2% (tools/exit_head_sweep.py)
  if (stages <= 0)
    stages = (V + kExitBoxRows - 1) / kExitBoxRows >= kBoxes * sms ? 2 : 3;
  if (per_sm <= 0) per_sm = kExitDefaultBlocksPerSm;
  auto encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)V};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(kExitChunkBytes / sizeof(T)),
                             (cuuint32_t)kExitBoxRows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult cr = encode(
      &map,
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(w), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return cudaErrorInvalidValue;
  ExitArgs a{h, ns, eps, R, B, V, D, stages, quant_exit, q, qscale, ws,
             reinterpret_cast<unsigned*>(ws + (size_t)kExitPartials * cap),
             cap, conf, tok, lse};
  int g = 0;
  if (!grid) grid = &g;
  if (R == 1) return exit_heads_rt<T, 1>(device, sms, map, a, per_sm, st, grid);
  if (R == 2) return exit_heads_rt<T, 2>(device, sms, map, a, per_sm, st, grid);
  if (R <= 4) return exit_heads_rt<T, 4>(device, sms, map, a, per_sm, st, grid);
  if (R <= 8) return exit_heads_rt<T, 8>(device, sms, map, a, per_sm, st, grid);
  // more rows: bf16 on the tensor cores, float32 on the CUDA cores
  if constexpr (sizeof(T) == 2)
    return exit_heads_rt<T, 16, true>(device, sms, map, a, per_sm, st, grid);
  else
    return exit_heads_rt<T, 16>(device, sms, map, a, per_sm, st, grid);
}

inline int exit_heads_entry(int device, int dtype, const void* hidden,
                            const void* weight, const void* norm_scales,
                            float eps, int E, int B, int V, int D,
                            int quant_exit, void* q, void* qscale, void* ws,
                            int cap, void* conf, void* tok, void* lse,
                            int stages, int per_sm, void* stream, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    err = exit_heads_launch_t<float>(
        device, hidden, weight, norm_scales, eps, E, B, V, D, quant_exit,
        (int8_t*)q, (float*)qscale, (float*)ws, cap, (float*)conf, (int*)tok,
        (float*)lse, stages, per_sm, st, grid);
  else if (dtype == kBF16)
    err = exit_heads_launch_t<__nv_bfloat16>(
        device, hidden, weight, norm_scales, eps, E, B, V, D, quant_exit,
        (int8_t*)q, (float*)qscale, (float*)ws, cap, (float*)conf, (int*)tok,
        (float*)lse, stages, per_sm, st, grid);
  else
    err = cudaErrorInvalidValue;
  return err;
}

}  // namespace
}  // namespace rt

