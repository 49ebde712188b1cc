// Hand-written flash-attention partial for Hopper (sm_90a): scores, online
// softmax and the weighted-V product of one Q block against one KV block, the
// score tile never leaving the SM.
//
// Replaces the TPU kernel matvec_mpi_multiplier_tpu/ops/pallas_attention.py::
// _flash_kernel. There, a grid (h, sq/512, sk/512) runs in order on one core
// and carries the running (acc, m, l) state in VMEM scratch across the KV
// steps of each (head, q-block). Blocks on Hopper run in parallel and in no
// order, so the sequential KV axis becomes a loop inside the CTA over KV
// tiles of 64 keys, and the running state lives in registers.
//
// What it computes, per head and query row (q pre-scaled, fp32):
//   s[k]     = q . k_k                         (-inf where masked)
//   m        = max_k s[k]                      (-inf if every key is masked)
//   l        = sum_k exp(s[k] - m)
//   o_unnorm = sum_k exp(s[k] - m) * v_k
// with the causal mask k_pos <= q_pos by the global position vectors the
// caller passes (the ring hands a device KV blocks from elsewhere in the
// sequence), and keys past sk masked. A fully masked row comes back as
// m = -inf, l = 0, o = 0, by the TPU kernel's guards: safe_m = m where finite
// else 0, and the correction of the old state is 0 where the old m is -inf.
// The bar is 2e-5 of the exact partial (fp64 sums), as the TPU kernel's test.
//
// Routes, planned by the wrapper (ops/cuda_attention.py::flash_route) from
// k's dtype and d alone:
//
// * wgmma_split (bf16 k and v, d = 128: every attention path). The products
//   run on the bf16 tensor cores. K and V are exact bf16 operands; q and the
//   softmax weights P are fp32, and each is split into three bf16 parts,
//   x = x0 + x1 + x2 + r with |r| <= 2^-24 |x| (each remainder is exact in
//   fp32), so each product x_i * k is exact and the three passes sum to
//   fp32 accuracy. Two passes leave |r| near 2^-16 |x| and land beyond 2e-5
//   of the exact partial (tests/test_torch_flash_route.py emulates both).
//   The tensor work is 3x a plain bf16 kernel's: 6 wgmma passes per tile.
//   Design: one CTA of 384 threads per (q-tile of 128 rows, head), the
//   q-tiles walked longest first (block b takes q-tile nqt-1-b/h: under a
//   causal mask with ascending positions a q-tile's work grows with its
//   index). One producer warp keeps TMA loads of K and V tiles (64 keys x
//   128 columns, two 128-byte-swizzled boxes each, from 3-D maps (d, sk, h)
//   so a tile never crosses a head and keys past sk arrive as zeros) in
//   flight through a ring of 2 stages on mbarriers; with each tile it writes
//   the tile's index and key positions into the stage. Two consumer
//   warpgroups of 64 rows each split their Q rows once into q0, q1, q2 in
//   shared memory (K-major, the same swizzle), then per KV tile:
//     1. S = q2 K^T + q1 K^T + q0 K^T: 24 SS wgmma m64n64k16, smallest part
//        first, into one fp32 accumulator;
//     2. the mask, only on a tile that crosses sk or the causal diagonal;
//     3. the online softmax in registers (expf, not __expf; row max and sum
//        by quad shuffles), l in fp64;
//     4. P split into p0, p1, p2, stored to shared memory in the swizzle;
//     5. P V in two halves of d: 12 SS wgmma m64n64k16 each (V MN-major
//        through the transpose bit), p2 first, into a fresh fp32 tile;
//     6. o = o * corr + tile in fp64 (fp32 merges, one per 64 keys, land
//        beyond 2e-5 at (2, 16384, 16384, 128)).
//   Registers bound the design: o in fp64 is 128 per thread and the fresh
//   half-tile 32, and setmaxnreg moves registers from the producer (40) to
//   the consumers (232). ptxas still spills a little (-Xptxas -v), and
//   every variant that held more in registers spilled more and ran slower
//   on an H100: P as register A fragments of RS wgmma (48 registers more),
//   both P V halves in flight at once, the scores' registers reused for
//   P V. Ordering the two warpgroups' score products by named barriers
//   gained nothing. What remains is the consumers' CUDA-core work beside
//   the tensor cores: the exponentials, the splits and the fp64 merges.
//   Causal: a KV tile every key of which follows every row of the q-tile is
//   never loaded, one that follows every row of a warpgroup is skipped by
//   it, and a tile below the diagonal takes no mask. Each leaves the state
//   bitwise as the masked product would (corr = 1 or 0, p = 0, and o is
//   never -0), so a row's result depends on that row, the keys and the
//   positions alone: not on its place in a tile, the tile order or the grid.
// * ffma (everything else: fp32 k and v, and d = 256). FFMA from shared
//   memory, one CTA of 128 threads per (q-tile of 64 rows, head, 128-column
//   chunk of d), K and V converted to fp32 on load; see its kernel below.
//   A tensor-core route for fp32 k/v would split K and V too (or run 3xTF32
//   behind a conversion stage: TMA copies bytes as they are): not built.
//
// What bounds it: operations. 4 d flops per unmasked (q, k) pair. On
// wgmma_split, three bf16 passes per product on the tensor cores (989
// TFLOP/s): at the ring's hop shape (8, 4096, 4096, 128) 3 x 68.7 GFLOP,
// 0.208 ms, against 48 MB of traffic (0.014 ms at 3.35 TB/s). On ffma, fp32
// FFMA (67 TFLOP/s): 1.03 ms at the same shape.
//
// No atomics, no split of the keys across CTAs: two launches on the same
// inputs are bitwise equal, on either route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) < INFINITY; }

// ---------------------------------------------------------------- ffma
//
// One CTA of 128 threads per (q-tile of 64 rows, head, 128-column chunk of
// d); d > 128 runs d/128 CTAs per q-tile, each recomputing the scores and
// writing its own columns of o (chunk 0 writes m and l). The running state
// lives in registers: 16 o values and one (m, l) pair for each of a
// thread's 4 rows, o and l in fp64. Per KV tile:
//   1. K (and, on the first d-chunk, V) is staged through shared memory,
//      converted to fp32 on load (bf16 or fp32 in); Q is staged once
//      (d = 128) or per chunk of d;
//   2. S = Q K^T by fp32 FFMA from shared memory, a 4 x 8 register tile per
//      thread (rows r + 16i, columns c + 8j: conflict-free float4 loads);
//   3. the online softmax in registers: row max and row sum across the 8
//      lanes that share a row by warp shuffles, then P to shared memory (over
//      the K tile, which is dead by then);
//   4. the tile's P V into a fresh fp32 register tile (in two halves of the
//      columns), then o = o * corr + tile in fp64, as the TPU kernel's
//      acc * corr + dot(p, v).
// Under a causal mask a KV tile whose every key lies after every row of the
// q-tile is skipped (one __syncthreads_or vote). Shared memory: Q and K
// tiles 64 x 132 floats each, V 64 x 128, 100.6 KB, so two CTAs fit on an
// SM. Rows past sq and keys past sk are zero-filled and masked, so any
// sq >= 1, sk >= 1 and d % 128 == 0 run.


constexpr int kThreads = 128;
constexpr int kBq = 64;               // q rows per CTA
constexpr int kBkv = 64;              // keys per KV tile
constexpr int kDc = 128;              // head-dim columns per chunk
constexpr int kQkPitch = kDc + 4;     // Q and K tiles: conflict-free float4 rows
constexpr int kPPitch = kBkv + 4;     // P tile, over the K tile
constexpr int kVPitch = kDc;
constexpr int kSmemBytes =
    (kBq * kQkPitch + kBkv * kQkPitch + kBkv * kVPitch) * 4 + kBkv * 4 + 4 * 4;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Rows [row0, row0 + 64) and columns [col0, col0 + 128) of a row-major
// (n, d) matrix into `dst` (row pitch `pitch`) as fp32, zeros past row n.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      int64_t row0, int64_t n, int64_t d,
                                      int64_t col0) {
  constexpr int kUnits = kDc / 4;  // float4 units per row
#pragma unroll 4
  for (int u = threadIdx.x; u < 64 * kUnits; u += kThreads) {
    const int r = u / kUnits;
    const int c = (u % kUnits) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = load4(src + (row0 + r) * d + col0 + c);
    *reinterpret_cast<float4*>(dst + r * pitch + c) = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_partial_kernel(const float* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos, float* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int64_t sq, int64_t sk, int64_t d, int causal) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][132]
  float* ks = qs + kBq * kQkPitch;               // [64][132]; P [64][68] later
  float* ps = ks;
  float* vs = ks + kBkv * kQkPitch;              // [64][128]
  int* kpos_s = reinterpret_cast<int*>(vs + kBkv * kVPitch);  // [64]
  int* red = kpos_s + kBkv;                                   // [4]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int rg = warp * 4 + lane / 8;  // rows rg + 16 i; lanes 8g..8g+7 share them
  const int cg = lane % 8;             // S columns cg + 8 j; o columns cg*4 + 32 j + e
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBq;
  const int64_t head = blockIdx.y;
  const int chunk = blockIdx.z;
  const int nch = static_cast<int>(d / kDc);

  const float* qh = q + head * sq * d;
  const T* kh = k + head * sk * d;
  const T* vh = v + head * sk * d;

  // Rows past sq take position INT_MIN: every key masked, never written.
  int qp[4];
  int qmax = INT_MIN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + rg + 16 * i;
    qp[i] = (causal && row < sq) ? q_pos[row] : INT_MIN;
    qmax = max(qmax, qp[i]);
  }
  if (causal) {
    qmax = __reduce_max_sync(kFull, qmax);
    if (lane == 0) red[warp] = qmax;
    __syncthreads();
    qmax = max(max(red[0], red[1]), max(red[2], red[3]));
  }

  // The running sums o and l are fp64: a merge per KV tile at the size of
  // the whole sum would otherwise round 256 times over a 16384-key row.
  float m_r[4];
  double l_r[4], acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.0;
#pragma unroll
    for (int x = 0; x < 16; ++x) acc[i][x] = 0.0;
  }

  if (nch == 1) stage(qs, kQkPitch, qh, q0, sq, d, 0);

  const int64_t ntiles = (sk + kBkv - 1) / kBkv;
  for (int64_t t = 0; t < ntiles; ++t) {
    const int64_t k0 = t * kBkv;
    if (causal) {
      int kp = INT_MAX;
      if (tid < kBkv && k0 + tid < sk) kp = k_pos[k0 + tid];
      if (tid < kBkv) kpos_s[tid] = kp;
      // A tile every key of which follows every row leaves the state
      // bitwise unchanged: skip it. The vote is also the barrier for kpos_s.
      if (!__syncthreads_or(kp <= qmax)) continue;
    }

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;

    for (int c = 0; c < nch; ++c) {
      if (nch > 1) stage(qs, kQkPitch, qh, q0, sq, d, static_cast<int64_t>(c) * kDc);
      stage(ks, kQkPitch, kh, k0, sk, d, static_cast<int64_t>(c) * kDc);
      if (c == 0) stage(vs, kVPitch, vh, k0, sk, d, static_cast<int64_t>(chunk) * kDc);
      __syncthreads();
#pragma unroll 2
      for (int d4 = 0; d4 < kDc; d4 += 4) {
        float4 qf[4], kf[8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qf[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * kQkPitch + d4);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          kf[j] = *reinterpret_cast<const float4*>(ks + (cg + 8 * j) * kQkPitch + d4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float a = s[i][j];
            a = fmaf(qf[i].x, kf[j].x, a);
            a = fmaf(qf[i].y, kf[j].y, a);
            a = fmaf(qf[i].z, kf[j].z, a);
            a = fmaf(qf[i].w, kf[j].w, a);
            s[i][j] = a;
          }
      }
      __syncthreads();  // every thread is done with the K (and Q) tile
    }

    // The online softmax, the TPU kernel's update with its -inf guards.
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cg + 8 * j;
        const bool keep = (k0 + col < sk) && (!causal || kpos_s[col] <= qp[i]);
        s[i][j] = keep ? s[i][j] : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 4));
      const float new_m = fmaxf(m_r[i], tmax);
      const float safe_m = is_finite(new_m) ? new_m : 0.f;
      corr[i] = is_finite(m_r[i]) ? expf(m_r[i] - safe_m) : 0.f;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - safe_m);  // exp(-inf) = 0 where masked
        rsum += s[i][j];
      }
      rsum += __shfl_xor_sync(kFull, rsum, 1);
      rsum += __shfl_xor_sync(kFull, rsum, 2);
      rsum += __shfl_xor_sync(kFull, rsum, 4);
      l_r[i] = l_r[i] * corr[i] + rsum;  // exact where corr = 1 and rsum = 0
      m_r[i] = new_m;
#pragma unroll
      for (int j = 0; j < 8; ++j) ps[(rg + 16 * i) * kPPitch + cg + 8 * j] = s[i][j];
    }
    __syncthreads();

    // P V in two halves of the thread's 16 columns, to keep the fp32 tile
    // and the fp64 sums within the register file.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tile[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int x = 0; x < 8; ++x) tile[i][x] = 0.f;
#pragma unroll 2
      for (int k4 = 0; k4 < kBkv; k4 += 4) {
        float4 pf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pf[i] = *reinterpret_cast<const float4*>(ps + (rg + 16 * i) * kPPitch + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4 vf[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            vf[j] = *reinterpret_cast<const float4*>(
                vs + (k4 + kk) * kVPitch + cg * 4 + 32 * (2 * half + j));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = kk == 0 ? pf[i].x : kk == 1 ? pf[i].y : kk == 2 ? pf[i].z : pf[i].w;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              tile[i][4 * j + 0] = fmaf(pv, vf[j].x, tile[i][4 * j + 0]);
              tile[i][4 * j + 1] = fmaf(pv, vf[j].y, tile[i][4 * j + 1]);
              tile[i][4 * j + 2] = fmaf(pv, vf[j].z, tile[i][4 * j + 2]);
              tile[i][4 * j + 3] = fmaf(pv, vf[j].w, tile[i][4 * j + 3]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int x = 0; x < 8; ++x)
          acc[i][8 * half + x] = acc[i][8 * half + x] * corr[i] + tile[i][x];
    }
    __syncthreads();  // P and V are read: the next tile may overwrite them
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + rg + 16 * i;
    if (row >= sq) continue;
    float* orow = o + (head * sq + row) * d + static_cast<int64_t>(chunk) * kDc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(orow + cg * 4 + 32 * j) = make_float4(
          static_cast<float>(acc[i][4 * j]), static_cast<float>(acc[i][4 * j + 1]),
          static_cast<float>(acc[i][4 * j + 2]), static_cast<float>(acc[i][4 * j + 3]));
    }
    if (chunk == 0 && cg == 0) {
      m_out[head * sq + row] = m_r[i];
      l_out[head * sq + row] = static_cast<float>(l_r[i]);
    }
  }
}

template <typename T>
cudaError_t launch_ffma(const void* q, const void* k, const void* v, const void* q_pos,
                   const void* k_pos, void* o, void* m, void* l, int64_t h,
                   int64_t sq, int64_t sk, int64_t d, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_partial_kernel<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((sq + kBq - 1) / kBq),
                  static_cast<unsigned>(h), static_cast<unsigned>(d / kDc));
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), sq, sk, d, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- wgmma_split

constexpr int kSplitBq = 128;        // q rows per CTA: two consumer warpgroups x 64
constexpr int kSplitBkv = 64;        // keys per KV tile
constexpr int kSplitD = 128;         // the head dim of this route
constexpr int kSplitThreads = 384;   // consumer warpgroups 0, 1; producer 2
constexpr int kSplitStages = 2;
constexpr int kPosBatch = 2;         // KV tiles whose positions the producer reads at once
constexpr uint32_t kBoxBytes = 64 * 128;               // one TMA box: 64 rows x 128 bytes
constexpr uint32_t kQSplitBytes = 3 * 2 * kBoxBytes;   // a warpgroup's q0, q1, q2
constexpr uint32_t kPSplitBytes = 3 * kBoxBytes;       // a warpgroup's p0, p1, p2
constexpr uint32_t kStageBytes = 4 * kBoxBytes;        // K's two boxes, then V's

// What the producer tells the consumers of the KV tile in a stage.
struct TileInfo {
  int tile;             // its index; -1 ends the walk
  int kmin, kmax;       // the least and largest position of its keys < sk (causal)
  int pad;              // keeps the struct 16-byte aligned: mbarriers follow it
  int kpos[kSplitBkv];  // the keys' positions, INT_MAX past sk (causal)
};

// Dynamic shared memory: 1024 bytes of alignment slack, the two warpgroups'
// Q splits and P splits, the stages, their TileInfo, two mbarriers per
// stage, the q-tile's row positions and each warpgroup's position range.
constexpr int kSplitSmemBytes =
    1024 + 2 * (kQSplitBytes + kPSplitBytes) +
    kSplitStages * (kStageBytes + sizeof(TileInfo) + 16) +
    kSplitBq * 4 + 2 * 2 * 2 * 4;

// Two values as three bf16 pairs (the first value in the low half): x =
// x0 + x1 + x2 + r with |r| <= 2^-24 |x|; each remainder x - x0, x - x0 - x1
// is exact in fp32.
__device__ __forceinline__ void split3(float a, float b, uint32_t& w0, uint32_t& w1,
                                       uint32_t& w2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(a, b);
  const float2 f0 = __bfloat1622float2(h0);
  const float ra = a - f0.x, rb = b - f0.y;
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(ra, rb);
  const float2 f1 = __bfloat1622float2(h1);
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(ra - f1.x, rb - f1.y);
  w0 = *reinterpret_cast<const uint32_t*>(&h0);
  w1 = *reinterpret_cast<const uint32_t*>(&h1);
  w2 = *reinterpret_cast<const uint32_t*>(&h2);
}

// The 128 threads of consumer warpgroup wg (named barrier wg + 1).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

__global__ void __launch_bounds__(kSplitThreads, 1)
flash_split_kernel(const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const float* __restrict__ q, const int* __restrict__ q_pos,
                   const int* __restrict__ k_pos, float* __restrict__ o,
                   float* __restrict__ m_out, float* __restrict__ l_out, int h,
                   int64_t sq, int64_t sk, int causal) {
  extern __shared__ uint8_t split_smem[];
  uint8_t* const base = split_smem + (1024 - smem_u32(split_smem) % 1024) % 1024;
  const uint32_t q_s = smem_u32(base);
  const uint32_t p_s = q_s + 2 * kQSplitBytes;
  const uint32_t kv_s = p_s + 2 * kPSplitBytes;
  TileInfo* const info = reinterpret_cast<TileInfo*>(base + (kv_s - q_s) +
                                                     kSplitStages * kStageBytes);
  const uint32_t full = smem_u32(info + kSplitStages);  // the stage's tiles landed
  const uint32_t empty = full + 8 * kSplitStages;        // the stage was read
  int* const qpos_s = reinterpret_cast<int*>(base + (empty - q_s) + 8 * kSplitStages);
  int* const qrange = qpos_s + kSplitBq;  // [warpgroup][warp 0, 1][min, max]

  const int64_t nqt = (sq + kSplitBq - 1) / kSplitBq;
  const int head = static_cast<int>(blockIdx.x % h);
  const int64_t q0 = (nqt - 1 - blockIdx.x / h) * kSplitBq;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSplitStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Row positions; rows past sq take INT_MIN (every key masked, never written).
  if (threadIdx.x < kSplitBq) {
    const int64_t row = q0 + threadIdx.x;
    qpos_s[threadIdx.x] = causal && row < sq ? q_pos[row] : INT_MIN;
  }
  __syncthreads();

  if (wg == 2) {  // the producer: warp 8 walks the KV tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x / 32 == 8) {
      const int lane = threadIdx.x % 32;
      int qmax = INT_MIN;
      if (causal) {
        for (int r = lane; r < kSplitBq; r += 32) qmax = max(qmax, qpos_s[r]);
        qmax = __reduce_max_sync(kFull, qmax);
      }
      const int64_t ntiles = (sk + kSplitBkv - 1) / kSplitBkv;
      int s = 0;
      uint32_t phase = 0;
      for (int64_t t0 = 0; t0 < ntiles; t0 += kPosBatch) {
        // The positions of kPosBatch tiles in one round trip: under a causal
        // mask most tiles of a short q-tile are skipped on them alone.
        int kp[kPosBatch][2];
#pragma unroll
        for (int u = 0; u < kPosBatch; ++u) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int64_t key = (t0 + u) * kSplitBkv + 32 * e + lane;
            kp[u][e] = causal && key < sk ? k_pos[key] : INT_MAX;
          }
        }
#pragma unroll
        for (int u = 0; u < kPosBatch; ++u) {
          const int64_t t = t0 + u;
          if (t >= ntiles) break;
          const int64_t k0 = t * kSplitBkv;
          int kmin = INT_MIN, kmax = INT_MAX;
          if (causal) {
            kmin = __reduce_min_sync(kFull, min(kp[u][0], kp[u][1]));
            if (kmin > qmax) continue;  // every key follows every row: never loaded
            kmax = __reduce_max_sync(kFull, max(k0 + lane < sk ? kp[u][0] : INT_MIN,
                                                k0 + 32 + lane < sk ? kp[u][1] : INT_MIN));
          }
          mbar_wait(empty + 8 * s, phase ^ 1);  // passes at once on round 0
          TileInfo& ti = info[s];
          if (causal) {
            ti.kpos[lane] = kp[u][0];
            ti.kpos[32 + lane] = kp[u][1];
          }
          if (lane == 0) {
            ti.tile = static_cast<int>(t);
            ti.kmin = kmin;
            ti.kmax = kmax;
          }
          __syncwarp();
          if (lane == 0) {
            __threadfence_block();  // the warp's TileInfo stores before the arrival
            const uint32_t dst = kv_s + s * kStageBytes;
            const int32_t key0 = static_cast<int32_t>(k0);
            mbar_expect_tx(full + 8 * s, kStageBytes);
            tma_load_3d(dst, &map_k, 0, key0, head, full + 8 * s);
            tma_load_3d(dst + kBoxBytes, &map_k, 64, key0, head, full + 8 * s);
            tma_load_3d(dst + 2 * kBoxBytes, &map_v, 0, key0, head, full + 8 * s);
            tma_load_3d(dst + 3 * kBoxBytes, &map_v, 64, key0, head, full + 8 * s);
          }
          if (++s == kSplitStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
      mbar_wait(empty + 8 * s, phase ^ 1);
      if (lane == 0) {
        info[s].tile = -1;
        __threadfence_block();
        mbar_arrive(full + 8 * s);
      }
    }
  } else {
    // The consumers: warpgroup wg owns rows r0 .. r0 + 63 of the q-tile; thread
    // (warp w, lane l) holds rows 16w + l/4 and + 8 (hh = 0, 1) and, in each
    // 8-column group j, columns 8j + 2(l%4) and + 1: register 4j + 2hh + e.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int64_t r0 = q0 + 64 * wg;
    const bool idle = r0 >= sq;  // the last q-tile's second half may hold no row
    uint8_t* const qw = base + wg * kQSplitBytes;  // box (part i, columns c) at (2i + c) * 8 KB
    const uint32_t qw_s = q_s + wg * kQSplitBytes;
    uint8_t* const pw = base + (p_s - q_s) + wg * kPSplitBytes;  // part i at i * 8 KB
    const uint32_t pw_s = p_s + wg * kPSplitBytes;

    // Q as q0, q1, q2, K-major in the 128-byte swizzle as TMA writes it: the
    // 16-byte chunk c of 128-byte row r at c ^ (r % 8), rows past sq zero.
    const float* const qh = q + static_cast<int64_t>(head) * sq * kSplitD;
    for (int u = tid; u < 64 * 16; u += 128) {
      const int r = u / 16, ch = u % 16;  // 8 columns of row r
      float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
      if (r0 + r < sq) {
        const float4* src = reinterpret_cast<const float4*>(qh + (r0 + r) * kSplitD + ch * 8);
        x0 = __ldg(src);
        x1 = __ldg(src + 1);
      }
      uint4 w[3];
      split3(x0.x, x0.y, w[0].x, w[1].x, w[2].x);
      split3(x0.z, x0.w, w[0].y, w[1].y, w[2].y);
      split3(x1.x, x1.y, w[0].z, w[1].z, w[2].z);
      split3(x1.z, x1.w, w[0].w, w[1].w, w[2].w);
      const uint32_t off = (ch / 8) * kBoxBytes + r * 128 + ((ch % 8) ^ (r % 8)) * 16;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        *reinterpret_cast<uint4*>(qw + 2 * i * kBoxBytes + off) = w[i];
      }
    }
    // The warpgroup's least and largest row position (rows < sq).
    if (warp < 2) {
      const bool ok = causal && r0 + 32 * warp + lane < sq;
      const int p = qpos_s[64 * wg + 32 * warp + lane];
      const int lo = __reduce_min_sync(kFull, ok ? p : INT_MAX);
      const int hi = __reduce_max_sync(kFull, ok ? p : INT_MIN);
      if (lane == 0) {
        qrange[4 * wg + 2 * warp] = lo;
        qrange[4 * wg + 2 * warp + 1] = hi;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // Q, seen by wgmma
    warpgroup_sync(wg);
    const int qmin = min(qrange[4 * wg], qrange[4 * wg + 2]);
    const int qmax = max(qrange[4 * wg + 1], qrange[4 * wg + 3]);

    // The running state: o (fp64, acc[half][register]), m and l per row.
    double acc[2][32];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[hf][x] = 0.0;
    }
    float m_r[2] = {-INFINITY, -INFINITY};
    double l_r[2] = {0.0, 0.0};

    int s = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(full + 8 * s, phase);
      const TileInfo& ti = info[s];
      const int t = ti.tile;
      if (t < 0) break;
      if (!idle && !(causal && ti.kmin > qmax)) {
        const int64_t k0 = static_cast<int64_t>(t) * kSplitBkv;
        const uint32_t kv = kv_s + s * kStageBytes;

        // 1. S = q2 K^T + q1 K^T + q0 K^T, 8 k-steps of 16 columns each.
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int i = 2; i >= 0; --i) {
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            wgmma<true, 64, false>(sc, sw128_desc(qw_s + (2 * i + kk / 4) * kBoxBytes) + 2 * (kk % 4),
                                   sw128_desc(kv + (kk / 4) * kBoxBytes) + 2 * (kk % 4),
                                   i < 2 || kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // 2. The mask, where the tile crosses sk or the diagonal.
        if (k0 + kSplitBkv > sk || (causal && ti.kmax > qmin)) {
          int qp[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) qp[hh] = qpos_s[64 * wg + 16 * warp + lane / 4 + 8 * hh];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * (lane % 4) + e;
              const int kp = causal ? ti.kpos[col] : 0;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                if (k0 + col >= sk || (causal && kp > qp[hh])) sc[4 * j + 2 * hh + e] = -INFINITY;
              }
            }
          }
        }

        // 3. The online softmax, the TPU kernel's update with its -inf guards.
        float corr[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            tmax = fmaxf(tmax, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
          }
          tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 2));
          const float new_m = fmaxf(m_r[hh], tmax);
          const float safe_m = is_finite(new_m) ? new_m : 0.f;
          corr[hh] = is_finite(m_r[hh]) ? expf(m_r[hh] - safe_m) : 0.f;
          float rsum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& p = sc[4 * j + 2 * hh + e];
              p = expf(p - safe_m);  // exp(-inf) = 0 where masked
              rsum += p;
            }
          }
          rsum += __shfl_xor_sync(kFull, rsum, 1);
          rsum += __shfl_xor_sync(kFull, rsum, 2);
          l_r[hh] = l_r[hh] * corr[hh] + rsum;  // exact where corr = 1 and rsum = 0
          m_r[hh] = new_m;
        }

        // 4. P as p0, p1, p2 into shared memory, K-major in the 128-byte
        // swizzle like Q: this thread's pair of keys 8c + 2(l%4) of row R
        // sits in chunk c ^ (R % 8); eight rows of a warp hit eight chunks.
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // Registers 8kk + 2r, + 1: row + 8 (r odd), keys 16kk + 8 (r > 1).
            const int row = 16 * warp + lane / 4 + 8 * (r & 1);
            const int chunk = 2 * kk + (r >> 1);
            uint32_t w[3];
            split3(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], w[0], w[1], w[2]);
            const uint32_t off = row * 128 + ((chunk ^ (row % 8)) * 16) + 4 * (lane % 4);
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              *reinterpret_cast<uint32_t*>(pw + i * kBoxBytes + off) = w[i];
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // P, seen by wgmma
        warpgroup_sync(wg);

        // 5., 6. P V by 64-column halves of d into a fresh tile, then the merge.
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float pv[32];
          const uint64_t dv = sw128_mn_desc(kv + (2 + hf) * kBoxBytes);
          wgmma_fence();
#pragma unroll
          for (int i = 2; i >= 0; --i) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              wgmma<true, 64, true>(pv, sw128_desc(pw_s + i * kBoxBytes) + 2 * kk, dv + 128 * kk,
                                    i < 2 || kk > 0);
            }
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(pv);
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            acc[hf][x] = fma(acc[hf][x], static_cast<double>(corr[(x / 2) % 2]),
                             static_cast<double>(pv[x]));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (++s == kSplitStages) {
        s = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t row = r0 + 16 * warp + lane / 4 + 8 * hh;
      if (row >= sq) continue;
      float* const orow = o + (static_cast<int64_t>(head) * sq + row) * kSplitD;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<float2*>(orow + 64 * hf + 8 * j + 2 * (lane % 4)) =
              make_float2(static_cast<float>(acc[hf][4 * j + 2 * hh]),
                          static_cast<float>(acc[hf][4 * j + 2 * hh + 1]));
        }
      }
      if (lane % 4 == 0) {
        m_out[static_cast<int64_t>(head) * sq + row] = m_r[hh];
        l_out[static_cast<int64_t>(head) * sq + row] = static_cast<float>(l_r[hh]);
      }
    }
  }
}

// ---------------------------------------------------------------- host

// Route codes, as ops/cuda_attention.py::ROUTE_CODES.
enum Route { kWgmmaSplit = 0, kFfma = 1 };

// bf16 (h, sk, 128) K or V as a 3-D TMA map (d, sk, h) with a (64, 64, 1)
// box: 128 bytes of 64 keys of one head, the 128-byte swizzle, zeros past sk.
cudaError_t encode_kv_map(CUtensorMap* map, const void* ptr, int64_t h, int64_t sk) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kSplitD), static_cast<cuuint64_t>(sk),
                              static_cast<cuuint64_t>(h)};
  const cuuint64_t strides[2] = {kSplitD * 2, static_cast<cuuint64_t>(sk) * kSplitD * 2};
  const cuuint32_t box[3] = {64, kSplitBkv, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                        dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_split(const void* q, const void* k, const void* v, const void* q_pos,
                         const void* k_pos, void* o, void* m, void* l, int64_t h,
                         int64_t sq, int64_t sk, int causal, cudaStream_t stream) {
  const int64_t blocks = (sq + kSplitBq - 1) / kSplitBq * h;
  if (blocks > INT_MAX || sk > INT_MAX) return cudaErrorInvalidConfiguration;
  CUtensorMap map_k, map_v;
  cudaError_t err = encode_kv_map(&map_k, k, h, sk);
  if (err == cudaSuccess) err = encode_kv_map(&map_v, v, h, sk);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_split_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSplitSmemBytes);
  }
  if (err != cudaSuccess) return err;
  const float* qf = static_cast<const float*>(q);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  float* of = static_cast<float*>(o);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  int hi = static_cast<int>(h);
  void* args[] = {&map_k, &map_v, &qf, &qp, &kp, &of, &mf, &lf, &hi, &sq, &sk, &causal};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(flash_split_kernel),
                         dim3(static_cast<unsigned>(blocks)), dim3(kSplitThreads), args,
                         kSplitSmemBytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// route: 0 wgmma_split (dtype 0 and d = 128 only), 1 ffma; dtype of k and
// v: 0 bf16, 2 fp32 (the GEMV's codes); q, o, m, l are fp32. q (h, sq, d),
// k and v (h, sk, d), o (h, sq, d), m and l (h, sq), all row-major,
// contiguous and 16-byte aligned; q_pos (sq,) and k_pos (sk,) int32, read
// only when causal != 0. Launches on `stream` and returns
// cudaGetLastError() after the launch; a route the shape or dtype does not
// take is refused with cudaErrorInvalidValue (nothing falls back).
extern "C" int matvec_flash_partial(int route, int dtype, const void* q, const void* k,
                                    const void* v, const void* q_pos,
                                    const void* k_pos, void* o, void* m, void* l,
                                    int64_t h, int64_t sq, int64_t sk, int64_t d,
                                    int causal, void* stream) {
  if (h < 1 || h > 65535 || sq < 1 || sk < 1 || d < kDc || d % kDc != 0 ||
      d / kDc > 65535 || (sq + kBq - 1) / kBq > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kWgmmaSplit) {
    if (dtype != 0 || d != kSplitD) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_split(q, k, v, q_pos, k_pos, o, m, l, h, sq, sk,
                                         causal, s));
  }
  if (route != kFfma) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_ffma<__nv_bfloat16>(q, k, v, q_pos, k_pos, o, m, l,
                                                         h, sq, sk, d, causal, s));
    case 2:
      return static_cast<int>(launch_ffma<float>(q, k, v, q_pos, k_pos, o, m, l, h, sq,
                                                 sk, d, causal, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A route's launch shape, for reports: out[0] registers per thread, out[1]
// dynamic and out[2] static shared-memory bytes per CTA, out[3] threads per
// CTA, out[4] q rows per CTA. Returns a cudaError_t code.
extern "C" int matvec_flash_launch_info(int route, int dtype, int* out) {
  const void* fn = nullptr;
  if (route == kWgmmaSplit && dtype == 0) {
    fn = reinterpret_cast<const void*>(flash_split_kernel);
    out[1] = kSplitSmemBytes, out[3] = kSplitThreads, out[4] = kSplitBq;
  } else if (route == kFfma && (dtype == 0 || dtype == 2)) {
    fn = dtype == 0 ? reinterpret_cast<const void*>(flash_partial_kernel<__nv_bfloat16>)
                    : reinterpret_cast<const void*>(flash_partial_kernel<float>);
    out[1] = kSmemBytes, out[3] = kThreads, out[4] = kBq;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaSuccess);
}
