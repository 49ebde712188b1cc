// Hand-written flash-attention partial for Hopper (sm_90a): scores, online
// softmax and the weighted-V product of one Q block against one KV block, the
// score tile never leaving the SM.
//
// Replaces the TPU kernel matvec_mpi_multiplier_tpu/ops/pallas_attention.py::
// _flash_kernel. There, a grid (h, sq/512, sk/512) runs in order on one core
// and carries the running (acc, m, l) state in VMEM scratch across the KV
// steps of each (head, q-block).
//
// What it computes, per head and query row (q pre-scaled, fp32):
//   s[k]     = q . k_k                         (-inf where masked)
//   m        = max_k s[k]                      (-inf if every key is masked)
//   l        = sum_k exp(s[k] - m)
//   o_unnorm = sum_k exp(s[k] - m) * v_k
// with the causal mask k_pos <= q_pos by the global position vectors the
// caller passes (the ring hands a device KV blocks from elsewhere in the
// sequence). A fully masked row comes back as m = -inf, l = 0, o = 0, by the
// TPU kernel's guards: safe_m = m where finite else 0, and the correction of
// the old state is 0 where the old m is -inf.
//
// Design. One CTA of 128 threads per (q-tile of 64 rows, head, 128-column
// chunk of d); d > 128 runs d/128 CTAs per q-tile, each recomputing the
// scores and writing its own columns of o (chunk 0 writes m and l). Blocks
// on Hopper run in parallel and in no order, so the TPU grid's sequential KV
// axis becomes a loop inside the CTA over KV tiles of 64 rows, and the
// running state lives in registers: 16 o values and one (m, l) pair for each
// of a thread's 4 rows, o and l in fp64. Per KV tile:
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
// fp32 FFMA for both products, not a bf16 wgmma (P rounded to 2^-8) or TF32
// (2^-11): the TPU kernel multiplies in fp32, and the bar is 2e-5 of the
// exact partial. The running sums are fp64 because in fp32 their merge, one
// rounding per KV tile at the size of the whole sum, took the kernel past
// that bar at (2, 16384, 16384, 128) on an H100 in bring-up; the 64 DFMA per
// tile and thread cost little beside the 8192 FFMA. expf, not __expf. Under a causal mask a KV tile whose every key
// lies after every row of the q-tile is skipped (one __syncthreads_or vote):
// it would leave o, m and l bitwise unchanged (corr = 1, p = 0). Nothing else
// is skipped. No atomics, no split of KV across CTAs: two launches on the
// same inputs are bitwise equal.
//
// What bounds it: operations. 4 d flops per unmasked (q, k) pair in fp32
// FFMA (67 TFLOP/s): at the ring's hop shape (8, 4096, 4096, 128) 68.7
// GFLOP, 1.03 ms, against 48 MB of traffic (0.014 ms at 3.35 TB/s). A
// wgmma/3xTF32 route, TMA and double-buffered KV tiles are later work.
//
// Shared memory: Q and K tiles 64 x 132 floats each, V 64 x 128, 100.6 KB,
// so two CTAs fit on an SM (opt-in above 48 KB with cudaFuncSetAttribute).
// Rows past sq and keys past sk are zero-filled and masked, so any sq >= 1,
// sk >= 1 and d % 128 == 0 run; the wrapper raises on the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kBq = 64;               // q rows per CTA
constexpr int kBkv = 64;              // keys per KV tile
constexpr int kDc = 128;              // head-dim columns per chunk
constexpr int kQkPitch = kDc + 4;     // Q and K tiles: conflict-free float4 rows
constexpr int kPPitch = kBkv + 4;     // P tile, over the K tile
constexpr int kVPitch = kDc;
constexpr int kSmemBytes =
    (kBq * kQkPitch + kBkv * kQkPitch + kBkv * kVPitch) * 4 + kBkv * 4 + 4 * 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) < INFINITY; }

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
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_pos,
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

}  // namespace

// dtype of k and v: 0 bf16, 2 fp32 (the GEMV's codes); q, o, m, l are fp32.
// q (h, sq, d), k and v (h, sk, d), o (h, sq, d), m and l (h, sq), all
// row-major, contiguous and 16-byte aligned; q_pos (sq,) and k_pos (sk,)
// int32, read only when causal != 0. Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int matvec_flash_partial(int dtype, const void* q, const void* k,
                                    const void* v, const void* q_pos,
                                    const void* k_pos, void* o, void* m, void* l,
                                    int64_t h, int64_t sq, int64_t sk, int64_t d,
                                    int causal, void* stream) {
  if (h < 1 || h > 65535 || sq < 1 || sk < 1 || d < kDc || d % kDc != 0 ||
      d / kDc > 65535 || (sq + kBq - 1) / kBq > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<__nv_bfloat16>(q, k, v, q_pos, k_pos, o, m, l,
                                                    h, sq, sk, d, causal, s));
    case 2:
      return static_cast<int>(launch<float>(q, k, v, q_pos, k_pos, o, m, l, h, sq,
                                            sk, d, causal, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
