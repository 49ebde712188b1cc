// Hand-written ring reduce-scatter GEMV for Hopper (sm_90a): the whole
// p-step ring walk of colwise's combine="pallas_ring" in one kernel.
//
// Replaces the TPU kernel matvec_mpi_multiplier_tpu/ops/pallas_collective.py::
// _ring_gemv_kernel. There, each of p devices holds an (m, k/p) column panel
// A_d and its x segment x_d; at every ring step it starts an async remote
// DMA of its accumulator to the right neighbour, computes the next (m/p, k/p)
// tile under it, waits, and adds. Device d ends holding chunk d of y = A x.
//
// What it computes: let t_d(c) be rank d's tile for chunk c, rows
// [c*m/p, (c+1)*m/p) of A_d times x_d in the accumulator type. Output chunk d
// is the ring sum ((t_{d+1}(d) + t_{d+2}(d)) + ...) + t_d(d), ranks mod p, the
// order of parallel/ring.py::_ring_reduce, written to rank d's y_d (m/p,) in
// the accumulator type (float for bf16/fp16/fp32, double for fp64). At
// p == 1 it is the plain panel GEMV.
//
// Design. The port's mesh holds p logical ranks on one card, so the ring
// runs inside one thread block cluster of p CTAs: CTA rank d in the cluster
// is logical rank d. Cluster j owns rows [j*R, (j+1)*R) of every chunk
// (R = 8 rows, one warp each), so there are ceil((m/p)/R) clusters. Each CTA
// keeps a double-buffered (2, R) accumulator in shared memory, as the TPU
// kernel's comm scratch. Step 0 computes t_d(d-1) into slot 0. At step s it
//   1. stores its send slot s%2 into the right neighbour's receive slot
//      (s+1)%2 through distributed shared memory (cluster.map_shared_rank),
//   2. computes t_d(d-2-s) into registers: the overlap window is the DSMEM
//      store issued before the tile's loads, as the TPU kernel's is the DMA
//      in flight under the tile,
//   3. crosses the cluster barrier (arrive.release / wait.acquire, in place
//      of the DMA semaphores) and adds the tile into its receive slot.
// One barrier per step orders every hazard: a slot is sent before the
// barrier of step s and overwritten only after it, and a received value is
// stored before the barrier and read only after it. A cluster barrier before
// the first store makes sure every CTA of the cluster has started (its
// shared memory exists), the TPU kernel's barrier semaphore. The hardware
// co-schedules a cluster's CTAs, so no CTA waits on a neighbour that has not
// been placed: flags in global memory under a plain launch could deadlock.
// Rows past m/p (the last cluster of a ragged chunk) compute nothing but
// still cross every barrier.
//
// Each tile row is gemv.cu's loop: one warp per row, 16-byte streaming loads
// of A where the row and x are 16-byte aligned (k/p * itemsize need not be a
// multiple of 16: 1542-byte bf16 rows at p = 8, k = 6168) and a scalar path
// otherwise, a fixed shuffle tree. No atomics, no split-K: the result is
// bitwise repeatable.
//
// What bounds it: HBM bytes, the same as one GEMV of the whole A:
//   m*k*itemsize + k*itemsize + m*acc_itemsize  (k = p * k/p),
// 2.56 ms at 65536^2 bf16 on 3.35 TB/s. The walk adds p-1 cluster barriers
// and p-1 DSMEM stores of R accumulators per CTA, no HBM traffic.
//
// Limits: a cluster holds at most 8 CTAs portably, 16 with
// cudaFuncAttributeNonPortableClusterSizeAllowed; the wrapper raises above
// 16. The TPU kernel's own limit (the panel must fit in VMEM) does not bind:
// the panel streams from HBM. The multi-card form (NVLink peer memory or
// NVSHMEM, one rank per card) waits for real multi-card meshes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kRows = 8;  // rows of each chunk per cluster: one warp each
constexpr int kMaxRanks = 16;

struct RingPtrs {
  const void* a[kMaxRanks];
  const void* x[kMaxRanks];
  void* y[kMaxRanks];
};

__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

// One row of A times x, by the whole warp; the sum is valid in lane 0.
template <typename T, typename Acc>
__device__ __forceinline__ Acc row_dot(const T* __restrict__ arow,
                                       const T* __restrict__ x, int64_t k,
                                       int lane) {
  constexpr int kVec = 16 / sizeof(T);
  Acc acc = Acc(0);
  int64_t done = 0;
  const uintptr_t misalign =
      (reinterpret_cast<uintptr_t>(arow) | reinterpret_cast<uintptr_t>(x)) % 16;
  if (misalign == 0) {
    const int64_t nvec = k / kVec;
    const uint4* av = reinterpret_cast<const uint4*>(arow);
    const uint4* xv = reinterpret_cast<const uint4*>(x);
#pragma unroll 4
    for (int64_t i = lane; i < nvec; i += kWarp) {
      const uint4 pa = __ldcs(av + i);
      const uint4 px = __ldg(xv + i);
      const T* ea = reinterpret_cast<const T*>(&pa);
      const T* ex = reinterpret_cast<const T*>(&px);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        acc += static_cast<Acc>(widen(ea[e])) * static_cast<Acc>(widen(ex[e]));
      }
    }
    done = nvec * kVec;
  }
  for (int64_t j = done + lane; j < k; j += kWarp) {
    acc += static_cast<Acc>(widen(arow[j])) * static_cast<Acc>(widen(x[j]));
  }
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
    acc += __shfl_down_sync(0xffffffffu, acc, offset);
  }
  return acc;
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kWarp * kRows)
ring_gemv_kernel(RingPtrs ptrs, int64_t m, int64_t k, int p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int d = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t chunk = m / p;
  const int64_t row = static_cast<int64_t>(blockIdx.x / p) * kRows + warp;
  const bool valid = row < chunk;  // warp-uniform

  __shared__ Acc comm[2][kRows];
  const T* a = static_cast<const T*>(ptrs.a[d]);
  const T* x = static_cast<const T*>(ptrs.x[d]);

  // This rank's tile for chunk c (0 <= c < p), this warp's row of it.
  auto tile = [&](int c) -> Acc {
    return valid ? row_dot<T, Acc>(a + (c * chunk + row) * k, x, k, lane) : Acc(0);
  };

  Acc first = tile((d - 1 + p) % p);
  if (lane == 0) comm[0][warp] = first;
  cluster.sync();  // every CTA of the cluster runs: its shared memory exists
  Acc* right = cluster.map_shared_rank(&comm[0][0], (d + 1) % p);
  for (int s = 0; s < p - 1; ++s) {
    const int send = s & 1, recv = send ^ 1;
    if (lane == 0) right[recv * kRows + warp] = comm[send][warp];
    const Acc t = tile((d - 2 - s + 2 * p) % p);
    cluster.sync();  // the left neighbour's store into comm[recv] is visible
    if (lane == 0) comm[recv][warp] += t;
  }
  if (lane == 0 && valid) static_cast<Acc*>(ptrs.y[d])[row] = comm[(p - 1) & 1][warp];
}

template <typename T, typename Acc>
cudaError_t launch(const RingPtrs& ptrs, int p, int64_t m, int64_t k,
                   cudaStream_t stream) {
  auto kernel = ring_gemv_kernel<T, Acc>;
  if (p > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  const int64_t clusters = (m / p + kRows - 1) / kRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * p), 1, 1);
  cfg.blockDim = dim3(kWarp * kRows, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, ptrs, m, k, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 bf16, 1 fp16, 2 fp32, 3 fp64 (y is fp32, fp32, fp32, fp64).
// a[d] is rank d's (m, k) panel, row-major and contiguous, x[d] its (k,)
// segment, y[d] its (m/p,) output chunk; k is the panel width k/p. Launches
// on `stream` and returns cudaGetLastError() after the launch.
extern "C" int matvec_ring_gemv(int dtype, int p, const void* const* a,
                                const void* const* x, void* const* y,
                                int64_t m, int64_t k, void* stream) {
  if (p < 1 || p > kMaxRanks || m <= 0 || k < 0 || m % p != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((m / p + kRows - 1) / kRows * p > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  RingPtrs ptrs = {};
  for (int d = 0; d < p; ++d) {
    ptrs.a[d] = a[d];
    ptrs.x[d] = x[d];
    ptrs.y[d] = y[d];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<__nv_bfloat16, float>(ptrs, p, m, k, s));
    case 1: return static_cast<int>(launch<__half, float>(ptrs, p, m, k, s));
    case 2: return static_cast<int>(launch<float, float>(ptrs, p, m, k, s));
    case 3: return static_cast<int>(launch<double, double>(ptrs, p, m, k, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
