// Hand-written GEMV for Hopper (sm_90a): y[m] = sum_k A[m, k] * x[k].
//
// Replaces the TPU kernel matvec_mpi_multiplier_tpu/ops/pallas_gemv.py::
// _gemv_kernel, which walks a sequential (m/bm, k/bk) grid and carries each
// row block's partial sums in its output block across the k axis. Hopper has
// no ordered grid, so the k walk becomes a loop inside one warp: one warp owns
// one row, eight warps (eight rows) per block.
//
// What bounds it: HBM bytes. A GEMV does 2 flops per element of A it reads,
// far below the card's ridge, so the least time is
//   (m*k*itemsize + k*itemsize + m*acc_itemsize) / HBM rate.
// What the design does about it: the A stream is read once, in 16-byte
// vector loads with neighbouring lanes on neighbouring addresses (a warp
// moves 512 contiguous bytes per load), marked streaming (__ldcs) so it does
// not evict x, which every warp re-reads through the read-only path (__ldg).
//
// x has A's type, or for the fused solver step (matvec_gemv_acc_x) the
// accumulator type.
//
// Numerics: the accumulator is float for bf16/fp16/fp32 input and double
// for fp64 input, and y is written in the accumulator type (the registry's
// contract, ops/gemv.py). Each lane sums a fixed set of elements in a fixed
// order and the warp reduction is a fixed shuffle tree: no atomics, no
// split-K, so the result is bitwise the same from run to run.
//
// Rows whose start (or an x) is not 16-byte aligned, e.g. k = 3001 in bf16,
// take the scalar path, as does the tail of k past the last whole vector.
// Every shape is covered, so the cuda tier has no library fallback.
//
// Left for later: more rows in flight per warp, cp.async/TMA staging of x in
// shared memory, and a deterministic two-pass split-K for short-m shapes
// (120 x 60000 launches only 120 warps).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

template <typename T, typename X, typename Acc>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gemv_kernel(const T* __restrict__ a, const X* __restrict__ x,
            Acc* __restrict__ y, int64_t m, int64_t k) {
  constexpr int kVec = 16 / sizeof(T);
  // 16-byte loads of x per vector of A: 1 when x has A's type, 2 for bf16 or
  // fp16 A against an fp32 x.
  constexpr int kXVec = kVec * sizeof(X) / 16;
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= m) return;  // the whole warp leaves together: row is warp-uniform

  const T* arow = a + row * k;
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
      uint4 px[kXVec];
#pragma unroll
      for (int j = 0; j < kXVec; ++j) px[j] = __ldg(xv + i * kXVec + j);
      const T* ea = reinterpret_cast<const T*>(&pa);
      const X* ex = reinterpret_cast<const X*>(px);
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
  if (lane == 0) y[row] = acc;
}

template <typename T, typename X, typename Acc>
cudaError_t launch(const void* a, const void* x, void* y, int64_t m, int64_t k,
                   cudaStream_t stream) {
  const int64_t blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gemv_kernel<T, X, Acc><<<static_cast<unsigned>(blocks), kWarp * kWarpsPerBlock,
                           0, stream>>>(static_cast<const T*>(a),
                                        static_cast<const X*>(x),
                                        static_cast<Acc*>(y), m, k);
  return cudaGetLastError();
}

// cudaSuccess for a shape the kernel takes, else the error to return.
cudaError_t check_shape(int64_t m, int64_t k) {
  if (m <= 0 || k < 0) return cudaErrorInvalidValue;
  if ((m + kWarpsPerBlock - 1) / kWarpsPerBlock > INT_MAX) {
    return cudaErrorInvalidConfiguration;
  }
  return cudaSuccess;
}

}  // namespace

// dtype: 0 bf16, 1 fp16, 2 fp32, 3 fp64 (y is fp32, fp32, fp32, fp64).
// A is (m, k) row-major and contiguous, x is (k,), y is (m,). Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int matvec_gemv(int dtype, const void* a, const void* x, void* y,
                           int64_t m, int64_t k, void* stream) {
  if (const cudaError_t bad = check_shape(m, k)) return static_cast<int>(bad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<__nv_bfloat16, __nv_bfloat16, float>(a, x, y, m, k, s));
    case 1: return static_cast<int>(launch<__half, __half, float>(a, x, y, m, k, s));
    case 2: return static_cast<int>(launch<float, float, float>(a, x, y, m, k, s));
    case 3: return static_cast<int>(launch<double, double, double>(a, x, y, m, k, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same GEMV with x in the ACCUMULATOR type (fp32 for bf16/fp16/fp32 A,
// fp64 for fp64 A): the fused solver step (csrc/solver_step.cu) multiplies
// A by its fp32 direction vector without casting it to A's dtype first.
extern "C" int matvec_gemv_acc_x(int dtype, const void* a, const void* x, void* y,
                                 int64_t m, int64_t k, void* stream) {
  if (const cudaError_t bad = check_shape(m, k)) return static_cast<int>(bad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<__nv_bfloat16, float, float>(a, x, y, m, k, s));
    case 1: return static_cast<int>(launch<__half, float, float>(a, x, y, m, k, s));
    case 2: return static_cast<int>(launch<float, float, float>(a, x, y, m, k, s));
    case 3: return static_cast<int>(launch<double, double, double>(a, x, y, m, k, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* matvec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
