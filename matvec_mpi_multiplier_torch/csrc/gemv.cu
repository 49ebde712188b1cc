// Hand-written GEMV for Hopper (sm_90a): y[m] = sum_k A[m, k] * x[k].
//
// Replaces the TPU kernel matvec_mpi_multiplier_tpu/ops/pallas_gemv.py::
// _gemv_kernel (:61, its pallas_call at :95), which walks a sequential
// (m/bm, k/bk) grid and carries each row block's partial sums in its output
// block across the k axis. Hopper has no ordered grid, so the k walk becomes
// a loop inside a warp, and where the rows are too few to keep the card
// busy, the walk is cut into slabs spread over every resident warp.
//
// What bounds it: HBM bytes. A GEMV does 2 flops per element of A it reads,
// far below the card's ridge, so the least time is
//   (m*k*itemsize + k*itemsize + m*acc_itemsize) / HBM rate.
// Meeting that rate takes loads in flight (Little's law: 3.35 TB/s times
// about 1 us of loaded HBM latency is some 3 MB across the card). Every warp
// here keeps a batch of kBatch = 8 16-byte loads of A per lane in flight
// (4 KB a warp, neighbouring lanes on neighbouring addresses, marked
// streaming (__ldcs) so A does not evict x, which every warp re-reads
// through the read-only path (__ldg)). At 128 registers a thread two blocks
// of eight warps fit an SM: 132 SMs x 16 warps x 4 KB = 8.6 MB at most. The
// plan (ops/cuda_gemv.py::gemv_plan) picks how many warps stream:
//
// * rows: one warp per row, eight rows per block, for m of at least four
//   warps an SM (m >= 528 on 132 SMs: 2.1 MB in flight and up). One launch.
//   The card set this line: from 600 rows of 60000 (fp32) one warp per row
//   ran faster than the split below with its 8.6 MB in flight. So the
//   figure the plan keeps is 2 MiB in flight wherever A holds that much.
// * split, for fewer rows: the m * slabs (row, slab) units in row order are
//   cut into one contiguous run per warp of a grid of two blocks per SM
//   (runs differ by at most one unit), each unit's partial goes to a scratch
//   the wrapper allocates (m * slabs accumulators), and a second launch sums
//   each row's partials in slab order, one thread per row. The second launch
//   is a programmatic dependent launch: it is scheduled while the first
//   streams A and waits (griddepcontrol.wait) for its stores. No atomics.
//   At 120 x 60000 bf16 that is 960 units on 960 warps, 3.75 MB in flight,
//   where one warp per row had 0.25 MB.
//   A one-launch design (a row's slabs spread over a thread block cluster,
//   reduced through distributed shared memory) was measured beside it on
//   the card: equal at 120 and 240 rows, 4-9% slower from 360 to 720 rows
//   (bf16) and at 120 rows in fp64, where its blocks of one slab per warp
//   turn over in waves the persistent grid does not have.
//
// Numerics, one association for every route and grid: the accumulator is
// float for bf16/fp16/fp32 input and double for fp64 (y is written in it,
// the registry's contract, ops/gemv.py). A row is cut into slabs of
// kSlabBytes of A (8192 bf16, 4096 fp32, 2048 fp64 elements: the dtype
// alone sets the length). A slab's partial is lane l's fresh FMA sum over
// the slab's 16-byte chunks l, l + 32, ..., each chunk's elements in order,
// then a fixed xor butterfly over the lanes (every lane ends with the same
// value). y is the slab partials summed in slab order. Whether a slab is
// read in 16-byte vectors (row and x 16-byte aligned) or element by element
// (e.g. k = 3001 in bf16) changes the loads, never the order. So y is
// bitwise the same whatever route or grid the plan picks, from run to run,
// and a row slice of A gives bitwise the full call's rows.
//
// x has A's type, or for the fused solver step (matvec_gemv_acc_x) the
// accumulator type. Every shape is covered (m = 1, k shorter than a slab,
// misaligned rows, fp64), so the cuda tier has no library fallback.
//
// Limits: a row's slab is one warp's, so a shape of few short rows (m = 1,
// k = 60000: 8 slabs in bf16) keeps few warps busy; such a call is small.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;       // warps per block, either route
constexpr int kSlabBytes = 16384;  // bytes of A per slab, whatever the dtype
constexpr int kBatch = 8;          // 16-byte loads of A a lane has in flight
constexpr int kMinBlocks = 2;      // resident blocks per SM: at most 128 registers
constexpr int kSumThreads = 256;   // split's second launch: threads (rows) per block

enum Route { kRows = 0, kSplit = 1 };

// The plan's codes (ops/cuda_gemv.py::GemvPlan.codes): the route, the
// grid of the (first) launch and its warps per block.
struct Plan {
  int route, grid, warps;
};

__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

template <typename T, typename X, typename Acc>
__device__ __forceinline__ Acc fma_elem(T a, X x, Acc acc) {
  return fma_acc(static_cast<Acc>(widen(a)), static_cast<Acc>(widen(x)), acc);
}

// The warp's sum by a fixed xor butterfly; every lane gets the same value
// (each step adds the same two numbers in both lanes of a pair).
template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// The partial of one slab of `len` elements (len <= kSlabBytes / sizeof(T))
// starting at a and x: lane l sums the 16-byte chunks l, l + 32, ... in
// order, each chunk's elements in order, then warp_sum. `vec` (slab and x
// 16-byte aligned) picks vector loads; the order is the same either way.
template <typename T, typename X, typename Acc>
__device__ __forceinline__ Acc slab_partial(const T* __restrict__ a,
                                            const X* __restrict__ x, int len,
                                            bool vec, int lane) {
  constexpr int kVec = 16 / sizeof(T);
  // 16-byte loads of x per chunk of A: 1 when x has A's type, 2 for bf16 or
  // fp16 A against an fp32 x.
  constexpr int kXVec = kVec * sizeof(X) / 16;
  Acc acc = Acc(0);
  const int whole = len / kVec;  // whole chunks; a ragged one may follow
  if (vec) {
    const uint4* av = reinterpret_cast<const uint4*>(a);
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int t0 = 0; t0 * kWarp < whole; t0 += kBatch) {
      uint4 pa[kBatch];
      uint4 px[kBatch][kXVec];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = lane + (t0 + u) * kWarp;
        if (c < whole) {
          pa[u] = __ldcs(av + c);
#pragma unroll
          for (int j = 0; j < kXVec; ++j) px[u][j] = __ldg(xv + c * kXVec + j);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = lane + (t0 + u) * kWarp;
        if (c < whole) {
          const T* ea = reinterpret_cast<const T*>(&pa[u]);
          const X* ex = reinterpret_cast<const X*>(px[u]);
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc = fma_elem(ea[e], ex[e], acc);
        }
      }
    }
    // The ragged chunk is the slab's last, so its lane takes it last.
    if (lane == whole % kWarp) {
      for (int j = whole * kVec; j < len; ++j) acc = fma_elem(a[j], x[j], acc);
    }
  } else {
    const int chunks = (len + kVec - 1) / kVec;
    for (int c = lane; c < chunks; c += kWarp) {
      const int end = len < (c + 1) * kVec ? len : (c + 1) * kVec;
      for (int j = c * kVec; j < end; ++j) acc = fma_elem(a[j], x[j], acc);
    }
  }
  return warp_sum(acc);
}

template <typename T, typename X>
__device__ __forceinline__ bool aligned16(const T* a, const X* x) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(x)) % 16) == 0;
}

// A launch's device predicate: NULL runs the kernel; otherwise the kernel
// returns at once when the byte it points to is 0 (a torch.bool on the card,
// written by earlier work on the stream). A graph-captured loop passes the
// flag of an iteration that may be inactive, so a skipped iteration streams
// no A. The flag is uniform across the grid, so whole blocks leave together.
__device__ __forceinline__ bool off(const unsigned char* pred) {
  return pred != nullptr && *pred == 0;
}

// Slab s of row `arow`: its partial.
template <typename T, typename X, typename Acc>
__device__ __forceinline__ Acc row_slab(const T* arow, const X* x, int64_t k, int64_t s,
                                        int lane) {
  constexpr int64_t kSlab = kSlabBytes / sizeof(T);
  const int64_t s0 = s * kSlab;
  const int len = static_cast<int>(min64(kSlab, k - s0));
  return slab_partial<T, X, Acc>(arow + s0, x + s0, len, aligned16(arow + s0, x + s0), lane);
}

// rows: warp w of block b owns row b * warps + w and sums its slabs in order.
template <typename T, typename X, typename Acc>
__global__ void __launch_bounds__(kWarp * kMaxWarps, kMinBlocks)
gemv_rows(const T* __restrict__ a, const X* __restrict__ x, Acc* __restrict__ y,
          int64_t m, int64_t k, const unsigned char* __restrict__ pred) {
  if (off(pred)) return;
  constexpr int64_t kSlab = kSlabBytes / sizeof(T);
  const int lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) +
                      threadIdx.x / kWarp;
  if (row >= m) return;  // the whole warp leaves together: row is warp-uniform
  const T* arow = a + row * k;
  const int64_t slabs = (k + kSlab - 1) / kSlab;
  Acc sum = Acc(0);
  for (int64_t s = 0; s < slabs; ++s) {
    const Acc p = row_slab<T, X, Acc>(arow, x, k, s, lane);
    sum = s == 0 ? p : sum + p;
  }
  if (lane == 0) y[row] = sum;
}

// split, pass 1: the m * slabs (row, slab) units in row-major order, cut into
// one contiguous run per warp of the grid (their lengths differ by at most
// one); each unit's partial goes to part[unit]. It lets the sum's launch
// begin at once (programmatic dependent launch), so that launch is under
// way while this one streams A.
template <typename T, typename X, typename Acc>
__global__ void __launch_bounds__(kWarp * kMaxWarps, kMinBlocks)
gemv_slabs(const T* __restrict__ a, const X* __restrict__ x, Acc* __restrict__ part,
           int64_t m, int64_t k, const unsigned char* __restrict__ pred) {
  constexpr int64_t kSlab = kSlabBytes / sizeof(T);
  asm volatile("griddepcontrol.launch_dependents;");
  if (off(pred)) return;
  const int lane = threadIdx.x % kWarp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / kWarp);
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int64_t slabs = (k + kSlab - 1) / kSlab;
  const int64_t units = m * slabs;
  const int64_t end = units * (w + 1) / warps;
  for (int64_t u = units * w / warps; u < end; ++u) {
    const int64_t row = u / slabs;
    const Acc p = row_slab<T, X, Acc>(a + row * k, x, k, u - row * slabs, lane);
    if (lane == 0) part[u] = p;
  }
}

// split, pass 2: one thread per row sums its slab partials in slab order,
// once pass 1 has finished and its stores are visible (griddepcontrol.wait).
template <typename Acc>
__global__ void __launch_bounds__(kSumThreads)
gemv_sum(const Acc* __restrict__ part, Acc* __restrict__ y, int64_t m, int64_t slabs,
         const unsigned char* __restrict__ pred) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (off(pred)) return;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const Acc* p = part + row * slabs;
  Acc sum = p[0];
  for (int64_t s = 1; s < slabs; ++s) sum += p[s];
  y[row] = sum;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// cudaSuccess for a plan the kernels take on this shape, else the error.
template <typename T>
cudaError_t check_plan(const Plan& p, int64_t m, int64_t k, const void* scratch) {
  if (m <= 0 || k < 0 || p.warps < 1 || p.warps > kMaxWarps || p.grid < 1) {
    return cudaErrorInvalidValue;
  }
  if (p.route == kRows) {
    if (ceil_div(m, p.warps) > INT_MAX) return cudaErrorInvalidConfiguration;
    return p.grid == ceil_div(m, p.warps) ? cudaSuccess : cudaErrorInvalidValue;
  }
  if (p.route != kSplit || scratch == nullptr || k == 0) return cudaErrorInvalidValue;
  return ceil_div(m, kSumThreads) > INT_MAX ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <typename T, typename X, typename Acc>
cudaError_t launch(const Plan& p, const void* a, const void* x, void* y, void* scratch,
                   int64_t m, int64_t k, cudaStream_t stream, const void* pred_ptr) {
  const unsigned char* pred = static_cast<const unsigned char*>(pred_ptr);
  if (const cudaError_t bad = check_plan<T>(p, m, k, scratch)) return bad;
  const T* ca = static_cast<const T*>(a);
  const X* cx = static_cast<const X*>(x);
  Acc* cy = static_cast<Acc*>(y);
  if (p.route == kRows) {
    gemv_rows<T, X, Acc><<<p.grid, kWarp * p.warps, 0, stream>>>(ca, cx, cy, m, k, pred);
    return cudaGetLastError();
  }
  Acc* part = static_cast<Acc*>(scratch);
  gemv_slabs<T, X, Acc><<<p.grid, kWarp * p.warps, 0, stream>>>(ca, cx, part, m, k, pred);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ceil_div(m, kSumThreads)), 1, 1);
  cfg.blockDim = dim3(kSumThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  constexpr int64_t kSlab = kSlabBytes / sizeof(T);
  err = cudaLaunchKernelEx(&cfg, gemv_sum<Acc>, static_cast<const Acc*>(part), cy, m,
                           ceil_div(k, kSlab), pred);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Plan read_plan(const int* codes) { return Plan{codes[0], codes[1], codes[2]}; }

}  // namespace

// dtype: 0 bf16, 1 fp16, 2 fp32, 3 fp64 (y is fp32, fp32, fp32, fp64).
// plan: int[3], the route (0 rows, 1 split), grid and warps per block of
// ops/cuda_gemv.py::gemv_plan. A is (m, k) row-major and contiguous, x is
// (k,), y is (m,); scratch holds m * ceil(k / slab) accumulators on split
// (NULL on rows). pred: NULL, or a device byte that skips the launches'
// work when 0 (see off()). Launches on `stream` and returns
// cudaGetLastError() after the launches, or the error for a plan the
// kernels do not take.
extern "C" int matvec_gemv(int dtype, const int* plan, const void* a, const void* x,
                           void* y, void* scratch, int64_t m, int64_t k, void* stream,
                           const void* pred) {
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = read_plan(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<__nv_bfloat16, __nv_bfloat16, float>(p, a, x, y, scratch, m, k, s, pred));
    case 1: return static_cast<int>(launch<__half, __half, float>(p, a, x, y, scratch, m, k, s, pred));
    case 2: return static_cast<int>(launch<float, float, float>(p, a, x, y, scratch, m, k, s, pred));
    case 3: return static_cast<int>(launch<double, double, double>(p, a, x, y, scratch, m, k, s, pred));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same GEMV with x in the ACCUMULATOR type (fp32 for bf16/fp16/fp32 A,
// fp64 for fp64 A): the fused solver step (csrc/solver_step.cu) multiplies
// A by its fp32 direction vector without casting it to A's dtype first.
extern "C" int matvec_gemv_acc_x(int dtype, const int* plan, const void* a, const void* x,
                                 void* y, void* scratch, int64_t m, int64_t k,
                                 void* stream, const void* pred) {
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = read_plan(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<__nv_bfloat16, float, float>(p, a, x, y, scratch, m, k, s, pred));
    case 1: return static_cast<int>(launch<__half, float, float>(p, a, x, y, scratch, m, k, s, pred));
    case 2: return static_cast<int>(launch<float, float, float>(p, a, x, y, scratch, m, k, s, pred));
    case 3: return static_cast<int>(launch<double, double, double>(p, a, x, y, scratch, m, k, s, pred));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* matvec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
