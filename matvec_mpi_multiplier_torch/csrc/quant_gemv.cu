// Hand-written block-scaled GEMV for Hopper (sm_90a) over a quantized A:
//   y[i, c] = sum_j deq(i, j) * x[j, c],
//   deq(i, j) = scales[i, j / block] * q[i, j]   (+ scales2[i, j / block] *
//                                                   q2[i, j] for int8c).
//
// Replaces the TPU kernel matvec_mpi_multiplier_tpu/ops/pallas_quant.py::
// _quant_gemv_kernel, which walks a sequential (m/bm, k/bk) grid, upcasts one
// low-bit (bm, bk) tile in VMEM, scales it per k-group and carries each row
// block's partial sums in its output block across the k axis; int8c runs it
// twice and adds. Hopper has no ordered grid, so the k walk becomes a loop
// inside one block. One kernel serves x as (k,) and as (k, n): the engine's
// promoted blocks stay on the card's kernel too.
//
// The payload is int8 or float8_e4m3fn, x has the logical dtype (bf16, fp16,
// fp32, fp64), and y is the accumulator dtype: float, or double for fp64.
//
// What bounds it. At n = 1, bytes: the payload and scales (both levels for
// int8c) plus x and y, read and written once; at 65536^2 an int8 payload is
// 4.43 GB, 1.32 ms at 3.35 TB/s. For a block of n right-hand sides on FFMA,
// operations: 2*m*k*n flops against 67 TFLOP/s, which passes the bytes near
// n = 10 for int8, so the engine's buckets 16 and 32 are bound by operations.
// What the design does about it:
// - The payload streams once, in coalesced 4-byte loads (__ldcs, 128 bytes
//   per warp and row per step); a lane issues all of a k-tile's payload and
//   scale loads (16 words per level) before it converts any, so enough bytes
//   are in flight. Each element is converted in registers
//   (int8 by a byte permute onto 2^23 and one subtraction; e4m3 by moving its
//   bits into a float and one exact multiply by 2^120): the dequantized A
//   never exists in device memory.
// - A block owns 32 rows (4 per warp) and up to 32 columns; a k-tile of x is
//   staged once per block in shared memory, already converted to the
//   accumulator type and transposed, so each lane reads 4 consecutive k of
//   one column in one conflict-free 16-byte load and uses them for its 4
//   rows. Every warp keeps 4 x 16 accumulators; at n = 32 two warps share
//   the rows, 16 columns each, and the payload is still read once from HBM.
//   Wider n tiles over n in 32-column tiles.
// - int8c's two levels are fused into one pass: each element is dequantized
//   as fl(fl(s1*q1) + fl(s2*q2)), the value the JAX package's dequantize
//   gives, and meets x once.
//
// Numerics and determinism: deq is computed with explicitly rounded
// multiplies and adds (no contraction into an FMA), then multiplied into
// the accumulator with FMAs. Each lane owns fixed k positions summed in k
// order, and the warp's lanes are added by a fixed shuffle tree: no atomics,
// no split-K, so y is bitwise the same from run to run, and y[i, c] depends
// on row i of the payload and column c of x only, so the engine's zero pad
// columns cannot change a real column. Built without fast math: subnormal
// scales and e4m3 subnormals stay exact.
//
// Every shape is covered: any block that divides k takes the 4-byte path
// when block % 4 == 0 and the payload rows are 4-byte aligned, else byte
// loads with a scale looked up per element; ragged m, k and n are masked.
// Indices are 64-bit (65536^2 elements overflow an int).
//
// Left for later: tensor-core routes for the rank-2 face (int8 mma and fp8
// wgmma with the scales folded in), more rows per warp at n >= 16, and
// cp.async/TMA staging of x.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kRows = 4;                   // rows per warp
constexpr int kLaneK = 4;                  // consecutive k per lane and step
constexpr int kStep = kWarp * kLaneK;      // 128 k per warp step
constexpr int kXTileBytes = 32768;         // the staged x tile
constexpr int kMaxNT = 32;                 // columns one block spans

enum Format { kInt8 = 0, kInt8c = 1, kFp8 = 2 };

__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

// Byte e of w as the exact float value of its payload element.
template <int F>
__device__ __forceinline__ float decode(uint32_t w, int e) {
  if constexpr (F == kFp8) {
    // e4m3fn's sign, exponent and mantissa moved into a float's fields; the
    // exponent bias differs by 120, and the multiply is exact (subnormals
    // included).
    const uint32_t b = (w >> (8 * e)) & 0xFFu;
    return __uint_as_float(((b & 0x80u) << 24) | ((b & 0x7Fu) << 20)) * 0x1p120f;
  } else {
    // q + 128 as the low byte of 2^23's mantissa, then 2^23 + 128 subtracted.
    const uint32_t u = w ^ 0x80808080u;
    return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | e)) - 8388736.0f;
  }
}

__device__ __forceinline__ float mul_rn(float v, float s) { return __fmul_rn(v, s); }
__device__ __forceinline__ double mul_rn(double v, float s) {
  return __dmul_rn(v, static_cast<double>(s));
}
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

struct Args {
  const uint8_t* q;
  const float* s;
  const uint8_t* q2;
  const float* s2;
  const void* x;
  void* y;
  int64_t m, k, n, block, nb;  // nb = k / block, the scale planes' width
  int shift;  // log2(block) when block is a power of two, else -1
  bool vec;   // block % 4 == 0 and the payload rows are 4-byte aligned
  bool xvec;  // x is aligned for loads of 4 elements (the vector face)
};

__device__ __forceinline__ int64_t block_of(int64_t j, const Args& a) {
  return a.shift >= 0 ? (j >> a.shift) : j / a.block;
}

// Byte path (any block, any alignment): the dequantized values of k
// positions j0 .. j0+3 of one row, each with its own scale, zero past k.
template <int F, typename Acc>
__device__ __forceinline__ void dequant4_bytes(const Args& a, int64_t row, int64_t j0,
                                               Acc (&d)[kLaneK]) {
#pragma unroll
  for (int e = 0; e < kLaneK; ++e) {
    const int64_t j = j0 + e;
    if (row >= a.m || j >= a.k) {
      d[e] = Acc(0);
      continue;
    }
    const int64_t sidx = row * a.nb + block_of(j, a);
    d[e] = mul_rn(static_cast<Acc>(decode<F>(a.q[row * a.k + j], 0)), a.s[sidx]);
    if constexpr (F == kInt8c) {
      d[e] = add_rn(d[e], mul_rn(static_cast<Acc>(decode<kInt8>(a.q2[row * a.k + j], 0)),
                                 a.s2[sidx]));
    }
  }
}

// Four consecutive staged x values of one column.
__device__ __forceinline__ void load4(const float* p, float (&v)[kLaneK]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[kLaneK]) {
  const double2 t0 = *reinterpret_cast<const double2*>(p);
  const double2 t1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = t0.x; v[1] = t0.y; v[2] = t1.x; v[3] = t1.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[kLaneK]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&v)[kLaneK]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// 4-byte path: every payload word and scale of a k-tile (V warp steps of
// the warp's kRows rows), all loads issued before any is used, so V * kRows
// words per lane and level are in flight. k % 4 == 0 here, so a word is all
// in or all out; a zero word with a zero scale dequantizes to zeros.
template <bool kComp, int V>
__device__ __forceinline__ void load_words(const Args& a, int64_t row0, int64_t k0, int lane,
                                           uint32_t (&w)[V][kRows], float (&sc)[V][kRows],
                                           uint32_t (&w2)[V][kRows], float (&sc2)[V][kRows]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t row = row0 + r, j0 = k0 + v * kStep + lane * kLaneK;
      const bool in = row < a.m && j0 < a.k;
      const int64_t off = row * a.k + j0, sidx = row * a.nb + block_of(j0, a);
      w[v][r] = in ? __ldcs(reinterpret_cast<const unsigned int*>(a.q + off)) : 0u;
      sc[v][r] = in ? __ldg(a.s + sidx) : 0.0f;
      if constexpr (kComp) {
        w2[v][r] = in ? __ldcs(reinterpret_cast<const unsigned int*>(a.q2 + off)) : 0u;
        sc2[v][r] = in ? __ldg(a.s2 + sidx) : 0.0f;
      }
    }
  }
}

// The dequantized values of one warp step's words, kRows rows x 4 k.
template <int F, typename Acc>
__device__ __forceinline__ void decode_words(const uint32_t (&w)[kRows], const float (&sc)[kRows],
                                             const uint32_t (&w2)[kRows], const float (&sc2)[kRows],
                                             Acc (&d)[kRows][kLaneK]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int e = 0; e < kLaneK; ++e) {
      d[r][e] = mul_rn(static_cast<Acc>(decode<F>(w[r], e)), sc[r]);
      if constexpr (F == kInt8c) {
        d[r][e] = add_rn(d[r][e], mul_rn(static_cast<Acc>(decode<kInt8>(w2[r], e)), sc2[r]));
      }
    }
  }
}

// x[j0 .. j0+3] of a vector, through the read-only cache: one vector load
// where aligned and in range, else element by element, zero past k.
template <typename T, typename Acc>
__device__ __forceinline__ void load_x4(const T* __restrict__ x, int64_t j0, const Args& a,
                                        Acc (&v)[kLaneK]) {
  if (a.xvec && j0 + kLaneK <= a.k) {
    alignas(16) T t[kLaneK];
    const uint4* p = reinterpret_cast<const uint4*>(x + j0);
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint2*>(t) = __ldg(reinterpret_cast<const uint2*>(x + j0));
    } else if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint4*>(t) = __ldg(p);
    } else {
      reinterpret_cast<uint4*>(t)[0] = __ldg(p);
      reinterpret_cast<uint4*>(t)[1] = __ldg(p + 1);
    }
#pragma unroll
    for (int e = 0; e < kLaneK; ++e) v[e] = static_cast<Acc>(widen(t[e]));
    return;
  }
#pragma unroll
  for (int e = 0; e < kLaneK; ++e) {
    v[e] = j0 + e < a.k ? static_cast<Acc>(widen(x[j0 + e])) : Acc(0);
  }
}

// acc[r][c] += d[r][e] * x[jt + e, c] for one warp step: one 16-byte load
// of the staged column per (c), reused for the warp's kRows rows.
template <typename Acc, int CW, int PITCH>
__device__ __forceinline__ void fma_step(const Acc (&d)[kRows][kLaneK], const Acc* xs,
                                         int jt, Acc (&acc)[kRows][CW]) {
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    Acc xv[kLaneK];
    load4(xs + c * PITCH + jt, xv);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int e = 0; e < kLaneK; ++e) acc[r][c] = fma(d[r][e], xv[e], acc[r][c]);
    }
  }
}

// NT columns per block (1, 4, 8, 16 or 32); warps split them into groups of
// at most 16, and the rest of the warps split the rows.
template <int F, typename T, typename Acc, int NT>
__global__ void __launch_bounds__(kThreads) quant_gemv_kernel(Args a) {
  constexpr bool kComp = F == kInt8c;
  constexpr int G = NT > 16 ? NT / 16 : 1;  // column groups
  constexpr int CW = NT / G;                // columns per warp
  constexpr int BM = (kWarps / G) * kRows;  // rows per block
  constexpr int BK0 = kXTileBytes / (NT * static_cast<int>(sizeof(Acc)));
  constexpr int BK = BK0 < 4 * kStep ? BK0 : 4 * kStep;
  constexpr int V = BK / kStep;
  // Row pitch of the staged tile: 4 past BK, so the staging threads (one
  // column each, 16-byte stores) hit distinct banks and rows stay 16-byte
  // aligned for the compute's 16-byte loads.
  constexpr int PITCH = BK + kLaneK;
  static_assert(V >= 1 && BK % kStep == 0, "the x tile must hold whole warp steps");

  const T* __restrict__ x = static_cast<const T*>(a.x);
  Acc* __restrict__ y = static_cast<Acc*>(a.y);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int cw0 = (warp % G) * CW;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM + (warp / G) * kRows;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * NT;

  Acc acc[kRows][CW];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[r][c] = Acc(0);
  }
  if constexpr (NT == 1) {
  // The vector face reads x straight through the read-only cache: no
  // staging and no barriers, so every warp streams its rows on its own.
  for (int64_t k0 = 0; k0 < a.k; k0 += BK) {
    if (a.vec) {
      uint32_t w[V][kRows], w2[V][kRows];
      float sc[V][kRows], sc2[V][kRows];
      load_words<kComp, V>(a, row0, k0, lane, w, sc, w2, sc2);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int64_t j0 = k0 + v * kStep + lane * kLaneK;
        Acc xv[kLaneK], d[kRows][kLaneK];
        load_x4<T, Acc>(x, j0, a, xv);
        decode_words<F, Acc>(w[v], sc[v], w2[v], sc2[v], d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int e = 0; e < kLaneK; ++e) acc[r][0] = fma(d[r][e], xv[e], acc[r][0]);
        }
      }
    } else {
      for (int v = 0; v < V; ++v) {
        const int64_t j0 = k0 + v * kStep + lane * kLaneK;
        Acc xv[kLaneK], d[kRows][kLaneK];
        load_x4<T, Acc>(x, j0, a, xv);
#pragma unroll
        for (int r = 0; r < kRows; ++r) dequant4_bytes<F, Acc>(a, row0 + r, j0, d[r]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int e = 0; e < kLaneK; ++e) acc[r][0] = fma(d[r][e], xv[e], acc[r][0]);
        }
      }
    }
  }
  } else {
  __shared__ __align__(16) Acc xs[NT * PITCH];
  const Acc* xw = xs + cw0 * PITCH;  // this warp's columns
  for (int64_t k0 = 0; k0 < a.k; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    // Stage x[k0 : k0+BK, c0 : c0+NT] transposed: each thread takes four
    // consecutive k of one column (neighbouring threads, neighbouring
    // columns: coalesced reads of row-major x) and stores them as one
    // 16-byte vector.
    for (int i = threadIdx.x; i < (BK / kLaneK) * NT; i += kThreads) {
      const int c = i % NT, j = (i / NT) * kLaneK;
      const int64_t gc = c0 + c;
      Acc v[kLaneK];
#pragma unroll
      for (int e = 0; e < kLaneK; ++e) {
        const int64_t gj = k0 + j + e;
        v[e] = gj < a.k && gc < a.n ? static_cast<Acc>(widen(x[gj * a.n + gc])) : Acc(0);
      }
      store4(xs + c * PITCH + j, v);
    }
    __syncthreads();
    if (a.vec) {
      uint32_t w[V][kRows], w2[V][kRows];
      float sc[V][kRows], sc2[V][kRows];
      load_words<kComp, V>(a, row0, k0, lane, w, sc, w2, sc2);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        Acc d[kRows][kLaneK];
        decode_words<F, Acc>(w[v], sc[v], w2[v], sc2[v], d);
        fma_step<Acc, CW, PITCH>(d, xw, v * kStep + lane * kLaneK, acc);
      }
    } else {
      for (int v = 0; v < V; ++v) {
        Acc d[kRows][kLaneK];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          dequant4_bytes<F, Acc>(a, row0 + r, k0 + v * kStep + lane * kLaneK, d[r]);
        }
        fma_step<Acc, CW, PITCH>(d, xw, v * kStep + lane * kLaneK, acc);
      }
    }
  }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      Acc v = acc[r][c];
#pragma unroll
      for (int offset = kWarp / 2; offset > 0; offset /= 2) {
        v += __shfl_down_sync(0xffffffffu, v, offset);
      }
      const int64_t row = row0 + r, col = c0 + cw0 + c;
      if (lane == 0 && row < a.m && col < a.n) y[row * a.n + col] = v;
    }
  }
}

template <int F, typename T, typename Acc, int NT>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int G = NT > 16 ? NT / 16 : 1;
  constexpr int BM = (kWarps / G) * kRows;
  const int64_t gx = (a.m + BM - 1) / BM, gy = (a.n + NT - 1) / NT;
  if (gx > INT_MAX || gy > 65535) return cudaErrorInvalidConfiguration;
  quant_gemv_kernel<F, T, Acc, NT><<<dim3(static_cast<unsigned>(gx),
                                          static_cast<unsigned>(gy)),
                                     kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// The block width: the smallest of 1, 4, 8, 16, 32 that covers n; wider n
// tiles over n in 32-column tiles.
template <int F, typename T, typename Acc>
cudaError_t by_width(const Args& a, cudaStream_t s) {
  if (a.n == 1) return launch<F, T, Acc, 1>(a, s);
  if (a.n <= 4) return launch<F, T, Acc, 4>(a, s);
  if (a.n <= 8) return launch<F, T, Acc, 8>(a, s);
  if (a.n <= 16) return launch<F, T, Acc, 16>(a, s);
  return launch<F, T, Acc, kMaxNT>(a, s);
}

template <int F>
cudaError_t by_dtype(int dtype, const Args& a, cudaStream_t s) {
  switch (dtype) {
    case 0: return by_width<F, __nv_bfloat16, float>(a, s);
    case 1: return by_width<F, __half, float>(a, s);
    case 2: return by_width<F, float, float>(a, s);
    case 3: return by_width<F, double, double>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned4(const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; }

}  // namespace

// fmt: 0 int8, 1 int8c, 2 fp8. dtype: the dtype of x, 0 bf16, 1 fp16,
// 2 fp32, 3 fp64 (y is fp32, fp32, fp32, fp64). q (and q2 for int8c, else
// NULL) is the (m, k) payload, scales (and scales2) the (m, k/block) fp32
// scales, x is (k, n) and y (m, n), all row-major and contiguous (n = 1 for
// a vector). Launches on `stream` and returns cudaGetLastError() after the
// launch.
extern "C" int matvec_quant_gemv(int fmt, int dtype, const void* q,
                                 const void* scales, const void* q2,
                                 const void* scales2, const void* x, void* y,
                                 int64_t m, int64_t k, int64_t n, int64_t block,
                                 void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || block <= 0 || k % block != 0 ||
      (fmt == kInt8c) != (q2 != nullptr && scales2 != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const uint8_t*>(q), static_cast<const float*>(scales),
         static_cast<const uint8_t*>(q2), static_cast<const float*>(scales2),
         x, y, m, k, n, block, k / block, -1, false, false};
  if ((block & (block - 1)) == 0) {
    int shift = 0;
    while ((int64_t{1} << shift) < block) ++shift;
    a.shift = shift;
  }
  a.vec = block % 4 == 0 && aligned4(q) && (q2 == nullptr || aligned4(q2));
  const int itemsize = dtype == 3 ? 8 : dtype == 2 ? 4 : 2;
  a.xvec = reinterpret_cast<uintptr_t>(x) % (kLaneK * itemsize) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kInt8: return static_cast<int>(by_dtype<kInt8>(dtype, a, s));
    case kInt8c: return static_cast<int>(by_dtype<kInt8c>(dtype, a, s));
    case kFp8: return static_cast<int>(by_dtype<kFp8>(dtype, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
