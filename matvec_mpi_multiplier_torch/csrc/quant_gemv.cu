// Hand-written block-scaled GEMV for Hopper (sm_90a) over a quantized A:
//   y[i, c] = sum_b s1[i, b] * (q1[i, b-block] . x[b-block, c])
//           (+ the same sum over s2 and q2 for int8c, added at the end),
// the JAX package's association: one fp32 partial per quantization block,
// scaled once per row and block and summed in block order, each level
// summed on its own (ops/quantize.py::_contract_level).
//
// Replaces the TPU kernel matvec_mpi_multiplier_tpu/ops/pallas_quant.py::
// _quant_gemv_kernel, which walks a sequential (m/bm, k/bk) grid, upcasts one
// low-bit (bm, bk) tile in VMEM, scales its per-block partials and carries
// each row block's sums in its output block across the k axis; int8c runs
// it twice and adds. Hopper has no ordered grid, so the k walk becomes a
// loop inside one CTA. One entry serves x as (k,) and as (k, n): the
// engine's promoted blocks stay on the card's kernel too. The dequantized
// A never exists in device memory.
//
// The payload is int8 or float8_e4m3fn, x has the logical dtype (bf16,
// fp16, fp32, fp64), and y is the accumulator dtype: float, or double for
// fp64. Routes, planned by the wrapper (ops/cuda_quant.py::quant_route) from
// the format, x's dtype, k, the block and the payload's alignment, and
// passed in as a code; a route a shape cannot take is refused:
//
// * wgmma (bf16 or fp16 x) and wgmma_split (fp32 x): the tensor cores.
//   Every payload value is exact in bf16 and in fp16 (int8 -128..127, every
//   e4m3 value), so each product with a 16-bit operand is exact in the fp32
//   accumulator. fp32 x is split by a pre-pass into P = 2 bf16 parts,
//   x = x0 + x1 + r with |r| <= 2^-16 |x|, whose errors, of both signs,
//   hold the bar of 1e-5 of |deq(A)|.|x| at every check shape (one part
//   misses it: tests/test_torch_quant_route.py emulates both); bf16 and
//   fp16 x are one part, copied.
//   Design of the rank-2 face (n >= 2), one CTA of 384 threads per tile of
//   BM payload rows and NT / P columns of x:
//   - The pre-pass writes x's parts once per call into scratch, (n, P, k)
//     16-bit, each 16 k permuted so that a thread's four payload bytes of a
//     k16 step are one 4-byte word (Marlin's trick: the k order inside a
//     block is free if B's rows follow it). A second launch, tiny beside
//     the payload (k n (4 + 2P) bytes). B's rows are x's (column, part)
//     pairs, part fastest, so one wgmma takes every part and both parts of
//     a column land in one thread's registers.
//   - One producer warp keeps TMA loads in flight over an S-stage mbarrier
//     ring (S fills 227 KB, at most 8): per stage 128 bytes of k of BM
//     payload rows per level (uint8 2-D map, 128-byte swizzle, rows past m
//     zero-filled), B's tile for those 128 k (NT rows of the scratch, rows
//     past n P zero-filled, never read), and, by 4-byte cp.async tracked by
//     the same mbarrier, the scales of the blocks the stage overlaps.
//   - Two consumer warpgroups of 64 MS rows each load their payload words
//     from shared memory (conflict-free under the swizzle), convert them in
//     registers (int8 to fp16: a byte permute onto 1024 and one fp16x2
//     subtraction; int8 to bf16: onto 2^23 in fp32, one subtraction, the
//     high halves packed; e4m3 by cvt.rn.f16x2.e4m3x2, and to bf16 its bits
//     moved down 3 and one exact bf16x2 multiply by 2^112) and issue wgmma
//     with A from registers (RS); no dequantized tile is written back to
//     shared memory. setmaxnreg moves registers from the producer's
//     warpgroup to them.
//   - Per quantization block a fresh fp32 partial (scale-d = 0 on its first
//     k16), then acc += s[row, b] * partial on the CUDA cores (the parts'
//     partials added small first, a rounded multiply, then an add), blocks
//     in k order.
//   - Tiles (tc_by_rows): N = 16, 32, or 64 (two parts above 16 columns,
//     one slab); BM = 256 (two m64 slabs per warpgroup) where m gives every
//     SM a CTA, else 128. Wider n tiles the grid over n, the n tiles of one
//     row tile adjacent in launch order so the payload comes from HBM once.
//     At N = 32 and BM = 256 B's L2 traffic, 2 N bytes per k, is a quarter
//     of the payload's 256.
//   int8's vector face (n = 1) runs a CUDA-core consumer on the same ring
//   (quant_vec_kernel): there a wgmma's fixed cost, not the bytes, bounded
//   the tensor cores, so each consumer thread owns a payload row and sums
//   the same per-block partials in fp32 FMA, x exact in fp32. int8c's and
//   fp8's vectors ran faster on the tensor cores (their conversion to fp32
//   costs more per byte), and take them. chip_smoke.py times both faces:
//   n = 2 takes the tile a vector would on the tensor cores.
//   What bounds it: bytes, the payload and scales once (0.26 of fp32 A for
//   int8 and fp8, 0.52 for int8c) plus x and y: 1.32 ms at 65536^2 int8 on
//   3.35 TB/s. The tensor work is 2 m k N flops per level (N = 64 at 32
//   columns of fp32 x: 0.56 ms of 989 TFLOP/s). The CUDA cores' share is
//   the conversion, about 2.5 instructions per payload byte on the rank-2
//   face (0.4 ms at 65536^2 per level), 3 on the vector face with its FMA.
// * fma (fp64 x, and any shape TMA or wgmma cannot take: k % 16, block %
//   16, a payload base that is not 16-byte aligned): FMA on the CUDA
//   cores, described below. It dequantizes each element as
//   fl(s1 q1) (+ fl(s2 q2)) and multiplies it into the sum.
//
// Numerics and determinism, every route: no atomics and no split-K, so y is
// bitwise the same from run to run; y[i, c] depends on row i of the payload
// and column c of x only, so the engine's pad columns cannot change a real
// column. Built without fast math: subnormal scales and e4m3 subnormals stay
// exact. Indices are 64-bit (65536^2 elements overflow an int).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- fma
//
// FFMA on the CUDA cores. A block owns 32 rows (4 per warp) and up to 32
// columns. The payload streams once, in coalesced 4-byte loads (__ldcs, 128
// bytes per warp and row per step); a lane issues all of a k-tile's payload
// and scale loads (16 words per level) before it converts any. Each element
// is converted in registers (int8 by a byte permute onto 2^23 and one
// subtraction; e4m3 by moving its bits into a float and one exact multiply
// by 2^120) and dequantized as fl(s1 q1) (+ fl(s2 q2)), explicitly rounded,
// then multiplied into the accumulator with FMAs. A k-tile of x is staged
// once per block in shared memory, converted to the accumulator type and
// transposed, so each lane reads 4 consecutive k of one column in one
// 16-byte load for its 4 rows; at n = 32 two warps share the rows, 16
// columns each. Each lane owns fixed k positions summed in k order and the
// warp's lanes are added by a fixed shuffle tree. Any block that divides k
// takes the 4-byte path when block % 4 == 0 and the payload rows are 4-byte
// aligned, else byte loads with a scale looked up per element; ragged m, k
// and n are masked. Bound by bytes at n = 1, by FFMA operations from about
// n = 10 (2 m k n flops against 67 TFLOP/s).

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

// ---------------------------------------------------------------- wgmma, wgmma_split

constexpr int kTcThreads = 384;    // consumer warpgroups 0, 1; producer 2
constexpr int kTcBK = 128;         // payload bytes of k per stage: one swizzle row
constexpr int kMaxParts = 2;       // bf16 parts of fp32 x on wgmma_split
constexpr int kTcMaxStages = 8;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a CTA may use

// Slot j (0..15) of a k16 step, as wgmma numbers its k, holds payload byte
// slot_phys(j) of the step's 16: lane t = l % 4 holds slots 2t, 2t + 1,
// 2t + 8, 2t + 9 of its rows in registers, and they are bytes 4t .. 4t + 3,
// one 4-byte word. The pre-pass writes B's rows in the same order.
__host__ __device__ constexpr int slot_phys(int j) {
  return 4 * ((j % 8) / 2) + (j % 2) + 2 * (j / 8);
}

// One payload word (bytes 4t .. 4t + 3 of a k16 step of one row) as the
// RS fragment's two 16-bit pairs, exact in the operand type: lo = slots
// (2t, 2t + 1), hi = slots (2t + 8, 2t + 9), the first of each in the low
// half.
template <int F, bool kBf16>
__device__ __forceinline__ void convert_word(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if constexpr (F == kFp8) {
    asm("{\n.reg .b16 l, h;\nmov.b32 {l, h}, %2;\n"
        "cvt.rn.f16x2.e4m3x2 %0, l;\ncvt.rn.f16x2.e4m3x2 %1, h;\n}\n"
        : "=r"(lo), "=r"(hi)
        : "r"(w));
    if constexpr (kBf16) {
      // fp16 to bf16: exponent and the top 7 mantissa bits moved down 3
      // (e4m3's 3 mantissa bits and its exponent range survive), the sign
      // kept, then the bias corrected by an exact multiply by 2^112.
      lo = ((lo & 0x7FFF7FFFu) >> 3) | (lo & 0x80008000u);
      hi = ((hi & 0x7FFF7FFFu) >> 3) | (hi & 0x80008000u);
      asm("fma.rn.bf16x2 %0, %0, %1, %2;" : "+r"(lo) : "r"(0x77807780u), "r"(0x80008000u));
      asm("fma.rn.bf16x2 %0, %0, %1, %2;" : "+r"(hi) : "r"(0x77807780u), "r"(0x80008000u));
    }
  } else {
    const uint32_t u = w ^ 0x80808080u;  // q + 128 in each byte
    if constexpr (kBf16) {
      // q + 128 as the low byte of 2^23's mantissa, 2^23 + 128 subtracted;
      // q is exact in bf16, so the fp32's high half is it.
      uint32_t f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[e] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | e)) -
                               8388736.0f);
      }
      lo = __byte_perm(f[0], f[1], 0x7632);
      hi = __byte_perm(f[2], f[3], 0x7632);
    } else {
      // q + 128 as the low byte of 1024's fp16 mantissa, 1152 subtracted.
      lo = __byte_perm(u, 0x64646464u, 0x4140);
      hi = __byte_perm(u, 0x64646464u, 0x4342);
      asm("sub.rn.f16x2 %0, %0, %1;" : "+r"(lo) : "r"(0x64806480u));
      asm("sub.rn.f16x2 %0, %0, %1;" : "+r"(hi) : "r"(0x64806480u));
    }
  }
}

// The pre-pass: x (k, n) of T as `parts` 16-bit parts into xs (n, parts,
// k), each the rounding (bf16, or fp16 when !kBf16) of what the ones before
// leave, largest first, with each 16 k in slot order. One thread per
// (column, 16 k).
template <typename T, bool kBf16>
__global__ void __launch_bounds__(256)
split_x_kernel(const T* __restrict__ x, uint16_t* __restrict__ xs, int64_t k, int64_t n,
               int parts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n * (k / 16)) return;
  const int64_t c = i % n, g = i / n;
  float r[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) r[e] = widen(x[(16 * g + e) * n + c]);
  for (int p = 0; p < parts; ++p) {
    alignas(16) uint16_t out[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      float v;
      if constexpr (kBf16) {
        const __nv_bfloat16 h = __float2bfloat16_rn(r[e]);
        out[e] = __bfloat16_as_ushort(h);
        v = __bfloat162float(h);
      } else {
        const __half h = __float2half_rn(r[e]);
        out[e] = __half_as_ushort(h);
        v = __half2float(h);
      }
      r[e] = __fsub_rn(r[e], v);  // exact: the next part's share
    }
    alignas(16) uint16_t perm[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) perm[j] = out[slot_phys(j)];
    uint4* dst = reinterpret_cast<uint4*>(xs + (c * parts + p) * k + 16 * g);
    dst[0] = reinterpret_cast<const uint4*>(perm)[0];
    dst[1] = reinterpret_cast<const uint4*>(perm)[1];
  }
}

// Scale slots per stage and level: the quantization blocks a stage's 128 k
// can overlap (one more than fit, for a block that straddles its start).
__host__ __device__ constexpr int scale_slots(int64_t block) {
  return static_cast<int>((kTcBK + block - 1) / block) + 1;
}

// One 4-byte cp.async (zeros where src_bytes is 0), and the arrival on an
// mbarrier once this thread's earlier cp.asyncs have landed (counted among
// the barrier's expected arrivals: .noinc).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// F the format, kBf16 the operand type (else fp16), P the parts of x (1, or
// 2 on wgmma_split), NT wgmma's N, MS the m64 slabs of each consumer
// warpgroup (BM = 128 MS). B's rows are x's (column, part) pairs, part
// fastest, so a tile spans NT / P columns of x and one wgmma per k16 step
// takes every part. Thread (warp w of warpgroup wg, lane l, g = l / 4,
// t = l % 4) holds, in slab u, rows r(u, h) = 64 (MS wg + u) + 16 w + g +
// 8 h of the tile and, in each 8-row group j of B, B rows 8j + 2t + e:
// register 4j + 2h + e of the partial, so both parts of x column 4j + t
// (P = 2), or x columns 8j + 2t + e (P = 1), sit in one thread.
template <int F, bool kBf16, int P, int NT, int MS>
__global__ void __launch_bounds__(kTcThreads, 1)
quant_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_q2,
                const __grid_constant__ CUtensorMap map_x, const float* __restrict__ s1,
                const float* __restrict__ s2, float* __restrict__ y, int64_t m, int64_t k,
                int64_t n, int64_t block, int stages) {
  constexpr bool kComp = F == kInt8c;
  constexpr int kLevels = kComp ? 2 : 1;
  constexpr int BM = 128 * MS;
  constexpr int kR = NT / 2;      // partial registers per slab and level
  constexpr int kA = kR / P;      // running sums per slab and level
  constexpr int kCols = NT / P;   // x columns per tile
  constexpr uint32_t kPayBytes = BM * kTcBK;
  constexpr uint32_t kBBytes = 2 * NT * 128;  // B: NT rows x 128 k, two boxes
  constexpr uint32_t kTxBytes = kLevels * kPayBytes + kBBytes;  // what TMA brings
  // k16 steps whose payload words are loaded at once, and wgmma groups
  // (steps) left in flight after each commit: each step holds 4 kLevels MS
  // registers of fragments.
  constexpr int kPre = kLevels == 1 ? 4 : 2;
  constexpr int kPending = kLevels * MS <= 2 ? 2 : 1;
  const int slots = scale_slots(block);
  // A stage: the payload tile per level, B, then the scales,
  // [level][slot][row] fp32, rounded up to keep the next stage aligned.
  const uint32_t stage_bytes = (kTxBytes + kLevels * slots * BM * 4 + 1023) & ~1023u;
  extern __shared__ uint8_t tc_smem[];
  const uint32_t pad = (1024 - smem_u32(tc_smem) % 1024) % 1024;
  uint8_t* const gbase = tc_smem + pad;
  const uint32_t base = smem_u32(gbase);
  const uint32_t full = base + stages * stage_bytes;  // the stage's tiles landed
  const uint32_t empty = full + 8 * stages;           // the stage was read
  const int64_t n_tiles = (n + kCols - 1) / kCols;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / n_tiles) * BM;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x % n_tiles) * kCols;
  const int ktiles = static_cast<int>((k + kTcBK - 1) / kTcBK);
  const int64_t nb = k / block;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1 + 32);  // lane 0's TMA, and the warp's scale copies
      mbar_init(empty + 8 * s, 8);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer: warp 8
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x / 32 == 8) {
      const int lane = threadIdx.x % 32;
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(empty + 8 * s, phase ^ 1);  // passes at once on round 0
        const uint32_t st = base + s * stage_bytes;
        const uint32_t bar = full + 8 * s;
        if (lane == 0) {
          mbar_expect_tx(bar, kTxBytes);
          tma_load_2d(st, &map_q, kt * kTcBK, static_cast<int32_t>(row0), bar);
          if constexpr (kComp) {
            tma_load_2d(st + kPayBytes, &map_q2, kt * kTcBK, static_cast<int32_t>(row0), bar);
          }
          const uint32_t bs = st + kLevels * kPayBytes;
          tma_load_2d(bs, &map_x, kt * kTcBK, static_cast<int32_t>(c0 * P), bar);
          tma_load_2d(bs + NT * 128, &map_x, kt * kTcBK + 64, static_cast<int32_t>(c0 * P), bar);
        }
        // The scales of the blocks the stage overlaps, from block
        // kt * 128 / block on, by cp.async; zeros past m and the last block.
        const int64_t j0 = static_cast<int64_t>(kt) * kTcBK / block;
        const uint32_t ss = st + kTxBytes;
#pragma unroll
        for (int L = 0; L < kLevels; ++L) {
          const float* const sl = L == 0 ? s1 : s2;
          for (int slot = 0; slot < slots; ++slot) {
            const int64_t jb = j0 + slot;
            for (int r = lane; r < BM; r += 32) {
              const int64_t row = row0 + r;
              const bool ok = row < m && jb < nb;
              cp_async4(ss + ((L * slots + slot) * BM + r) * 4, ok ? sl + row * nb + jb : sl,
                        ok ? 4 : 0);
            }
          }
        }
        cp_async_mbar_arrive(bar);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // The consumers' registers come from the producer's warpgroup.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int spb = static_cast<int>(block / 16);  // k16 steps per block

    float part[kLevels][MS][kR], acc[kLevels][MS][kA];
#pragma unroll
    for (int L = 0; L < kLevels; ++L) {
#pragma unroll
      for (int u = 0; u < MS; ++u) {
#pragma unroll
        for (int i = 0; i < kR; ++i) part[L][u][i] = 0.f;
#pragma unroll
        for (int i = 0; i < kA; ++i) acc[L][u][i] = 0.f;
      }
    }

    int s = 0, in_block = 0;
    uint32_t phase = 0;
    int64_t j = 0;  // the block being summed
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(full + 8 * s, phase);
      const uint8_t* const st = gbase + s * stage_bytes;
      const uint32_t bs = base + s * stage_bytes + kLevels * kPayBytes;
#pragma unroll
      for (int q0 = 0; q0 < kTcBK / 16; q0 += kPre) {
        if (static_cast<int64_t>(kt) * kTcBK + 16 * q0 >= k) break;
        // kPre steps' payload words at once (past k they are TMA's zeros).
        // Rows r and r + 8 share r % 8 = g: step q's 16-byte chunk sits at
        // chunk q ^ g of both (the 128-byte swizzle), word t of it.
        uint32_t words[kPre][kLevels][MS][2];
#pragma unroll
        for (int qq = 0; qq < kPre; ++qq) {
#pragma unroll
          for (int L = 0; L < kLevels; ++L) {
#pragma unroll
            for (int u = 0; u < MS; ++u) {
              const uint8_t* p = st + L * kPayBytes +
                                 (64 * (MS * wg + u) + 16 * warp + g) * 128 +
                                 (((q0 + qq) ^ g) * 16) + 4 * t;
              words[qq][L][u][0] = *reinterpret_cast<const uint32_t*>(p);
              words[qq][L][u][1] = *reinterpret_cast<const uint32_t*>(p + 8 * 128);
            }
          }
        }
#pragma unroll
        for (int qq = 0; qq < kPre; ++qq) {
          const int q = q0 + qq;
          if (16 * (static_cast<int64_t>(kt) * (kTcBK / 16) + q) >= k) break;
          uint32_t frag[kLevels][MS][4];
#pragma unroll
          for (int L = 0; L < kLevels; ++L) {
#pragma unroll
            for (int u = 0; u < MS; ++u) {
              if (L == 0) {
                convert_word<F, kBf16>(words[qq][L][u][0], frag[L][u][0], frag[L][u][2]);
                convert_word<F, kBf16>(words[qq][L][u][1], frag[L][u][1], frag[L][u][3]);
              } else {
                convert_word<kInt8, kBf16>(words[qq][L][u][0], frag[L][u][0], frag[L][u][2]);
                convert_word<kInt8, kBf16>(words[qq][L][u][1], frag[L][u][1], frag[L][u][3]);
              }
            }
          }
          // Step q of the stage is 16-value column group q % 4 of box q / 4.
          const uint64_t db = sw128_desc(bs + (q / 4) * NT * 128) + 2 * (q % 4);
          wgmma_fence();
#pragma unroll
          for (int L = 0; L < kLevels; ++L) {
#pragma unroll
            for (int u = 0; u < MS; ++u) {
              wgmma_rs<kBf16, NT>(part[L][u], frag[L][u], db, in_block != 0);
            }
          }
          wgmma_commit();
          if (++in_block == spb) {
            // Block j ends here: its scales sit in slot j - j0 of this stage.
            const float* const sc = reinterpret_cast<const float*>(st + kTxBytes) +
                                    (j - static_cast<int64_t>(kt) * kTcBK / block) * BM;
            wgmma_wait_all();
#pragma unroll
            for (int L = 0; L < kLevels; ++L) {
#pragma unroll
              for (int u = 0; u < MS; ++u) {
                fence_regs(part[L][u]);
                const int r = 64 * (MS * wg + u) + 16 * warp + g;
                const float scale[2] = {sc[L * slots * BM + r], sc[L * slots * BM + r + 8]};
#pragma unroll
                for (int i = 0; i < kA; ++i) {
                  // P = 2: the small part's partial, then the large one's.
                  const int d = P == 1 ? i : 4 * (i / 2) + 2 * (i % 2);
                  const float pv = P == 1 ? part[L][u][d]
                                          : __fadd_rn(part[L][u][d + 1], part[L][u][d]);
                  const float sv = scale[P == 1 ? (i / 2) % 2 : i % 2];
                  acc[L][u][i] = __fadd_rn(acc[L][u][i], __fmul_rn(sv, pv));
                }
              }
            }
            in_block = 0;
            ++j;
          } else {
            // Steps stay in flight while their fragments' registers allow.
            wgmma_wait<kPending>();
          }
        }
      }
      wgmma_wait_all();  // every wgmma reading this stage's B is done
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int u = 0; u < MS; ++u) {
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        const int h = P == 1 ? (i / 2) % 2 : i % 2;
        const int64_t row = row0 + 64 * (MS * wg + u) + 16 * warp + g + 8 * h;
        const int64_t col = c0 + (P == 1 ? 8 * (i / 4) + 2 * t + i % 2 : 4 * (i / 2) + t);
        float v = acc[0][u][i];
        if constexpr (kComp) v = __fadd_rn(v, acc[kLevels - 1][u][i]);
        if (row < m && col < n) y[row * n + col] = v;
      }
    }
  }
}

// int8's vector face (n = 1) on the tensor-core routes, on the CUDA cores: a
// vector fills 1/16 of the smallest tile's wgmma and the wgmma's fixed cost
// bounds the kernel, so here each consumer thread owns one payload row and
// runs the same association in fp32 FMA (x exact in fp32, no parts). The
// same ring: the producer warp's lane 0 brings the payload by TMA, its
// lanes the scales by cp.async and the stage's 128 values of x, loaded a
// stage ahead and widened to fp32. BM is 256 where m gives every SM a CTA,
// else 128. A thread reads its row's 16-byte chunks (the 128-byte
// swizzle puts 8 consecutive rows' chunk c in 8 bank groups), converts each
// byte in registers as the fma route does, and sums a block's products in
// four interleaved fp32 chains, added pairwise at the block's end: a fresh
// partial per block, then acc + s * partial in block order.
template <int F, typename T, int MS>
__global__ void __launch_bounds__(128 * MS + 32, 1)
quant_vec_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_q2, const T* __restrict__ x,
                 const float* __restrict__ s1, const float* __restrict__ s2,
                 float* __restrict__ y, int64_t m, int64_t k, int64_t block, int stages) {
  constexpr bool kComp = F == kInt8c;
  constexpr int kLevels = kComp ? 2 : 1;
  constexpr int BM = 128 * MS;  // one row per consumer thread
  constexpr uint32_t kPayBytes = BM * kTcBK;
  constexpr uint32_t kTxBytes = kLevels * kPayBytes;
  const int slots = scale_slots(block);
  // A stage: the payload tile per level, x's 128 values in fp32, then the
  // scales, [level][slot][row] fp32.
  const uint32_t stage_bytes =
      (kTxBytes + kTcBK * 4 + kLevels * slots * BM * 4 + 1023) & ~1023u;
  extern __shared__ uint8_t vec_smem[];
  const uint32_t pad = (1024 - smem_u32(vec_smem) % 1024) % 1024;
  uint8_t* const gbase = vec_smem + pad;
  const uint32_t base = smem_u32(gbase);
  const uint32_t full = base + stages * stage_bytes;
  const uint32_t empty = full + 8 * stages;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int ktiles = static_cast<int>((k + kTcBK - 1) / kTcBK);
  const int64_t nb = k / block;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // lane 0's TMA, the warp's scale copies, lane 0 once x is stored
      mbar_init(full + 8 * s, 1 + 32 + 1);
      mbar_init(empty + 8 * s, BM / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= BM) {  // the producer warp
    const int lane = threadIdx.x % 32;
    float xv[kTcBK / 32];
#pragma unroll
    for (int i = 0; i < kTcBK / 32; ++i) {
      const int64_t kk = lane + 32 * i;
      xv[i] = kk < k ? static_cast<float>(widen(x[kk])) : 0.f;
    }
    int s = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(empty + 8 * s, phase ^ 1);  // passes at once on round 0
      const uint32_t st = base + s * stage_bytes;
      const uint32_t bar = full + 8 * s;
      if (lane == 0) {
        mbar_expect_tx(bar, kTxBytes);
        tma_load_2d(st, &map_q, kt * kTcBK, static_cast<int32_t>(row0), bar);
        if constexpr (kComp) {
          tma_load_2d(st + kPayBytes, &map_q2, kt * kTcBK, static_cast<int32_t>(row0), bar);
        }
      }
      const int64_t j0 = static_cast<int64_t>(kt) * kTcBK / block;
      const uint32_t ss = st + kTxBytes + kTcBK * 4;
#pragma unroll
      for (int L = 0; L < kLevels; ++L) {
        const float* const sl = L == 0 ? s1 : s2;
        for (int slot = 0; slot < slots; ++slot) {
          const int64_t jb = j0 + slot;
          for (int r = lane; r < BM; r += 32) {
            const int64_t row = row0 + r;
            const bool ok = row < m && jb < nb;
            cp_async4(ss + ((L * slots + slot) * BM + r) * 4, ok ? sl + row * nb + jb : sl,
                      ok ? 4 : 0);
          }
        }
      }
      cp_async_mbar_arrive(bar);
      float* const xs = reinterpret_cast<float*>(gbase + s * stage_bytes + kTxBytes);
#pragma unroll
      for (int i = 0; i < kTcBK / 32; ++i) xs[lane + 32 * i] = xv[i];
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();  // the warp's x stores before the arrival
        mbar_arrive(bar);
      }
      // The next stage's x, in flight while this loop waits.
#pragma unroll
      for (int i = 0; i < kTcBK / 32; ++i) {
        const int64_t kk = static_cast<int64_t>(kt + 1) * kTcBK + lane + 32 * i;
        xv[i] = kk < k ? static_cast<float>(widen(x[kk])) : 0.f;
      }
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
  } else {
    const int r = threadIdx.x, lane = threadIdx.x % 32;
    const int spb = static_cast<int>(block / 16);  // 16-byte chunks per block
    float acc[kLevels], part[kLevels][4];
#pragma unroll
    for (int L = 0; L < kLevels; ++L) acc[L] = 0.f;
    int s = 0, in_block = 0;
    uint32_t phase = 0;
    int64_t j = 0;  // the block being summed
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(full + 8 * s, phase);
      const uint8_t* const st = gbase + s * stage_bytes;
      const float* const xs = reinterpret_cast<const float*>(st + kTxBytes);
#pragma unroll
      for (int c = 0; c < kTcBK / 16; ++c) {
        if (static_cast<int64_t>(kt) * kTcBK + 16 * c >= k) break;
        if (in_block == 0) {
#pragma unroll
          for (int L = 0; L < kLevels; ++L) {
#pragma unroll
            for (int e = 0; e < 4; ++e) part[L][e] = 0.f;
          }
        }
        float xc[16];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 f = reinterpret_cast<const float4*>(xs + 16 * c)[v];
          xc[4 * v] = f.x, xc[4 * v + 1] = f.y, xc[4 * v + 2] = f.z, xc[4 * v + 3] = f.w;
        }
#pragma unroll
        for (int L = 0; L < kLevels; ++L) {
          const uint4 w = *reinterpret_cast<const uint4*>(st + L * kPayBytes + r * 128 +
                                                          ((c ^ (r % 8)) * 16));
          const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float d = L == 0 ? decode<F>(ws[i], e) : decode<kInt8>(ws[i], e);
              part[L][e] = fmaf(d, xc[4 * i + e], part[L][e]);
            }
          }
        }
        if (++in_block == spb) {
          // Block j ends here: its scales sit in slot j - j0 of this stage.
          const float* const sc = reinterpret_cast<const float*>(st + kTxBytes + kTcBK * 4) +
                                  (j - static_cast<int64_t>(kt) * kTcBK / block) * BM + r;
#pragma unroll
          for (int L = 0; L < kLevels; ++L) {
            const float pv = __fadd_rn(__fadd_rn(part[L][0], part[L][1]),
                                       __fadd_rn(part[L][2], part[L][3]));
            acc[L] = __fadd_rn(acc[L], __fmul_rn(sc[L * slots * BM], pv));
          }
          in_block = 0;
          ++j;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    if (row0 + r < m) y[row0 + r] = kComp ? __fadd_rn(acc[0], acc[kLevels - 1]) : acc[0];
  }
}

// ---------------------------------------------------------------- host

// Route codes, as ops/cuda_quant.py::ROUTE_CODES.
enum Route { kWgmma = 0, kWgmmaSplit = 1, kFma = 2 };

struct TcArgs {
  const void *q, *s, *q2, *s2, *x;
  void *y, *xs;
  int64_t m, k, n, block;
  int parts;
};

// A (m, k) uint8 payload as a 2-D TMA map with a (128 bytes, box_rows) box
// in the 128-byte swizzle, zeros past m.
cudaError_t encode_payload_map(CUtensorMap* map, const void* ptr, int64_t m, int64_t k,
                               int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {kTcBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The (n, parts, k) 16-bit scratch of x's parts as a 2-D map (k, n parts)
// with a (64, nt) box: 128 bytes of k of nt (column, part) rows, the
// 128-byte swizzle, zeros past the last row.
cudaError_t encode_x_map(CUtensorMap* map, const void* ptr, int64_t k, int64_t rows, int nt) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(nt)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The launch of one tile shape: stages fill the shared memory (at most 8).
template <int F, bool kBf16, int P, int NT, int MS>
cudaError_t launch_tc(const TcArgs& a, cudaStream_t stream) {
  constexpr int kLevels = F == kInt8c ? 2 : 1;
  constexpr int BM = 128 * MS;
  const int64_t stage_bytes =
      (kLevels * BM * kTcBK + 2 * NT * 128 + kLevels * scale_slots(a.block) * BM * 4 + 1023) /
      1024 * 1024;
  int stages = static_cast<int>((kSmemLimit - 1024) / (stage_bytes + 16));
  if (stages > kTcMaxStages) stages = kTcMaxStages;
  if (stages < 2) return cudaErrorInvalidConfiguration;
  const int smem = static_cast<int>(1024 + stages * (stage_bytes + 16));
  const int64_t blocks = (a.m + BM - 1) / BM * ((a.n + NT / P - 1) / (NT / P));
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  CUtensorMap map_q, map_q2, map_x;
  cudaError_t err = encode_payload_map(&map_q, a.q, a.m, a.k, BM);
  if (err == cudaSuccess) {
    err = encode_payload_map(&map_q2, kLevels == 2 ? a.q2 : a.q, a.m, a.k, BM);
  }
  if (err == cudaSuccess) err = encode_x_map(&map_x, a.xs, a.k, a.n * P, NT);
  const void* fn = reinterpret_cast<const void*>(quant_tc_kernel<F, kBf16, P, NT, MS>);
  if (err == cudaSuccess) {
    // The opt-in is the kernel's, for the whole process, and its ring size
    // varies with the block: opted in at the most a CTA may use, so that no
    // launch, on any thread, lowers it under another's.
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
  }
  if (err != cudaSuccess) return err;
  const float* s1 = static_cast<const float*>(a.s);
  const float* s2 = static_cast<const float*>(kLevels == 2 ? a.s2 : a.s);
  float* y = static_cast<float*>(a.y);
  int64_t m = a.m, k = a.k, n = a.n, block = a.block;
  void* args[] = {&map_q, &map_q2, &map_x, &s1, &s2, &y, &m, &k, &n, &block, &stages};
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)), dim3(kTcThreads), args, smem,
                         stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Whether a tile of 256 rows still gives every SM of the current card a
// CTA: then BM = 256, else 128 (more CTAs for a short m).
bool tall(int64_t m) {
  static int sms[16] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return true;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return true;
  }
  return (m + 255) / 256 >= sms[dev];
}

// The vector face's launch: stages fill the shared memory (at most 8).
template <int F, typename T, int MS>
cudaError_t launch_vec(const TcArgs& a, cudaStream_t stream) {
  constexpr int kLevels = F == kInt8c ? 2 : 1;
  constexpr int BM = 128 * MS;
  const int64_t stage_bytes =
      (kLevels * BM * kTcBK + kTcBK * 4 + kLevels * scale_slots(a.block) * BM * 4 + 1023) /
      1024 * 1024;
  int stages = static_cast<int>((kSmemLimit - 1024) / (stage_bytes + 16));
  if (stages > kTcMaxStages) stages = kTcMaxStages;
  if (stages < 2) return cudaErrorInvalidConfiguration;
  const int smem = static_cast<int>(1024 + stages * (stage_bytes + 16));
  const int64_t blocks = (a.m + BM - 1) / BM;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  CUtensorMap map_q, map_q2;
  cudaError_t err = encode_payload_map(&map_q, a.q, a.m, a.k, BM);
  if (err == cudaSuccess) {
    err = encode_payload_map(&map_q2, kLevels == 2 ? a.q2 : a.q, a.m, a.k, BM);
  }
  const void* fn = reinterpret_cast<const void*>(quant_vec_kernel<F, T, MS>);
  if (err == cudaSuccess) {  // at the most a CTA may use, as launch_tc's
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
  }
  if (err != cudaSuccess) return err;
  const T* x = static_cast<const T*>(a.x);
  const float* s1 = static_cast<const float*>(a.s);
  const float* s2 = static_cast<const float*>(kLevels == 2 ? a.s2 : a.s);
  float* y = static_cast<float*>(a.y);
  int64_t m = a.m, k = a.k, block = a.block;
  void* args[] = {&map_q, &map_q2, &x, &s1, &s2, &y, &m, &k, &block, &stages};
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)), dim3(BM + 32), args, smem,
                         stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_int8_vec(const TcArgs& a, cudaStream_t s) {
  return tall(a.m) ? launch_vec<kInt8, T, 2>(a, s) : launch_vec<kInt8, T, 1>(a, s);
}

// The tile, by B's rows (x columns times parts), as measured on an H100 at
// 65536^2: N = 16 up to 16 rows (N = 8 ran slower: a wgmma's fixed cost),
// N = 32 up to 32, and for two parts N = 64 with one slab (two slabs of
// N = 64 ran slower); one part tiles n by 32 columns above. BM is 256 where
// that gives every SM a CTA (tall), else 128; int8c at N = 16 takes one
// slab (measured faster: its two-slab kernels are ptxas-serialized).
template <int F, bool kBf16, int P, int MS>
cudaError_t tc_by_rows(const TcArgs& a, cudaStream_t s) {
  const int64_t rows = a.n * P;
  if (rows <= 16) return launch_tc<F, kBf16, P, 16, F == kInt8c ? 1 : MS>(a, s);
  if (P == 1 || rows <= 32) return launch_tc<F, kBf16, P, 32, MS>(a, s);
  if constexpr (P == 1) {
    return cudaErrorInvalidValue;  // not reached: one part tiles at N = 32
  } else {
    return launch_tc<F, kBf16, P, 64, 1>(a, s);
  }
}

template <int F, bool kBf16, int P>
cudaError_t tc_by_width(const TcArgs& a, cudaStream_t s) {
  return tall(a.m) ? tc_by_rows<F, kBf16, P, 2>(a, s) : tc_by_rows<F, kBf16, P, 1>(a, s);
}

template <bool kBf16, int P>
cudaError_t tc_by_format(int fmt, const TcArgs& a, cudaStream_t s) {
  switch (fmt) {
    case kInt8: return tc_by_width<kInt8, kBf16, P>(a, s);
    case kInt8c: return tc_by_width<kInt8c, kBf16, P>(a, s);
    case kFp8: return tc_by_width<kFp8, kBf16, P>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool kBf16>
cudaError_t launch_split_x(const TcArgs& a, cudaStream_t s) {
  const int64_t threads = a.n * (a.k / 16);
  const int64_t blocks = (threads + 255) / 256;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  split_x_kernel<T, kBf16><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const T*>(a.x), static_cast<uint16_t*>(a.xs), a.k, a.n, a.parts);
  return cudaGetLastError();
}

// The tensor-core routes: the pre-pass, then the kernel.
cudaError_t launch_tensor_route(int fmt, int dtype, const TcArgs& a, cudaStream_t s) {
  // int8's vector face runs on the CUDA cores: faster there on an H100.
  // int8c's (two levels per word of B) and fp8's (a dearer conversion to
  // fp32) ran faster on the tensor cores.
  if (a.n == 1 && fmt == kInt8) {
    switch (dtype) {
      case 0: return launch_int8_vec<__nv_bfloat16>(a, s);
      case 1: return launch_int8_vec<__half>(a, s);
      case 2: return launch_int8_vec<float>(a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_split_x<__nv_bfloat16, true>(a, s); break;
    case 1: err = launch_split_x<__half, false>(a, s); break;
    case 2: err = launch_split_x<float, true>(a, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  if (dtype == 1) return tc_by_format<false, 1>(fmt, a, s);
  return a.parts == 1 ? tc_by_format<true, 1>(fmt, a, s)
                       : tc_by_format<true, kMaxParts>(fmt, a, s);
}

bool aligned4(const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; }
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// route: 0 wgmma (dtype 0 or 1), 1 wgmma_split (dtype 2), 2 fma (any), as
// ops/cuda_quant.py::quant_route plans it; the tensor-core routes need k %
// 16 == 0, block % 16 == 0 and 16-byte aligned payloads, and xs, 16-byte
// aligned scratch of parts * n * k 16-bit values (2 parts on wgmma_split,
// 1 on wgmma; NULL on fma). fmt: 0 int8, 1 int8c, 2 fp8. dtype: the dtype
// of x, 0 bf16, 1 fp16, 2 fp32, 3 fp64 (y is fp32, fp32, fp32, fp64). q
// (and q2 for int8c, else NULL) is the (m, k) payload, scales (and scales2)
// the (m, k/block) fp32 scales, x is (k, n) and y (m, n), all row-major and
// contiguous (n = 1 for a vector). Launches on `stream` (the tensor-core
// routes: the pre-pass, then the kernel) and returns cudaGetLastError()
// after the launch. A route the shape or dtype does not take is refused
// with cudaErrorInvalidValue: nothing falls back.
extern "C" int matvec_quant_gemv(int route, int fmt, int dtype, const void* q,
                                 const void* scales, const void* q2,
                                 const void* scales2, const void* x, void* y, void* xs,
                                 int64_t m, int64_t k, int64_t n, int64_t block,
                                 void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || block <= 0 || k % block != 0 || fmt < kInt8 ||
      fmt > kFp8 || (fmt == kInt8c) != (q2 != nullptr && scales2 != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kWgmma || route == kWgmmaSplit) {
    const bool dtype_ok = route == kWgmma ? (dtype == 0 || dtype == 1) : dtype == 2;
    if (!dtype_ok || k % 16 != 0 || block % 16 != 0 || !aligned16(q) ||
        (q2 != nullptr && !aligned16(q2)) || xs == nullptr || !aligned16(xs) ||
        m > INT_MAX || k > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const TcArgs a{q, scales, q2, scales2, x, y, xs, m, k, n, block,
                   route == kWgmmaSplit ? kMaxParts : 1};
    return static_cast<int>(launch_tensor_route(fmt, dtype, a, s));
  }
  if (route != kFma) return static_cast<int>(cudaErrorInvalidValue);
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
  switch (fmt) {
    case kInt8: return static_cast<int>(by_dtype<kInt8>(dtype, a, s));
    case kInt8c: return static_cast<int>(by_dtype<kInt8c>(dtype, a, s));
    case kFp8: return static_cast<int>(by_dtype<kFp8>(dtype, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
