// Hand-written GEMM for Hopper (sm_90a): C[m, n] = A[m, k] @ B[k, n].
//
// Replaces the TPU kernel matvec_mpi_multiplier_tpu/ops/pallas_gemm.py::
// _mm_kernel, which walks a sequential (m/bm, n/bn, k/bk) grid with the
// contraction innermost and keeps each (bm, bn) block of C resident in VMEM
// as an fp32 accumulator. Hopper has no ordered grid, so the contraction
// walk becomes a loop inside one block, and the accumulator lives in the
// block's registers.
//
// What bounds it: at serving widths (the engine's buckets, n <= 128) the
// bytes of A. A GEMM does 2*n flops per element of A it reads. For bf16
// input on the tensor cores (989 TFLOP/s) the ridge is ~295 flops per byte,
// and at n = 32 the kernel does 32 flops per byte: bound by HBM bytes,
//   ((m*k + k*n)*itemsize + m*n*acc_itemsize) / HBM rate.
// fp32 input runs on FFMA (67 TFLOP/s, IEEE, never TF32): n/2 flops per
// byte, so operations bind above n = 40. fp64 runs on DFMA (67 TFLOP/s).
// What the design does about it: for n <= 128 one block's tile spans all
// n columns (BN is the smallest of 8, 16, 32, 64, 128 that covers n), so A
// is read from HBM exactly once per dispatch, the point of the engine's
// GEMV->GEMM promotion. Only wider n (the sweep's square GEMM) is tiled
// over n, in 128-column tiles. Tiles of A and B go through registers into
// shared memory; the next tile's loads are in flight while the current one
// is multiplied (register double buffering). A streams with __ldcs in
// 16-byte loads, B (small, re-read by every row block) through __ldg.
//
// Routes: bf16 and fp16 use mma.sync m16n8k16 with fp32 accumulate (one
// warp owns 16 rows and all BN columns). fp32 uses FFMA and fp64 uses DFMA
// on a (BM x BN) thread tile.
//
// Numerics: the accumulator is float for bf16/fp16/fp32 input and double
// for fp64 input, and C is written in the accumulator type (the registry's
// contract, ops/gemm_kernels.py). Each k-tile (64 for bf16/fp16, 32 for
// fp32, 16 for fp64) is summed into a fresh partial, and the partials are
// added to the running sum in k order with round-to-nearest adds. C[i, j] therefore depends only on row i
// of A and column j of B, summed in an order fixed by k alone: not by n,
// not by j, not by the other columns. The zero pad columns the engine adds
// cannot change a real column, and two runs are bitwise equal (no split-K,
// no atomics). The per-k-tile partial also keeps the tensor cores' own
// accumulation (which is not round-to-nearest) from biasing a long sum.
//
// Every shape is covered: ragged m, k and n read as zeros past the edge
// and are masked on store; rows whose pitch or base is not 16-byte aligned
// take scalar loads. Indices are 64-bit (65536^2 elements overflow an int).
// Shared memory stays under the 48 KB a static allocation may use, so no
// cudaFuncSetAttribute is needed.
//
// Left for later: TMA/cp.async multi-stage pipelines, wgmma, and a
// persistent schedule; ldmatrix fragment loads.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kMmaBM = 128;    // 8 warps x 16 rows
constexpr int kMmaBK = 64;     // four m16n8k16 steps per k-tile
constexpr int kMmaPad = 8;     // shared-memory row pad (bank spread)
constexpr int kSimtBM = 64;

__device__ __forceinline__ bool in_tile(int64_t r, int64_t nrows, int64_t c,
                                        int64_t ncols) {
  return r < nrows && c < ncols;
}

// A ROWS x COLS tile of a row-major (nrows x ncols) matrix, staged in this
// thread's registers as 16-byte vectors. Elements past the matrix read as
// zero bits (+0.0 in every float type).
template <typename Bits, int ROWS, int COLS>
struct Staged {
  static constexpr int kVec = 16 / sizeof(Bits);
  static constexpr int kVecsPerRow = COLS / kVec;
  static constexpr int kVecs = ROWS * kVecsPerRow;
  static constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
  static_assert(COLS % kVec == 0, "tile width must hold whole vectors");
  uint4 raw[kPer];

  template <bool kStream>
  __device__ __forceinline__ void load(const Bits* __restrict__ src,
                                       int64_t nrows, int64_t ncols,
                                       int64_t r0, int64_t c0, bool vec) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v >= kVecs) break;
      const int64_t gr = r0 + v / kVecsPerRow;
      const int64_t gc = c0 + (v % kVecsPerRow) * kVec;
      if (vec && gr < nrows && gc + kVec <= ncols) {
        const uint4* p = reinterpret_cast<const uint4*>(src + gr * ncols + gc);
        raw[i] = kStream ? __ldcs(p) : __ldg(p);
      } else {
        Bits* e = reinterpret_cast<Bits*>(&raw[i]);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          e[j] = in_tile(gr, nrows, gc + j, ncols) ? src[gr * ncols + gc + j]
                                                   : Bits(0);
        }
      }
    }
  }

  // f(row, col, vector) for each vector this thread holds.
  template <typename F>
  __device__ __forceinline__ void for_each(F&& f) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v >= kVecs) break;
      f(v / kVecsPerRow, (v % kVecsPerRow) * kVec, raw[i]);
    }
  }
};

template <bool kBf16>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (kBf16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// bf16/fp16: warp w owns rows [16w, 16w + 16) of the block's 128 and all BN
// columns, as BN/8 m16n8 accumulator tiles.
template <bool kBf16, int BN>
__global__ void __launch_bounds__(kThreads)
gemm_mma_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                float* __restrict__ c, int64_t m, int64_t n, int64_t k,
                bool a_vec, bool b_vec) {
  constexpr int BM = kMmaBM, BK = kMmaBK, NT = BN / 8;
  __shared__ __align__(16) uint16_t as[BM][BK + kMmaPad];
  __shared__ __align__(16) uint16_t bs[BN][BK + kMmaPad];  // B^T: k contiguous
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int r = warp * 16 + g;

  Staged<uint16_t, BM, BK> ta;
  Staged<uint16_t, BK, BN> tb;
  float acc[NT][4] = {};
  const int64_t tiles = (k + BK - 1) / BK;
  ta.template load<true>(a, m, k, m0, 0, a_vec);
  tb.template load<false>(b, k, n, 0, n0, b_vec);
  for (int64_t kt = 0; kt < tiles; ++kt) {
    __syncthreads();  // the previous tile is consumed
    ta.for_each([&](int row, int col, const uint4& q) {
      *reinterpret_cast<uint4*>(&as[row][col]) = q;
    });
    tb.for_each([&](int row, int col, const uint4& q) {
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&q);
#pragma unroll
      for (int j = 0; j < 8; ++j) bs[col + j][row] = e[j];
    });
    __syncthreads();
    if (kt + 1 < tiles) {  // in flight while this tile is multiplied
      ta.template load<true>(a, m, k, m0, (kt + 1) * BK, a_vec);
      tb.template load<false>(b, k, n, (kt + 1) * BK, n0, b_vec);
    }
    float part[NT][4] = {};
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(&as[r][ks + 2 * t]);
      af[1] = *reinterpret_cast<const uint32_t*>(&as[r + 8][ks + 2 * t]);
      af[2] = *reinterpret_cast<const uint32_t*>(&as[r][ks + 2 * t + 8]);
      af[3] = *reinterpret_cast<const uint32_t*>(&as[r + 8][ks + 2 * t + 8]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(&bs[nt * 8 + g][ks + 2 * t]);
        bf[1] = *reinterpret_cast<const uint32_t*>(&bs[nt * 8 + g][ks + 2 * t + 8]);
        mma16816<kBf16>(part[nt], af, bf);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += part[nt][i];
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = m0 + r + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t col = n0 + nt * 8 + 2 * t + e;
        if (in_tile(row, m, col, n)) c[row * n + col] = acc[nt][2 * h + e];
      }
    }
  }
}

// fp32/fp64: a (64 x BN) block tile; thread (tx, ty) owns rows ty + i*RG
// and columns tx + j*TXN.
template <typename T, typename Bits, int BN>
__global__ void __launch_bounds__(kThreads)
gemm_simt_kernel(const Bits* __restrict__ a, const Bits* __restrict__ b,
                 T* __restrict__ c, int64_t m, int64_t n, int64_t k,
                 bool a_vec, bool b_vec) {
  constexpr int BM = kSimtBM;
  constexpr int BK = 128 / sizeof(T);      // 32 fp32, 16 fp64
  constexpr int TXN = BN < 16 ? BN : 16;   // column lanes
  constexpr int RG = kThreads / TXN;       // row groups
  constexpr int TM = BM / RG;              // rows per thread
  constexpr int TN = BN / TXN;             // columns per thread
  __shared__ T as[BM][BK + 1];
  __shared__ __align__(16) T bs[BK][BN];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int tx = threadIdx.x % TXN, ty = threadIdx.x / TXN;

  Staged<Bits, BM, BK> ta;
  Staged<Bits, BK, BN> tb;
  T acc[TM][TN] = {};
  const int64_t tiles = (k + BK - 1) / BK;
  ta.template load<true>(a, m, k, m0, 0, a_vec);
  tb.template load<false>(b, k, n, 0, n0, b_vec);
  for (int64_t kt = 0; kt < tiles; ++kt) {
    __syncthreads();
    ta.for_each([&](int row, int col, const uint4& q) {
      const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
      for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j) as[row][col + j] = e[j];
    });
    tb.for_each([&](int row, int col, const uint4& q) {
      *reinterpret_cast<uint4*>(&bs[row][col]) = q;
    });
    __syncthreads();
    if (kt + 1 < tiles) {
      ta.template load<true>(a, m, k, m0, (kt + 1) * BK, a_vec);
      tb.template load<false>(b, k, n, (kt + 1) * BK, n0, b_vec);
    }
    T part[TM][TN] = {};
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      T av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[ty + i * RG][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + j * TXN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fma(av[i], bv[j], part[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = m0 + ty + i * RG;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t col = n0 + tx + j * TXN;
      if (in_tile(row, m, col, n)) c[row * n + col] = acc[i][j];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int BM, int BN>
dim3 grid_for(int64_t m, int64_t n) {
  return dim3(static_cast<unsigned>((m + BM - 1) / BM),
              static_cast<unsigned>((n + BN - 1) / BN));
}

template <bool kBf16, int BN>
cudaError_t run_mma(const void* a, const void* b, void* c, int64_t m, int64_t n,
                    int64_t k, cudaStream_t s) {
  gemm_mma_kernel<kBf16, BN><<<grid_for<kMmaBM, BN>(m, n), kThreads, 0, s>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
      static_cast<float*>(c), m, n, k, k % 8 == 0 && aligned16(a),
      n % 8 == 0 && aligned16(b));
  return cudaGetLastError();
}

template <typename T, typename Bits, int BN>
cudaError_t run_simt(const void* a, const void* b, void* c, int64_t m,
                     int64_t n, int64_t k, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  gemm_simt_kernel<T, Bits, BN><<<grid_for<kSimtBM, BN>(m, n), kThreads, 0, s>>>(
      static_cast<const Bits*>(a), static_cast<const Bits*>(b),
      static_cast<T*>(c), m, n, k, k % kVec == 0 && aligned16(a),
      n % kVec == 0 && aligned16(b));
  return cudaGetLastError();
}

// The block width: the smallest of 8..128 that covers n, so that for
// n <= 128 one block spans every column and A streams once.
template <template <int> class Run>
cudaError_t by_width(const void* a, const void* b, void* c, int64_t m,
                     int64_t n, int64_t k, cudaStream_t s) {
  if (n <= 8) return Run<8>::go(a, b, c, m, n, k, s);
  if (n <= 16) return Run<16>::go(a, b, c, m, n, k, s);
  if (n <= 32) return Run<32>::go(a, b, c, m, n, k, s);
  if (n <= 64) return Run<64>::go(a, b, c, m, n, k, s);
  return Run<128>::go(a, b, c, m, n, k, s);
}

template <int BN> struct MmaBf16 {
  static cudaError_t go(const void* a, const void* b, void* c, int64_t m,
                        int64_t n, int64_t k, cudaStream_t s) {
    return run_mma<true, BN>(a, b, c, m, n, k, s);
  }
};
template <int BN> struct MmaF16 {
  static cudaError_t go(const void* a, const void* b, void* c, int64_t m,
                        int64_t n, int64_t k, cudaStream_t s) {
    return run_mma<false, BN>(a, b, c, m, n, k, s);
  }
};
template <int BN> struct SimtF32 {
  static cudaError_t go(const void* a, const void* b, void* c, int64_t m,
                        int64_t n, int64_t k, cudaStream_t s) {
    return run_simt<float, uint32_t, BN>(a, b, c, m, n, k, s);
  }
};
template <int BN> struct SimtF64 {
  static cudaError_t go(const void* a, const void* b, void* c, int64_t m,
                        int64_t n, int64_t k, cudaStream_t s) {
    return run_simt<double, uint64_t, BN>(a, b, c, m, n, k, s);
  }
};

}  // namespace

// dtype: 0 bf16, 1 fp16, 2 fp32, 3 fp64 (C is fp32, fp32, fp32, fp64).
// A is (m, k), B is (k, n) and C is (m, n), all row-major and contiguous.
// Launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int matvec_gemm(int dtype, const void* a, const void* b, void* c,
                           int64_t m, int64_t n, int64_t k, void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((m + kSimtBM - 1) / kSimtBM > INT_MAX || (n + 127) / 128 > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(by_width<MmaBf16>(a, b, c, m, n, k, s));
    case 1: return static_cast<int>(by_width<MmaF16>(a, b, c, m, n, k, s));
    case 2: return static_cast<int>(by_width<SimtF32>(a, b, c, m, n, k, s));
    case 3: return static_cast<int>(by_width<SimtF64>(a, b, c, m, n, k, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
