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
// byte, so operations bind above n = 40. fp64 runs on DFMA, 34 TFLOP/s
// outside the tensor cores (67 is the fp64 tensor-core DMMA rate, which
// no route here uses). The sweep's square GEMM (n > 128) is bound by
// operations on every route.
//
// Routes, chosen by the wrapper (ops/cuda_gemm.py::default_gemm_tiles) from
// A's dtype, shape and alignment alone, never from n or B:
//
// * wgmma_tma (bf16/fp16, k a multiple of 8 and A 16-byte aligned, so that
//   TMA can describe A). Warp-specialised and persistent: one CTA per SM
//   walks the output tiles; one producer thread keeps TMA loads of A and B
//   tiles (128 bytes of k per row, the 128-byte swizzle) in flight through
//   a ring of S stages in dynamic shared memory, each completing on an
//   mbarrier; two consumer warpgroups run wgmma.mma_async m64nBNk16 with
//   both operands in shared memory and release the stage on a second
//   mbarrier. B reaches shared memory K-major: a one-launch pre-pass
//   transposes it into scratch Bt (n, k), whatever its row pitch (the
//   bucket-4 block's rows are 8 bytes). Faces: (a) n <= 128, the engine's
//   buckets: 128 x BN tiles, BN the smallest of 8, 16, 32, 64, 128 that
//   covers n, so one tile spans every column and A is read from HBM exactly
//   once per dispatch; S up to 8 keeps >= 128 KB of A in flight per SM, and
//   the persistent walk leaves no partial wave of blocks. (b) n > 128, the
//   square GEMM: 256 x 128 tiles (3/4 of the L2 bytes per flop of 128 x
//   128), 4 stages, the consumers' registers raised by setmaxnreg; where
//   B's rows are a multiple of 16 bytes TMA reads B as it is, in two 64 x
//   64 boxes per stage, and wgmma takes it MN-major through its transpose
//   bit (one launch, no pre-pass).
// * mma_sync (bf16/fp16 A that TMA cannot describe: a row pitch that is not
//   a multiple of 16 bytes, or a base that is not 16-byte aligned, as in a
//   ragged k or a shard of an indivisible mesh): mma.sync m16n8k16, 16-byte
//   or scalar loads staged through registers into shared memory.
// * ffma (fp32): a pipelined register-tiled SGEMM, 256 threads on a 128 x BN
//   tile, persistent. A comes by TMA (where its rows are a multiple of 16
//   bytes; cp.async otherwise) into the 128-byte swizzle: rows of 32 floats,
//   k contiguous, so the inner loop reads 4 k of a row as one 16-byte vector
//   without bank conflicts; B comes by cp.async. A ring of S stages. n <=
//   32: a row per thread (two at BN = 32), each row split between two (four)
//   threads, so shared memory serves each A element twice (four times);
//   n > 32: 8 rows x 8 (or 4) columns per thread.
// * dfma (fp64): a 64 x BN DFMA tile, register double buffering.
//
// Numerics (every route): the accumulator is float for bf16/fp16/fp32 input
// and double for fp64 input, and C is written in the accumulator type (the
// registry's contract, ops/gemm_kernels.py). Each k-block (64 for 16-bit
// input, 32 for fp32, 16 for fp64) is summed into a fresh partial (on
// wgmma: the k-block's first instruction runs with scale-d = 0; on FFMA and
// DFMA: a sequential FMA chain from 0), and the partials are added to the
// running sum in k order with round-to-nearest adds. C[i, j] therefore
// depends only on row i of A and column j of B, summed in an order fixed by
// k alone: not by m, n, j, the row's place in a tile, the grid or the SM
// count. The zero pad columns the engine adds cannot change a real column,
// a row slice of A gives the same bits as the whole, and two runs are
// bitwise equal (no split-K, no atomics). The per-k-block partial also keeps
// the tensor cores' own accumulation (which is not round-to-nearest) from
// biasing a long sum. Every BN of a route runs the same instructions on an
// element, so a pad that crosses a tile width changes nothing either.
//
// Every shape is covered: ragged m, k and n read as zeros past the edge (TMA
// fills them, the other routes mask their loads) and are masked on store.
// Indices are 64-bit (65536^2 elements overflow an int).
//
// The TMA maps are encoded on the host per call by cuTensorMapEncodeTiled,
// a libcuda function whose address the runtime hands over
// (cudaGetDriverEntryPointByVersion), so the library is not linked against
// libcuda.
//
// Left for later: a second k-block partial in flight on the operation face
// (the wait before each batch's adds; it needs more than 232 registers at
// 256 x 128), thread block clusters with TMA multicast, B through the
// transpose bit on the byte face, a faster transpose pre-pass, a wider FFMA
// micro-tile (shared-memory wavefronts bound it), an fp64 DMMA route.

#include <cuda.h>          // CUtensorMap and its enums; no libcuda call is linked
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>
#include <type_traits>
#include <vector>

#include "hopper.cuh"

namespace {

// Route codes, as ops/cuda_gemm.py::ROUTE_CODES.
enum Route { kWgmmaTma = 0, kMmaSync = 1, kFfma = 2, kDfma = 3 };

constexpr int kThreads = 256;  // mma_sync, ffma and dfma: 8 warps per block
constexpr int kMmaBM = 128;    // 8 warps x 16 rows
constexpr int kMmaBK = 64;     // four m16n8k16 steps per k-tile
constexpr int kMmaPad = 8;     // shared-memory row pad (bank spread)
constexpr int kSimtBM = 64;
constexpr int kTmaBM = 128;         // two consumer warpgroups x 64 rows
constexpr int kTmaBK = 64;          // 64 16-bit values: 128 bytes, the swizzle span
constexpr int kTmaThreads = 384;    // consumer warpgroups 0, 1; producer 2
constexpr int kTmaMaxStages = 8;
constexpr int kFfmaBM = 128;
constexpr int kFfmaBK = 32;         // 32 floats: 128 bytes per row
constexpr int kFfmaMaxStages = 6;

__device__ __forceinline__ bool in_tile(int64_t r, int64_t nrows, int64_t c,
                                        int64_t ncols) {
  return r < nrows && c < ncols;
}

// ---------------------------------------------------------------- mma_sync

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

// ---------------------------------------------------------------- wgmma_tma

// The pre-pass: Bt (n, k) = B (k, n)^T for 16-bit B, through a 64 x 64
// shared tile (k-tiles on x, so k may exceed 65535 * 64). Each thread reads
// two neighbouring columns of B (one 4-byte load where `pairs`: n even and
// B 4-byte aligned) and writes two neighbouring k of Bt (k is a multiple of
// 8 on this route).
__global__ void __launch_bounds__(256)
transpose16_kernel(const uint16_t* __restrict__ b, uint16_t* __restrict__ bt,
                   int64_t k, int64_t n, bool pairs) {
  __shared__ uint16_t tile[64][66];
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * 64;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * 64;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int r = ty; r < 64; r += 8) {
    const int64_t i = k0 + r, j = n0 + 2 * tx;
    uint16_t lo = 0, hi = 0;
    if (i < k && pairs && j + 1 < n) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(b + i * n + j);
      lo = static_cast<uint16_t>(v), hi = static_cast<uint16_t>(v >> 16);
    } else if (i < k) {
      if (j < n) lo = b[i * n + j];
      if (j + 1 < n) hi = b[i * n + j + 1];
    }
    tile[2 * tx][r] = lo;
    tile[2 * tx + 1][r] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int c = ty; c < 64; c += 8) {
    const int64_t j = n0 + c, i = k0 + 2 * tx;
    if (j >= n || i >= k) continue;
    *reinterpret_cast<uint32_t*>(bt + j * k + i) =
        *reinterpret_cast<const uint32_t*>(&tile[c][2 * tx]);
  }
}

// Dynamic shared memory of the wgmma kernel: 1024 bytes of alignment slack,
// S stages of the A tile (BM x 64) and the Bt tile (BN x 64), and two
// mbarriers per stage.
constexpr int wgmma_smem_bytes(int bm, int bn, int stages) {
  return 1024 + stages * (bm + bn) * kTmaBK * 2 + 16 * stages;
}

// SUBM m64 row blocks per consumer warpgroup: the tile is 128*SUBM x BN.
// SUBM = 2 is the operation face (256 x 128: 3/4 of the L2 bytes per flop
// of 128 x 128); its consumers hold 128 running sums and one 64-register
// partial, so registers move from the producer to them (setmaxnreg).
// kDirectB (operation face, B's rows a multiple of 16 bytes): TMA reads B
// as it is, in two 64 x 64 boxes per stage, and wgmma takes it MN-major
// through its transpose bit; map_b maps B, and no pre-pass runs.
template <bool kBf16, int BN, int SUBM, bool kDirectB>
__global__ void __launch_bounds__(kTmaThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  float* __restrict__ c, int64_t m, int64_t n, int64_t k,
                  int stages) {
  static_assert(!kDirectB || BN % 64 == 0, "direct B loads 64-column boxes");
  constexpr int BM = kTmaBM * SUBM;
  constexpr int kR = BN / 2;  // accumulator registers per thread and m64 block
  constexpr uint32_t kABytes = BM * kTmaBK * 2;
  constexpr uint32_t kBBytes = BN * kTmaBK * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t a_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t b_s = a_s + stages * kABytes;
  const uint32_t full = b_s + stages * kBBytes;  // the stage's tiles landed
  const uint32_t empty = full + 8 * stages;      // the stage's tiles were read
  const int m_tiles = static_cast<int>((m + BM - 1) / BM);
  const int tiles = m_tiles * static_cast<int>((n + BN - 1) / BN);
  const int kblocks = static_cast<int>((k + kTmaBK - 1) / kTmaBK);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every load
    if constexpr (SUBM > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 2 * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int32_t m0 = (t % m_tiles) * BM, n0 = (t / m_tiles) * BN;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(empty + 8 * s, phase ^ 1);  // passes at once on round 0
          mbar_expect_tx(full + 8 * s, kABytes + kBBytes);
          tma_load_2d(a_s + s * kABytes, &map_a, kb * kTmaBK, m0, full + 8 * s);
          if constexpr (kDirectB) {
#pragma unroll
            for (int h = 0; h < BN / 64; ++h) {
              tma_load_2d(b_s + s * kBBytes + h * 64 * 128, &map_b, n0 + 64 * h,
                          kb * kTmaBK, full + 8 * s);
            }
          } else {
            tma_load_2d(b_s + s * kBBytes, &map_b, kb * kTmaBK, n0, full + 8 * s);
          }
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // The consumers: warpgroup wg owns m64 blocks SUBM*wg + u of the tile;
    // in each, thread (warp w, lane l) holds rows 16w + l/4 (+ 8) and, in
    // each 8-column group j, columns 8j + 2(l%4) (+ 1): acc[u][4j + 2h + e].
    if constexpr (SUBM > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    float acc[SUBM][kR], part[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) part[i] = 0.f;
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int64_t m0 = static_cast<int64_t>(t % m_tiles) * BM;
      const int64_t n0 = static_cast<int64_t>(t / m_tiles) * BN;
#pragma unroll
      for (int u = 0; u < SUBM; ++u) {
#pragma unroll
        for (int i = 0; i < kR; ++i) acc[u][i] = 0.f;
      }
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(full + 8 * s, phase);
        const uint64_t db = kDirectB ? sw128_mn_desc(b_s + s * kBBytes)
                                     : sw128_desc(b_s + s * kBBytes);
        constexpr uint64_t kStepB = kDirectB ? 128 : 2;  // k by 16
#pragma unroll
        for (int u = 0; u < SUBM; ++u) {
          const uint64_t da =
              sw128_desc(a_s + s * kABytes + (SUBM * wg + u) * 64 * 128);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kTmaBK / 16; ++ks) {
            wgmma<kBf16, BN, kDirectB>(part, da + 2 * ks, db + kStepB * ks, ks > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(part);
          if (u == SUBM - 1 && lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
          for (int i = 0; i < kR; ++i) acc[u][i] += part[i];
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
#pragma unroll
      for (int u = 0; u < SUBM; ++u) {
        const int64_t r0 = m0 + (SUBM * wg + u) * 64 + warp * 16 + lane / 4;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int64_t col = n0 + j * 8 + 2 * (lane % 4);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int64_t row = r0 + 8 * h;
            if (row >= m || col >= n) continue;
            float* dst = c + row * n + col;
            const float v0 = acc[u][4 * j + 2 * h], v1 = acc[u][4 * j + 2 * h + 1];
            if (col + 1 < n && n % 2 == 0) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              dst[0] = v0;
              if (col + 1 < n) dst[1] = v1;
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- ffma

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// Waits until at most `pending` groups are in flight (an immediate in PTX).
__device__ __forceinline__ void cp_async_wait_dyn(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// 256 threads on a 128 x BN tile, TM rows x TN columns each. A sits in
// shared memory as TMA's 128-byte swizzle writes it: rows of 32 floats (k
// contiguous), the 16-byte chunk c of row r at c ^ (r % 8), so a thread
// reads 4 k of a row as one 16-byte vector and eight neighbouring rows hit
// eight distinct chunks. Byte face (BN <= 32): one row (two at BN = 32) per
// thread, each row split between two (four) threads, so A is read from
// shared memory twice (four times), not BN times. Operation face (BN >=
// 64): 8 rows (strided by 16) x 8 (or 4) columns per thread.
template <int BN>
struct FfmaShape {
  static constexpr bool kWide = BN >= 64;
  static constexpr int CT = kWide ? 16 : BN == 32 ? 4 : 2;  // column threads
  static constexpr int TN = BN / CT;         // 8, 4 | 8, 8, 4
  static constexpr int RT = kThreads / CT;   // row threads: 16 | 128
  static constexpr int TM = kFfmaBM / RT;    // 8 | 1
  __device__ static constexpr int col(int jj, int tx) {
    return TN == 8 && kWide ? (jj / 4) * 64 + tx * 4 + jj % 4 : tx * TN + jj;
  }
};

// Dynamic shared memory of the ffma kernel: 1024 bytes of alignment slack,
// S stages of the A tile (128 x 32) and the B tile (32 x BN), and an
// mbarrier per stage.
constexpr int ffma_smem_bytes(int bn, int stages) {
  return 1024 + stages * (kFfmaBM + bn) * kFfmaBK * 4 + 8 * stages;
}

// a_tma: A's rows are a multiple of 16 bytes and its base 16-byte aligned,
// so one thread brings each A tile by TMA (map_a) and the stage's mbarrier
// reports it; otherwise every thread copies A by cp.async into the same
// swizzled layout. B always comes by cp.async (16-byte where b_vec).
template <int BN>
__global__ void __launch_bounds__(kThreads)
gemm_ffma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ c, int64_t m, int64_t n, int64_t k,
                 int stages, bool a_tma, bool b_vec) {
  using S = FfmaShape<BN>;
  constexpr int TM = S::TM, TN = S::TN, RT = S::RT;
  constexpr int kAFloats = kFfmaBM * kFfmaBK, kBFloats = kFfmaBK * BN;
  extern __shared__ uint8_t fsmem_raw[];
  float* const as = reinterpret_cast<float*>(
      fsmem_raw + ((1024 - smem_u32(fsmem_raw) % 1024) % 1024));  // stages x A
  float* const bs = as + stages * kAFloats;                        // stages x B
  const uint32_t full = smem_u32(bs + stages * kBFloats);          // A landed
  const int m_tiles = static_cast<int>((m + kFfmaBM - 1) / kFfmaBM);
  const int tiles = m_tiles * static_cast<int>((n + BN - 1) / BN);
  const int kblocks = static_cast<int>((k + kFfmaBK - 1) / kFfmaBK);
  // Lanes 8q..8q+7 share q: one tx (B reads broadcast) and eight
  // neighbouring rows (A reads hit eight distinct 16-byte chunks).
  const int q = threadIdx.x / 8;
  const int ty = threadIdx.x % 8 + 8 * (q % (RT / 8));
  const int tx = q / (RT / 8);
  const int sw = ty % 8;  // every row this thread reads is ty mod 8
  if (a_tma && threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto load = [&](int slot, int64_t m0, int64_t n0, int kb) {
    const uint32_t a_dst = smem_u32(as + slot * kAFloats);
    const uint32_t b_dst = smem_u32(bs + slot * kBFloats);
    const int64_t k0 = static_cast<int64_t>(kb) * kFfmaBK;
    if (a_tma) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(full + 8 * slot, kAFloats * 4);
        tma_load_2d(a_dst, &map_a, static_cast<int32_t>(k0), static_cast<int32_t>(m0),
                    full + 8 * slot);
      }
    } else {
      for (int v = threadIdx.x; v < kFfmaBM * 8; v += kThreads) {
        const int row = v / 8, ch = v % 8;
        const int64_t gr = m0 + row, gc = k0 + ch * 4;
        const uint32_t dst = a_dst + (row * kFfmaBK + (ch ^ (row % 8)) * 4) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gr < m && gc + e < k;
          cp_async4(dst + 4 * e, ok ? a + gr * k + gc + e : a, ok ? 4 : 0);
        }
      }
    }
    for (int v = threadIdx.x; v < kFfmaBK * BN / 4; v += kThreads) {
      const int row = v / (BN / 4), ch = v % (BN / 4);
      const int64_t gr = k0 + row, gc = n0 + ch * 4;
      const uint32_t dst = b_dst + (row * BN + ch * 4) * 4;
      if (b_vec) {  // n % 4 == 0
        const bool ok = gr < k && gc < n;
        cp_async16(dst, ok ? b + gr * n + gc : b, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gr < k && gc + e < n;
          cp_async4(dst + 4 * e, ok ? b + gr * n + gc + e : b, ok ? 4 : 0);
        }
      }
    }
  };

  // This thread's TN columns of B row kk, as 16-byte vectors.
  auto b_row = [&](const float* bt, int kk, float (&bv)[TN]) {
#pragma unroll
    for (int jj = 0; jj < TN; jj += 4) {
      const float4 v = *reinterpret_cast<const float4*>(bt + kk * BN + S::col(jj, tx));
      bv[jj] = v.x, bv[jj + 1] = v.y, bv[jj + 2] = v.z, bv[jj + 3] = v.w;
    }
  };

  int iter = 0;  // k-blocks consumed so far by this CTA: slot and phase
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t m0 = static_cast<int64_t>(t % m_tiles) * kFfmaBM;
    const int64_t n0 = static_cast<int64_t>(t / m_tiles) * BN;
    float acc[TM][TN] = {};
    for (int st = 0; st < stages - 1; ++st) {
      if (st < kblocks) load((iter + st) % stages, m0, n0, st);
      cp_async_commit();
    }
    for (int kb = 0; kb < kblocks; ++kb, ++iter) {
      const int slot = iter % stages;
      cp_async_wait_dyn(stages - 2);  // k-block kb's cp.async copies landed
      if (a_tma) mbar_wait(full + 8 * slot, (iter / stages) % 2);
      __syncthreads();  // for every thread; the slot of kb - 1 is free
      if (kb + stages - 1 < kblocks) {
        load((iter + stages - 1) % stages, m0, n0, kb + stages - 1);
      }
      cp_async_commit();
      const float* at = as + slot * kAFloats;
      const float* bt = bs + slot * kBFloats;
      // A fresh partial, summed over k in order (one FMA chain per element);
      // B's rows are read ahead of their FMAs (D k ahead at one row per
      // thread, where a k holds only TN FMAs).
      float part[TM][TN] = {};
      constexpr int D = TM > 1 || TN >= 16 ? 2 : TN == 8 ? 4 : 6;
      float bv[D][TN];
#pragma unroll
      for (int d = 0; d < D; ++d) b_row(bt, d, bv[d]);
#pragma unroll
      for (int kc = 0; kc < kFfmaBK / 4; ++kc) {
        float ak[TM][4];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              at + (ty + RT * i) * kFfmaBK + (kc ^ sw) * 4);
          ak[i][0] = v.x, ak[i][1] = v.y, ak[i][2] = v.z, ak[i][3] = v.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 4 * kc + e;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int jj = 0; jj < TN; ++jj) {
              part[i][jj] = fmaf(ak[i][e], bv[kk % D][jj], part[i][jj]);
            }
          }
          if (kk + D < kFfmaBK) b_row(bt, kk + D, bv[kk % D]);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) acc[i][jj] += part[i][jj];
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next tile's prologue
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t row = m0 + ty + RT * i;
      if (row >= m) continue;
#pragma unroll
      for (int jj = 0; jj < TN; jj += 4) {
        const int64_t col = n0 + S::col(jj, tx);
        float* dst = c + row * n + col;
        if (n % 4 == 0 && col + 4 <= n) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][jj], acc[i][jj + 1], acc[i][jj + 2], acc[i][jj + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (col + e < n) dst[e] = acc[i][jj + e];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- dfma

// fp64: a (64 x BN) block tile; thread (tx, ty) owns rows ty + i*RG and
// columns tx + j*TXN.
template <int BN>
__global__ void __launch_bounds__(kThreads)
gemm_dfma_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                 double* __restrict__ c, int64_t m, int64_t n, int64_t k,
                 bool a_vec, bool b_vec) {
  constexpr int BM = kSimtBM;
  constexpr int BK = 16;
  constexpr int TXN = BN < 16 ? BN : 16;   // column lanes
  constexpr int RG = kThreads / TXN;       // row groups
  constexpr int TM = BM / RG;              // rows per thread
  constexpr int TN = BN / TXN;             // columns per thread
  __shared__ double as[BM][BK + 1];
  __shared__ __align__(16) double bs[BK][BN];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int tx = threadIdx.x % TXN, ty = threadIdx.x / TXN;

  Staged<uint64_t, BM, BK> ta;
  Staged<uint64_t, BK, BN> tb;
  double acc[TM][TN] = {};
  const int64_t tiles = (k + BK - 1) / BK;
  ta.template load<true>(a, m, k, m0, 0, a_vec);
  tb.template load<false>(b, k, n, 0, n0, b_vec);
  for (int64_t kt = 0; kt < tiles; ++kt) {
    __syncthreads();
    ta.for_each([&](int row, int col, const uint4& q) {
      const double* e = reinterpret_cast<const double*>(&q);
      as[row][col] = e[0];
      as[row][col + 1] = e[1];
    });
    tb.for_each([&](int row, int col, const uint4& q) {
      *reinterpret_cast<uint4*>(&bs[row][col]) = q;
    });
    __syncthreads();
    if (kt + 1 < tiles) {
      ta.template load<true>(a, m, k, m0, (kt + 1) * BK, a_vec);
      tb.template load<false>(b, k, n, (kt + 1) * BK, n0, b_vec);
    }
    double part[TM][TN] = {};
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      double av[TM], bv[TN];
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

// ---------------------------------------------------------------- host

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// f(std::integral_constant<int, BN>) for the plan's BN.
template <typename F>
cudaError_t with_bn(int bn, F&& f) {
  switch (bn) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

// A kernel with its launch shape. The persistent routes launch
// min(tiles, resident blocks) CTAs; their dynamic shared memory is opted in
// above 48 KB.
struct Launch {
  const void* fn;
  int threads;
  int smem;  // dynamic bytes
  dim3 grid;
};

cudaError_t persistent_grid(Launch* l, int64_t tiles) {
  // Each (kernel, bytes, device) has its resident blocks per SM counted
  // once: the serving engine calls a few plans over and over. The opt-in is
  // the kernel's, for the whole process, and one kernel may run with
  // several stage counts (the tuner races them) from any thread: it only
  // ever rises, to the largest size launched, so no launch lowers it under
  // another's. One table for every thread, under a lock.
  struct Seen { const void* fn; int smem, dev, per_sm; };
  struct OptIn { const void* fn; int dev, smem; };
  static std::mutex lock;
  static std::vector<Seen> seen;
  static std::vector<OptIn> opted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> hold(lock);
    for (const Seen& e : seen) {
      if (e.fn == l->fn && e.smem == l->smem && e.dev == dev) per_sm = e.per_sm;
    }
    if (per_sm == 0) {
      OptIn* mine = nullptr;
      for (OptIn& e : opted) {
        if (e.fn == l->fn && e.dev == dev) mine = &e;
      }
      if (mine == nullptr || mine->smem < l->smem) {
        err = cudaFuncSetAttribute(l->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   l->smem);
        if (err != cudaSuccess) return err;
        if (mine == nullptr) {
          opted.push_back({l->fn, dev, l->smem});
        } else {
          mine->smem = l->smem;
        }
      }
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l->fn, l->threads,
                                                          l->smem);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      seen.push_back({l->fn, l->smem, dev, per_sm});
    }
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  l->grid = dim3(static_cast<unsigned>(tiles < resident ? tiles : resident));
  return cudaSuccess;
}

// The launch shape of (dtype, route, BM, BN, stages) at (m, n), or an error
// for a plan the kernels do not take. direct_b: wgmma_tma reads B with TMA
// as it is (the operation face), not a transposed copy.
cudaError_t plan_launch(int dtype, int route, int bm, int bn, int stages,
                        bool direct_b, int64_t m, int64_t n, Launch* l) {
  const int64_t n_tiles = (n + bn - 1) / bn;
  return with_bn(bn, [&](auto bn_c) -> cudaError_t {
    constexpr int BN = decltype(bn_c)::value;
    switch (route) {
      case kWgmmaTma: {
        const bool wide = bm == 2 * kTmaBM && BN == 128;
        if (dtype > 1 || (bm != kTmaBM && !wide) || stages < 2 ||
            stages > kTmaMaxStages) {
          return cudaErrorInvalidValue;
        }
        const int64_t tiles = (m + bm - 1) / bm * n_tiles;
        if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
        if (direct_b && !wide) return cudaErrorInvalidValue;
        const void* fn =
            !wide ? (dtype == 0 ? reinterpret_cast<const void*>(gemm_wgmma_kernel<true, BN, 1, false>)
                                : reinterpret_cast<const void*>(gemm_wgmma_kernel<false, BN, 1, false>))
            : direct_b
                ? (dtype == 0 ? reinterpret_cast<const void*>(gemm_wgmma_kernel<true, 128, 2, true>)
                              : reinterpret_cast<const void*>(gemm_wgmma_kernel<false, 128, 2, true>))
                : (dtype == 0 ? reinterpret_cast<const void*>(gemm_wgmma_kernel<true, 128, 2, false>)
                              : reinterpret_cast<const void*>(gemm_wgmma_kernel<false, 128, 2, false>));
        *l = {fn, kTmaThreads, wgmma_smem_bytes(bm, BN, stages), dim3(1)};
        return persistent_grid(l, tiles);
      }
      case kFfma: {
        if (dtype != 2 || bm != kFfmaBM || stages < 2 || stages > kFfmaMaxStages) {
          return cudaErrorInvalidValue;
        }
        const int64_t tiles = (m + kFfmaBM - 1) / kFfmaBM * n_tiles;
        if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
        *l = {reinterpret_cast<const void*>(gemm_ffma_kernel<BN>), kThreads,
              ffma_smem_bytes(BN, stages), dim3(1)};
        return persistent_grid(l, tiles);
      }
      case kMmaSync:
      case kDfma: {
        const bool mma = route == kMmaSync;
        if ((mma ? dtype > 1 : dtype != 3) || bm != (mma ? kMmaBM : kSimtBM) ||
            stages != 1) {
          return cudaErrorInvalidValue;
        }
        if ((m + bm - 1) / bm > INT_MAX || n_tiles > 65535) {
          return cudaErrorInvalidConfiguration;
        }
        const void* fn =
            !mma ? reinterpret_cast<const void*>(gemm_dfma_kernel<BN>)
            : dtype == 0 ? reinterpret_cast<const void*>(gemm_mma_kernel<true, BN>)
                         : reinterpret_cast<const void*>(gemm_mma_kernel<false, BN>);
        *l = {fn, kThreads, 0,
              dim3(static_cast<unsigned>((m + bm - 1) / bm), static_cast<unsigned>(n_tiles))};
        return cudaSuccess;
      }
      default:
        return cudaErrorInvalidValue;
    }
  });
}

// A row-major (rows x cols) matrix of `dtype` (0 bf16, 1 fp16, 2 fp32) as a
// TMA map with a (box_rows x 128 bytes) box: 128 bytes of each row, the
// 128-byte swizzle, zeros past the edge.
cudaError_t encode_map(CUtensorMap* map, const void* ptr, int64_t rows,
                       int64_t cols, int box_rows, int dtype) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int itemsize = dtype == 2 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * itemsize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / itemsize),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUtensorMapDataType type = dtype == 0   ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 bf16, 1 fp16, 2 fp32, 3 fp64 (C is fp32, fp32, fp32, fp64).
// route: 0 wgmma_tma, 1 mma_sync, 2 ffma, 3 dfma; bm, bn and stages as
// ops/cuda_gemm.py::default_gemm_tiles plans them. A is (m, k), B is (k, n)
// and C is (m, n), all row-major and contiguous; bt is scratch of n*k
// elements of A's type, 16-byte aligned, for wgmma_tma's transposed B. On
// wgmma_tma's operation face (bm 256) with n % 8 == 0 and B 16-byte
// aligned, bt may be NULL: TMA then reads B as it is. Launches on `stream`
// (wgmma_tma with bt: the transpose, then the GEMM) and
// returns cudaGetLastError() after the launch. A plan a route cannot take
// (wgmma_tma with k % 8 != 0 or an unaligned A, a tile or stage count it
// was not built for) is refused with cudaErrorInvalidValue: nothing falls
// back.
extern "C" int matvec_gemm(int dtype, int route, int bm, int bn, int stages,
                           const void* a, const void* b, void* bt, void* c,
                           int64_t m, int64_t n, int64_t k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool direct_b = route == kWgmmaTma && bt == nullptr;
  if (route == kWgmmaTma &&
      (k % 8 != 0 || !aligned16(a) || (direct_b ? n % 8 != 0 || !aligned16(b)
                                                : !aligned16(bt)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch l;
  cudaError_t err = plan_launch(dtype, route, bm, bn, stages, direct_b, m, n, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case kWgmmaTma: {
      CUtensorMap map_a, map_b;
      if ((err = encode_map(&map_a, a, m, k, bm, dtype)) != cudaSuccess) {
        return static_cast<int>(err);
      }
      if (direct_b) {
        err = encode_map(&map_b, b, k, n, 64, dtype);
      } else {
        const bool pairs = n % 2 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
        transpose16_kernel<<<dim3(static_cast<unsigned>((k + 63) / 64),
                                  static_cast<unsigned>((n + 63) / 64)),
                             dim3(32, 8), 0, s>>>(static_cast<const uint16_t*>(b),
                                                   static_cast<uint16_t*>(bt), k, n, pairs);
        if ((err = cudaGetLastError()) == cudaSuccess) {
          err = encode_map(&map_b, bt, n, k, bn, dtype);
        }
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      float* cf = static_cast<float*>(c);
      void* args[] = {&map_a, &map_b, &cf, &m, &n, &k, &stages};
      err = cudaLaunchKernel(l.fn, l.grid, dim3(l.threads), args, l.smem, s);
      break;
    }
    case kFfma: {
      const float* af = static_cast<const float*>(a);
      const float* bf = static_cast<const float*>(b);
      float* cf = static_cast<float*>(c);
      bool a_tma = k % 4 == 0 && aligned16(a), b_vec = n % 4 == 0 && aligned16(b);
      CUtensorMap map_a = {};
      if (a_tma && (err = encode_map(&map_a, a, m, k, kFfmaBM, 2)) != cudaSuccess) {
        return static_cast<int>(err);
      }
      void* args[] = {&map_a, &af, &bf, &cf, &m, &n, &k, &stages, &a_tma, &b_vec};
      err = cudaLaunchKernel(l.fn, l.grid, dim3(l.threads), args, l.smem, s);
      break;
    }
    default: {  // mma_sync (16-bit) and dfma (fp64): 16-byte vectors where aligned
      const int vec = route == kMmaSync ? 8 : 2;
      bool a_vec = k % vec == 0 && aligned16(a), b_vec = n % vec == 0 && aligned16(b);
      void* args[] = {const_cast<void**>(&a), const_cast<void**>(&b), &c, &m, &n, &k,
                      &a_vec, &b_vec};
      err = cudaLaunchKernel(l.fn, l.grid, dim3(l.threads), args, 0, s);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of a plan, for reports: out[0] the grid's CTAs, out[1]
// registers per thread, out[2] dynamic and out[3] static shared-memory
// bytes per CTA, out[4] threads per CTA. direct_b as matvec_gemm's NULL bt.
// Returns a cudaError_t code.
extern "C" int matvec_gemm_launch_info(int dtype, int route, int bm, int bn,
                                       int stages, int direct_b, int64_t m,
                                       int64_t n, int* out) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Launch l;
  cudaError_t err = plan_launch(dtype, route, bm, bn, stages, direct_b != 0, m, n, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, l.fn)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  out[0] = static_cast<int>(l.grid.x * l.grid.y);
  out[1] = attr.numRegs;
  out[2] = l.smem;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = l.threads;
  return static_cast<int>(cudaSuccess);
}
