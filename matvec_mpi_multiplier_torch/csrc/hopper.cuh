// Hopper (sm_90a) building blocks shared by the kernels that feed the
// tensor cores through TMA: shared-memory addresses, mbarriers, TMA tile
// loads, wgmma descriptors for the 128-byte swizzle and the wgmma
// instructions themselves (A from shared memory, or from registers), and the
// host's handle on cuTensorMapEncodeTiled. Included by gemm.cu,
// flash_attention.cu and quant_gemv.cu; everything is internal to the
// including source (an anonymous namespace).

#pragma once

#include <cuda.h>          // CUtensorMap and its enums; no libcuda call is linked
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

// Spins until the barrier's phase with this parity has completed. A wait
// that never ends (a broken protocol) traps after 2^28 polls, seconds at
// the least, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// One TMA tile load: box (c0 along the contiguous dimension, c1 rows),
// completing on `bar` with its byte count (zero-filled edges included).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int32_t c0, int32_t c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The same for a 3-D map: box (c0 along the contiguous dimension, c1, c2).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int32_t c0, int32_t c1, int32_t c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// The wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of
// 128 bytes (64 16-bit values of k) as TMA wrote them, 8-row groups 1024
// bytes apart (SBO), the tile 1024-byte aligned so the base offset is 0.
// Adding 2 (32 bytes) steps k by 16 inside the swizzle span.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// The same for an MN-major B tile (wgmma's transpose bit): k rows of 128
// bytes (64 16-bit values of n) as TMA wrote them from row-major B, 8-row
// k groups 1024 bytes apart (SBO), 64-column chunks 8192 bytes apart (LBO:
// two 64 x 64 boxes per stage). Adding 128 (2048 bytes) steps k by 16.
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (512ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Ties the registers to this point: reads after it wait for the wgmma
// results the preceding wait_group guarantees.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, f32 += 16-bit x 16-bit, A and B K-major in
// shared memory; accumulate == 0 makes it D = A*B (scale-d = 0).
#define MATVEC_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MATVEC_D8(i) MATVEC_D4(i), MATVEC_D4(i + 4)
#define MATVEC_D16(i) MATVEC_D8(i), MATVEC_D8(i + 8)
#define MATVEC_D32(i) MATVEC_D16(i), MATVEC_D16(i + 16)
#define MATVEC_D64(i) MATVEC_D32(i), MATVEC_D32(i + 32)

template <bool kBf16, bool kTransB>
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], uint64_t da,
                                                 uint64_t db, uint32_t accumulate) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, %7;\n}\n"
        : MATVEC_D4(0)
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB ? 1 : 0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.f16.f16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, %7;\n}\n"
        : MATVEC_D4(0)
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB ? 1 : 0));
  }
}

template <bool kBf16, bool kTransB>
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da,
                                                 uint64_t db, uint32_t accumulate) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, %11;\n}\n"
        : MATVEC_D8(0)
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB ? 1 : 0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, %11;\n}\n"
        : MATVEC_D8(0)
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB ? 1 : 0));
  }
}

template <bool kBf16, bool kTransB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                 uint64_t db, uint32_t accumulate) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : MATVEC_D16(0)
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB ? 1 : 0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : MATVEC_D16(0)
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB ? 1 : 0));
  }
}

template <bool kBf16, bool kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db, uint32_t accumulate) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : MATVEC_D32(0)
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB ? 1 : 0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : MATVEC_D32(0)
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB ? 1 : 0));
  }
}

template <bool kBf16, bool kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, uint32_t accumulate) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : MATVEC_D64(0)
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB ? 1 : 0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : MATVEC_D64(0)
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB ? 1 : 0));
  }
}

#undef MATVEC_D4
#undef MATVEC_D8
#undef MATVEC_D16
#undef MATVEC_D32
#undef MATVEC_D64

template <bool kBf16, int BN, bool kTransB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                      uint32_t accumulate) {
  if constexpr (BN == 8) wgmma_m64n8k16<kBf16, kTransB>(d, da, db, accumulate);
  if constexpr (BN == 16) wgmma_m64n16k16<kBf16, kTransB>(d, da, db, accumulate);
  if constexpr (BN == 32) wgmma_m64n32k16<kBf16, kTransB>(d, da, db, accumulate);
  if constexpr (BN == 64) wgmma_m64n64k16<kBf16, kTransB>(d, da, db, accumulate);
  if constexpr (BN == 128) wgmma_m64n128k16<kBf16, kTransB>(d, da, db, accumulate);
}

// Waits until at most N committed wgmma groups of this warpgroup are in
// flight: the registers the older groups read or write are then free.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// wgmma.mma_async m64nNk16 with A from registers (the RS form), f32 +=
// 16-bit x 16-bit, B K-major in shared memory. Warp w of the warpgroup
// holds rows 16w .. 16w + 15 of A; lane l with g = l / 4, t = l % 4 holds
// a[0] = row g, k 2t and 2t + 1 (the first in the low half); a[1] = row
// g + 8, the same k; a[2] = row g, k 2t + 8 and 2t + 9; a[3] = row g + 8,
// those k. The registers of a and d must not change until a wait_group
// covers the instruction.
#define MATVEC_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MATVEC_D8(i) MATVEC_D4(i), MATVEC_D4(i + 4)
#define MATVEC_D16(i) MATVEC_D8(i), MATVEC_D8(i + 8)
#define MATVEC_D32(i) MATVEC_D16(i), MATVEC_D16(i + 16)
#define MATVEC_A4 "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])

template <bool kBf16>
__device__ __forceinline__ void wgmma_rs_m64n16k16(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t db, uint32_t accumulate) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : MATVEC_D8(0)
        : MATVEC_A4, "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : MATVEC_D8(0)
        : MATVEC_A4, "l"(db), "r"(accumulate));
  }
}

template <bool kBf16>
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db, uint32_t accumulate) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : MATVEC_D16(0)
        : MATVEC_A4, "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : MATVEC_D16(0)
        : MATVEC_A4, "l"(db), "r"(accumulate));
  }
}

template <bool kBf16>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db, uint32_t accumulate) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : MATVEC_D32(0)
        : MATVEC_A4, "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : MATVEC_D32(0)
        : MATVEC_A4, "l"(db), "r"(accumulate));
  }
}

#undef MATVEC_D4
#undef MATVEC_D8
#undef MATVEC_D16
#undef MATVEC_D32
#undef MATVEC_A4

template <bool kBf16, int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4],
                                         uint64_t db, uint32_t accumulate) {
  if constexpr (BN == 16) wgmma_rs_m64n16k16<kBf16>(d, a, db, accumulate);
  if constexpr (BN == 32) wgmma_rs_m64n32k16<kBf16>(d, a, db, accumulate);
  if constexpr (BN == 64) wgmma_rs_m64n64k16<kBf16>(d, a, db, accumulate);
}

// ---------------------------------------------------------------- host

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  // cuTensorMapEncodeTiled needs a context current on the calling thread, and
  // a thread may reach it before any runtime call that binds one (its launch
  // plan came from a table another thread filled): cudaSetDevice binds the
  // device's primary context.
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess) {
    return nullptr;
  }
  return fn;
}

}  // namespace
