// Hand-written fused solver step for Hopper (sm_90a): one iteration of the
// rotated CG or Chebyshev recurrence for one shard, then the shard's row
// GEMV against the fresh direction.
//
// Replaces the TPU kernel matvec_mpi_multiplier_tpu/ops/pallas_solver.py::
// _make_step_kernel (its pallas_call in _fused_step), which runs the vector
// update once, at grid step (0, 0), into output blocks that stay in VMEM, and
// lets every later grid step read the fresh p straight back out of VMEM while
// it streams its tile of A. That trick rests on the TPU's sequential grid:
// Hopper's blocks run in no order, so no block can wait for another's update
// without a grid-wide sync. Here the step is two launches, enqueued back to
// back on the caller's stream by one C call with no host work between them:
//
// 1. update_kernel: ONE block of 1024 threads. Three passes over the n-long
//    vectors: p.ap (cg only), then x2 = x + alpha p and r2 = r - alpha ap with
//    sum r2^2, then p2 = r2 + beta p. Each thread sums a fixed strided set of
//    elements in order, and a fixed shuffle tree plus one shared-memory round
//    reduces the block, so the two dependent reductions need no grid sync
//    and are bitwise repeatable. It writes x2, r2, p2 and s_out.
// 2. The row GEMV of the shard against p2[off : off + k_loc]: csrc/gemv.cu
//    instantiated with x in the ACCUMULATOR type (matvec_gemv_acc_x), on
//    the route the wrapper plans (ops/cuda_gemv.py::gemv_plan, passed in
//    as int gplan[3] with its scratch: one warp per row, or for a short
//    shard the row's slabs spread over every resident warp and summed by a
//    second launch, one association either way), or csrc/quant_gemv.cu's vector face with x in the
//    accumulator type for an int8 / int8c / fp8 payload (on the tensor cores
//    for fp32: the pre-pass that splits p2's segment, then the GEMV). The
//    fused step reads p in the accumulator type (the TPU kernel's
//    pseg.astype(acc)), where the unfused tier casts it to A's dtype first:
//    for bf16 or fp16 A the two differ, which is why this cannot simply call
//    matvec_gemv.
//
// Why two launches cost nothing a fused one would save: p2 is 4n bytes
// (256 KB at n = 65536 fp32) and stays in the 50 MB L2 between the two
// launches, which is what VMEM residency bought on the TPU; the update moves
// about 8n * 4 bytes (~2 MB at n = 65536), tens of microseconds against a
// 5 ms GEMV.
//
// What bounds the step: HBM bytes, m_loc * k_loc * itemsize (or the payload's
// bytes) + 8n * acc_itemsize (x, r, p, ap read; x2, r2, p2 and the partial
// written): 5.13 ms at 65536^2 fp32 at 3.35 TB/s. The GEMV streams A once in
// 16-byte loads (TMA-fed payload tiles for quantized storage); the update is
// one block, latency-bound, and small beside it.
//
// Numerics: the accumulator is float, or double for fp64 A (x, r, p, ap,
// s_in and every output are in it). The vector updates round the product and
// the sum separately (no FMA contraction), as the plain PyTorch version's
// separate multiply and add do, so given the same scalars they agree
// bitwise; the reductions use FMA. Quantized storage runs quant_gemv.cu's
// vector face on the route the wrapper plans (ops/cuda_quant.py::
// quant_route, passed in as a code): fp32 p on wgmma_split (int8's vector
// face on the CUDA cores, int8c's and fp8's on the tensor cores), with the
// TPU kernel's association, s * sum(q * p) per block (a fresh fp32 partial
// per block, scaled and summed in block order, int8c's levels summed apart
// and then added), as the unfused tier's kernel on the same route; fp64 p
// (or a shape the tensor cores cannot take) on fma, each element
// dequantized as fl(s * q) (int8c: fl(fl(s1 q1) + fl(s2 q2))) and
// multiplied into the sum.
// No atomics: the step is bitwise the same from run to run.
//
// The graph-captured solver loop (ops/cuda_solver.py) replays chunks of
// steps; a step of an iteration that is no longer active gets a device
// predicate of 0 and returns at once.
//
// Left for later: a persistent cooperative kernel with a grid sync (update
// and GEMV in one launch).

#include <cuda_runtime.h>

#include <cstdint>

// The row GEMVs of csrc/gemv.cu and csrc/quant_gemv.cu (one library).
extern "C" int matvec_gemv_acc_x(int dtype, const int* plan, const void* a, const void* x,
                                 void* y, void* scratch, int64_t m, int64_t k,
                                 void* stream, const void* pred);
extern "C" int matvec_quant_gemv(int route, int fmt, int dtype, const void* q,
                                 const void* scales, const void* q2,
                                 const void* scales2, const void* x, void* y, void* xs,
                                 int64_t m, int64_t k, int64_t n, int64_t block,
                                 void* stream);

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / kWarp;

enum Op { kCg = 0, kChebyshev = 1 };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// The block's sum of one value per thread, in a fixed order: a shuffle tree
// in each warp, then warp 0 over the 32 warp sums. Every thread gets it.
template <typename Acc>
__device__ __forceinline__ Acc block_sum(Acc v, Acc* red) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];
#pragma unroll
    for (int offset = kWarps / 2; offset > 0; offset /= 2) {
      v += __shfl_down_sync(0xffffffffu, v, offset);
    }
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  const Acc total = red[kWarps];
  __syncthreads();  // red is free again for the next reduction
  return total;
}

// s_in: cg [rz]; chebyshev [alpha, k, d, c^2]. s_out: cg [rz2]; chebyshev
// [alpha_next, sum r2^2].
template <int OP, typename Acc>
__global__ void __launch_bounds__(kThreads)
update_kernel(const Acc* __restrict__ x, const Acc* __restrict__ r,
              const Acc* __restrict__ p, const Acc* __restrict__ ap,
              const Acc* __restrict__ s_in, Acc* __restrict__ x2, Acc* r2,
              Acc* __restrict__ p2, Acc* __restrict__ s_out, int64_t n,
              const unsigned char* __restrict__ pred) {
  static_assert(kWarps == kWarp, "warp 0 reduces one value per warp");
  // A device predicate of 0 skips the step (csrc/gemv.cu's off()); the
  // block leaves whole, before any barrier.
  if (pred != nullptr && *pred == 0) return;
  __shared__ Acc red[kWarps + 1];
  const int64_t t = threadIdx.x;
  Acc alpha;
  bool safe = true;
  if constexpr (OP == kCg) {
    Acc part = Acc(0);
    for (int64_t i = t; i < n; i += kThreads) part += p[i] * ap[i];
    const Acc pap = block_sum(part, red);
    // p'Ap > 0 for SPD A; stall (not inf/NaN) on breakdown, as the
    // unfused tier does, so the loop exits on maxiter.
    safe = pap > Acc(0);
    alpha = safe ? s_in[0] / pap : Acc(0);
  } else {
    alpha = s_in[0];
  }
  Acc part = Acc(0);
  for (int64_t i = t; i < n; i += kThreads) {
    const Acc ri = add_rn(r[i], -mul_rn(alpha, ap[i]));
    x2[i] = add_rn(x[i], mul_rn(alpha, p[i]));
    r2[i] = ri;
    part += ri * ri;
  }
  const Acc rr = block_sum(part, red);
  Acc beta;
  if constexpr (OP == kCg) {
    const Acc rz = s_in[0];
    beta = safe ? rr / (rz != Acc(0) ? rz : Acc(1)) : Acc(0);
    if (t == 0) s_out[0] = rr;
  } else {
    // Saad Alg. 12.1 with the beta/alpha division folded away, rotated one
    // step: this applies step k's alpha and builds direction k+1, whose
    // weight is c^2 alpha / 2 (building direction 1) or c^2 alpha / 4.
    const Acc kf = s_in[1], d = s_in[2], c2 = s_in[3];
    const Acc factor = mul_rn(mul_rn(kf == Acc(0) ? Acc(0.5) : Acc(0.25), c2), alpha);
    beta = mul_rn(factor, alpha);
    if (t == 0) {
      s_out[0] = Acc(1) / add_rn(d, -factor);
      s_out[1] = rr;
    }
  }
  // Each thread reads back the r2 elements it wrote itself.
  for (int64_t i = t; i < n; i += kThreads) p2[i] = add_rn(r2[i], mul_rn(beta, p[i]));
}

template <typename Acc>
cudaError_t launch_update(int op, const void* x, const void* r, const void* p,
                          const void* ap, const void* s_in, void* x2, void* r2,
                          void* p2, void* s_out, int64_t n, cudaStream_t s,
                          const void* pred_ptr) {
  const unsigned char* pred = static_cast<const unsigned char*>(pred_ptr);
  const Acc *cx = static_cast<const Acc*>(x), *cr = static_cast<const Acc*>(r),
            *cp = static_cast<const Acc*>(p), *cap = static_cast<const Acc*>(ap),
            *cs = static_cast<const Acc*>(s_in);
  Acc *ox = static_cast<Acc*>(x2), *orr = static_cast<Acc*>(r2),
      *op2 = static_cast<Acc*>(p2), *os = static_cast<Acc*>(s_out);
  if (op == kCg) {
    update_kernel<kCg, Acc><<<1, kThreads, 0, s>>>(cx, cr, cp, cap, cs, ox, orr, op2, os, n,
                                                   pred);
  } else {
    update_kernel<kChebyshev, Acc><<<1, kThreads, 0, s>>>(cx, cr, cp, cap, cs, ox, orr, op2,
                                                          os, n, pred);
  }
  return cudaGetLastError();
}

}  // namespace

// op: 0 cg, 1 chebyshev. fmt: -1 native A, 0 int8, 1 int8c, 2 fp8 payload.
// dtype: A's (logical) dtype, 0 bf16, 1 fp16, 2 fp32, 3 fp64; the
// accumulator is fp64 for 3, else fp32, and x, r, p, ap, s_in, x2, r2, p2,
// s_out and partial are all in it. a is the (m_loc, k_loc) row-major shard
// (native), or the payload q with its (m_loc, k_loc / block) fp32 scales (and
// q2/scales2 for int8c, else NULL), with qroute, quant_gemv.cu's route code
// for the accumulator's x, and xs, its scratch (NULL on fma); qroute and xs
// are ignored for native A, and gplan and gscratch, the native GEMV's plan
// (gemv.cu's int plan[3]) and scratch, for quantized storage. The vectors are (n,); s_in is (1,) for cg and
// (4,) for chebyshev, s_out (1,) or (2,); partial is (m_loc,), the shard's
// product with p2[off : off + k_loc]. pred: NULL, or a device byte that
// skips the update and a native shard's GEMV when 0 (a quantized shard's
// GEMV still runs, on the skipped update's outputs). Enqueues the update
// kernel and then the GEMV on `stream`, checking each launch; returns 0 or
// the cudaError.
extern "C" int matvec_solver_step(int op, int fmt, int dtype, const void* a,
                                  const void* scales, const void* q2,
                                  const void* scales2, int64_t block, int qroute,
                                  void* xs, const int* gplan, void* gscratch,
                                  const void* x, const void* r, const void* p,
                                  const void* ap, const void* s_in, void* x2,
                                  void* r2, void* p2, void* s_out, void* partial,
                                  int64_t n, int64_t m_loc, int64_t k_loc,
                                  int64_t off, void* stream, const void* pred) {
  if ((op != kCg && op != kChebyshev) || fmt < -1 || fmt > 2 || dtype < 0 ||
      dtype > 3 || n <= 0 || m_loc <= 0 || k_loc <= 0 || off < 0 ||
      off + k_loc > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = dtype == 3;
  const cudaError_t up =
      wide ? launch_update<double>(op, x, r, p, ap, s_in, x2, r2, p2, s_out, n, s, pred)
           : launch_update<float>(op, x, r, p, ap, s_in, x2, r2, p2, s_out, n, s, pred);
  if (up != cudaSuccess) return static_cast<int>(up);
  const void* seg = static_cast<const char*>(p2) + off * (wide ? 8 : 4);
  if (fmt < 0) {
    return matvec_gemv_acc_x(dtype, gplan, a, seg, partial, gscratch, m_loc, k_loc, stream,
                             pred);
  }
  // quant_gemv's x dtype code for the accumulator: fp32 (2) or fp64 (3).
  return matvec_quant_gemv(qroute, fmt, wide ? 3 : 2, a, scales, q2, scales2, seg, partial,
                           xs, m_loc, k_loc, 1, block, stream);
}
