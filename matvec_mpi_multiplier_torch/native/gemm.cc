// Native C++ GEMM: the host-side native tier's rank-2 face in the PyTorch port.
//
// Reference analog: the reference's compute layer is matvec-only
// (multiply_std_rowwise, src/matr_utils.c:86-96); GEMM extends the same
// native-kernel pattern (see gemv.cc) to C = A @ B. The extern "C" entry
// points (matvec_gemm_f32/f64) are loaded with ctypes (ops/native_gemm.py).
//
// Kernel shape: i-l-j loops with a k-strip block. The innermost j loop
// streams one row of B against a scalar of A — contiguous loads/stores the
// compiler vectorizes — while the l-strip keeps the active rows of B hot in
// L1/L2 across the i sweep.

#include <cstdint>

namespace {

template <typename T>
void GemmKernel(const T* a, const T* b, T* c, int64_t m, int64_t k,
                int64_t n) {
  constexpr int64_t kStrip = 64;
  for (int64_t i = 0; i < m; ++i) {
    T* crow = c + i * n;
    for (int64_t j = 0; j < n; ++j) crow[j] = 0;
  }
  for (int64_t l0 = 0; l0 < k; l0 += kStrip) {
    const int64_t l1 = (l0 + kStrip < k) ? l0 + kStrip : k;
    for (int64_t i = 0; i < m; ++i) {
      const T* arow = a + i * k;
      T* crow = c + i * n;
      for (int64_t l = l0; l < l1; ++l) {
        const T av = arow[l];
        const T* brow = b + l * n;
        for (int64_t j = 0; j < n; ++j) crow[j] += av * brow[j];
      }
    }
  }
}

}  // namespace

extern "C" {

void matvec_gemm_f32(const float* a, const float* b, float* c, int64_t m,
                     int64_t k, int64_t n) {
  GemmKernel(a, b, c, m, k, n);
}

void matvec_gemm_f64(const double* a, const double* b, double* c, int64_t m,
                     int64_t k, int64_t n) {
  GemmKernel(a, b, c, m, k, n);
}

}  // extern "C"
