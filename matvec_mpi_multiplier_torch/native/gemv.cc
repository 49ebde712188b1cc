// Native C++ GEMV: the host-side native tier of the PyTorch port.
//
// Reference analog: multiply_std_rowwise (src/matr_utils.c:86-96), the serial
// dense row-major dot-product kernel the reference compiles with mpicc. The
// plain extern "C" entry points (matvec_gemv_f32/f64) are loaded with ctypes
// (ops/native_gemv.py): a CPU oracle, and the "native" GEMV tier on CPU
// tensors. The arithmetic is the JAX package's native tier's, template and
// all, so both libraries give the same bits under the same flags.
//
// Build: utils/native_lib.py (g++, at first use).

#include <cstdint>

namespace {

template <typename T>
void GemvKernel(const T* a, const T* x, T* y, int64_t m, int64_t k) {
  for (int64_t i = 0; i < m; ++i) {
    const T* row = a + i * k;
    // Four partial accumulators break the sequential-add dependence chain so
    // the compiler can keep the FMA pipes full after vectorizing.
    T acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
    int64_t j = 0;
    for (; j + 4 <= k; j += 4) {
      acc0 += row[j] * x[j];
      acc1 += row[j + 1] * x[j + 1];
      acc2 += row[j + 2] * x[j + 2];
      acc3 += row[j + 3] * x[j + 3];
    }
    for (; j < k; ++j) acc0 += row[j] * x[j];
    y[i] = (acc0 + acc1) + (acc2 + acc3);
  }
}

}  // namespace

extern "C" {

void matvec_gemv_f32(const float* a, const float* x, float* y, int64_t m,
                     int64_t k) {
  GemvKernel(a, x, y, m, k);
}

void matvec_gemv_f64(const double* a, const double* x, double* y, int64_t m,
                     int64_t k) {
  GemvKernel(a, x, y, m, k);
}

}  // extern "C"
