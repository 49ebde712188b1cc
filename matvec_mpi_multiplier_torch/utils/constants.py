"""Framework-wide constants (the port's own copy).

Analog of the reference's ``src/constants.h`` (lines 4-7): the
coordinator-process convention, the data-directory layout, and the benchmark
protocol parameters (``src/multiplier_rowwise.c:135`` runs 100 repetitions;
CSV schema at ``src/multiplier_rowwise.c:86``). The CSV headers are
byte-identical to the JAX package's, so both packages write the same files.
"""

from __future__ import annotations

# The coordinator process (reference: MAIN_PROCESS, src/constants.h:5).
MAIN_PROCESS: int = 0

# Data-file conventions (reference: src/matr_utils.c:9-18, "./data/" prefix at
# src/matr_utils.c:45-46). The directory itself is resolved at call time in
# utils/io.py (env var MATVEC_DATA_DIR) so it can be overridden after import.
OUT_SUBDIR: str = "out"
MATRIX_FILENAME_FMT: str = "matrix_{n_rows}_{n_cols}.txt"
VECTOR_FILENAME_FMT: str = "vector_{n}.txt"

# Benchmark protocol (reference: 100-rep loop, src/multiplier_rowwise.c:135;
# mean over reps at :168; max across ranks at :147).
DEFAULT_N_REPS: int = 100

# CSV metric schema — byte-identical header to the reference
# (src/multiplier_rowwise.c:86): "n_rows, n_cols, n_processes, time".
CSV_HEADER: str = "n_rows, n_cols, n_processes, time"
# Extended schema (strategy/dtype/protocol/throughput columns).
# n_rhs: columns of the right-hand side (1 = matvec, >1 = GEMM).
CSV_HEADER_EXTENDED: str = (
    "n_rows, n_cols, n_devices, time, strategy, dtype, mode, measure, "
    "gflops, gbps, n_rhs"
)

# Default mesh axis names for the 2-D device grid (reference's process grid
# from get_2_most_closest_multipliers, src/utils.c:26-37).
MESH_AXIS_ROWS: str = "rows"
MESH_AXIS_COLS: str = "cols"

# Bytes per element by dtype name (CSV rows carry dtype as a string).
DTYPE_ITEMSIZE: dict[str, int] = {
    "float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
}

# NVIDIA H100 SXM (data sheet): HBM3 rate and L2 size. The HBM rate is the
# nominal denominator of every bandwidth bound the port reports; a shape whose
# operands fit a few times over in L2 is served from cache across reps and is
# given no HBM bound.
H100_HBM_PEAK_GBPS: float = 3350.0
H100_L2_BYTES: int = 50 * 1000 * 1000
# NVIDIA H100 SXM (data sheet): dense bf16/fp16 tensor-core peak, and the
# fp32 rate outside the tensor cores, in GFLOP/s: the compute roofs of the
# GEMV-to-GEMM crossover study (bench/crossover_study.py).
H100_TENSOR_BF16_GFLOPS: float = 989e3
H100_FP32_GFLOPS: float = 67e3
