"""Quantized storage through the port's strategies, engine, timing, serve
bench and sweep, against the JAX package.

The JAX package's quantized ``shard_map`` programs cannot serve as the
oracle here: under the installed jax their scan raises a ``TypeError``
inside ``shard_map`` (ROADMAP.md, queue C). So the distributed and engine
results are held, as tests/test_quantized.py holds the JAX package's own,
against the numpy fp64 oracle ``dequantize(qa) @ x`` on the JAX package's
payload (tests/test_quantized.py:310): rtol 1e-4, atol 1e-5; bf16 at rtol
0.02 (:623). The payload each shard holds is compared bitwise with the JAX
package's placement of its own payload.
"""

import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.bench import serve as jax_serve
from matvec_mpi_multiplier_tpu.bench.metrics import read_csv
from matvec_mpi_multiplier_tpu.engine import bucket_for as jax_bucket_for
from matvec_mpi_multiplier_tpu.engine import split_widths as jax_split_widths
from matvec_mpi_multiplier_tpu.engine.executables import ExecKey as JaxExecKey
from matvec_mpi_multiplier_tpu.ops import quantize as jq
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.bench import serve
from matvec_mpi_multiplier_torch.bench.serve import append_serve_result, run_serve, serve_csv_path
from matvec_mpi_multiplier_torch.bench.sweep import main as sweep_main
from matvec_mpi_multiplier_torch.bench.timing import benchmark_gemm, benchmark_strategy
from matvec_mpi_multiplier_torch.engine import MatvecEngine
from matvec_mpi_multiplier_torch.models.gemm import build_gemm
from matvec_mpi_multiplier_torch.ops import quantize as tq
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.utils.convert import from_numpy
from matvec_mpi_multiplier_torch.utils.errors import ConfigError, ShardingError

CPU = torch.device("cpu")
STRATEGIES = ["blockwise", "colwise", "rowwise"]
FORMATS = ["int8", "int8c", "fp8"]
TOL = dict(rtol=1e-4, atol=1e-5)
CPU_ARGS = ["--platform", "cpu", "--host-devices", "8", "--devices", "8"]


def port_mesh(p=8):
    return make_mesh(p, devices=[CPU] * p)


def operands(seed, m=64, k=1024, n=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(dtype)
    x = rng.standard_normal((k,) if n is None else (k, n)).astype(dtype)
    return a, x


def oracle(qa_jax, x):
    """The numpy fp64 oracle on the JAX package's payload."""
    return np.asarray(jq.dequantize(qa_jax)).astype(np.float64) @ x.astype(np.float64)


def quantized_pair(a, fmt, strategy, mesh):
    shards = strategy.contraction_shards(mesh)
    return (jq.quantize_matrix(a, fmt, contraction_shards=shards),
            tq.quantize_matrix(from_numpy(a, "cpu"), fmt, contraction_shards=shards))


# ------------------------------------------------------------ strategies


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("name", STRATEGIES)
def test_build_and_build_batched_match_the_oracle(name, p, fmt):
    strat, mesh = get_strategy(name), port_mesh(p)
    jax_shards = mv_jax.get_strategy(name).contraction_shards(mv_jax.make_mesh(p))
    assert strat.contraction_shards(mesh) == jax_shards
    a, x = operands(12)
    _, b = operands(13, n=8)
    qj, qt = quantized_pair(a, fmt, strat, mesh)
    y = strat.build(port_mesh(p), dtype_storage=fmt)(qt, from_numpy(x, "cpu"))
    assert y.dtype == torch.float32 and tuple(y.shape) == (64,)
    np.testing.assert_allclose(y.numpy(), oracle(qj, x), **TOL)
    c = strat.build_batched(mesh, dtype_storage=fmt)(qt, from_numpy(b, "cpu"))
    np.testing.assert_allclose(c.numpy(), oracle(qj, b), **TOL)


@pytest.mark.parametrize("name", STRATEGIES)
def test_build_gemm_and_scan_tier_match_the_oracle(name):
    mesh = port_mesh(8)
    a, b = operands(14, n=8)
    qj, qt = quantized_pair(a, "int8c", get_strategy(name), mesh)
    for kernel in ("cuda", "torch"):
        c = build_gemm(name, mesh, kernel=kernel, dtype_storage="int8c")(qt, from_numpy(b, "cpu"))
        np.testing.assert_allclose(c.numpy(), oracle(qj, b), **TOL)
        y = get_strategy(name).build(mesh, kernel=kernel, dtype_storage="int8c")(
            qt, from_numpy(b[:, 0].copy(), "cpu"))
        np.testing.assert_allclose(y.numpy(), oracle(qj, b[:, 0]), **TOL)


def test_bf16_operands_quantize_and_serve():
    import ml_dtypes

    strat, mesh = get_strategy("rowwise"), port_mesh(8)
    a, x = operands(20, m=32, dtype=ml_dtypes.bfloat16)
    qj, qt = quantized_pair(a, "int8c", strat, mesh)
    assert qt.dtype == torch.bfloat16
    y = strat.build(mesh, dtype_storage="int8c")(qt, from_numpy(x, "cpu"))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), oracle(qj, x), rtol=0.02, atol=0.02)


@pytest.mark.parametrize("name", STRATEGIES)
def test_each_shard_holds_the_jax_packages_slice(name):
    """Every leaf of every shard is the JAX package's placement of its own
    payload (``jax.device_put`` with the strategy's sharding), bitwise."""
    mesh, jmesh = port_mesh(8), mv_jax.make_mesh(8)
    a, x = operands(21)
    qj, qt = quantized_pair(a, "int8c", get_strategy(name), mesh)
    placed, _ = get_strategy(name).place(qt, from_numpy(x, "cpu"), mesh)
    sh_a, _ = mv_jax.get_strategy(name).shardings(jmesh)
    devs = list(jmesh.devices.flat)
    for leaf_j, attr in ((qj.q, "q"), (qj.scales, "scales"), (qj.q2, "q2"),
                         (qj.scales2, "scales2")):
        by_device = {s.device: np.asarray(s.data) for s in
                     jax.device_put(leaf_j, sh_a).addressable_shards}
        for f, shard in enumerate(placed.shards):
            port = getattr(shard, attr)
            assert (shard.fmt, shard.block, shard.dtype) == ("int8c", qt.block, torch.float32)
            np.testing.assert_array_equal(port.numpy(), by_device[devs[f]])


def test_compensated_int8_clears_the_fp32_budget():
    """The acceptance gate of tests/test_quantized.py:382-430 on the port:
    the int8c distributed residual against the fp64 oracle of the NATIVE A
    clears the worst-case bound and the normwise fp32-level seat, and beats
    plain int8 by a wide factor."""
    strat, mesh = get_strategy("colwise"), port_mesh(8)
    m, k = 64, 2048
    a, x = operands(15, m=m, k=k)
    exact = a.astype(np.float64) @ x.astype(np.float64)
    xt = from_numpy(x, "cpu")

    def run(fmt):
        qa = tq.quantize_matrix(from_numpy(a, "cpu"), fmt,
                                contraction_shards=strat.contraction_shards(mesh))
        y = strat.build(mesh, dtype_storage=fmt)(qa, xt).double().numpy()
        return qa, np.abs(y - exact)

    qa_c, err_c = run("int8c")
    _, err_plain = run("int8")
    amax_rows = np.abs(a.reshape(m, k // qa_c.block, qa_c.block)).max(axis=(1, 2))
    bound = (k * tq.INT8C_EPS * amax_rows * np.abs(x).max()
             + np.finfo(np.float32).eps * k * np.abs(a).max() * np.abs(x).max())
    assert np.all(err_c <= bound)
    assert err_c.max() / np.abs(exact).max() <= tq.FP32_LEVEL_RELERR
    assert err_plain.max() / err_c.max() >= 30


def test_storage_arguments_are_checked():
    strat, mesh = get_strategy("colwise"), port_mesh(2)
    for bad in ("int4", "speculate", "auto"):
        with pytest.raises(ConfigError, match="unknown dtype_storage"):
            strat.build(mesh, dtype_storage=bad)
        with pytest.raises(ConfigError, match="unknown dtype_storage"):
            strat.build_batched(mesh, dtype_storage=bad)
    with pytest.raises(ConfigError, match="tiles A inside"):
        strat.build(mesh, combine="overlap", dtype_storage="int8")
    assert strat.storage_combine_ok(None) and not strat.storage_combine_ok("pallas_ring")
    with pytest.raises(KeyError, match="quantized-storage kernel"):
        strat.build(mesh, kernel="pallas", dtype_storage="int8")


def test_operands_of_another_storage_are_refused():
    strat, mesh = get_strategy("colwise"), port_mesh(2)
    a, x = operands(22, m=8, k=64)
    at, xt = from_numpy(a, "cpu"), from_numpy(x, "cpu")
    qa = tq.quantize_matrix(at, "int8", contraction_shards=2)
    with pytest.raises(ConfigError, match="serves int8 storage and got a native A"):
        strat.build(mesh, dtype_storage="int8")(at, xt)
    with pytest.raises(ConfigError, match="serves native storage and got a int8 A"):
        strat.build(mesh)(qa, xt)
    placed = strat.place(qa, xt, mesh)
    with pytest.raises(ShardingError, match="another strategy, mesh or storage"):
        strat.build(mesh, dtype_storage="fp8")(*placed)
    whole = tq.quantize_matrix(at, "int8", block=64)  # one block spans both shards
    with pytest.raises(ShardingError, match="contraction_shards=2"):
        strat.build(mesh, dtype_storage="int8")(whole, xt)


# ----------------------------------------------------------------- engine


def quant_engine(a, strategy="colwise", **kwargs):
    kwargs.setdefault("promote", 4)
    kwargs.setdefault("max_bucket", 8)
    return MatvecEngine(a, port_mesh(), strategy=strategy, dtype_storage="int8c", **kwargs)


def test_engine_quantized_storage_end_to_end():
    a, _ = operands(16)
    eng = quant_engine(a)
    assert (eng.storage, eng.storage_reason, eng.storage_block) == ("int8c", "explicit", 64)
    assert eng.resident_bytes < 0.55 * a.nbytes
    qj = jq.quantize_matrix(a, "int8c", contraction_shards=8)
    assert eng.resident_bytes == qj.nbytes
    gauges = eng.metrics.snapshot()["gauges"]
    assert gauges["engine_resident_bytes"] == float(eng.resident_bytes)
    assert gauges['engine_storage_format{format="int8c",dtype="float32",reason="explicit"}'] == 1.0
    rng = np.random.default_rng(16)
    for width in (1, 3, 8):
        block = rng.standard_normal((1024, width)).astype(np.float32)
        out = eng.submit(block).result().numpy()
        np.testing.assert_allclose(out, oracle(qj, block), **TOL)
    x = rng.standard_normal(1024).astype(np.float32)
    np.testing.assert_allclose(eng.submit(x).result().numpy(), oracle(qj, x), **TOL)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_is_bitwise_its_own_builds(strategy):
    """A vector and a block below b* are served by the program
    ``build(dtype_storage=...)`` returns, a promoted block by the one
    ``build_batched`` returns for its bucket: bitwise equal."""
    a, _ = operands(17)
    eng = quant_engine(a, strategy)
    mesh = port_mesh()
    strat = get_strategy(strategy)
    qt = tq.quantize_matrix(from_numpy(a, "cpu"), "int8c",
                            contraction_shards=strat.contraction_shards(mesh))
    rng = np.random.default_rng(17)
    x = from_numpy(rng.standard_normal(1024).astype(np.float32), "cpu")
    narrow = from_numpy(rng.standard_normal((1024, 3)).astype(np.float32), "cpu")
    wide = from_numpy(rng.standard_normal((1024, 6)).astype(np.float32), "cpu")
    vec_fn = strat.build(mesh, dtype_storage="int8c")
    assert torch.equal(eng.submit(x).result(), vec_fn(qt, x))
    assert torch.equal(eng.submit(narrow).result(),
                       torch.stack([vec_fn(qt, narrow[:, j].contiguous()) for j in range(3)], 1))
    padded = torch.cat([wide, torch.zeros(1024, 2)], dim=1)
    expect = strat.build_batched(mesh, dtype_storage="int8c")(qt, padded)[:, :6]
    assert torch.equal(eng.submit(wide).result(), expect)


@pytest.mark.parametrize("strategy,widths", [
    ("colwise", None), ("rowwise", [1, 2, 3, 5]), ("blockwise", [3, 4, 11]),
])
def test_exec_key_labels_carry_the_storage(strategy, widths):
    """After warmup the labels equal the JAX package's ExecKey labels with
    storage="int8c" (kernel "pallas" mapped to "cuda"), for the keys the
    JAX engine's routing gives those widths."""
    a, _ = operands(18)
    eng = quant_engine(a, strategy)
    eng.warmup(widths)
    if widths is None:
        buckets = {1, 2, 4, 8}
    else:
        buckets = {jax_bucket_for(c, 8) for w in widths if w >= 4
                   for c in jax_split_widths(w, 8)}
    # The strategies' own schedules: a None combine labels as "default".
    expect = [JaxExecKey("matvec", strategy, "pallas", None, 1, "float32", "int8c")]
    expect += [JaxExecKey("gemm", strategy, "pallas", None, b, "float32", "int8c")
               for b in buckets]
    labels = sorted(k.label() for k in eng._cache.keys())
    assert labels == sorted(k.label().replace(":pallas:", ":cuda:") for k in expect)
    assert all(label.endswith(":int8c") for label in labels)


def test_compiles_flat_across_a_mixed_replay():
    a, X = operands(19, n=11)
    eng = quant_engine(a)
    eng.warmup()
    baseline = eng.stats.compiles
    for f in [eng.submit(X[:, :w]) for w in (1, 2, 3, 5, 8, 11, 7, 4, 6, 2)]:
        assert np.all(np.isfinite(f.result().numpy()))
    assert eng.stats.compiles == baseline and eng.stats.hits > 0


def test_engine_auto_speculate_and_unknown_storage():
    a, _ = operands(23, m=64, k=64)
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise", dtype_storage="auto")
    assert (eng.storage, eng.storage_reason) == ("native", "auto_miss")
    assert eng.resident_bytes == a.nbytes
    default = MatvecEngine(a, port_mesh(), strategy="rowwise")
    assert (default.storage, default.storage_reason) == ("native", "default")
    # Speculation arms beside a native primary: A plus the int8c payload,
    # P (s x k) and U (s x m), s = 33 probes.
    spec = MatvecEngine(a, port_mesh(), dtype_storage="speculate")
    assert (spec.storage, spec.storage_reason, spec.speculative) == ("native", "explicit", True)
    qa = tq.quantize_matrix(from_numpy(a, "cpu"), "int8c", contraction_shards=1)
    assert spec.spec_resident_bytes == qa.nbytes + 33 * (64 + 64) * 4
    assert spec.resident_bytes == a.nbytes + spec.spec_resident_bytes
    assert spec.device_resident_bytes == spec.resident_bytes
    with pytest.raises(ConfigError, match="unknown dtype_storage"):
        MatvecEngine(a, port_mesh(), dtype_storage="int4")
    with pytest.raises(KeyError, match="quantized-storage kernel"):
        MatvecEngine(a, port_mesh(), dtype_storage="int8", kernel="pallas")


def test_engine_keeps_no_native_a():
    a_t = torch.from_numpy(operands(24)[0])
    ref = weakref.ref(a_t)
    eng = MatvecEngine(a_t, port_mesh(1), strategy="rowwise", dtype_storage="fp8")
    del a_t
    gc.collect()
    assert ref() is None, "a quantized engine still holds the native A"
    assert eng._a.shards[0].fmt == "fp8"


# ------------------------------------------------------ timing, serve, sweep


def test_benchmark_strategy_and_gemm_time_the_payload():
    mesh = port_mesh(4)
    a, x = operands(25, m=64, k=256)
    for mode in ("amortized", "reference"):
        res = benchmark_strategy(get_strategy("blockwise"), mesh, a, x, n_reps=3,
                                 mode=mode, dtype_storage="int8c")
        assert res.strategy == "blockwise" and res.dtype == "float32"
        # gbps keeps the native-byte formula, so the CSVs stay comparable.
        assert res.gbps == pytest.approx(4 * (64 * 256 + 64 + 256) / res.mean_time_s / 1e9)
    res = benchmark_gemm("colwise", mesh, a, np.ones((256, 4), np.float32), n_reps=3,
                         dtype_storage="fp8")
    assert res.strategy == "gemm_colwise" and res.n_rhs == 4


def test_run_serve_records_storage_and_resident_bytes(tmp_path):
    res = run_serve("rowwise", port_mesh(), 64, 64, n_requests=20, max_bucket=8,
                    promote=4, promo_reps=2, dtype_storage="int8c")
    assert res.dtype_storage == "int8c" and res.compiles_steady == 0
    nb = 64 // tq.default_block(64)
    assert res.resident_bytes == 2 * (64 * 64 + 64 * nb * 4)
    path = append_serve_result(res, tmp_path / "port")
    jax_path = jax_serve.append_serve_result(
        jax_serve.ServeResult(**dataclasses.asdict(res)), tmp_path / "jax")
    assert path.read_bytes() == jax_path.read_bytes()
    assert path.read_text().splitlines()[0] == serve.SERVE_CSV_HEADER == jax_serve.SERVE_CSV_HEADER
    row = read_csv(path)[0]
    assert (row["dtype_storage"], row["resident_bytes"]) == ("int8c", res.resident_bytes)


def test_serve_cli_storage_flags(capsys, tmp_path):
    rc = serve.main(["--strategy", "colwise", "--sizes", "64", "--n-requests", "6",
                     "--max-bucket", "4", "--dtype-storage", "fp8",
                     "--data-root", str(tmp_path), *CPU_ARGS])
    assert rc == 0
    assert "storage=fp8 resident=" in capsys.readouterr().out
    assert read_csv(serve_csv_path("colwise", tmp_path))[0]["dtype_storage"] == "fp8"
    rc = serve.main(["--strategy", "rowwise", "--sizes", "64", "--n-requests", "4",
                     "--max-bucket", "4", "--dtype-storage", "auto", "--no-csv", *CPU_ARGS])
    assert rc == 0 and "storage=" not in capsys.readouterr().out
    rc = serve.main(["--strategy", "rowwise", "--sizes", "64", "--n-requests", "4",
                     "--max-bucket", "4", "--no-csv", "--dtype-storage", "speculate",
                     "--spec-rtol", "1e-3", *CPU_ARGS])
    out = capsys.readouterr().out
    assert rc == 0 and " esc_rate=0.0000 bw_ratio=" in out and " spec=0 " not in out


def test_sweep_writes_format_labelled_rows(tmp_path, capsys):
    rc = sweep_main(["--platform", "cpu", "--host-devices", "4", "--sizes", "64",
                     "--n-reps", "3", "--dtype-storage", "int8", "--strategy", "colwise",
                     "rowwise", "--data-root", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "colwise_int8 64x64 p=4" in out and "rowwise_int8 64x64 p=1" in out
    rows = read_csv(tmp_path / "out" / "results_extended.csv")
    assert {r["strategy"] for r in rows} == {"colwise_int8", "rowwise_int8"}
    assert (tmp_path / "out" / "colwise_int8.csv").exists()
    rc = sweep_main(["--op", "gemm", "--platform", "cpu", "--host-devices", "2", "--sizes",
                     "64", "--n-rhs", "4", "--n-reps", "3", "--dtype-storage", "int8c",
                     "--strategy", "blockwise", "--no-csv"])
    assert rc == 0 and "gemm_blockwise_int8c 64x64" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="serve-only"):
        sweep_main(["--platform", "cpu", "--sizes", "64", "--dtype-storage", "auto"])
