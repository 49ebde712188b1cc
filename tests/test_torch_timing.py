"""The port's timing protocol, metrics and sweep CLI against the JAX package's.

Timings here are CPU numbers of tiny shapes: the tests check the protocol
(how many reps, which reduction, which errors) and the CSV files, never a
speed.
"""

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_tpu.bench import metrics as jax_metrics
from matvec_mpi_multiplier_tpu.bench import sweep as jax_sweep
from matvec_mpi_multiplier_tpu.bench import timing as jax_timing
from matvec_mpi_multiplier_tpu.bench.timing import TimingResult as JaxTimingResult
from matvec_mpi_multiplier_tpu.utils import constants as jax_constants
from matvec_mpi_multiplier_tpu.utils.errors import ConfigError as JaxConfigError
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.bench import metrics, sweep, timing
from matvec_mpi_multiplier_torch.bench.timing import (
    TimingResult,
    benchmark_strategy,
    resolve_measure,
    time_fn_chained,
    time_fn_looped,
)
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.utils import constants
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

CPU = torch.device("cpu")


def cpu_mesh(p):
    return make_mesh(p, devices=[CPU] * p)


@pytest.mark.parametrize("mode,measure", [
    ("amortized", "sync"), ("amortized", "chain"), ("reference", "sync"),
    ("amortized", "loop"), ("amortized", "auto"),
])
def test_benchmark_strategy_cpu(mode, measure):
    rng = np.random.default_rng(0)
    a, x = rng.uniform(0, 10, (256, 256)), rng.uniform(0, 10, 256)
    res = benchmark_strategy(
        get_strategy("blockwise"), cpu_mesh(4), a, x, dtype="float32",
        n_reps=20, mode=mode, measure=measure, chain_samples=3,
    )
    assert (res.n_rows, res.n_cols, res.n_devices) == (256, 256, 4)
    assert (res.strategy, res.dtype, res.mode, res.measure) == (
        "blockwise", "float32", mode, resolve_measure(mode, measure))
    if measure == "sync":
        assert len(res.times_s) == 20
        assert res.mean_time_s == pytest.approx(np.mean(res.times_s))
        assert min(res.times_s) > 0
    else:
        assert len(res.times_s) == 3
        assert res.mean_time_s == pytest.approx(np.median(res.times_s))
    assert res.mean_time_s > 0


def test_throughput_formulas_match_jax():
    fields = dict(n_rows=1000, n_cols=3000, n_devices=4, strategy="rowwise",
                  mode="amortized", measure="chain", mean_time_s=1.5e-3,
                  times_s=(1.5e-3,))
    for dtype in ("float64", "float32", "bfloat16", "float16"):
        mine = TimingResult(dtype=dtype, **fields)
        ref = JaxTimingResult(dtype=dtype, **fields)
        assert mine.gflops == pytest.approx(ref.gflops, rel=1e-15)
        assert mine.gbps == pytest.approx(ref.gbps, rel=1e-15)


@pytest.mark.parametrize("mode,measure,resolved", [
    ("amortized", "auto", "loop"), ("reference", "auto", "sync"),
    ("amortized", "chain", "chain"), ("amortized", "sync", "sync"),
    ("reference", "sync", "sync"), ("amortized", "loop", "loop"),
])
def test_resolve_measure(mode, measure, resolved):
    assert resolve_measure(mode, measure) == resolved


@pytest.mark.parametrize("mode,measure,match", [
    ("reference", "loop", "loop"),
    ("reference", "chain", "cannot time mode='reference'"),
    ("bogus", "auto", "mode must be"), ("amortized", "bogus", "measure must be"),
])
def test_resolve_measure_errors(mode, measure, match):
    with pytest.raises(ConfigError, match=match):
        resolve_measure(mode, measure)


@pytest.mark.parametrize("mode", ["amortized", "reference", "bogus"])
@pytest.mark.parametrize("measure", ["auto", "loop", "chain", "sync", "bogus"])
def test_resolve_measure_table_is_the_jax_packages(mode, measure):
    """Every (mode, measure) resolves as in the JAX package, or both raise."""
    try:
        want = jax_timing.resolve_measure(mode, measure)
    except JaxConfigError as e:
        with pytest.raises(ConfigError) as got:
            resolve_measure(mode, measure)
        assert str(got.value) == str(e)
        return
    assert resolve_measure(mode, measure) == want


def _small(seed, shape, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def test_looped_wrapper_preserves_operand_and_computes():
    """The carry with a runtime eps = 0 comes back bit-identical after k
    reps; eps = 1 changes it: every rep really ran (JAX's
    tests/test_bench.py::test_looped_wrapper_preserves_operand_and_computes)."""
    a, x = torch.from_numpy(_small(1, (8, 8))), torch.from_numpy(_small(2, 8))
    chained = timing._build_looped(lambda a_, x_: a_ @ x_)
    out0 = chained(a, x, 3, torch.tensor(0.0))
    assert torch.equal(out0, x)
    out1 = chained(a, x, 3, torch.tensor(1.0))
    assert not torch.equal(out1, x)
    assert torch.equal(x, torch.from_numpy(_small(2, 8)))  # the caller's rhs untouched


def test_looped_bump_is_nonlinear_in_output():
    """With eps = 1 one rep returns x + sum((A x)^2), as the JAX package's
    loop does on the same inputs (rtol 1e-12, fp64)."""
    import jax.numpy as jnp

    an, xn = _small(2, (6, 6)), _small(3, 6)
    chained = timing._build_looped(lambda a_, x_: a_ @ x_)
    out = chained(torch.from_numpy(an), torch.from_numpy(xn), 1, torch.tensor(1.0))
    np.testing.assert_allclose(out.numpy(), xn + np.sum(np.square(an @ xn)), rtol=1e-12)
    jax_chained = jax_timing._build_looped(lambda a_, x_: a_ @ x_)
    ref = jax_chained(jnp.asarray(an), jnp.asarray(xn), jnp.asarray(1, jnp.int32),
                      jnp.asarray(1.0, jnp.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)


def test_looped_carry_of_a_placed_vector_is_one_buffer():
    """A placed x on a one-device mesh is carried as one buffer that every
    shard views, so one bump reaches all of them."""
    mesh = cpu_mesh(4)
    strategy = get_strategy("colwise")
    a, x = (torch.from_numpy(_small(s, shape)) for s, shape in ((4, (16, 16)), (5, 16)))
    a_dev, x_dev = strategy.place(a, x, mesh)
    carry, roots = timing._carry_of(x_dev)
    assert len(roots) == 1 and torch.equal(roots[0], x)
    roots[0].add_(1.0)
    assert all(torch.equal(s, b + 1.0) for s, b in zip(carry.shards, x_dev.shards))
    chained = timing._build_looped(strategy.build(mesh))
    out = chained(a_dev, x_dev, 2, torch.tensor(0.0))
    assert all(torch.equal(s, b) for s, b in zip(out.shards, x_dev.shards))


def test_time_fn_looped():
    """The study's face: device-resident args, looped reps, a positive
    median (JAX's test_time_fn_looped)."""
    a, x = torch.from_numpy(_small(0, (32, 32))), torch.from_numpy(_small(1, 32))
    times = time_fn_looped(lambda a_, x_: a_ @ x_, (a, x), cpu_mesh(1), n_reps=4,
                           samples=2)
    assert len(times) == 2
    assert np.median(times) > 0


def test_loop_measure_on_the_8_shard_mesh():
    """benchmark_strategy(measure="loop") on the conftest's 8-device mesh
    shape: 8 CPU shards in a 2x4 grid (JAX's test_loop_measure_explicit)."""
    rng = np.random.default_rng(0)
    a, x = rng.standard_normal((16, 16)), rng.standard_normal(16)
    for name in ("rowwise", "colwise", "blockwise"):
        res = benchmark_strategy(get_strategy(name), cpu_mesh(8), a, x, n_reps=3,
                                 measure="loop", chain_samples=2)
        assert (res.measure, res.n_devices, len(res.times_s)) == ("loop", 8, 2)
        assert res.mean_time_s == pytest.approx(np.median(res.times_s))
        assert res.mean_time_s > 0


def test_reference_mode_rejects_loop():
    rng = np.random.default_rng(0)
    with pytest.raises(ConfigError, match="loop"):
        benchmark_strategy(get_strategy("rowwise"), cpu_mesh(2),
                           rng.standard_normal((16, 16)), rng.standard_normal(16),
                           n_reps=3, mode="reference", measure="loop")


def test_grow_spread_expands_until_signal_beats_jitter():
    """A 50 ms dispatch and 1 us reps: the spread widens until the endpoint
    delta reaches the target (JAX's test of the same name)."""
    per_rep = 1e-6
    delta, t1, t2 = timing._grow_spread(lambda k: 0.05 + per_rep * k, 5, 50,
                                        target_delta_s=0.1)
    assert t2 - t1 >= 0.1
    assert (t2 - t1) / delta == pytest.approx(per_rep, rel=1e-6)
    assert (delta, t1, t2) == jax_timing._grow_spread(
        lambda k: 0.05 + per_rep * k, 5, 50, target_delta_s=0.1)


def test_grow_spread_stops_at_max_run_time():
    calls = []

    def run(k):
        calls.append(k)
        return 10.0 * k

    delta, _, _ = timing._grow_spread(run, 1, 3, target_delta_s=1e9)
    assert delta == 3 and calls == [1, 1, 4, 4]


def test_dispatch_overhead_subtracts_one_rep():
    run = lambda k: 0.002 + 0.01 * k  # noqa: E731
    pure, t_k1 = timing._dispatch_overhead(run)
    assert pure == pytest.approx(0.002) and t_k1 == pytest.approx(0.012)
    assert (pure, t_k1) == jax_timing._dispatch_overhead(run)


def test_loop_slope_raises_on_a_flat_run(monkeypatch):
    """A run whose time does not grow with k is no measurement: TimingError
    (the JAX package's doctrine: raise, never clamp)."""
    from matvec_mpi_multiplier_torch.utils.errors import TimingError

    monkeypatch.setattr(timing, "_loop_runner", lambda *a: (lambda k: 1e-3))
    with pytest.raises(TimingError, match="not measurable"):
        timing._loop_slope(None, None, None, cpu_mesh(1), 1, 11, 3)


def test_time_fn_chained_counts_calls():
    calls = []
    times = time_fn_chained(lambda: calls.append(torch.ones(64).sum()), (),
                            cpu_mesh(1), n_reps=10, samples=2, warmup=1)
    assert len(times) == 2
    # 2 warm-up calls, then per sample chains of n1=1 and n2=11.
    assert len(calls) == 2 + 2 * (1 + 11)


def test_csv_headers_are_the_jax_packages():
    assert constants.CSV_HEADER == jax_constants.CSV_HEADER
    assert constants.CSV_HEADER_EXTENDED == jax_constants.CSV_HEADER_EXTENDED


def test_metrics_write_the_same_bytes_as_jax(tmp_path):
    fields = dict(n_rows=64, n_cols=64, n_devices=4, strategy="colwise",
                  dtype="float32", mode="amortized", measure="chain",
                  mean_time_s=1.234567e-4, times_s=(1.234567e-4,))
    for mode in ("amortized", "reference"):
        fields["mode"] = mode
        metrics.append_result(TimingResult(**fields), tmp_path / "port")
        jax_metrics.append_result(JaxTimingResult(**fields), tmp_path / "jax")
    for name in ("colwise.csv", "colwise_reference.csv", "results_extended.csv"):
        assert (tmp_path / "port" / "out" / name).read_bytes() == (
            tmp_path / "jax" / "out" / name).read_bytes()


def test_stale_header_rotates_to_bak(tmp_path):
    path = metrics.csv_path("rowwise", tmp_path)
    path.parent.mkdir(parents=True)
    path.write_text("old, header\n1, 2\n")
    metrics.append_result(TimingResult(
        n_rows=8, n_cols=8, n_devices=1, strategy="rowwise", dtype="float32",
        mode="amortized", measure="sync", mean_time_s=1e-3, times_s=(1e-3,),
    ), tmp_path)
    assert path.with_suffix(".csv.bak").read_text() == "old, header\n1, 2\n"
    assert path.read_text().splitlines()[0] == jax_constants.CSV_HEADER


def test_sweep_cli_writes_reference_csvs(tmp_path, capsys):
    rc = sweep.main([
        "--platform", "cpu", "--host-devices", "4", "--sizes", "64",
        "--n-reps", "3", "--measure", "sync", "--data-root", str(tmp_path),
    ])
    assert rc == 0
    # Every registry strategy, the four colwise_* bindings included, at p = 1, 2, 4.
    assert "21 configs timed, 0 skipped" in capsys.readouterr().out
    out = tmp_path / "out"
    for name in ("rowwise", "colwise", "blockwise", "colwise_ring", "colwise_a2a"):
        lines = (out / f"{name}.csv").read_text().splitlines()
        assert lines[0] == jax_constants.CSV_HEADER
        assert [ln.split(", ")[:3] for ln in lines[1:]] == [
            ["64", "64", str(p)] for p in (1, 2, 4)]
        for ln in lines[1:]:
            assert len(ln.split(", ")[3].split(".")[1]) == 6  # "%f"
    ext = (out / "results_extended.csv").read_text().splitlines()
    assert ext[0] == jax_constants.CSV_HEADER_EXTENDED
    assert len(ext) == 22
    assert all(ln.split(", ")[5:8] == ["float32", "amortized", "sync"]
               for ln in ext[1:])


def test_sweep_cli_loop_rows_match_the_jax_packages(tmp_path, monkeypatch):
    """``--measure loop`` (and ``auto``) rows: the same lines as the JAX
    package's sweep writes for the same configs, but for the measured time."""
    monkeypatch.setenv("MATVEC_DATA_DIR", str(tmp_path / "jax"))
    assert jax_sweep.main(["--strategy", "rowwise", "--devices", "1", "2", "--sizes", "16",
                           "--n-reps", "2", "--dtype", "float32", "--measure", "loop",
                           "--chain-samples", "2"]) == 0
    for measure in ("loop", "auto"):
        assert sweep.main(["--platform", "cpu", "--host-devices", "2", "--strategy",
                           "rowwise", "--sizes", "16", "--n-reps", "2", "--measure",
                           measure, "--chain-samples", "2", "--data-root",
                           str(tmp_path / measure)]) == 0
    want = (tmp_path / "jax" / "out")
    for measure in ("loop", "auto"):
        got = tmp_path / measure / "out"
        for name in ("rowwise.csv", "results_extended.csv"):
            mine = (got / name).read_text().splitlines()
            ref = (want / name).read_text().splitlines()
            assert mine[0] == ref[0] and len(mine) == len(ref) == 3
            # The measured fields: time (and the rates derived from it).
            timed = (3,) if name == "rowwise.csv" else (3, 8, 9)
            for m, r in zip(mine[1:], ref[1:]):
                mf, rf = m.split(", "), r.split(", ")
                assert len(mf) == len(rf)
                for i, (x, y) in enumerate(zip(mf, rf)):
                    if i in timed:  # the same "%f"-style format
                        assert len(x.split(".")[1]) == len(y.split(".")[1])
                    else:
                        assert x == y
        ext = (got / "results_extended.csv").read_text().splitlines()[1:]
        assert all(ln.split(", ")[5:8] == ["float32", "amortized", "loop"] for ln in ext)


def test_sweep_cli_cuda_without_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        sweep.main(["--sizes", "64", "--no-csv"])
