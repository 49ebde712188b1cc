"""The port's host-link model (``bench/hostlink.py``,
``bench/hostlink_study.py``) against the JAX package's
(``tests/test_hostlink.py``).

``LinkModel``, ``operand_bytes`` and ``derive_reference_result`` are the JAX
package's arithmetic: on the same fields, bitwise the same numbers. So is
the weighted fit of ``measure_link``: fed the same clock readings, both
packages fit the same model bit for bit. On the CPU the derived rows land
within a factor of 5 of literal ``reference`` rows (the JAX test's bound).
"""

import dataclasses

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_tpu.bench import hostlink as jhl
from matvec_mpi_multiplier_tpu.bench.timing import TimingResult as JaxTimingResult
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.bench import hostlink as thl
from matvec_mpi_multiplier_torch.bench.hostlink import (
    DEFAULT_LADDER_BYTES,
    LinkModel,
    derive_reference_result,
    measure_link,
    operand_bytes,
)
from matvec_mpi_multiplier_torch.bench.metrics import append_result, csv_path, read_csv
from matvec_mpi_multiplier_torch.bench.timing import TimingResult, benchmark_strategy
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """Copies on one thread: a copy that fans out over the intra-op pool
    times the pool's wake-up (tens of ms on a host busy with other test
    workers), not the copy."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _fields(**kw):
    base = dict(
        n_rows=64, n_cols=32, n_devices=1, strategy="rowwise",
        dtype="float32", mode="amortized", measure="chain",
        mean_time_s=0.5, times_s=(0.5,), n_reps=1,
    )
    base.update(kw)
    return base


def _result(**kw):
    return TimingResult(**_fields(**kw))


def test_ladder_is_the_jax_packages():
    assert DEFAULT_LADDER_BYTES == jhl.DEFAULT_LADDER_BYTES


def test_link_model_math():
    link = LinkModel(alpha_s=0.001, bps=1e9, samples=())
    assert link.transfer_time_s(0) == pytest.approx(0.001)
    assert link.transfer_time_s(10**9) == pytest.approx(1.001)
    assert link.gbps == pytest.approx(1.0)


@pytest.mark.parametrize("n_bytes", [0, 4, 12345, 10**9, 2**33 + 7])
@pytest.mark.parametrize("alpha,bps", [(0.001, 1e9), (3.7e-5, 6.1e9), (0.0, 55.3e9)])
def test_link_model_is_bitwise_the_jax_packages(alpha, bps, n_bytes):
    port = LinkModel(alpha_s=alpha, bps=bps, samples=())
    jax_ = jhl.LinkModel(alpha_s=alpha, bps=bps, samples=())
    assert port.transfer_time_s(n_bytes) == jax_.transfer_time_s(n_bytes)
    assert port.gbps == jax_.gbps


@pytest.mark.parametrize("kw", [
    {}, {"n_rhs": 8}, {"dtype": "bfloat16"}, {"dtype": "float64"},
    {"dtype": "float16", "n_rows": 65536, "n_cols": 65536},
    {"n_rows": 120, "n_cols": 60000, "n_rhs": 32},
])
def test_operand_bytes_and_derivation_are_bitwise_the_jax_packages(kw):
    port, jax_ = _result(**kw), JaxTimingResult(**_fields(**kw))
    assert operand_bytes(port) == jhl.operand_bytes(jax_)
    link = (LinkModel(alpha_s=2.3e-5, bps=6.37e9, samples=()),
            jhl.LinkModel(alpha_s=2.3e-5, bps=6.37e9, samples=()))
    d_port = derive_reference_result(port, link[0])
    d_jax = jhl.derive_reference_result(jax_, link[1])
    assert dataclasses.asdict(d_port) == dataclasses.asdict(d_jax)


def test_operand_bytes_matvec_and_gemm():
    assert operand_bytes(_result()) == 4 * (64 * 32 + 32)
    assert operand_bytes(_result(n_rhs=8)) == 4 * (64 * 32 + 32 * 8)
    assert operand_bytes(_result(dtype="bfloat16")) == 2 * (64 * 32 + 32)


def test_derive_reference_result():
    link = LinkModel(alpha_s=0.01, bps=1e9, samples=())
    derived = derive_reference_result(_result(), link)
    assert derived.mode == "reference_derived"
    assert derived.measure == "derived"
    assert derived.mean_time_s == pytest.approx(0.5 + 0.01 + 4 * (64 * 32 + 32) / 1e9)
    assert derived.strategy == "rowwise" and derived.n_reps == 1


def test_derive_rejects_reference_input():
    link = LinkModel(alpha_s=0.0, bps=1e9, samples=())
    with pytest.raises(ValueError, match="amortized"):
        derive_reference_result(_result(mode="reference"), link)


class _Clock:
    """perf_counter readings: each rep of each size lasts ``durations[i]``."""

    def __init__(self, durations):
        self.durations, self.t, self.started = list(durations), 100.0, False

    def perf_counter(self):
        if self.started:
            self.t += self.durations.pop(0)
        self.started = not self.started
        return self.t


@pytest.mark.parametrize("ladder,reps", [
    ([2**16, 2**18, 2**20], 2), ([2**20], 3), (list(DEFAULT_LADDER_BYTES[:3]), 1),
])
def test_fit_is_bitwise_the_jax_packages(monkeypatch, devices, ladder, reps):
    """The same clock readings give the same (alpha, bps, samples): min of
    the reps, the 1/bytes-weighted line, the one-size rule."""
    rng = np.random.default_rng(3)
    durations = [2e-5 + b / 6e9 * (1 + 0.1 * rng.random())
                 for b in ladder for _ in range(reps)]
    monkeypatch.setattr(thl, "time", _Clock(durations))
    port = measure_link(ladder, reps=reps, device="cpu")
    monkeypatch.setattr(jhl, "time", _Clock(durations))
    jax_ = jhl.measure_link(ladder, reps=reps)
    assert (port.alpha_s, port.bps, port.samples) == (jax_.alpha_s, jax_.bps, jax_.samples)


def test_measure_link_cpu():
    link = measure_link([2**16, 2**18, 2**20], reps=2, device="cpu")
    assert link.bps > 0 and link.alpha_s >= 0
    assert len(link.samples) == 3 and all(t > 0 for _, t in link.samples)
    n, t = link.samples[-1]
    assert link.transfer_time_s(n) == pytest.approx(t, rel=2.0, abs=1e-2)


def test_measure_link_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        measure_link([2**16])


def test_measure_link_input_validation():
    with pytest.raises(ConfigError, match="ladder"):
        measure_link([], device="cpu")
    with pytest.raises(ConfigError, match="ladder"):
        measure_link([0], device="cpu")
    with pytest.raises(ConfigError, match="reps"):
        measure_link([2**16], reps=0, device="cpu")


def test_derived_agrees_with_literal_reference_cpu(rng):
    mesh = make_mesh(4, devices=[CPU] * 4)
    strat = get_strategy("rowwise")
    a = rng.standard_normal((128, 64))
    x = rng.standard_normal(64)
    amortized = benchmark_strategy(strat, mesh, a, x, n_reps=3, mode="amortized",
                                   measure="sync")
    literal = benchmark_strategy(strat, mesh, a, x, n_reps=3, mode="reference",
                                 measure="sync")
    derived = derive_reference_result(
        amortized, measure_link([2**16, 2**18, 2**20], reps=2, device="cpu"))
    assert derived.mean_time_s < 5 * literal.mean_time_s
    assert literal.mean_time_s < 5 * derived.mean_time_s


def test_hostlink_study_cli(tmp_path, capsys):
    """Amortized rows in, derived rows appended to their own per-strategy
    file (never the literal reference one); re-runs are idempotent."""
    from matvec_mpi_multiplier_torch.bench import hostlink_study

    append_result(_result(mean_time_s=0.001), tmp_path)
    argv = ["--data-root", str(tmp_path), "--max-mb", "1", "--reps", "1",
            "--platform", "cpu"]
    assert hostlink_study.main(argv) == 0
    assert "1 reference-mode rows derived" in capsys.readouterr().out
    derived_path = csv_path("rowwise", tmp_path, mode="reference_derived")
    rows = read_csv(derived_path)
    assert rows and rows[0]["time"] >= 0.001
    assert not csv_path("rowwise", tmp_path, mode="reference").exists()
    derived = [r for r in read_csv(tmp_path / "out" / "results_extended.csv")
               if r["measure"] == "derived"]
    assert len(derived) == 1 and derived[0]["mode"] == "reference_derived"
    assert hostlink_study.main(argv) == 0
    assert "already present" in capsys.readouterr().out
    assert len(read_csv(derived_path)) == 1


def test_hostlink_study_without_rows_prints_the_link(tmp_path, capsys):
    from matvec_mpi_multiplier_torch.bench import hostlink_study

    assert hostlink_study.main(["--data-root", str(tmp_path), "--max-mb", "1",
                                "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("link: alpha=") and "link model printed only" in out
