"""The port's profiling and named spans (``bench/profiling.py``,
``obs/annotations.py``) against the JAX package's (``tests/test_profiling.py``).

Contracts, as in the JAX package: ``trace(enabled=False)`` is a strict no-op;
enabled, it writes a capture (here a Chrome-trace JSON); ``annotate`` spans
nest; ``named_span`` is off by default and toggles through
``set_annotations``/``annotations``/``MATVEC_ANNOTATE``. And the parity:
per strategy and combine schedule, the span names the port's trace records
are the names the JAX package's lowered program carries (its debug
metadata, what a device capture shows), and none when annotations are off.
"""

import contextlib
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.bench.profiling import annotations as jax_annotations
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.bench import profiling
from matvec_mpi_multiplier_torch.bench.profiling import (
    annotate,
    annotations,
    annotations_enabled,
    named_span,
    set_annotations,
    trace,
)
from matvec_mpi_multiplier_torch.parallel.mesh import make_1d_mesh, make_mesh
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

CPU = torch.device("cpu")
STRATS = ("rowwise", "colwise", "blockwise")
COMBINES = ("psum", "psum_scatter", "ring", "ring_overlap", "a2a", "overlap",
            "overlap_ring", "pallas_ring", "gather")
# Every span name either package opens (parallel/ring.py's stages, the
# strategies' local GEMV and combines, the fused ring's walk).
UNIVERSE = (
    {f"{s}/local_gemv" for s in STRATS}
    | {f"{s}/combine/{c}" for s in STRATS for c in COMBINES}
    | {f"{s}/combine/overlap@{k}" for s in STRATS for k in range(1, 17)}
    | {f"{s}/combine/ring_gather" for s in STRATS}
    | {f"stage{i}/{part}" for i in range(16) for part in ("compute", "combine")}
    | {f"pallas_ring/ring_walk@p{p}" for p in range(1, 17)}
)


def _trace_files(log_dir):
    return sorted(log_dir.glob("*.json"))


def _span_names(log_dir) -> set[str]:
    (path,) = _trace_files(log_dir)
    events = json.loads(path.read_text())["traceEvents"]
    return {e["name"] for e in events if e.get("name") in UNIVERSE}


# ----------------------------------------------------------------- trace


def test_trace_disabled_is_noop(tmp_path):
    log_dir = tmp_path / "never_created"
    with trace(log_dir, enabled=False) as captured:
        assert captured is None
    assert not log_dir.exists()


def test_trace_enabled_creates_dir_and_captures(tmp_path):
    log_dir = tmp_path / "profile" / "run1"
    with trace(log_dir) as captured:
        assert captured == log_dir
        assert log_dir.is_dir()
        with annotate("region"):
            (torch.ones(8) * 2).sum()
    (path,) = _trace_files(log_dir)
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "region" in names


def test_trace_refuses_a_cuda_capture_without_cuda_activity(tmp_path, monkeypatch):
    """A CUDA trace without the profiler's CUDA activity (no CUPTI) is an
    error that reaches the caller, never a quiet CPU-only trace."""
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(ConfigError, match="no CUPTI"):
        with trace(tmp_path / "t", cuda=True):
            pass
    assert not (tmp_path / "t").exists()


# -------------------------------------------------------------- annotate


def test_annotate_nests_without_error(tmp_path):
    with trace(tmp_path / "t"):
        with annotate("outer"):
            with annotate("outer/inner"):
                with annotate("outer/inner/leaf"):
                    pass
    (path,) = _trace_files(tmp_path / "t")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"outer", "outer/inner", "outer/inner/leaf"} <= names


# ------------------------------------------------------------- named_span


def test_named_span_disabled_by_default(monkeypatch):
    monkeypatch.delenv("MATVEC_ANNOTATE", raising=False)
    set_annotations(None)
    assert not annotations_enabled()
    # Disabled means the profiler's record_function is never entered.
    monkeypatch.setattr(
        torch.profiler, "record_function",
        lambda name: (_ for _ in ()).throw(AssertionError("entered")),
    )
    with named_span("should/not/enter"):
        pass


def test_named_span_toggles(monkeypatch):
    monkeypatch.delenv("MATVEC_ANNOTATE", raising=False)
    set_annotations(None)
    with annotations(True):
        assert annotations_enabled()
        with annotations(False):
            assert not annotations_enabled()
        assert annotations_enabled()
    assert not annotations_enabled()
    monkeypatch.setenv("MATVEC_ANNOTATE", "1")
    assert annotations_enabled()
    set_annotations(False)  # the programmatic override outranks the env
    assert not annotations_enabled()
    set_annotations(None)


def test_obs_exports_set_annotations():
    from matvec_mpi_multiplier_torch import obs

    assert obs.set_annotations is set_annotations
    assert profiling.named_span is obs.named_span


def test_named_span_reaches_the_trace_where_cuda_is_present(tmp_path, monkeypatch):
    """With CUDA present a span is an NVTX range AND a profiler span: an
    NVTX range alone never shows in a torch.profiler trace."""
    entered = []

    @contextlib.contextmanager
    def nvtx_range(name):
        entered.append(name)
        yield

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range", nvtx_range)
    with trace(tmp_path / "t", cuda=False), annotations(True):
        with named_span("blockwise/local_gemv"):
            torch.ones(4).sum()
    assert entered == ["blockwise/local_gemv"]
    assert _span_names(tmp_path / "t") == {"blockwise/local_gemv"}


# ---------------------------------------------------- parity with the JAX spans


def _jax_spans(fn, a, x) -> set[str]:
    """Span names in the JAX program's debug metadata, each matched whole
    (followed by '/' or '"', so ring does not match ring_overlap). JAX's
    caches are cleared first: a module-level jit traced earlier with
    annotations off (``_collective_ring_gemv``) would otherwise serve that
    trace, without the spans opened at trace time."""
    jax.clear_caches()
    mod = fn.lower(a, x).compiler_ir(dialect="stablehlo")
    buf = io.StringIO()
    mod.operation.print(file=buf, enable_debug_info=True)
    txt = buf.getvalue()
    return {n for n in UNIVERSE if re.search(re.escape(n) + r'(?=[/"])', txt)}


def _port_spans(tmp_path, fn, a, x, enabled=True) -> set[str]:
    with trace(tmp_path / "t", cuda=False), annotations(enabled):
        fn(a, x)
    return _span_names(tmp_path / "t")


# (strategy, build kwargs, one-dimensional mesh)
CASES = [
    ("rowwise", {}, False),
    ("blockwise", {}, False),
    ("colwise", {}, False),
    *[("colwise", {"combine": c}, False)
      for c in ("psum_scatter", "ring", "ring_overlap", "a2a")],
    ("colwise", {"combine": "overlap", "stages": 2}, False),
    ("colwise", {"combine": "overlap_ring", "stages": 2}, False),
    ("colwise", {"combine": "pallas_ring"}, True),
    ("rowwise", {"combine": "ring"}, False),
    ("rowwise", {"combine": "overlap", "stages": 2}, False),
    ("blockwise", {"combine": "ring"}, False),
    ("blockwise", {"combine": "overlap", "stages": 4}, False),
]


@pytest.mark.parametrize("name,kw,flat", CASES,
                         ids=[f"{n}-{'-'.join(map(str, kw.values())) or 'default'}"
                              for n, kw, _ in CASES])
def test_span_names_match_the_jax_program(devices, tmp_path, name, kw, flat):
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    x = rng.uniform(0, 10, 64).astype(np.float32)
    jax_mesh = mv_jax.make_1d_mesh(8) if flat else mv_jax.make_mesh(8)
    port_mesh = (make_1d_mesh(8, devices=[CPU] * 8) if flat
                 else make_mesh(8, devices=[CPU] * 8))
    with jax_annotations(True):
        fn_j = mv_jax.get_strategy(name).build(jax_mesh, **kw)
        want = _jax_spans(fn_j, jnp.asarray(a), jnp.asarray(x))
    fn_t = get_strategy(name).build(port_mesh, **kw)
    got = _port_spans(tmp_path, fn_t, torch.from_numpy(a), torch.from_numpy(x))
    assert want, "the JAX program carries no span"
    assert got == want
    y = fn_t(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), a @ x, rtol=1e-5)


@pytest.mark.parametrize("name", STRATS)
def test_no_span_when_annotations_are_off(tmp_path, name):
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.uniform(0, 10, (64, 64)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 10, 64).astype(np.float32))
    fn = get_strategy(name).build(make_mesh(8, devices=[CPU] * 8))
    assert _port_spans(tmp_path, fn, a, x, enabled=False) == set()


def test_engine_dispatch_carries_stage_spans(tmp_path):
    """--annotate + serve: each eager engine dispatch (the CPU's) records
    the staged program's names."""
    from matvec_mpi_multiplier_torch.engine import MatvecEngine

    a = np.random.default_rng(7).uniform(0, 10, (64, 64)).astype(np.float32)
    with annotations(True):
        engine = MatvecEngine(a, make_mesh(8, devices=[CPU] * 8), strategy="colwise",
                              combine="overlap", stages=2, promote=None)
        engine.warmup()
        with trace(tmp_path / "t", cuda=False):
            engine.submit(torch.ones(64)).result()
    assert {"colwise/combine/overlap", "stage0/compute", "stage1/combine"} <= \
        _span_names(tmp_path / "t")


def test_serve_cli_annotate_scopes_the_flag(tmp_path, monkeypatch):
    from matvec_mpi_multiplier_torch.bench import serve

    monkeypatch.delenv("MATVEC_ANNOTATE", raising=False)
    set_annotations(None)
    argv = ["--strategy", "rowwise", "--sizes", "64", "--n-requests", "4",
            "--max-bucket", "4", "--no-csv", "--platform", "cpu",
            "--host-devices", "2", "--devices", "2"]
    with trace(tmp_path / "t", cuda=False):
        assert serve.main(argv + ["--annotate"]) == 0
    assert "rowwise/local_gemv" in _span_names(tmp_path / "t")
    assert not annotations_enabled()  # scoped to the run
    with trace(tmp_path / "u", cuda=False):
        assert serve.main(argv) == 0
    assert _span_names(tmp_path / "u") == set()
