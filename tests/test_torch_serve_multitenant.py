"""The serve bench's multi-tenant trace mode: the port's
``run_serve_multitenant``, its parsers, its CSV and its CLI flags against
the JAX package's bench/serve.py (:943-1439), in-process on the conftest's
8-device CPU mesh.

The trace (which tenant each request goes to, and its vector) is drawn from
the same seed in both packages, so the registry's decisions — hits,
evictions, quota rejections, failures, the ledger's bytes, the LRU floor —
are held EQUAL to the JAX bench's; only the wall-clock columns differ. The
tenants' matrices are each package's own seeded draws (the counts do not
depend on their values), and the port's results are held to the fp32
product of its own matrices at 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.bench import serve as jax_serve
from matvec_mpi_multiplier_torch.bench import serve
from matvec_mpi_multiplier_torch.bench.metrics import out_dir
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

CPU = torch.device("cpu")
CPU_ARGS = ["--platform", "cpu", "--host-devices", "8", "--devices", "8"]
N = 64

# The columns that depend only on the trace, the budget and the registry's
# decisions (everything but the wall-clock ones).
ROW_FIELDS = ("tenant", "requests", "hits", "evictions", "evictions_caused",
              "quota_rejections", "failed_requests", "rejected", "resident_bytes",
              "pinned", "availability")
RUN_FIELDS = ("n_rows", "n_cols", "n_devices", "strategy", "dtype", "n_tenants",
              "zipf_a", "hbm_budget", "budget_tenants", "n_requests", "hit_rate",
              "lru_floor", "global_sched", "deadline_expires")


def port_mesh(p=8):
    return make_mesh(p, devices=[CPU] * p)


@pytest.fixture(scope="module")
def jax_mesh(devices):
    return mv_jax.make_mesh(8)


def _rows(result):
    return [{f: getattr(r, f) for f in ROW_FIELDS} for r in result.rows]


def _run(result):
    return {f: getattr(result, f) for f in RUN_FIELDS}


def test_csv_header_and_result_fields_equal_jax():
    assert serve.MULTITENANT_CSV_HEADER == jax_serve.MULTITENANT_CSV_HEADER
    for port_cls, jax_cls in ((serve.MultiTenantResult, jax_serve.MultiTenantResult),
                              (serve.TenantRow, jax_serve.TenantRow)):
        assert [f.name for f in dataclasses.fields(port_cls)] == \
            [f.name for f in dataclasses.fields(jax_cls)]


@pytest.mark.parametrize("strategy,n_tenants,zipf_a,budget,pin_hot,quota", [
    ("rowwise", 4, 1.1, "2x", 1, None),
    ("blockwise", 6, 0.8, "3x", 0, None),
    ("colwise", 3, 1.5, "1x", 0, "2"),
    ("rowwise", 5, 1.1, None, 2, "tenant-0=1,tenant-3=2"),
    ("blockwise", 4, 1.1, "0.5x", 1, None),
])
def test_run_serve_multitenant_rows_equal_jax(jax_mesh, strategy, n_tenants, zipf_a,
                                              budget, pin_hot, quota):
    """Every per-tenant row and the ALL row equal the JAX bench's on the
    same seed (a sub-payload budget, pins and quotas included)."""
    kw = dict(n_tenants=n_tenants, zipf_a=zipf_a, hbm_budget=budget, pin_hot=pin_hot,
              tenant_quota=quota, n_requests=60, seed=3)
    port = serve.run_serve_multitenant(strategy, port_mesh(), N, N, **kw)
    ref = jax_serve.run_serve_multitenant(strategy, jax_mesh, N, N, **kw)
    assert _run(port) == _run(ref)
    assert _rows(port) == _rows(ref)
    all_row = port.rows[-1]
    assert all_row.tenant == "ALL" and all_row.requests == 60
    if budget is not None and quota is None and port.budget_tenants >= 1:
        # Homogeneous tenants: the cost-aware score is exactly LRU (a
        # sub-payload budget admits by counted overshoots instead).
        assert port.hit_rate == pytest.approx(port.lru_floor)


def test_isolation_under_chaos_matches_jax(jax_mesh):
    """A fault spec on tenant-1, a quota on tenant 2 and poison on tenant-3:
    every other tenant's availability is 1.0, and every count equals the
    JAX bench's."""
    kw = dict(n_tenants=5, zipf_a=0.9, hbm_budget="2x", n_requests=80, seed=1,
              fault_spec="dispatch:device_error:key=tenant-1/*",
              tenant_quota="tenant-2=1", poison_rate=0.5, poison_tenant="tenant-3",
              breaker_reset_s=0.001)
    port = serve.run_serve_multitenant("rowwise", port_mesh(), N, N, kernel="torch", **kw)
    ref = jax_serve.run_serve_multitenant("rowwise", jax_mesh, N, N, **kw)
    assert _rows(port) == _rows(ref)
    by_tenant = {r.tenant: r for r in port.rows}
    assert by_tenant["tenant-1"].availability == 0.0
    assert by_tenant["tenant-2"].quota_rejections > 0
    assert 0 < by_tenant["tenant-3"].failed_requests < by_tenant["tenant-3"].requests
    for tid in ("tenant-0", "tenant-4"):
        assert by_tenant[tid].availability == 1.0


def test_results_hold_the_product():
    """``on_result`` sees every served request: each result is the fp32
    product of its tenant's seeded matrix (its own draw) within 1e-5."""
    seen = []
    res = serve.run_serve_multitenant(
        "blockwise", port_mesh(), N, N, n_tenants=3, hbm_budget="1x", n_requests=30,
        seed=5, on_result=lambda tid, x, y: seen.append((tid, x, y)))
    assert len(seen) == 30 and res.rows[-1].evictions > 0
    for tid, x, y in seen:
        i = int(tid.split("-")[1])
        a = serve.resident_matrix(N, N, torch.float32, CPU, 5 + i)
        np.testing.assert_allclose(y.numpy(), (a @ x).numpy(), rtol=1e-5, atol=1e-4)


def test_quantized_tenants_are_charged_their_payload_and_scales():
    """int8c tenants under a budget of one native payload: each resident
    tenant is charged its int8c payload and scales (a numpy count: two int8
    planes and two fp32 scale planes), and the hit rate is the LRU floor of
    the payloads that fit. The JAX bench's quantized programs raise under
    the installed jax (ROADMAP.md queue C), so this case has no JAX twin."""
    res = serve.run_serve_multitenant(
        "rowwise", port_mesh(), N, N, n_tenants=4, hbm_budget="1x",
        dtype_storage="int8c", n_requests=40, seed=2)
    from matvec_mpi_multiplier_torch.ops.quantize import default_block

    block = default_block(N, 1)
    payload = 2 * N * N + 2 * N * (N // block) * 4
    assert res.budget_tenants == (N * N * 4) // payload
    charged = [r.resident_bytes for r in res.rows[:-1]]
    assert set(charged) <= {0, payload} and sum(charged) == res.rows[-1].resident_bytes
    assert res.hit_rate == pytest.approx(res.lru_floor)


def test_deadline_overlay():
    """Paced arrivals with deadlines: every request served on time at a
    generous deadline, end-to-end percentiles measured, no gate expiry."""
    res = serve.run_serve_multitenant(
        "rowwise", port_mesh(), N, N, n_tenants=3, hbm_budget="2x", n_requests=20,
        deadline_ms=10_000.0, rate=2000.0, max_in_flight=4, seed=0)
    assert res.deadline_expires == 0 and res.on_time == 20
    assert np.isfinite(res.p50_e2e_ms) and res.p99_e2e_ms >= res.p50_e2e_ms
    assert res.rows[-1].availability == 1.0


@pytest.mark.parametrize("kwargs", [
    {"global_sched": True}, {"demand_weight": 2.0}, {"decision_jsonl": "d.jsonl"},
    {"reshard": "auto"},
])
def test_global_scheduler_arguments_are_refused(kwargs):
    with pytest.raises(ConfigError, match="queue A 2"):
        serve.run_serve_multitenant("rowwise", port_mesh(), N, N, n_tenants=2,
                                    n_requests=4, **kwargs)


@pytest.mark.parametrize("kwargs,match", [
    ({"n_tenants": 0}, "n_tenants"), ({"pin_hot": 3}, "pin_hot"),
    ({"poison_rate": 1.5}, "poison_rate"),
    ({"poison_rate": 0.1, "poison_tenant": "tenant-9"}, "not one of"),
])
def test_bad_arguments_raise(kwargs, match):
    kw = dict(n_tenants=2, n_requests=4)
    kw.update(kwargs)
    with pytest.raises(ConfigError, match=match):
        serve.run_serve_multitenant("rowwise", port_mesh(), N, N, **kw)


@pytest.mark.parametrize("text,payload", [
    (None, 100), ("2.5x", 100), ("4096", 100), ("0", 100), ("1X", 7), ("0.5x", 16384),
])
def test_parse_hbm_budget_matches_jax(text, payload):
    assert serve.parse_hbm_budget(text, payload) == jax_serve.parse_hbm_budget(text, payload)


@pytest.mark.parametrize("text", [None, "4", " 8 ", "tenant-0=4,tenant-2=8", "t=1"])
def test_parse_tenant_quota_matches_jax(text):
    assert serve.parse_tenant_quota(text) == jax_serve.parse_tenant_quota(text)


def test_parsers_refuse_what_jax_refuses():
    with pytest.raises(ConfigError):
        serve.parse_hbm_budget("-1x", 100)
    with pytest.raises(ConfigError):
        serve.parse_tenant_quota("tenant-0=4,oops")


@pytest.mark.parametrize("n,a", [(1, 1.1), (4, 1.1), (8, 0.0), (16, 2.5)])
def test_zipf_probs_match_jax(n, a):
    np.testing.assert_array_equal(serve._zipf_probs(n, a), jax_serve._zipf_probs(n, a))


def test_cli_writes_the_tenants_csv(tmp_path, jax_mesh, capsys):
    """``--tenants`` takes precedence over load mode and writes one row per
    tenant plus ALL under the JAX header; every column but the wall-clock
    ones equals what the JAX bench writes for the same run."""
    rc = serve.main(["--strategy", "rowwise", "--sizes", str(N), "--tenants", "3",
                     "--zipf-a", "1.2", "--hbm-budget", "2x", "--pin-hot", "1",
                     "--tenant-quota", "tenant-2=1", "--n-requests", "30",
                     "--concurrency", "4", "--data-root", str(tmp_path), *CPU_ARGS])
    assert rc == 0
    out = capsys.readouterr().out
    assert "serve-tenants rowwise 64x64 p=8 tenants=3" in out
    path = serve.multitenant_csv_path("rowwise", tmp_path)
    assert not (out_dir(tmp_path) / "serve_rowwise.csv").exists()
    ref = jax_serve.run_serve_multitenant(
        "rowwise", jax_mesh, N, N, n_tenants=3, zipf_a=1.2, hbm_budget="2x",
        pin_hot=1, tenant_quota="tenant-2=1", n_requests=30, seed=0)
    jax_root = tmp_path / "jax"
    jax_path = jax_serve.append_multitenant_result(ref, jax_root)
    port_lines = path.read_text().splitlines()
    jax_lines = jax_path.read_text().splitlines()
    assert port_lines[0] == jax_lines[0] == serve.MULTITENANT_CSV_HEADER
    assert len(port_lines) == len(jax_lines) == 1 + 3 + 1
    header = port_lines[0].split(", ")
    timed = {header.index(c) for c in ("wall_s", "rps", "p50_e2e_ms", "p99_e2e_ms")}
    for p_line, j_line in zip(port_lines[1:], jax_lines[1:]):
        p_cells, j_cells = p_line.split(", "), j_line.split(", ")
        assert [c for i, c in enumerate(p_cells) if i not in timed] == \
            [c for i, c in enumerate(j_cells) if i not in timed]
    assert port_lines[-1].split(", ")[header.index("tenant")] == "ALL"


def test_poison_tenant_needs_tenants():
    with pytest.raises(ConfigError, match="--poison-tenant"):
        serve.main(["--sizes", str(N), "--no-csv", "--poison-rate", "0.1",
                    "--poison-tenant", "tenant-0", *CPU_ARGS])
