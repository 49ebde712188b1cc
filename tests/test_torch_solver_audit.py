"""The port's solver, fused-solver and speculative audits against the JAX package's.

* Every solver, fused-solver and speculative cell, run on the 8-shard CPU
  mesh under the collective recorder, equals the JAX package's committed
  golden (``data/staticcheck/golden_schedule.json``, sections ``solvers``,
  ``fused_solvers``, ``speculative``) under the name mapping: the census
  and payload bytes exactly; JAX's one ``pallas_call`` a body as one
  ``solver_step`` call a shard a trip and no separate GEMV; JAX's
  ``all_gather``/``psum`` as ``all-gather``/``all-reduce``; JAX's i1 output
  as a ``bool`` verdict and no host read inside the program. The loop is
  the port's departure: cg and chebyshev take the device loop on one card,
  gmres, power and lanczos the host loop (where JAX counts a while op).
* Each mutation turns its gate red.
* The traced fingerprints of solver, speculative and ``pallas_ring`` keys:
  equal across fresh builds, different across ops and combines.

The tolerance everywhere is exact: counts and bytes are integers.
"""

import json
from pathlib import Path

import pytest
import torch

from matvec_mpi_multiplier_torch.engine.executables import (
    ExecKey,
    build_fingerprint,
    trace_program,
    trace_solver,
    trace_speculative,
)
from matvec_mpi_multiplier_torch.models import get_strategy
from matvec_mpi_multiplier_torch.ops import cuda_solver, speculative
from matvec_mpi_multiplier_torch.ops.cuda_gemv import gemv_cuda
from matvec_mpi_multiplier_torch.ops.quantize import QuantizedMatrix
from matvec_mpi_multiplier_torch.parallel.mesh import (
    CollectiveRecorder,
    make_1d_mesh,
    psum,
    shard,
    unshard,
)
from matvec_mpi_multiplier_torch.solvers import ops as solver_ops
from matvec_mpi_multiplier_torch.staticcheck import hlo

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return hlo.audit_mesh()


@pytest.fixture(scope="module")
def jax_golden():
    return json.loads((REPO / "data/staticcheck/golden_schedule.json").read_text())


def _rules(findings):
    return {f.rule for f in findings}


# ----------------------------------------------------- the JAX golden


def test_audit_families_are_the_jax_package_s(jax_golden):
    assert [c.key for c in hlo.SOLVER_AUDIT_CONFIGS] == list(jax_golden["solvers"])
    assert sorted(c.key for c in hlo.FUSED_SOLVER_AUDIT_CONFIGS) == sorted(
        jax_golden["fused_solvers"])
    assert [c.key for c in hlo.SPEC_AUDIT_CONFIGS] == list(jax_golden["speculative"])
    assert jax_golden["solver_operand"]["n"] == hlo.SOLVER_AUDIT_N
    assert jax_golden["fused_solver_operand"]["n"] == hlo.FUSED_SOLVER_AUDIT_N
    assert set(solver_ops.SOLVER_OPS) == {c.op for c in hlo.SOLVER_AUDIT_CONFIGS}


@pytest.mark.parametrize("cfg", hlo.SOLVER_AUDIT_CONFIGS, ids=lambda c: c.key)
def test_solver_cell_equals_the_jax_golden(cfg, mesh, jax_golden):
    entry = hlo.solver_audit_entry(cfg, mesh)
    want = jax_golden["solvers"][cfg.key]
    assert (entry["census"], entry["payload_bytes"]) == (want["census"], want["payload_bytes"])
    # The departure: JAX keeps every loop on the device (while ops >= 1);
    # the port runs gmres, power and lanczos host-stepped.
    assert want["while_ops"] >= 1
    assert entry["loop"] == ("device" if cfg.op in ("cg", "chebyshev") else "host")
    assert hlo.solver_findings(cfg, entry, mesh) == []


@pytest.mark.parametrize("cfg", hlo.FUSED_SOLVER_AUDIT_CONFIGS, ids=lambda c: c.key)
def test_fused_cell_equals_the_jax_golden(cfg, mesh, jax_golden):
    entry = hlo.fused_solver_audit_entry(cfg, mesh)
    want = jax_golden["fused_solvers"][cfg.key]
    assert entry["steps"] == want["pallas_calls"] == 1
    assert entry["gemv_calls"] == 0
    assert entry["census"] == {hlo.FUSED_CENSUS_NAMES[k]: n for k, n in want["census"].items()}
    assert entry["lowbit_shard_converts"] == want["lowbit_shard_converts"] == 0
    # The quantized step's GEMV takes no launch predicate: host-stepped.
    assert entry["loop"] == ("device" if cfg.storage == "native" else "host")
    assert hlo.fused_solver_findings(cfg, entry) == []


@pytest.mark.parametrize("cfg", hlo.SPEC_AUDIT_CONFIGS, ids=lambda c: c.key)
def test_spec_cell_equals_the_jax_golden(cfg, mesh, jax_golden):
    entry = hlo.spec_audit_entry(cfg, mesh)
    want = jax_golden["speculative"][cfg.key]
    assert (entry["census"], entry["payload_bytes"], entry["probes"]) == (
        want["census"], want["payload_bytes"], want["probes"])
    assert want["pred_outputs"] == 1
    assert (entry["verdict_dtype"], entry["host_reads"]) == ("bool", 0)
    assert hlo.spec_findings(cfg, entry, mesh) == []


def test_the_port_s_golden_holds_the_three_sections(mesh):
    table = json.loads(hlo.golden_path().read_text())
    assert table["schema"] == hlo.GOLDEN_SCHEMA == 2
    assert set(table["solvers"]) == {c.key for c in hlo.SOLVER_AUDIT_CONFIGS}
    assert set(table["fused_solvers"]) == {c.key for c in hlo.FUSED_SOLVER_AUDIT_CONFIGS}
    assert set(table["speculative"]) == {c.key for c in hlo.SPEC_AUDIT_CONFIGS}
    assert hlo.run_hlo_audit(solver_configs=hlo.SOLVER_AUDIT_CONFIGS,
                             fused_solver_configs=hlo.FUSED_SOLVER_AUDIT_CONFIGS,
                             spec_configs=hlo.SPEC_AUDIT_CONFIGS, mesh=mesh) == []


def test_golden_drift_in_a_solver_section(mesh, tmp_path):
    table = json.loads(hlo.golden_path().read_text())
    table["solvers"]["cg|colwise|psum"]["census"] = {"all-reduce": 3}
    path = tmp_path / "golden.json"
    path.write_text(json.dumps(table))
    cells = [c for c in hlo.SOLVER_AUDIT_CONFIGS if c.key == "cg|colwise|psum"]
    found = hlo.run_hlo_audit(path, solver_configs=cells, mesh=mesh)
    assert [(f.rule, f.severity) for f in found] == [("hlo-census", "drift")]


def test_loop_pin_reads_solver_loop_on_a_one_card_mesh():
    """``solver_loop`` is pure: a mesh of cuda:0 allocates nothing."""
    for op in solver_ops.SOLVER_OPS:
        assert hlo.one_card_loop(op, "rowwise", "gather") == (
            "device" if op in ("cg", "chebyshev") else "host")
    assert hlo.one_card_loop("cg", "colwise", "pallas_ring") == "host"
    assert hlo.one_card_loop("cg", "rowwise", "gather", storage="int8c") == "host"


def test_coverage_gate(monkeypatch):
    assert hlo.solver_coverage_findings() == []
    monkeypatch.setattr(solver_ops, "SOLVER_OPS", solver_ops.SOLVER_OPS + ("bicgstab",))
    assert _rules(hlo.solver_coverage_findings()) == {"hlo-solver-coverage"}


# ----------------------------------------------------------- mutations


def test_mutation_host_driven_cg_loop_goes_red(mesh, monkeypatch):
    monkeypatch.setattr(solver_ops, "DEVICE_LOOP_OPS", frozenset())
    cells = [c for c in hlo.SOLVER_AUDIT_CONFIGS if c.op in ("cg", "chebyshev")]
    found = hlo.run_hlo_audit(solver_configs=cells, mesh=mesh, check_fingerprints=False)
    assert {f.path for f in found if f.rule == "hlo-solver-loop"} == {
        f"<hlo:{c.key}>" for c in cells}


def test_mutation_stray_collective_in_a_solver_body_goes_red(mesh, monkeypatch):
    real = solver_ops.residual_norm

    def gathering_norm(v):
        full = unshard(shard(v, (mesh.axis_names,), mesh))  # an un-staged gather
        return real(full)

    monkeypatch.setattr(solver_ops, "residual_norm", gathering_norm)
    cells = [c for c in hlo.SOLVER_AUDIT_CONFIGS if c.op == "cg"]
    found = hlo.run_hlo_audit(solver_configs=cells, mesh=mesh, check_fingerprints=False)
    assert {f.path for f in found if f.rule == "hlo-solver-schedule"} == {
        f"<hlo:{c.key}>" for c in cells}


def _fused_cells(storage=None):
    return [c for c in hlo.FUSED_SOLVER_AUDIT_CONFIGS
            if storage is None or c.storage == storage]


def test_mutation_unfused_body_goes_red(mesh, monkeypatch):
    """The step's vector updates in plain PyTorch and its GEMV a separate
    call: no fused step, one GEMV a shard a trip."""
    def unfused(op, a_local, off, x, r, p, ap, s_in):
        x2, r2, p2, s_out, _ = cuda_solver.solver_step_plain(op, a_local, off, x, r, p, ap,
                                                              s_in)
        if isinstance(a_local, QuantizedMatrix):
            from matvec_mpi_multiplier_torch.ops.cuda_quant import quant_gemv_cuda

            return x2, r2, p2, s_out, quant_gemv_cuda(a_local, p2[off:off + a_local.shape[1]])
        return x2, r2, p2, s_out, gemv_cuda(a_local, p2[off:off + a_local.shape[1]])

    monkeypatch.setattr(cuda_solver, "solver_step_cuda", unfused)
    cells = _fused_cells("native")
    found = hlo.run_hlo_audit(fused_solver_configs=cells, mesh=mesh, check_fingerprints=False)
    assert {f.path for f in found if f.rule == "hlo-fused-solver"} == {
        f"<hlo:fused:{c.key}>" for c in cells}


def test_mutation_stray_collective_in_the_fused_body_goes_red(mesh, monkeypatch):
    real = cuda_solver.solver_step_cuda

    def chatty(op, a_local, off, x, r, p, ap, s_in):
        out = real(op, a_local, off, x, r, p, ap, s_in)
        psum([torch.zeros(1)] * mesh.size, mesh, mesh.axis_names)
        return out

    monkeypatch.setattr(cuda_solver, "solver_step_cuda", chatty)
    cells = _fused_cells()
    found = hlo.run_hlo_audit(fused_solver_configs=cells, mesh=mesh, check_fingerprints=False)
    assert {f.path for f in found if f.rule == "hlo-fused-solver"} == {
        f"<hlo:fused:{c.key}>" for c in cells}


def test_mutation_full_shard_dequant_in_the_fused_int8c_cell_goes_red(mesh, monkeypatch):
    real = cuda_solver.solver_step_cuda

    def dequant_first(op, a_local, off, x, r, p, ap, s_in):
        if isinstance(a_local, QuantizedMatrix):
            a_local.q.to(torch.float32)  # the whole shard's payload, outside the step
        return real(op, a_local, off, x, r, p, ap, s_in)

    monkeypatch.setattr(cuda_solver, "solver_step_cuda", dequant_first)
    cells = _fused_cells()
    found = hlo.run_hlo_audit(fused_solver_configs=cells, mesh=mesh, check_fingerprints=False)
    assert {f.path for f in found if f.rule == "hlo-early-dequant"} == {
        f"<hlo:fused:{c.key}>" for c in cells if c.storage != "native"}
    assert "hlo-fused-solver" not in _rules(found)


def test_mutation_full_width_all_reduce_in_the_check_goes_red(mesh, monkeypatch):
    real = speculative.psum

    def wide(blocks, mesh_, axes):
        real([b.new_zeros(hlo.AUDIT_K) for b in blocks], mesh_, axes)
        return real(blocks, mesh_, axes)

    monkeypatch.setattr(speculative, "psum", wide)
    cells = [c for c in hlo.SPEC_AUDIT_CONFIGS if c.strategy != "rowwise"]
    found = hlo.run_hlo_audit(spec_configs=cells, mesh=mesh, check_fingerprints=False)
    assert {f.path for f in found if f.rule == "hlo-spec-schedule"} == {
        f"<hlo:{c.key}>" for c in cells}


def test_mutation_item_in_the_check_goes_red(mesh, monkeypatch):
    real = speculative.verdict

    def reading(*args, **kwargs):
        est_rel, accept = real(*args, **kwargs)
        accept.item()  # the verdict resolved inside the program
        return est_rel, accept

    monkeypatch.setattr(speculative, "verdict", reading)
    found = hlo.run_hlo_audit(spec_configs=hlo.SPEC_AUDIT_CONFIGS, mesh=mesh,
                              check_fingerprints=False)
    assert {f.path for f in found if f.rule == "hlo-spec-host-sync"} == {
        f"<hlo:{c.key}>" for c in hlo.SPEC_AUDIT_CONFIGS}


# ------------------------------------------------------- fingerprints


def _solver_print(mesh, op, strategy="colwise", combine="psum", kernel="cuda"):
    trace = trace_solver(get_strategy(strategy), mesh, op=op, kernel=kernel, combine=combine,
                         stages=None, storage="native", a_shape=(64, 64),
                         dtype=torch.float32, restart=10, steps=32)
    key = ExecKey(op, strategy, kernel, combine, 1, "float32")
    return trace, build_fingerprint(key, trace["schedule"], trace["local_shapes"],
                                    trace["routes"], loop=trace["loop"])


@pytest.mark.parametrize("op", solver_ops.SOLVER_OPS)
def test_solver_fingerprint_is_traced_and_stable(op, mesh):
    (trace, first), (_, second) = _solver_print(mesh, op), _solver_print(mesh, op)
    assert first == second
    key = ExecKey(op, "colwise", "cuda", "psum", 1, "float32")
    assert first != build_fingerprint(key, None, None, None)  # no longer the key alone
    if op != "lanczos":  # lanczos's fixed depth makes no loop trip
        assert {r.kind for r in trace["schedule"] if not r.boundary} == {"all-reduce"}
    assert trace["loop"] == "host" and trace["routes"] == ["[64, 8]x[8]:plain"]


def test_solver_fingerprints_differ_across_ops_and_combines(mesh):
    prints = {op: _solver_print(mesh, op)[1] for op in solver_ops.SOLVER_OPS}
    prints["cg|psum_scatter"] = _solver_print(mesh, "cg", combine="psum_scatter")[1]
    prints["cg|fused"] = _solver_print(mesh, "cg", combine="psum", kernel="cuda_fused")[1]
    assert len(set(prints.values())) == len(prints)


def test_fused_trace_sees_one_step_a_shard_and_one_hop(mesh):
    trace, _ = _solver_print(mesh, "cg", kernel="cuda_fused")
    assert [r.kind for r in trace["schedule"]] == ["all-reduce"]
    assert any(route.startswith("solver_step:") for route in trace["routes"])


def test_speculative_and_ring_fingerprints(mesh):
    def spec(strategy, combine):
        cfg = hlo.SpecAuditConfig(strategy, combine)
        trace = trace_speculative(get_strategy(strategy), mesh, kernel="cuda", combine=combine,
                                  gather_output=True, a_shape=(hlo.AUDIT_M, hlo.AUDIT_K),
                                  dtype=torch.float32, probes=hlo.audit_probes(), bucket=None,
                                  block=hlo.audit_block(cfg.counterpart, mesh))
        return trace, json.dumps([r.payload_bytes for r in trace["schedule"]
                                  if not r.boundary])

    trace, bytes_a = spec("colwise", "psum")
    assert bytes_a == spec("colwise", "psum")[1] == json.dumps([256, 132])
    assert spec("rowwise", "gather")[1] == "[]"
    ring = make_1d_mesh(4, devices=[CPU] * 4)

    def ring_trace(combine):
        return trace_program(get_strategy("colwise"), ring, batched=False, kernel="cuda",
                             combine=combine, stages=None, gather_output=True,
                             storage="native", a_shape=(64, 64), dtype=torch.float32)

    t = ring_trace("pallas_ring")
    assert t["routes"] == ["ring_gemv:[64, 16]x[16]:ring[4 ranks, 4 steps]"]
    assert t == ring_trace("pallas_ring")
    assert ring_trace("psum")["routes"] != t["routes"]
    assert hlo.solver_fingerprint_findings(hlo.SOLVER_AUDIT_CONFIGS[:2], mesh) == []


def test_engines_record_traced_fingerprints_for_every_key_kind():
    from matvec_mpi_multiplier_torch.bench.serve import solver_operand
    from matvec_mpi_multiplier_torch.engine import MatvecEngine

    a = torch.as_tensor(solver_operand(64, "float32", 0))
    x = torch.rand(64, generator=torch.Generator().manual_seed(1))
    mesh4 = hlo.audit_mesh(4)

    def run():
        prints = {}
        e = MatvecEngine(a, mesh4, strategy="colwise", solver_kernel="cuda_fused")
        e.submit(op="cg", rhs=x).result()
        prints.update(e.fingerprints())
        e.close()
        e = MatvecEngine(a, mesh4, strategy="colwise", dtype_storage="speculate")
        e.submit(x, rtol=1e-3).result()
        prints.update(e.fingerprints())
        e.close()
        e = MatvecEngine(a, make_1d_mesh(4, devices=[CPU] * 4), strategy="colwise",
                         combine="pallas_ring")
        e.submit(x).result()
        prints.update(e.fingerprints())
        e.close()
        return prints

    first = run()
    assert first == run()
    assert {"cg:colwise:cuda_fused:psum:1:float32",
            "matvec:colwise:cuda:pallas_ring:1:float32"} <= set(first)
    assert any(k.endswith(":speculate") for k in first)
    for label, fp in first.items():
        op, strategy, kernel, combine, bucket, dtype, *storage = label.split(":")
        key = ExecKey(op, strategy, kernel, None if combine == "default" else combine,
                      int(bucket), dtype, *storage)
        assert fp != build_fingerprint(key, None, None, None), label


# ------------------------------------------------ the recorder's notes


def test_recorder_counts_kernels_at_the_wrapper_entry_and_stands_them_in():
    a = torch.rand(8, 4)
    x = torch.rand(4)
    with CollectiveRecorder() as rec:
        y = gemv_cuda(a, x)
    assert [c.name for c in rec.kernels] == ["gemv"] and torch.allclose(y, a @ x)
    with CollectiveRecorder(stand_in=True) as rec:
        y = gemv_cuda(torch.empty(8, 4, device="meta"), x)
    assert rec.kernels[0].a_shape == (8, 4) and torch.equal(y, torch.zeros(8))
