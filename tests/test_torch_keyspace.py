"""The port's ExecKey-space audit against the JAX package's.

For every serve configuration the JAX package's golden pins
(``data/staticcheck/golden_keyspace.json``), the port's symbolic
enumeration equals the JAX package's, labels mapped to the port's tier
names, and equals the port engine's own ``exec_keyspace()`` on 8 logical
CPU shards. The compile budget (``steady`` within ``warmup``) holds, a
widened surface is drift, an unwarmed steady key is hard red, and a live
engine builds exactly the enumerated warmup class and nothing after it.
"""

import copy
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from matvec_mpi_multiplier_tpu.staticcheck import keyspace as jks
from matvec_mpi_multiplier_torch.engine import MatvecEngine
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.staticcheck import __main__ as pmain
from matvec_mpi_multiplier_torch.staticcheck import keyspace as ks
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
# The JAX package's tier names and the port's counterparts (kernels, then
# the fused solver tier).
LABELS = {"xla": "torch", "pallas": "cuda", "pallas_fused": "cuda_fused"}
CLASSES = ("warmup", "steady", "fault_only", "rollover")


def _map_label(label: str) -> str:
    parts = label.split(":")
    parts[2] = LABELS.get(parts[2], parts[2])
    return ":".join(parts)


def _port_config(jcfg) -> ks.ServeConfig:
    d = dataclasses.asdict(jcfg)
    d["kernel"] = LABELS[d["kernel"]]
    d["solver_kernel"] = LABELS[d["solver_kernel"]]
    return ks.ServeConfig(**d)


JAX_GOLDEN = json.loads((REPO / "data/staticcheck/golden_keyspace.json").read_text())
JAX_CONFIGS = {c.name: c for c in jks.KEYSPACE_CONFIGS}


def test_the_golden_configs_are_the_jax_package_s():
    assert set(JAX_GOLDEN["configs"]) == set(JAX_CONFIGS)
    assert [c.name for c in ks.KEYSPACE_CONFIGS] == [c.name for c in jks.KEYSPACE_CONFIGS]
    for cfg in ks.KEYSPACE_CONFIGS:
        assert cfg == _port_config(JAX_CONFIGS[cfg.name])


@pytest.mark.parametrize("name", sorted(JAX_GOLDEN["configs"]))
def test_enumeration_equals_the_jax_package_s(name):
    port = ks.enumerate_keyspace(_port_config(JAX_CONFIGS[name]))
    golden = JAX_GOLDEN["configs"][name]
    for cls in CLASSES:
        assert list(getattr(port, cls)) == sorted(_map_label(x) for x in golden[cls]), cls
    assert port.budget == golden["budget"]


@pytest.fixture(scope="module")
def operands():
    gen = torch.Generator().manual_seed(0)
    a = torch.rand(64, 2048, generator=gen)
    s = torch.rand(64, 64, generator=gen)
    return a, s @ s.T + 64 * torch.eye(64)  # SPD for the solver configs


def _engine(cfg: ks.ServeConfig, operands):
    a = operands[1] if cfg.solver_ops else operands[0]
    return MatvecEngine(
        a, make_mesh(8, devices=[CPU] * 8), strategy=cfg.strategy, kernel=cfg.kernel,
        combine=cfg.combine, stages=cfg.stages, dtype=cfg.dtype,
        dtype_storage=None if cfg.dtype_storage == "native" else cfg.dtype_storage,
        promote=cfg.promote, max_bucket=cfg.max_bucket, solver_kernel=cfg.solver_kernel)


@pytest.mark.parametrize("cfg", ks.KEYSPACE_CONFIGS, ids=lambda c: c.name)
def test_enumeration_equals_the_engine_s_exec_keyspace(cfg, operands):
    engine = _engine(cfg, operands)
    try:
        live = engine.exec_keyspace(cfg.solver_ops, restart=cfg.restart, steps=cfg.steps,
                                    widths=cfg.warm_widths, reshard_to=cfg.reshard_to)
    finally:
        engine.close()
    space = ks.enumerate_keyspace(cfg)
    for cls in CLASSES:
        assert live[cls] == list(getattr(space, cls)), cls


@pytest.mark.parametrize("cfg", [c for c in ks.KEYSPACE_CONFIGS
                                 if not c.solver_ops and not c.reshard_to],
                         ids=lambda c: c.name)
def test_a_live_engine_builds_the_warmup_class_and_nothing_after(cfg, operands):
    engine = _engine(cfg, operands)
    try:
        engine.warmup(widths=cfg.warm_widths)
        built = engine.stats.compiles
        gen = torch.Generator().manual_seed(1)
        for w in range(1, cfg.max_bucket + 1):
            x = torch.rand((engine.k,) if w == 1 else (engine.k, w), generator=gen)
            engine.submit(x).result()
        assert engine.stats.compiles == built
        assert sorted(k.label() for k in engine._cache.keys()) == list(
            ks.enumerate_keyspace(cfg).warmup)
    finally:
        engine.close()


def test_exec_keyspace_refuses_what_the_model_does_not_cover(operands):
    engine = MatvecEngine(operands[0], make_mesh(8, devices=[CPU] * 8), strategy="colwise",
                          kernel="torch", combine="ring", promote=8)
    try:
        with pytest.raises(ConfigError):
            engine.exec_keyspace(reshard_to=("rowwise",))
        with pytest.raises(ConfigError):
            engine.exec_keyspace(("nope",))
    finally:
        engine.close()


def test_keyspace_audit_green_on_the_tree():
    assert ks.run_keyspace_audit() == []


def test_budget_proves_steady_subset_of_warmup():
    for cfg in ks.KEYSPACE_CONFIGS:
        space = ks.enumerate_keyspace(cfg)
        assert set(space.steady) <= set(space.warmup), cfg.name
        assert space.budget["steady_beyond_warmup"] == 0
        assert space.budget["total"] == len(
            set(space.warmup) | set(space.steady) | set(space.fault_only)
            | set(space.rollover))
        assert not set(space.fault_only) & set(space.warmup)
        assert not set(space.rollover) & set(space.warmup)


def test_widened_surface_is_drift():
    table = ks.keyspace_table()
    golden = ks.load_golden()
    assert ks.audit_table(table, golden) == []
    widened = copy.deepcopy(table)
    name = sorted(widened["configs"])[0]
    widened["configs"][name]["warmup"].append("gemm:rowwise:cuda:none:512:float64")
    found = ks.audit_table(widened, golden)
    assert found and all(f.rule == "keyspace-golden" and f.severity == "drift" for f in found)
    assert pmain.exit_status(found) == pmain.EXIT_DRIFT
    assert [f.rule for f in ks.audit_table(table, None)] == ["keyspace-golden"]


def test_unwarmed_steady_key_is_hard_red(monkeypatch):
    real = ks._warm_buckets

    def narrowed(cfg):
        buckets = real(cfg)
        return set(sorted(buckets)[:-1]) if buckets else buckets

    monkeypatch.setattr(ks, "_warm_buckets", narrowed)
    found = ks.audit_table(ks.keyspace_table(), ks.load_golden())
    hard = [f for f in found if f.rule == "keyspace-steady-unwarmed"]
    assert hard and all(f.severity == "error" for f in hard)
    assert pmain.exit_status(found) == pmain.EXIT_HLO
    with pytest.raises(ValueError, match="refusing to bless"):
        ks.write_golden_keyspace()
    assert pmain.main(["--keyspace"]) == pmain.EXIT_HLO
    monkeypatch.undo()
    assert ks.run_keyspace_audit() == []
