"""The port's tuning cache, search and ``auto`` consumers against the JAX
package's (tests/test_tuning.py, tests/test_cache_corruption.py).

Both packages read and write one file format under one key layout; their
platform fingerprints differ, so neither ever applies the other's entries.
Every test points the cache at ``tmp_path`` (the ``cache_path`` fixture).
The searches run on the CPU mesh, where the CUDA candidates are offered only
where a test fakes a card (``offer_cuda``: they then compute their plain
versions); timings differ between the packages, so the tests compare the
decisions' structure, not their winners.
"""

import json

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_tpu import make_mesh as jax_make_mesh
from matvec_mpi_multiplier_tpu import tuning as jtuning
from matvec_mpi_multiplier_tpu.tuning import cache as jcache
from matvec_mpi_multiplier_tpu.tuning import search as jsearch
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch import tuning
from matvec_mpi_multiplier_torch.engine import DEFAULT_PROMOTE_B, MatvecEngine
from matvec_mpi_multiplier_torch.ops import cuda_gemm, cuda_gemv
from matvec_mpi_multiplier_torch.ops import gemm_kernels, gemv
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.tuning import cache as tcache
from matvec_mpi_multiplier_torch.tuning import search
from matvec_mpi_multiplier_torch.utils.convert import from_numpy
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

CPU = torch.device("cpu")
QUIET = dict(log=lambda *_: None)
FAST = dict(n_reps=2, samples=1, **QUIET)


@pytest.fixture()
def cache_path(tmp_path, monkeypatch):
    """Both packages' caches (dispatch singletons included) on a temp file."""
    path = tmp_path / "tuning_cache.json"
    monkeypatch.setenv("MATVEC_TUNING_CACHE", str(path))
    tuning.reset_cache()
    jtuning.reset_cache()
    yield path
    tuning.reset_cache()
    jtuning.reset_cache()


def offer_cuda(monkeypatch):
    """Offer the CUDA candidates for CPU operands, planned for an H100
    SXM's 132 SMs: they compute their plain versions here."""
    monkeypatch.setattr(search, "_cuda_offered", lambda device: True)
    monkeypatch.setattr(cuda_gemv, "sm_count", lambda device: 132)


def port_mesh(p=8):
    return make_mesh(p, devices=[CPU] * p)


def seed(cache_path, key, decision):
    """Record one decision in the file and make the singleton read it."""
    cache = tuning.TuningCache.load(cache_path)
    cache.record(key, decision)
    cache.save()
    tuning.reset_cache()


# ------------------------------------------------------------------ cache


def test_round_trip_and_schema(cache_path):
    cache = tuning.TuningCache.load(cache_path)
    key = tuning.gemv_key(512, 4096, "float32")
    decision = {"kernel": "cuda", "route": "split", "blocks_per_sm": 1, "time_s": 1e-4}
    cache.record(key, decision)
    assert cache.save() == cache_path
    reloaded = tuning.TuningCache.load(cache_path)
    assert reloaded.lookup(key) == decision and len(reloaded) == 1
    raw = json.loads(cache_path.read_text())
    assert raw["version"] == tcache.CACHE_VERSION == jcache.CACHE_VERSION == 6
    assert tcache.COMPATIBLE_VERSIONS == jcache.COMPATIBLE_VERSIONS
    assert tcache.CACHE_ENV == jcache.CACHE_ENV
    assert tuning.lookup_gemv(512, 4096, "float32") == decision


def test_fingerprints_never_cross(cache_path):
    """The port's fingerprint names torch and the device, and begins like no
    JAX fingerprint; a foreign entry for the same config is a miss."""
    fp = tuning.platform_fingerprint()
    assert fp.startswith("torch-cpu:") and "|" not in fp
    assert not jtuning.platform_fingerprint().startswith("torch-")
    seed(cache_path, tuning.gemv_key(64, 64, "float32", fingerprint="tpu:v5e:jax-9.9.9"),
         {"kernel": "pallas"})
    assert tuning.lookup_gemv(64, 64, "float32") is None
    assert tuning.TuningCache.load(cache_path).lookup(
        tuning.gemv_key(64, 64, "float32", fingerprint="tpu:v5e:jax-9.9.9")) is not None


def test_default_path_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("MATVEC_TUNING_CACHE", raising=False)
    monkeypatch.setenv("MATVEC_DATA_DIR", str(tmp_path))
    assert tcache.default_cache_path() == jcache.default_cache_path()
    assert tcache.default_cache_path(tmp_path / "x") == jcache.default_cache_path(tmp_path / "x")


KEYS = [
    ("gemv_key", (120, 60000, "bfloat16")),
    ("gemm_key", (16384, 16384, 16, "float32")),
    ("combine_key", ("gemm", "colwise", 64, 64, 8, "float32")),
    ("promote_key", ("blockwise", 32768, 32768, 4, "float32")),
    ("overlap_key", ("rowwise", 64, 64, 8, "bfloat16")),
    ("storage_key", ("colwise", 64, 128, 2, "float64")),
    ("solver_kernel_key", ("cg", "rowwise", 64, 64, 1, "float32", "int8c")),
    ("calibration_key", (8,)),
]


@pytest.mark.parametrize("name,args", KEYS, ids=[k for k, _ in KEYS])
def test_keys_equal_jax_with_the_fingerprint_swapped(name, args):
    assert getattr(tcache, name)(*args, fingerprint="F") == \
        getattr(jcache, name)(*args, fingerprint="F")
    assert getattr(tcache, name)(*args).startswith(tuning.platform_fingerprint() + "|")


def test_a_shared_file_keeps_both_packages_entries(cache_path):
    """A file the JAX package wrote loads in the port with every JAX entry a
    miss, and survives a port save; the reverse holds too."""
    jax_c = jcache.TuningCache.load(cache_path)
    jkey = jcache.gemv_key(64, 64, "float32")
    jax_c.record(jkey, {"kernel": "xla", "time_s": 1e-5})
    jax_c.record(jcache.combine_key("matvec", "colwise", 64, 64, 8, "float32"),
                 {"combine": "ring"})
    jax_c.save()
    port = tuning.TuningCache.load(cache_path)
    assert not port.quarantined and len(port) == 2
    assert tuning.lookup_gemv(64, 64, "float32") is None
    assert tuning.lookup_combine(op="matvec", strategy="colwise", m=64, k=64, p=8,
                                 dtype="float32") is None
    pkey = tuning.gemv_key(64, 64, "float32")
    port.record(pkey, {"kernel": "torch"})
    port.save()
    jax_back = jcache.TuningCache.load(cache_path)
    assert jax_back.lookup(jkey) == {"kernel": "xla", "time_s": 1e-5}
    assert jax_back.lookup(pkey) == {"kernel": "torch"}
    assert jtuning.lookup_gemv(64, 64, "float32") == {"kernel": "xla", "time_s": 1e-5}
    jax_back.record(jcache.gemv_key(8, 8, "float32"), {"kernel": "xla"})
    jax_back.save()
    assert tuning.TuningCache.load(cache_path).lookup(pkey) == {"kernel": "torch"}


def test_save_keeps_entries_another_writer_saved(cache_path):
    """Two caches loaded from one file both save: neither loses the
    other's decisions (the JAX package's atomic-overwrite test, and a save
    that keeps what it did not write)."""
    c1 = tuning.TuningCache.load(cache_path)
    c2 = tuning.TuningCache.load(cache_path)
    c1.record(tuning.gemv_key(8, 8, "float32"), {"kernel": "torch"})
    c1.save()
    c2.record(tuning.gemv_key(16, 16, "float32"), {"kernel": "torch"})
    c2.save()
    assert len(tuning.TuningCache.load(cache_path)) == 2
    assert not list(cache_path.parent.glob("*.tmp"))


UNUSABLE = {
    "empty": "",
    "truncated": "{\"version\": 3, \"entr",
    "garbage": "not json at all {{{",
    "non-dict": json.dumps([1, 2, 3]),
    "bad-entries": json.dumps({"version": 6, "entries": "nope"}),
    "nonsense-version": json.dumps({"version": "banana", "entries": {}}),
    "future-version": json.dumps({"version": 99, "entries": {"fp|x|8x8|f": {"k": 1}}}),
}


@pytest.mark.parametrize("name", list(UNUSABLE))
def test_unusable_file_is_quarantined_like_jax(cache_path, name):
    """Loads empty and quarantined, in both packages alike; the save moves
    the bytes aside (a future version to its own slot) and writes a fresh
    valid file."""
    payload = UNUSABLE[name]
    cache_path.write_text(payload)
    jax_c = jcache.TuningCache.load(cache_path)
    cache = tuning.TuningCache.load(cache_path)
    assert len(cache) == 0 and cache.quarantined and cache.lookup("anything") is None
    assert (jax_c.quarantined, jax_c.corrupt_path) == (True, cache.corrupt_path)
    assert cache.corrupt_path.name.endswith(
        ".v99.corrupt" if name == "future-version" else ".json.corrupt")
    cache.record("fp|gemv|4x4|float32", {"kernel": "torch"})
    cache.save()
    assert cache.corrupt_path.read_text() == payload
    again = tuning.TuningCache.load(cache_path)
    assert not again.quarantined
    assert again.lookup("fp|gemv|4x4|float32") == {"kernel": "torch"}


def test_quarantine_edges(cache_path):
    """The latest damage wins the generic slot; a file that vanished
    between load and save leaves nothing to keep; a missing file is not
    quarantined."""
    cache_path.write_text("first corruption")
    tuning.TuningCache.load(cache_path).save()
    cache_path.write_text("second corruption")
    tuning.TuningCache.load(cache_path).save()
    assert tuning.TuningCache(cache_path).corrupt_path.read_text() == "second corruption"
    cache_path.write_text("garbage {{{")
    cache = tuning.TuningCache.load(cache_path)
    cache_path.unlink()
    cache.corrupt_path.unlink()
    cache.save()
    assert not cache.corrupt_path.exists()
    assert json.loads(cache_path.read_text())["version"] == 6
    cache_path.unlink()
    missing = tuning.TuningCache.load(cache_path)
    assert not missing.quarantined and len(missing) == 0


@pytest.mark.parametrize("version", [1, 2, 3, 4, 5])
def test_older_versions_load(cache_path, version):
    key = tuning.promote_key("rowwise", 8, 8, 2, "float32")
    cache_path.write_text(json.dumps({"version": version, "entries": {key: {"b_star": 4}}}))
    cache = tuning.TuningCache.load(cache_path)
    assert not cache.quarantined and cache.lookup(key) == {"b_star": 4}


def test_broadcast_and_calibration(cache_path):
    """lookup_calibration misses on an empty cache and returns the record a
    calibration wrote (the record the JAX package's lookup returns too)."""
    cache = tuning.TuningCache.load(cache_path)
    assert tuning.broadcast_decisions(cache) is cache
    assert tuning.lookup_calibration(p=8) is None
    from matvec_mpi_multiplier_torch.tuning.cost_model import calibrate

    record = calibrate(port_mesh(8), level="quick", n_reps=2, **QUIET).to_record()
    seed(cache_path, tuning.calibration_key(8), record)
    tuning.reset_cache()
    assert tuning.lookup_calibration(p=8) == record
    assert tuning.lookup_calibration(p=4) is None


# ------------------------------------------------------------- search


def test_pick_winner_hysteresis_matches_jax():
    assert search.TUNE_MIN_GAIN == jsearch.TUNE_MIN_GAIN
    assert (search.TUNE_N_REPS, search.TUNE_SAMPLES) == (jsearch.TUNE_N_REPS, jsearch.TUNE_SAMPLES)
    cases = [({"psum": 10.0, "ring": 9.8}, "psum"), ({"psum": 10.0, "ring": 9.0}, "psum"),
             ({"ring": 5.0}, "psum"), ({}, "psum"), ({"a": 1.0, "b": 1.0}, "b")]
    for measured, default in cases:
        assert search._pick_winner(measured, default) == \
            jsearch._pick_winner(measured, default), measured


def test_gemv_candidates():
    """Off the card only the torch tier; on a CUDA device (faked: nothing
    runs) the cuda tier on gemv_plan's route first, then each route the
    plan did not pick, each with its own layout."""
    assert search.gemv_candidates(600, 60000, "bfloat16", CPU) == [{"kernel": "torch"}]
    cuda = torch.device("cuda", 0)
    short = search.gemv_candidates(120, 60000, "bfloat16", cuda, sms=132)
    assert short == [{"kernel": "cuda"}, {"kernel": "cuda", "route": "rows"},
                     {"kernel": "cuda", "route": "split", "blocks_per_sm": 1},
                     {"kernel": "torch"}]
    assert cuda_gemv.gemv_plan(120, 60000, torch.bfloat16, torch.bfloat16, 132).route == "split"
    # 600 rows: the plan's line gives rows, and split races beside it.
    assert cuda_gemv.gemv_plan(600, 60000, torch.bfloat16, torch.bfloat16, 132).route == "rows"
    tall = search.gemv_candidates(600, 60000, "bfloat16", cuda, sms=132)
    assert [search._candidate_label(c) for c in tall] == \
        ["cuda", "cuda[split@1]", "cuda[split@2]", "torch"]


def test_gemm_candidates_cover_the_tile_ladder():
    cuda = torch.device("cuda", 0)
    cands = search.gemm_candidates(16384, 16384, 16, "float32", cuda)
    ladder = cuda_gemm.gemm_tile_ladder(16384, 16, 16384, torch.float32)
    assert ladder[0] == cuda_gemm.default_gemm_tiles(16384, 16, 16384, torch.float32)
    assert cands[0] == {"kernel": "cuda"} and cands[-1] == {"kernel": "torch"}
    assert [(c["route"], c["bn"], c["stages"]) for c in cands[1:-1]] == \
        [(p.route, p.bn, p.stages) for p in ladder[1:]]
    assert {p.route for p in ladder} == {"ffma"}
    assert len(set(ladder)) == len(ladder) >= 3
    assert search.gemm_candidates(64, 64, 8, "float32", CPU) == [{"kernel": "torch"}]
    for m, n, k, dt in [(65536, 8, 65536, torch.bfloat16), (4096, 4096, 4096, torch.float64),
                        (4096, 4, 3001, torch.bfloat16)]:
        for plan in cuda_gemm.gemm_tile_ladder(m, n, k, dt):
            assert plan.route == cuda_gemm.default_gemm_tiles(m, n, k, dt).route
            assert plan.smem_bytes <= cuda_gemm.SMEM_LIMIT


@pytest.mark.parametrize("name", ["rowwise", "colwise", "colwise_ring", "blockwise"])
def test_local_gemv_shapes_match_jax(devices, name):
    for m, k in [(64, 48), (60, 48), (64, 64), (120, 60000)]:
        assert search.local_gemv_shapes(name, m, k, port_mesh()) == \
            jsearch.local_gemv_shapes(name, m, k, jax_make_mesh(8)), (m, k)


def test_tune_gemv_records_the_fastest_route(cache_path, monkeypatch):
    """A faked timer makes one forced route the fastest: it is recorded
    with its route, and a second pass on the filled cache measures nothing."""
    offer_cuda(monkeypatch)
    cands = search.gemv_candidates(32, 128, "float32", CPU)
    fast = search._candidate_label(cands[1])
    real = search._candidate_gemv_fn

    def tagged(cand):
        fn = real(cand)

        def wrapper(*a):
            return fn(*a)

        wrapper.label = search._candidate_label(cand)
        return wrapper

    def fake_measure(fn, args, mesh, *, n_reps, samples, measure="loop"):
        label = getattr(fn, "label", None)
        return 1.0 if label == fast else 10.0

    monkeypatch.setattr(search, "_candidate_gemv_fn", tagged)
    monkeypatch.setattr(search, "_measure_fn", fake_measure)
    cache = tuning.TuningCache.load(cache_path)
    decision = search.tune_gemv(32, 128, "float32", cache, device=CPU, **QUIET)
    assert {k: decision[k] for k in cands[1]} == cands[1]
    assert decision["time_s"] == 1.0
    assert set(decision["candidates"]) == {search._candidate_label(c) for c in cands}
    assert cache.lookup(tuning.gemv_key(32, 128, "float32")) == decision
    monkeypatch.setattr(search, "_measure_fn",
                        lambda *a, **k: pytest.fail("a cache hit must not measure"))
    assert search.tune_gemv(32, 128, "float32", cache, device=CPU, **QUIET) == decision


def _jax_axis(axis, mesh_j, cache):
    f = dict(measure="sync", n_reps=2, samples=1, log=lambda *_: None)
    if axis == "gemv":
        return jsearch.tune_gemv(32, 64, "float32", cache, **f)
    if axis == "gemm":
        return jsearch.tune_gemm(32, 64, 8, "float32", cache, **f)
    if axis == "combine":
        return jsearch.tune_combine("colwise", mesh_j, 16, 16, "float32", cache, **f)
    if axis == "gemm_combine":
        return jsearch.tune_gemm_combine("colwise", mesh_j, 16, 16, 4, "float32", cache, **f)
    if axis == "promotion":
        return jsearch.tune_promotion("rowwise", mesh_j, 64, 64, "float32", cache,
                                      buckets=(2, 4), **f)
    if axis == "overlap":
        return jsearch.tune_overlap("colwise", mesh_j, 64, 64, "float32", cache, **f)
    return jsearch.tune_solver_kernel("cg", "rowwise", mesh_j, 64, 64, "float32", cache, **f)


def _port_axis(axis, mesh, cache):
    f = dict(measure="sync", **FAST)
    if axis == "gemv":
        return search.tune_gemv(32, 64, "float32", cache, device=CPU, **f)
    if axis == "gemm":
        return search.tune_gemm(32, 64, 8, "float32", cache, device=CPU, **f)
    if axis == "combine":
        return search.tune_combine("colwise", mesh, 16, 16, "float32", cache, **f)
    if axis == "gemm_combine":
        return search.tune_gemm_combine("colwise", mesh, 16, 16, 4, "float32", cache, **f)
    if axis == "promotion":
        return search.tune_promotion("rowwise", mesh, 64, 64, "float32", cache,
                                     buckets=(2, 4), **f)
    if axis == "overlap":
        return search.tune_overlap("colwise", mesh, 64, 64, "float32", cache, **f)
    return search.tune_solver_kernel("cg", "rowwise", mesh, 64, 64, "float32", cache, **f)


AXES = ["gemv", "gemm", "combine", "gemm_combine", "promotion", "overlap", "solver_kernel"]


@pytest.mark.parametrize("axis", AXES)
def test_axis_records_the_jax_decision_structure(devices, cache_path, monkeypatch, axis):
    """Each axis, run by both packages on the same config of the CPU mesh,
    records a decision with the same fields under the same key (the
    fingerprint aside); the winners may differ, the timings being
    different. The kernel axes' candidates are each package's own tiers;
    the solver axis races both tiers (the fused ones forced in)."""
    monkeypatch.setenv("MATVEC_TUNE_PALLAS", "1")
    offer_cuda(monkeypatch)
    jc = jcache.TuningCache.load(cache_path)
    want = _jax_axis(axis, jax_make_mesh(8 if axis == "solver_kernel" else 2), jc)
    tc = tuning.TuningCache.load(cache_path)
    got = _port_axis(axis, port_mesh(8 if axis == "solver_kernel" else 2), tc)
    assert want is not None and got is not None
    assert set(got) == set(want)
    (jkey,), (tkey,) = jc.entries, tc.entries
    assert tkey.split("|", 1)[1] == jkey.split("|", 1)[1]
    if axis in ("combine", "gemm_combine", "overlap"):
        assert set(got["candidates"]) == set(want["candidates"])
    if axis == "solver_kernel":
        assert set(got["candidates"]) == {"torch", "cuda_fused"}
        assert got["race_iters"] == want["race_iters"] == search.SOLVER_RACE_ITERS
    if axis == "promotion":
        assert set(got["gemm_times"]) == set(want["gemm_times"]) == {"2", "4"}


def test_tune_storage_records_every_format(cache_path):
    """The storage axis races native, the quantized ladder and ``speculate``
    (the fused int8c candidate and check), the JAX package's candidates in
    its order, and records its fields: resident bytes and achieved bandwidth
    per format."""
    assert search.storage_format_candidates("float32") == [
        "native", "int8", "int8c", "fp8", "speculate"]
    assert search.storage_format_candidates("float32") == jsearch.storage_format_candidates(
        "float32")
    cache = tuning.TuningCache.load(cache_path)
    decision = search.tune_storage("rowwise", port_mesh(2), 64, 256, "float32", cache,
                                   measure="sync", **FAST)
    assert set(decision) == {"storage", "time_s", "candidates", "resident_bytes",
                             "bandwidth_gbps"}
    assert set(decision["candidates"]) == {"native", "int8", "int8c", "fp8", "speculate"}
    assert decision["resident_bytes"]["native"] == 64 * 256 * 4
    assert decision["resident_bytes"]["int8"] < decision["resident_bytes"]["native"]
    # The int8c payload plus P (33 x 256) and U (33 x 64), fp32.
    assert decision["resident_bytes"]["speculate"] == (
        decision["resident_bytes"]["int8c"] + 33 * (256 + 64) * 4)
    assert search.tune_storage("colwise_overlap", port_mesh(2), 64, 256, "float32",
                               cache, **FAST) is None


def test_untunable_cells_record_nothing(cache_path):
    cache = tuning.TuningCache.load(cache_path)
    mesh = port_mesh(8)
    assert search.tune_solver_kernel("cg", "rowwise", mesh, 64, 128, "float32", cache, **FAST) is None
    assert search.tune_solver_kernel("gmres", "rowwise", mesh, 64, 64, "float32", cache, **FAST) is None
    assert search.tune_solver_kernel("cg", "blockwise", mesh, 64, 64, "float32", cache, **FAST) is None
    # Off the card with the CUDA candidates not forced: one tier, no race.
    assert search.tune_solver_kernel("cg", "rowwise", mesh, 64, 64, "float32", cache, **FAST) is None
    assert search.tune_gemm_combine("rowwise", mesh, 16, 16, 4, "float32", cache, **FAST) is None
    assert search.tune_promotion("rowwise", mesh, 63, 64, "float32", cache, **FAST) is None
    assert len(cache) == 0


def test_tune_sweep_and_cli_fill_then_hit(cache_path, capsys):
    """The CLI fills the cache for a grid; a second pass measures nothing."""
    from matvec_mpi_multiplier_torch.tuning.__main__ import main

    args = ["--platform", "cpu", "--host-devices", "2", "--devices", "2", "--sizes", "16",
            "--strategy", "rowwise", "colwise", "--measure", "sync", "--n-reps", "2",
            "--samples", "1", "--cache", str(cache_path)]
    assert main(args) == 0
    filled = tuning.TuningCache.load(cache_path)
    kinds = {key.split("|")[1] for key in filled.entries}
    assert kinds == {"gemv", "combine", "overlap", "storage"}
    before = search.candidates_measured()
    assert main(args) == 0
    assert search.candidates_measured() == before
    assert "saved" in capsys.readouterr().out
    # --calibrate records the cost model's constants for each mesh first.
    assert main(args + ["--calibrate", "quick"]) == 0
    record = tuning.TuningCache.load(cache_path).lookup(tuning.calibration_key(2))
    assert record["level"] == "quick" and record["p"] == 2
    assert record["flops"] > 0 and record["mem_bps"] > 0


# ------------------------------------------------------- the auto consumers


@pytest.fixture()
def operands():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    return a, rng.uniform(0, 10, (64,)).astype(np.float32)


def test_gemv_auto(cache_path, monkeypatch):
    a = torch.rand(16, 32)
    x = torch.rand(32)
    calls = []
    real = gemv.resolve_gemv

    def spy(decision):
        fn = real(decision)
        calls.append(getattr(fn, "__name__", None))
        return fn

    monkeypatch.setattr(gemv, "resolve_gemv", spy)
    auto = gemv.get_kernel("auto")
    assert torch.equal(auto(a, x), cuda_gemv.gemv_cuda(a, x))  # miss: cuda
    key = tuning.gemv_key(16, 32, "float32")
    for decision, name in [({"kernel": "torch"}, "gemv_torch"),
                           ({"kernel": "cuda", "route": "split", "blocks_per_sm": 1},
                            "cuda[split@1]"),
                           ({"kernel": "cuda", "route": "rows"}, "cuda[rows]"),
                           # A winner the port does not register (the JAX
                           # package's Pallas tier) takes the default.
                           ({"kernel": "pallas"}, "gemv_cuda")]:
        seed(cache_path, key, decision)
        y = auto(a, x)
        assert calls[-1] == name, decision
        want = gemv.gemv_torch(a, x) if name == "gemv_torch" else cuda_gemv.gemv_cuda(a, x)
        assert torch.equal(y, want)
    assert calls[0] == "gemv_cuda"
    # A registered winner runs: the host C++ tier, once its library is built.
    from matvec_mpi_multiplier_torch.ops import native_gemv

    if native_gemv.register_if_available(build=True):
        assert gemv.resolve_gemv({"kernel": "native"}) is native_gemv.gemv_native
    # A route or grid the kernel lacks is refused, never run as another.
    for decision in ({"kernel": "cuda", "route": "warp"},
                     {"kernel": "cuda", "route": "split", "blocks_per_sm": 3}):
        seed(cache_path, key, decision)
        with pytest.raises(ValueError):
            auto(a, x)


def test_gemm_auto(cache_path):
    a, b = torch.rand(16, 32), torch.rand(32, 8)
    auto = gemm_kernels.get_gemm_kernel("auto")
    assert gemm_kernels.gemm_kernel_name_for("auto") == "auto"
    assert torch.equal(auto(a, b), cuda_gemm.gemm_cuda(a, b))
    key = tuning.gemm_key(16, 32, 8, "float32")
    for decision, name in [({"kernel": "torch"}, "gemm_torch"),
                           ({"kernel": "cuda", "route": "ffma", "bn": 16, "stages": 3},
                            "cuda[ffma:16s3]"),
                           # A winner the port does not register takes the default.
                           ({"kernel": "pallas"}, "gemm_cuda")]:
        seed(cache_path, key, decision)
        assert gemm_kernels.resolve_gemm(tuning.lookup_gemm(16, 32, 8, "float32")).__name__ == name
        assert torch.equal(auto(a, b), gemm_kernels.gemm_torch(a, b) if name == "gemm_torch"
                           else cuda_gemm.gemm_cuda(a, b))
    from matvec_mpi_multiplier_torch.ops import native_gemm

    if native_gemm.register_if_available(build=True):
        assert gemm_kernels.resolve_gemm({"kernel": "native"}) is native_gemm.gemm_native
    # Tiles recorded for a route this A does not take, or that its face
    # cannot take, raise before any launch: never another plan.
    ffma = cuda_gemm.gemm_with_tiles("ffma", 16, 3)
    assert ffma.plan_of(16, 8, 32, torch.float32, True, True) == cuda_gemm.gemm_tiles(
        16, 8, 32, torch.float32, bn=16, stages=3)
    for route, bn, stages, dtype in [("ffma", 16, 99, torch.float32),
                                     ("wgmma_tma", 16, 3, torch.float32),
                                     ("ffma", 16, 3, torch.bfloat16)]:
        fn = cuda_gemm.gemm_with_tiles(route, bn, stages)
        assert fn.__name__ == f"cuda[{route}:{bn}s{stages}]"
        with pytest.raises(ValueError):
            fn.plan_of(16, 8, 32, dtype, True, True)


def test_combine_auto(cache_path, monkeypatch, operands):
    """build(combine="auto") dispatches the recorded schedule per shape, the
    static default on a miss or an invalid winner; the engine reads it once
    for each path."""
    import matvec_mpi_multiplier_torch.parallel.ring as ring

    a, x = operands
    mesh = port_mesh()
    a_t, x_t = from_numpy(a, "cpu"), from_numpy(x, "cpu")
    strat = get_strategy("colwise")
    assert torch.equal(strat.build(mesh, combine="auto")(a_t, x_t), strat.build(mesh)(a_t, x_t))
    calls = []
    real = ring.ring_psum_scatter
    monkeypatch.setattr(ring, "ring_psum_scatter",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    seed(cache_path, tuning.combine_key("matvec", "colwise", 64, 64, 8, "float32"),
         {"combine": "ring"})
    y = get_strategy("colwise", combine="auto").build(mesh)(a_t, x_t)
    np.testing.assert_allclose(y.numpy(), a @ x, rtol=1e-4)
    assert calls, "the recorded 'ring' did not run"
    eng = MatvecEngine(a, mesh, strategy="colwise", combine="auto")
    assert (eng._matvec_combine, eng._gemm_combine) == ("ring", None)
    assert eng._matvec_key().combine == "ring"
    seed(cache_path, tuning.combine_key("matvec", "colwise", 60, 64, 8, "float32"),
         {"combine": "ring"})  # 60 rows do not split 8 ways: the default
    a60 = from_numpy(a[:60], "cpu")
    np.testing.assert_allclose(strat.build(mesh, combine="auto")(a60, x_t).numpy(),
                               a[:60] @ x, rtol=1e-4)
    seed(cache_path, tuning.combine_key("matvec", "colwise", 64, 64, 8, "float32"),
         {"combine": "definitely_not_a_schedule"})
    assert MatvecEngine(a, mesh, strategy="colwise", combine="auto")._matvec_combine is None
    seed(cache_path, tuning.combine_key("gemm", "colwise", 64, 64, 8, "float32"),
         {"combine": "a2a"})
    assert MatvecEngine(a, mesh, strategy="colwise", combine="auto")._gemm_combine == "a2a"
    seed(cache_path, tuning.combine_key("matvec", "colwise", 64, 64, 8, "float32"),
         {"combine": "overlap"})
    qeng = MatvecEngine(a, mesh, strategy="colwise", combine="auto", dtype_storage="int8")
    assert qeng._matvec_combine is None  # a schedule that tiles A: the default


def test_overlap_stages_auto(cache_path, operands):
    a, _ = operands
    mesh = port_mesh()
    strat = get_strategy("colwise")
    assert strat.resolve_stages(64, 64, mesh, None, 8, torch.float32) == 2
    seed(cache_path, tuning.overlap_key("colwise", 64, 64, 8, "float32"), {"stages": 8})
    assert strat.resolve_stages(64, 64, mesh, None, 8, torch.float32) == 8
    assert strat.resolve_stages(64, 64, mesh, None, 16, torch.float32) == 4  # clamped
    eng = MatvecEngine(a, mesh, strategy="colwise", combine="overlap")
    assert eng.stages == 8 and eng._matvec_key().combine == "overlap@8"


def test_promotion_auto(cache_path, operands):
    a, _ = operands
    mesh = port_mesh()
    assert MatvecEngine(a, mesh, strategy="rowwise").b_star == DEFAULT_PROMOTE_B
    key = tuning.promote_key("rowwise", 64, 64, 8, "float32")
    seed(cache_path, key, {"b_star": 2})
    assert MatvecEngine(a, mesh, strategy="rowwise").b_star == 2
    seed(cache_path, key, {"b_star": None})  # promotion never won: honored
    assert MatvecEngine(a, mesh, strategy="rowwise").b_star is None
    assert MatvecEngine(a, mesh, strategy="rowwise", promote=3).b_star == 3


def test_storage_auto(cache_path, operands):
    a, x = operands
    mesh = port_mesh()
    eng = MatvecEngine(a, mesh, strategy="rowwise", dtype_storage="auto")
    assert (eng.storage, eng.storage_reason) == ("native", "auto_miss")
    key = tuning.storage_key("rowwise", 64, 64, 8, "float32")
    seed(cache_path, key, {"storage": "int8"})
    eng = MatvecEngine(a, mesh, strategy="rowwise", dtype_storage="auto")
    assert (eng.storage, eng.storage_reason) == ("int8", "tuned")
    explicit = MatvecEngine(a, mesh, strategy="rowwise", dtype_storage="int8")
    assert torch.equal(eng.submit(x).result(), explicit.submit(x).result())
    # A speculate winner arms the tier beside a native primary.
    seed(cache_path, key, {"storage": "speculate"})
    eng = MatvecEngine(a, mesh, strategy="rowwise", dtype_storage="auto")
    assert (eng.storage, eng.storage_reason, eng.speculative) == ("native", "tuned", True)
    for foreign in ("int3",):
        seed(cache_path, key, {"storage": foreign})
        eng = MatvecEngine(a, mesh, strategy="rowwise", dtype_storage="auto")
        assert (eng.storage, eng.storage_reason) == ("native", "auto_degraded")
        assert eng.health()["counters"]["storage_fallbacks"] == 1
    seed(cache_path, tuning.storage_key("colwise_overlap", 64, 64, 8, "float32"),
         {"storage": "int8"})
    eng = MatvecEngine(a, mesh, strategy="colwise_overlap", dtype_storage="auto")
    assert (eng.storage, eng.storage_reason) == ("native", "auto_degraded")


def test_solver_kernel_auto(cache_path):
    from matvec_mpi_multiplier_torch.bench.serve import solver_operand

    a = solver_operand(64, "float32", 0)
    mesh = port_mesh()
    eng = MatvecEngine(a, mesh, strategy="rowwise", solver_kernel="auto")
    assert eng._resolve_solver_kernel("cg") == "torch"
    seed(cache_path, tuning.solver_kernel_key("cg", "rowwise", 64, 64, 8, "float32", "native"),
         {"solver_kernel": "cuda_fused"})
    assert eng._resolve_solver_kernel("cg") == "cuda_fused"
    assert eng._resolve_solver_kernel("chebyshev") == "torch"  # its own key: a miss
    assert eng._resolve_solver_kernel("gmres") == "torch"  # not a fused op
    assert eng._solver_key("cg", 1).kernel == "cuda_fused"
    b = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    fused = MatvecEngine(a, mesh, strategy="rowwise", solver_kernel="cuda_fused")
    assert torch.equal(eng.submit(op="cg", rhs=b, rtol=1e-5).result().x,
                       fused.submit(op="cg", rhs=b, rtol=1e-5).result().x)
    blockwise = MatvecEngine(a, mesh, strategy="blockwise", solver_kernel="auto")
    seed(cache_path, tuning.solver_kernel_key("cg", "blockwise", 64, 64, 8, "float32",
                                              "native"), {"solver_kernel": "cuda_fused"})
    assert blockwise._resolve_solver_kernel("cg") == "torch"  # the fused tier cannot serve it


def test_auto_engine_equals_the_named_winners(cache_path, operands):
    """An engine with every "auto" dispatches what an engine with the
    recorded winners named dispatches, bitwise."""
    a, _ = operands
    mesh = port_mesh(4)
    strat = "colwise"
    seed(cache_path, tuning.combine_key("matvec", strat, 64, 64, 4, "float32"), {"combine": "a2a"})
    seed(cache_path, tuning.combine_key("gemm", strat, 64, 64, 4, "float32"), {"combine": "ring"})
    seed(cache_path, tuning.promote_key(strat, 64, 64, 4, "float32"), {"b_star": 2})
    seed(cache_path, tuning.gemv_key(64, 16, "float32"), {"kernel": "torch"})
    auto = MatvecEngine(a, mesh, strategy=strat, kernel="auto", combine="auto",
                        promote="auto", dtype_storage="auto", stages=None)
    assert (auto._matvec_combine, auto._gemm_combine, auto.b_star) == ("a2a", "ring", 2)
    rng = np.random.default_rng(9)
    for width in (1, 2, 3, 8):
        xb = rng.uniform(0, 10, (64, width)).astype(np.float32)
        named_gemv = MatvecEngine(a, mesh, strategy=strat, kernel="torch", combine="a2a",
                                  promote=None)
        named_gemm = get_strategy(strat).build_batched(mesh, kernel="cuda", combine="ring")
        if width >= 2:
            pad = np.zeros((64, 8 if width > 4 else (2 if width == 2 else 4)), np.float32)
            pad[:, :width] = xb
            want = named_gemm(from_numpy(a, "cpu"), from_numpy(pad, "cpu"))[:, :width]
        else:
            want = named_gemv.submit(xb[:, 0]).result()[:, None]
        got = auto.submit(xb).result()
        assert torch.equal(got, want), width
