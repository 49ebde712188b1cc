"""The frozen copies of the program's operand constructions and request
draws give, for one seed, what the program's own give. Only this test
imports the program's bench module."""

import json

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_torch.bench import serve as port_serve
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh

from cellbench.harness import drivers, operands

from conftest import HARNESS

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345  # a seed past 32 signed bits


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resident_matrix_is_the_ports(dtype):
    ours = operands.resident_matrix(48, 300, dtype, CPU, SEED)
    assert torch.equal(ours, port_serve.resident_matrix(48, 300, dtype, CPU, SEED))
    rows = torch.cat([blk for _, blk in operands.resident_rows(48, 300, dtype, CPU, SEED)])
    assert torch.equal(rows, ours)


def test_solver_operand_is_the_ports_device_construction():
    ours = operands.solver_operand(96, torch.float32, CPU, SEED)
    theirs = port_serve.solver_operand(96, torch.float32, SEED, device=CPU)
    assert torch.equal(ours, theirs)
    rows = torch.cat([blk for _, blk in operands.solver_rows(96, torch.float32, CPU, SEED)])
    assert torch.equal(rows, ours)


def test_request_pool_is_the_ports():
    widths = port_serve.DEFAULT_WIDTH_MIX
    ours = operands.request_pool(64, widths, torch.bfloat16, SEED)
    theirs = port_serve._request_pool(64, widths, torch.bfloat16, SEED)
    assert list(ours) == list(theirs)
    assert all(torch.equal(ours[w], theirs[w]) for w in ours)


def _recording_engine(monkeypatch):
    submitted = []

    class Recording(port_serve.MatvecEngine):
        def submit(self, x=None, **kw):
            submitted.append(x if x is not None else kw.get("rhs"))
            return super().submit(x, **kw)

    monkeypatch.setattr(port_serve, "MatvecEngine", Recording)
    return submitted


def test_serve_traffic_sends_the_ports_payloads_in_a_balanced_order():
    """``serve_mix_c4`` sends the serve bench's payloads (``_request_pool``),
    and each client's every 10 requests hold each width once, so that every
    seed asks for the same mix of work."""
    traffic = json.loads((HARNESS / "traffic" / "serve_mix_c4.json").read_text())
    widths = port_serve.DEFAULT_WIDTH_MIX
    assert tuple(traffic["payload"]["widths"]) == widths
    pool = drivers.make_pool(traffic, {"k": 64, "dtype": "bfloat16"}, SEED)
    theirs = port_serve._request_pool(64, widths, torch.bfloat16, SEED + 1)
    assert [p.width for p in pool.payloads] == list(theirs)
    assert all(torch.equal(p.value, theirs[p.width]) for p in pool.payloads)
    clients, n = traffic["clients"], len(widths)
    for t in range(clients):
        mine = pool.order[t::clients]
        for r in range(len(mine) // n):
            assert sorted(mine[r * n:(r + 1) * n]) == list(range(n))
    other = drivers.make_pool(traffic, {"k": 64, "dtype": "bfloat16"}, SEED + 1)
    assert not np.array_equal(other.order, pool.order)


def test_solve_traffic_sends_what_run_serve_solver_sends(monkeypatch):
    submitted = _recording_engine(monkeypatch)
    n = 48
    mesh = make_mesh(1, devices=[CPU])
    port_serve.run_serve_solver("rowwise", mesh, n, op="cg", n_solves=32, rtol=1e-5,
                                seed=SEED)
    traffic = json.loads((HARNESS / "traffic" / "cg_stream.json").read_text())
    pool = drivers.make_pool(traffic, {"k": n, "dtype": "float32"}, SEED)
    assert torch.equal(pool.warm_extra[0].value, submitted[0])
    for i, b in enumerate(submitted[1:]):
        assert torch.equal(pool.payloads[pool.order[i]].value, b)


def test_stream_vectors_are_a_width_16_request_block():
    traffic = json.loads((HARNESS / "traffic" / "matvec_stream.json").read_text())
    pool = drivers.make_pool(traffic, {"k": 64, "dtype": "bfloat16"}, SEED)
    block = port_serve._request_pool(64, [16], torch.bfloat16, SEED + 1)[16]
    assert len(pool.payloads) == 16
    for j, p in enumerate(pool.payloads):
        assert torch.equal(p.value, block[:, j])
    assert np.array_equal(pool.order[:32], np.arange(32) % 16)
