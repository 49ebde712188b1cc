"""The check fails what it must: the controls (the reference one precision
below the configuration's, in the program's place) and the program with
its timed path broken underneath, each driven through a whole run on the
CPU at a small size. At the cells' own size the controls run on the card:
``python3 -m cellbench.harness.control --workload <cell> --seeds ...``."""

import pytest
import torch

from matvec_mpi_multiplier_torch.ops import gemm_kernels, gemv

from cellbench.harness.runner import run_cell

CELLS = ("northstar_bf16.matvec", "northstar_bf16.serve_c4", "cg_fp32.solve")
SECONDS = 0.3


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 7])
def test_program_is_correct_and_control_is_not(small_root, cell, seed):
    sound = run_cell(cell, seed, SECONDS, False, root=small_root, require_cuda=False)
    assert sound["correct"], sound["checks"]
    control = run_cell(cell, seed, SECONDS, False, root=small_root, require_cuda=False,
                       system="control")
    assert not control["correct"], control["checks"]
    number = next(iter(control["checks"]))
    assert control["checks"][number]["value"] > 3 * max(sound["checks"][number]["value"], 0)


def _wrap(registry, name, change):
    inner = registry[name]

    def broken(a, x):
        return change(inner(a, x), x)

    return broken


def _alter_one_answer(out, x):
    out = out.clone()
    out.view(-1)[0] *= 1.01
    return out


def _leave_out_half_the_block(out, b):
    out = out.clone()
    out[:, b.shape[1] // 2:] = 0
    return out


def _return_nothing_new(out, x):
    return torch.zeros_like(out)


def _scale_the_product(out, x):
    return out * (1 + 1e-3)


FAULTS = {
    # a token or an answer altered where it is produced
    ("northstar_bf16.matvec", "answer_altered"): (gemv._KERNELS, _alter_one_answer),
    ("northstar_bf16.serve_c4", "answer_altered"): (gemv._KERNELS, _alter_one_answer),
    ("cg_fp32.solve", "answer_altered"): (gemv._KERNELS, _scale_the_product),
    # half of the batch left out
    ("northstar_bf16.serve_c4", "half_batch"): (gemm_kernels._GEMM_KERNELS,
                                                _leave_out_half_the_block),
    # a step that returns its state unchanged: every product reads zero, so
    # no iteration moves x
    ("cg_fp32.solve", "state_unchanged"): (gemv._KERNELS, _return_nothing_new),
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(small_root, monkeypatch, cell, fault):
    registry, change = FAULTS[(cell, fault)]
    monkeypatch.setitem(registry, "cuda", _wrap(registry, "cuda", change))
    result = run_cell(cell, 3, SECONDS, False, root=small_root, require_cuda=False)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cells_run_on_the_card_at_a_small_size(card, small_root, cell):
    for trace in (False, True):
        result = run_cell(cell, 21, SECONDS, trace, root=small_root)
        assert result["correct"], result["checks"]
        assert result["device"]["platform"] == "gpu"
        assert result["metrics"]
    assert result["device"]["busy_s"] > 0
