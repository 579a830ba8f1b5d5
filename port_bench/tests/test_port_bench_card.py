"""On a CUDA card only (they skip elsewhere, decided in a fixture): a short
run of each cell at its own sizes comes out correct, and its control fails
a limit while the program's numbers stay within all of them.

    python3 -m pytest port_bench/tests/test_port_bench_card.py -q
"""
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from port_bench import harness  # noqa: E402
from port_bench.control import control_numbers  # noqa: E402

CELLS = ["hipt4k.serve.plane", "resnet50.serve.plane"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def files(workload):
    return harness.cell_files(harness.load_json(
        os.path.join(ROOT, "BENCHMARK.json")), ROOT, workload)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_short_run_is_correct(card, workload):
    res = harness.run_cell(files(workload), 9100000001, 5.0, False, card,
                           time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["attempted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(card, workload):
    out = control_numbers(files(workload), 9100000002, 5.0, card)
    lim = out["limits"]
    assert all(v <= lim[k] for k, v in out["program"].items()), out
    assert any(v > lim[k] for k, v in out["control"].items()), out
