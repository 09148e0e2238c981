"""On the card: one short run of each cell is correct, and its traced run
reads a device share inside (0, 1].  Skipped without a CUDA device."""

import pytest
import torch

from benchmark.harness import run_cell
from benchmark.manifest import Cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("workload", ["noadv.mu_sweep", "advdiff.flow_sweep",
                                      "noadv.geometry_sweep"])
def test_short_traced_run(card, workload):
    r = run_cell(Cell(workload), 2**40 + 5, 5.0, 1, device="cuda")
    assert r["correct"], r["check"]
    idle = r["metrics"]["device_idle_share"]["value"]
    assert 0.0 <= idle < 1.0 and r["device"]["busy_s"] > 0
