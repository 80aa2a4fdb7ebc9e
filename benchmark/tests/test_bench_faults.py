"""A run at a small size on the CPU, the harness's look for a card
skipped, with a fault planted under the timed path: `correct` comes out
false for each fault a cell can have (one card: no exchange between
chips to leave out)."""

import pytest

from benchmark import faults, run


@pytest.mark.parametrize("cell,fault", [
    ("vitb32.encode_stl10", "half_batch"),
    ("vitb32.encode_stl10", "altered"),
    ("vitb32.encode_in256", "altered"),
    ("bince.train", "unchanged"),
    ("bince.train", "half_batch"),
    ("bince.train", "altered"),
    ("bince.train", "k3_backward"),
])
def test_a_fault_makes_the_run_incorrect(tiny, cell, fault):
    root, bench = tiny
    kind = "train" if cell.startswith("bince") else "encode"
    with faults.plant(fault, kind):
        result = run.run_cell(root, cell, 2**31 + 5, 0.0, False, "cpu",
                              bench_dir=bench)
    assert result["correct"] is False
    assert result["failed"] > 0


@pytest.mark.parametrize("cell", ["vitb32.encode_stl10", "bince.train"])
def test_a_sound_run_is_correct(tiny, cell):
    root, bench = tiny
    result = run.run_cell(root, cell, 2**31 + 5, 0.0, False, "cpu",
                          bench_dir=bench)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"
