"""On the card, at each cell's own size: the control (the reference in
float8 e4m3 put in the program's place) fails the comparison on three
seeds. `python3 -m pytest benchmark/tests -m card` on the chip."""

import pytest

from benchmark import cells
from benchmark.tests.conftest import REPO


@pytest.mark.card
@pytest.mark.parametrize("name", ["vitb32.encode_stl10",
                                  "vitb32.encode_in256", "bince.train"])
def test_the_control_fails_at_the_cells_size(card, name):
    cell = cells.load_cell(REPO, name)
    limits = cell.limits
    for seed in (901, 902, 903):
        s = cells.driver(cell).Session(cell, seed, "cuda")
        s.setup()
        s.window(0.0)
        s.closing()
        s.free()
        control = s.control()
        assert any(control[k] > limits[k] for k in control), control
