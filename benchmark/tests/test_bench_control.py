"""The control on the card at each cell's own size, on three seeds: the
reference in bfloat16 put in the program's place comes out not correct.
The benchmark's runs do not run it; run it on the card with
``python -m pytest benchmark/tests/test_bench_control.py -m card -s -n 0``
(it prints each reading)."""

import os

import pytest

from conftest import ROOT
from harness.cell import find_cell, load_json

SEEDS = (2 ** 33 + 101, 2 ** 34 + 202, 2 ** 35 + 303)


@pytest.mark.card
@pytest.mark.parametrize("name", ["removert.parkinglot", "slam.sc"])
def test_control_is_not_correct_at_the_cells_size(name, card):
    for seed in SEEDS:
        cell = find_cell(load_json(os.path.join(ROOT, "BENCHMARK.json")), name)
        d = cell.driver.Driver(cell, seed, card)
        if cell.config["driver"] == "removert":
            d.job(0)
        checks, info = d.control()
        print(f"control {name} seed {seed}: "
              + ", ".join(f"{n} {v!r} (limit {lim!r})" for n, v, lim in checks))
        assert any(v > lim for _, v, lim in checks), checks
