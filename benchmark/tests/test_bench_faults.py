"""A whole run, but the look for a card, of the tiny cells with the timed
path broken underneath (``faults.py``): ``correct`` comes out false under
each cell's limits for each fault a one-chip training cell can have (the
cells have no exchange between chips)."""

import pytest

from benchmark import faults

import tiny


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", ["sd21.t2i", "mvdream.t2i"])
def test_fault_makes_run_incorrect(name, fault):
    res = tiny.run(tiny.cell(name), fault=faults.FAULTS[fault])
    assert not res["correct"], res["compared"]
