"""The plain reference against the program's CPU path on tiny versions of
both cells (float32 weights, so the two differ by rounding alone), and
the controls: the reference one precision down in the program's place
(the check on the card at the cells' sizes is ``test_bench_control.py``)."""

import pytest

import tiny

# the program in float32 against the float32 reference on the CPU: measured
# 4e-5 / 7e-4 / 2.5e-3 (loss, grad, change) at most over the two cells and two seeds;
# the bounds leave 3-30x
F32_AGREES = {"loss": 1e-3, "grad": 1e-2, "change": 5e-2, "change_median": 5e-2}


@pytest.mark.parametrize("name", ["sd21.t2i", "mvdream.t2i"])
def test_reference_follows_program_cpu(name):
    res = tiny.run(tiny.cell(name))
    assert res["compared"]
    for key, c in res["compared"].items():
        assert c["value"] < F32_AGREES[key], (key, res["compared"])
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("name", ["sd21.t2i", "mvdream.t2i"])
def test_control_fails_cell_limits(name):
    """The control (fp8 for the bf16 configuration, bf16 for the float32
    one) breaks at least one of the cell's limits."""
    res = tiny.run(tiny.cell(name), control=True)
    assert not res["correct"], res["compared"]
