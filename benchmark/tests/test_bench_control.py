"""The control on the card, at the cells' own sizes: the reference one
precision below the configuration's (fp8 operands for the bfloat16
SD 2.1-base, bfloat16 for the float32 MVDream) in the program's place
breaks the cell's limits on three seeds.  Each case is a ``--control`` run
of ``run.py`` in its own process (``python -m pytest benchmark/tests -m gpu``
on a card)."""

import json
import os
import subprocess
import sys

import pytest

import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [7001, 7002, 7003])
@pytest.mark.parametrize("cell", ["sd21.t2i", "mvdream.t2i"])
def test_control_fails_on_card(card, cell, seed):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", "2", "--trace", "0", "--control"],
                         capture_output=True, text=True, cwd=tiny.ROOT, timeout=900,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is False, result["compared"]
