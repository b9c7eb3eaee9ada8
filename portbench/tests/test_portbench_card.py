"""One short run of each cell on the card (marked ``gpu``; skips without
a card): the result line is the last line of standard output and the run
is correct."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness

CELLS = [c["name"] for c in harness.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", "2147483648", "--seconds", "2", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
