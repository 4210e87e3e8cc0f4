"""On the card: a short run of each mamba2 cell through ``run.py`` reads
correct and prints its result last.  Skips without a card; run with
``pytest -m cuda sagebench/tests`` on a machine that holds one."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mamba2-train", "mamba2-longprompt"])
def test_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "sagebench/run.py", "--workload", cell, "--seed",
         "2147483701", "--seconds", "3", "--trace", "1"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
