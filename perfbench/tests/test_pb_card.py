"""On the card: a short run of each one-chip cell is correct and reports
its end-to-end metrics.  Skips without a CUDA device.

    python -m pytest --noconftest -q -m cuda perfbench/tests/test_pb_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["omega_train_b64", "beta_train_b32",
                                  "omega_predict_b256"])
def test_short_run(card, cell):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"], line["check"]
    assert "setup_s" in line["metrics"]
