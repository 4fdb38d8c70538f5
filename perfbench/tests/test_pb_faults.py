"""A run with its timed path broken underneath comes out not correct: once
for each fault the cell can have (``perfbench/faults.py``).  Each run is a
process of its own, since a fault patches the program."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import faults, harness
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CASES = [(w, f) for w in tiny.ONE_CHIP
         for f in faults.FAULTS[harness.driver(harness.load_spec(w)).KIND]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_rejected(cell, fault):
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.tests.tiny", cell,
         f"perfbench.faults:{fault}"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert not line["result"]["correct"], line["result"]["check"]
