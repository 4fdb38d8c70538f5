"""No run loads JAX, jaxlib, flax or the JAX package: the check compares
whole top-level names, so the port (whose name begins with the JAX
package's) passes and the JAX package does not."""

import json
import subprocess
import sys
from pathlib import Path

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "graphflow_tpu_torch_fake", sys)
    assert "graphflow_tpu_torch_fake" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "graphflow_tpu.core", sys)
    assert "graphflow_tpu.core" in harness.banned_modules()


def test_a_cpu_run_loads_none():
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.tests.tiny", "omega_predict_b256"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["banned"] == []
    assert line["result"]["correct"]


def test_the_command_refuses_without_a_card():
    """Here there is no card: no result, and another exit code than 0."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "omega_train_b64",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
