"""At a size a CPU can hold, each one-chip cell's family's plain reference
agrees with the program's BatchLearn and Threaded_Predict, and rejects the
control (the reference in TF32 in the program's place) and a model whose
weights were rounded to bfloat16."""

import pytest
import torch

from perfbench import calibrate, harness
from perfbench.tests import tiny

ONE_CHIP = tiny.ONE_CHIP
SEEDS = [7, 2**31 + 11, 987654321]


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_program_is_correct(cell):
    _, out = tiny.run(cell)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_control_is_rejected(cell, seed):
    spec = tiny.spec(cell)
    limits = spec.check["limits"]
    numbers = calibrate.readings(spec, seed, "control", device="cpu")
    _, ok = harness.judge({k: numbers[k] for k in limits}, limits)
    assert not ok, numbers


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_bf16_rounded_model_is_rejected(cell, monkeypatch):
    fam = harness.family(tiny.spec(cell))
    build = fam.build_model

    def rounded(cfg, weights, device):
        w = {k: v.to(torch.bfloat16).to(v.dtype) for k, v in weights.items()}
        return build(cfg, w, device)

    monkeypatch.setattr(fam, "build_model", rounded)
    _, out = tiny.run(cell)
    assert not out["correct"], out["check"]
