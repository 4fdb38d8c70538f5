"""The bank's ablation variants in the port (``ops/risi_bank_ablate.py``)
against the JAX package's tool ``tools/ablate_bank.py``: each plain variant
against the Pallas ``variant`` run in interpret mode on the same inputs,
``full`` against the plain bank, the definitions of the other four spelled
out on T, and the wrapper and the tool's command line on the CPU."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphflow_tpu_torch.ops.risi_bank import risi18_bank_reference
from graphflow_tpu_torch.ops.risi_bank_ablate import (
    MODES, risi18_bank_variant, risi18_bank_variant_reference)
from graphflow_tpu_torch.tools import ablate_bank as port_tool

torch.set_num_threads(1)

# The plain variant (float32 sums in torch's order) against the Pallas body
# (float32 selector matmuls in interpret mode): 1e-5 of the scale.
RTOL32 = 1e-5
# bfloat16: both sides sum in float32 from the same bfloat16 inputs and round
# once on store (2^-8 relative); 1e-2 of the scale.
RTOL16 = 1e-2
SHAPES = [(3, 4, 8, 8), (2, 4, 6, 3), (2, 8, 2, 5)]     # B, P, C, Cout


def _jax_tool():
    """tools/ablate_bank.py, imported by path (tools/ is not a package)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "ablate_bank.py"
    spec = importlib.util.spec_from_file_location("jax_ablate_bank", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TOOL = _jax_tool()


def _inputs(B, P, C, Cout, seed, negative=True):
    rng = np.random.default_rng(seed)
    T = rng.normal(size=(B, P, P, P, C)).astype(np.float32)
    A = np.abs(rng.normal(size=(B, P, P))).astype(np.float32)
    if negative:
        A -= np.median(A)
    K = (rng.normal(size=(18 * C, Cout)) * 0.1).astype(np.float32)
    return T, A, K


def _scaled_close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,P,C,Cout", SHAPES)
def test_plain_variant_matches_pallas_variant(B, P, C, Cout, mode):
    T, A, K = _inputs(B, P, C, Cout, seed=B + P + C)
    with pltpu.force_tpu_interpret_mode():
        ref = JAX_TOOL.variant(jnp.asarray(T), jnp.asarray(A), jnp.asarray(K),
                               mode)
    got = risi18_bank_variant_reference(*map(torch.from_numpy, (T, A, K)),
                                        mode)
    assert got.dtype == torch.float32 and got.shape == (B, P, P, Cout)
    _scaled_close(got.numpy(), ref, RTOL32)


@pytest.mark.parametrize("mode", MODES)
def test_plain_variant_matches_pallas_variant_bfloat16(mode):
    T, A, K = _inputs(2, 4, 8, 8, seed=11)
    jT, jK = jnp.asarray(T, jnp.bfloat16), jnp.asarray(K, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = JAX_TOOL.variant(jT, jnp.asarray(A), jK, mode)
    # The same bfloat16 values, rounded once, by JAX.
    tT, tK = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
              for x in (jT, jK))
    got = risi18_bank_variant_reference(tT, torch.from_numpy(A), tK, mode)
    assert got.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    _scaled_close(got.float().numpy(), np.asarray(ref, np.float32), RTOL16)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,P,C,Cout", SHAPES)
def test_full_is_the_bank(B, P, C, Cout, dtype):
    T, A, K = (torch.from_numpy(x).to(dtype)
               for x in _inputs(B, P, C, Cout, seed=P))
    got = risi18_bank_variant_reference(T, A, K, "full")
    ref = risi18_bank_reference(T, A, K)
    _scaled_close(got.numpy(), ref.numpy(),
                  1e-12 if dtype == torch.float64 else RTOL32)


def test_dma_and_reduce_are_what_the_tool_defines():
    B, P, C, Cout = 2, 4, 3, 5
    T, A, K = (torch.from_numpy(x).double()
               for x in _inputs(B, P, C, Cout, seed=5))
    dma = risi18_bank_variant_reference(T, A, K, "dma")
    assert torch.equal(dma, T.reshape(B, P * P, P * C)[:, :, :Cout]
                       .reshape(B, P, P, Cout))
    # reduce, entry by entry from T.
    Y0 = torch.zeros(B, P, P, C, dtype=torch.float64)
    Y1 = torch.zeros_like(Y0)
    for x in range(P):
        for y in range(P):
            Y0[:, x, y] = (T[:, x, y].sum(1) + T[:, :, x, y].sum(1)
                           + T[:, y, x, y])
            Y1[:, x, y] = T[:, x, y, y] + T[:, x, y, x]
    ref = Y0 @ K[:C] + Y1 @ K[C:2 * C]
    _scaled_close(risi18_bank_variant_reference(T, A, K, "reduce").numpy(),
                  ref.numpy(), 1e-12)


def test_nogroupd_is_full_with_seven_blocks_of_k_zeroed():
    B, P, C, Cout = 2, 4, 3, 5
    T, A, K = (torch.from_numpy(x).double()
               for x in _inputs(B, P, C, Cout, seed=6))
    Kz = K.clone().reshape(18, C, Cout)
    Kz[[5, 8, 9, 11, 12, 15, 16]] = 0.0
    ref = risi18_bank_reference(T, A, Kz.reshape(18 * C, Cout))
    got = risi18_bank_variant_reference(T, A, K, "nogroupd")
    _scaled_close(got.numpy(), ref.numpy(), 1e-12)
    full = risi18_bank_variant_reference(T, A, K, "full")
    assert float((full - got).abs().max()) > 1e-3


def test_novpu_differs_from_full_and_ignores_the_diagonals():
    """Apart from case 6 (M6 weighs T by R[c]), novpu reads T only through
    sums over c, so permuting T along c leaves it unchanged, where full
    changes."""
    B, P, C, Cout = 2, 4, 3, 5
    T, A, K = (torch.from_numpy(x).double()
               for x in _inputs(B, P, C, Cout, seed=7))
    K = K.reshape(18, C, Cout).clone()
    K[5] = 0.0
    K = K.reshape(18 * C, Cout)
    Tp = T[:, :, :, [1, 2, 3, 0]]
    novpu = risi18_bank_variant_reference(T, A, K, "novpu")
    _scaled_close(risi18_bank_variant_reference(Tp, A, K, "novpu").numpy(),
                  novpu.numpy(), 1e-12)
    full = risi18_bank_variant_reference(T, A, K, "full")
    assert float((full - novpu).abs().max()) > 1e-3
    assert float((full - risi18_bank_variant_reference(Tp, A, K, "full"))
                 .abs().max()) > 1e-3


def test_wrapper_on_cpu_is_the_plain_version_and_checks_its_mode():
    T, A, K = map(torch.from_numpy, _inputs(2, 4, 2, 3, seed=8))
    before = dict(risi18_bank_variant.launches)
    for mode in MODES:
        assert torch.equal(risi18_bank_variant(T, A, K, mode),
                           risi18_bank_variant_reference(T, A, K, mode))
    assert risi18_bank_variant.launches == before
    with pytest.raises(ValueError, match="the variants are"):
        risi18_bank_variant(T, A, K, "nomxu")
    wide = torch.zeros(18 * 2, 4 * 2 + 1)
    with pytest.raises(ValueError, match="Cout=9 > P\\*C=8"):
        risi18_bank_variant(T, A, wide, "dma")


def test_tool_inputs_are_the_jax_tools_and_it_needs_a_card():
    """The tool draws T, A and K from RandomState(0) as tools/ablate_bank.py
    does, and refuses to run without a CUDA device."""
    B, P, C = 2, 4, 3
    T, A, K = port_tool.make_inputs(B, P, C, torch.float32, device="cpu")
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(
        T.numpy(), rng.randn(B, P, P, P, C).astype(np.float32))
    np.testing.assert_array_equal(
        A.numpy(), np.abs(rng.randn(B, P, P).astype(np.float32)))
    np.testing.assert_array_equal(
        K.numpy(), (rng.randn(18 * C, C) * 0.1).astype(np.float32))
    assert port_tool.parse_args([]) == (256, 16, 32)
    assert port_tool.parse_args(["8", "4"]) == (8, 4, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_tool.main(["2", "4", "3"])


def test_attribution_is_the_tools_differences():
    ms = {"dma": 1.0, "reduce": 3.0, "nogroupd": 4.5, "novpu": 6.5,
          "full": 7.0}
    assert port_tool.attribution(ms) == {
        "stream": 1.0, "reductions": 2.0, "products": 1.5, "group_d": 2.5,
        "selection": 0.5}


def test_report_prints_quartiles_and_paired_differences(monkeypatch):
    """The tool's report, on made-up timings: medians with quartiles, each
    stage's difference taken within every round, and ``full - bank``."""
    names = port_tool.MODE_ORDER + ("bank",)
    times = {m: [1.0 + i + 0.01 * ((3 * j + i) % 5) for j in range(9)]
             for i, m in enumerate(names)}
    times["bank"] = list(times["full"])
    monkeypatch.setattr(port_tool, "time_variants", lambda T, A, K: times)
    monkeypatch.setattr(port_tool.make_inputs, "__defaults__", ("cpu",))
    lines = []
    ms, parts, spread = port_tool.report(2, 4, 3, torch.float32,
                                         out=lines.append)
    assert parts == port_tool.attribution(ms)
    assert spread["full-bank"] == (0.0, 0.0)
    assert spread["stream"] == spread["dma"]
    for k in ("reductions", "products", "group_d", "selection"):
        lo, hi = spread[k]
        assert lo <= hi and abs(parts[k] - (lo + hi) / 2) < 0.05
    assert len(lines) == 1 + len(names) + 2
    assert "[" in lines[1] and lines[-1].startswith("full - bank")
