"""The ver7 level's yardstick (``counts_ver7``): its bytes and operations
pinned at a tiny shape by hand and at the cell's shape, its products equal
to what the factored bank multiplies, and a batch's work the same whichever
bank the program ran."""

import numpy as np
import pytest
import torch

from perfbench import counts_ver7, harness
from perfbench.tests import tiny

CELL = "ver7_predict_b256"


def test_tiny_shape_by_hand():
    # N = 2 rows, P = 2, C = Cout = 1, float32 (4 bytes).  Bytes: state
    # 2*4*1*4 = 32, nbr 2*2*4 = 16, pos 2*4*4 = 32, radj 32, K and b
    # (50 + 1)*4 = 204, out 32: 348.
    assert counts_ver7.level_bytes(2, 2, 1, 1, "float32") == 348
    # Products a row: slabs 3*2*4 = 24; index sums 3*(2*3*8 + 2*3*4) = 216;
    # vectors against R, Rc 2*2*6*2 = 48; one-axis 4*(2*6*4 + 2*8) = 256;
    # scalars' vectors 2*5 = 10: 554, twice.
    assert counts_ver7.bank_product_ops(2, 2, 1, 1) == 1108
    # The rest a row: sums of A 3*4 + 2 = 14, of T 3*8 + 6*4 + 5*2 = 58,
    # mixed K 9, outer products 3*4 = 12, A times vectors 4, Z 11*4 = 44:
    # 141, twice.
    assert counts_ver7.bank_other_ops(2, 2, 1, 1) == 282
    # + b and LeakyReLU: 2*2*4*1 = 16.
    assert counts_ver7.level_ops(2, 2, 1, 1) == 1108 + 282 + 16
    assert counts_ver7.level_backward_ops(2, 2, 1, 1) == 2 * 1406
    assert counts_ver7.level_backward_bytes(2, 2, 1, 1, "float32") == 696


def test_the_cell_s_shape():
    """256 molecules of 40 vertex rows, P = 16, C = 32: 692,920,448 bytes a
    level, the inputs read once and the output written once."""
    assert counts_ver7.level_bytes(10240, 16, 32, 32, "float32") == 692920448
    spec = harness.load_spec(CELL)
    fam, cfg = harness.family(spec), spec.config
    e = fam.graph_elements(cfg, np.zeros((3, 3)))
    (b, o), (b2, o2) = fam.batch_work(cfg, 256, e)["fwd"]
    assert (b, o) == (b2, o2) == (692920448,
                                  counts_ver7.level_ops(10240, 16, 32, 32))


@pytest.mark.parametrize("shape", [(3, 4, 2, 3), (2, 5, 3, 2), (1, 3, 4, 4)])
def test_products_are_the_factored_bank_s(shape):
    """torch's count of the multiply-adds the program's bank takes."""
    from torch.utils.flop_counter import FlopCounterMode

    from graphflow_tpu_torch.ops.contractions import (
        risi_contraction_50_matmul)

    N, P, C, Cout = shape
    T = torch.randn(N, P, P, P, C)
    A = torch.randn(N, P, P)
    K = torch.randn(50 * C, Cout)
    with FlopCounterMode(display=False) as flops:
        risi_contraction_50_matmul(T, A, K)
    assert flops.get_total_flops() == counts_ver7.bank_product_ops(*shape)


def _per_request(record):
    w = record["ranks"][0]["work"]
    n = w["batches"]
    return (w["fwd"]["bound_s"] / n, w["fwd"]["bytes_s"] / n,
            w["fwd"]["ops_s"] / n, w["model_ops"] / n)


def test_the_work_is_the_same_whichever_bank_ran(monkeypatch):
    """A request's counted work with the program's factored bank and with
    the plain 50-case bank times K in its place."""
    from graphflow_tpu_torch.models import smp2d
    from graphflow_tpu_torch.ops.contractions import risi_contraction_50

    record, out = tiny.run(CELL, trace=True, seconds=0.1)
    assert out["correct"]
    factored = _per_request(record)
    monkeypatch.setattr(smp2d, "risi_contraction_50_matmul",
                        lambda T, A, K: risi_contraction_50(T, A) @ K)
    record, out = tiny.run(CELL, trace=True, seconds=0.1)
    assert out["correct"]
    assert _per_request(record) == pytest.approx(factored, rel=1e-12)
