"""The yardstick: the frozen counts equal the functions they were copied
from, and the present elements that the counts take come out the same from
the reference's fields and from the program's own index arrays (so they
depend on no layout or plan of the program)."""

import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import counts, family_smp2d, graphs

ROOT = Path(__file__).resolve().parents[2]


def test_copies_match_chip_smoke():
    import chip_smoke

    for shape in [(256, 16, 32, 32), (2048, 64, 32, 32), (96, 40, 32, 16)]:
        for e in (0, 12345, 10**7):
            assert counts.level_ops(*shape, e) == chip_smoke.level_ops(
                *shape, e)
            assert counts.level_backward_ops(
                *shape, e) == chip_smoke.level_backward_ops(*shape, e)
    assert counts.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S
    assert counts.PEAK_FLOPS == {"float32": 495e12, "bfloat16": 989e12}


@pytest.mark.parametrize("config", ["smp_omega_c32_f32", "smp_beta_v40_f32"])
def test_present_elements_match_the_program(config):
    import chip_smoke
    import torch

    cfg = json.loads((ROOT / f"perfbench/configs/{config}.json").read_text())
    traffic = json.loads(
        (ROOT / "perfbench/traffic/zinc_b64_pool1024.json").read_text())
    traffic["pool"] = 6
    pool, _ = graphs.make_pool(3, traffic)
    model = family_smp2d.build_model(
        cfg, family_smp2d.make_weights(cfg, 3, "cpu"), "cpu")
    for adj, feat in pool:
        pg = model.prepare(family_smp2d.program_graph(adj, feat))
        V = cfg["max_nVertices"]
        ours = family_smp2d.graph_elements(cfg, adj)
        theirs = []
        for l in range(cfg["nLevels"]):
            nbr = torch.as_tensor(pg.nbr[l]).clone()
            nbr[torch.as_tensor(pg.vmask == 0)] = V     # padding: absent
            theirs.append(chip_smoke.present_elements(
                nbr, torch.as_tensor(pg.pos[l])))
        assert ours == theirs


def test_work_is_a_function_of_shapes_and_elements():
    cfg = json.loads(
        (ROOT / "perfbench/configs/smp_omega_c32_f32.json").read_text())
    a = family_smp2d.batch_work(cfg, 64, [10**6, 2 * 10**6])
    b = family_smp2d.batch_work(dict(cfg), 64, np.array([10**6, 2 * 10**6]))
    assert a == b
    (by, op), = [counts.bound_s(*a["fwd"][0], "float32")]
    assert by > 0 and op > 0
