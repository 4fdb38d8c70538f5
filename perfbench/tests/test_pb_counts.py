"""The yardstick: the frozen counts equal the functions they were copied
from, the present elements that SMP2D's counts take come out the same from
the reference's fields and from the program's own index arrays (so they
depend on no layout or plan of the program), and every cell's family counts
a batch's work from shapes and elements alone."""

import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import counts, family_smp2d, graphs, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SMP2D = [c["name"] for c in BENCH["configs"] if json.loads(
    (ROOT / c["file"]).read_text())["family"] == "smp2d"]


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


@pytest.mark.parametrize("config", SMP2D)
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
    for cell in (w["name"] for w in BENCH["workloads"]):
        spec = harness.load_spec(cell)
        fam, cfg = harness.family(spec), spec.config
        pool, _ = graphs.make_pool(3, dict(spec.traffic, pool=4))
        e = np.sum([fam.graph_elements(cfg, adj) for adj, _ in pool], axis=0)
        a = fam.batch_work(cfg, 4, [int(x) for x in e])
        b = fam.batch_work(dict(cfg), 4, e)
        assert a == b, cell
        (by, op), = [counts.bound_s(*a["fwd"][0], cfg["dtype"])]
        assert by > 0 and op > 0, cell
