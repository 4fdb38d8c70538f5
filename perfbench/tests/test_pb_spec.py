"""BENCHMARK.json and the files it names: the contract's rules that a
file can break, and that a new cell needs only new files and entries."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["perfbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_parse(cell):
    spec = harness.load_spec(cell)
    assert spec.config["family"] == "smp2d"
    assert spec.traffic["pool"] % spec.traffic["batch"] == 0
    assert set(spec.check["limits"]) and all(
        v > 0 for v in spec.check["limits"].values())
    assert spec.chips in (1, 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports(cell):
    """setup_s, another end-to-end metric and a per-layer one; each
    per-layer metric's end-to-end metric is reported in the cell."""
    spec = harness.load_spec(cell)
    e2e = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer
    for m in spec.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_configs():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("perfbench/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_fits_its_configuration(cell):
    """One-hot atom types of the traffic are the model's features, and its
    largest molecule fits the model's vertices."""
    spec = harness.load_spec(cell)
    assert spec.traffic["atom_types"] == spec.config["nFeatures"]
    assert spec.traffic["atoms"][1] <= spec.config["max_nVertices"]


def test_four_chip_cells():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A cell added as a traffic file, a limits file and an entry of
    BENCHMARK.json runs with no file of the harness edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    traffic = json.loads(
        (ROOT / "perfbench/traffic/zinc_b64_pool1024.json").read_text())
    traffic.update(pool=2048, batch=128)
    (tmp_path / "perfbench/traffic/zinc_b128_pool2048.json").write_text(
        json.dumps(traffic))
    shutil.copy(ROOT / "perfbench/workloads/omega_train_b64.json",
                tmp_path / "perfbench/workloads/omega_train_b128.json")
    bench["workloads"] = BENCH["workloads"] + [{
        "name": "omega_train_b128", "config": "smp_omega_c32_f32",
        "traffic": "zinc_b128_pool2048", "chips": 1, "why": "a test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "omega_train_b64" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + ["omega_train_b128"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (f"import sys; sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
            "import json, perfbench\n"
            "from perfbench.tests import tiny\n"
            "assert perfbench.__file__.startswith(sys.path[0])\n"
            "s = tiny.harness.load_spec('omega_train_b128')\n"
            "assert s.traffic['batch'] == 128\n"
            "record, out = tiny.run('omega_train_b128')\n"
            "print(json.dumps(out))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] and "train_graphs_per_s" in line["metrics"]
