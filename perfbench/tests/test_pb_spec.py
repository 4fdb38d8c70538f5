"""BENCHMARK.json and the files it names: the contract's rules that a
file can break, and that a new cell needs only new files and entries."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import faults, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
# What a family module gives (harness.py's docstring), and its reference.
FAMILY = ("make_weights", "build_model", "program_graph", "graph_elements",
          "batch_work", "KERNELS", "LIBRARIES", "REFERENCE",
          "first_gradient", "tiny_config")
REFERENCE = ("prepare", "predict", "train")


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
    family = spec.config["family"]
    assert (ROOT / f"perfbench/family_{family}.py").is_file(), family
    fam = harness.family(spec)
    assert [n for n in FAMILY if not hasattr(fam, n)] == []
    assert all(callable(getattr(fam.REFERENCE, n, None)) for n in REFERENCE)
    kind = harness.driver(spec).KIND
    assert kind in fam.LIBRARIES and kind in faults.FAULTS
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


def _copy(tmp_path) -> Path:
    """A copy of ``perfbench/`` under ``tmp_path``."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "perfbench"


def _add_cell(bench, name, config, traffic, like):
    """``bench`` with the cell ``name`` added, reported as ``like`` is."""
    bench["workloads"] = bench["workloads"] + [{
        "name": name, "config": config, "traffic": traffic, "chips": 1,
        "why": "a test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"] = m["workloads"] + [name]


def _run_in_copy(tmp_path, bench, body):
    """Write ``bench`` into the copy and run ``body`` there, with the copy's
    ``perfbench`` first on the path -> the last line it printed, parsed."""
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (f"import sys; sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
            "import json, perfbench\n"
            "from perfbench.tests import tiny\n"
            "assert perfbench.__file__.startswith(sys.path[0])\n" + body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A cell added as a traffic file, a limits file and an entry of
    BENCHMARK.json runs with no file of the harness edited."""
    pb = _copy(tmp_path)
    bench = json.loads(json.dumps(BENCH))
    traffic = json.loads(
        (ROOT / "perfbench/traffic/zinc_b64_pool1024.json").read_text())
    traffic.update(pool=2048, batch=128)
    (pb / "traffic/zinc_b128_pool2048.json").write_text(json.dumps(traffic))
    shutil.copy(pb / "workloads/omega_train_b64.json",
                pb / "workloads/omega_train_b128.json")
    _add_cell(bench, "omega_train_b128", "smp_omega_c32_f32",
              "zinc_b128_pool2048", "omega_train_b64")
    line = _run_in_copy(tmp_path, bench, (
        "s = tiny.harness.load_spec('omega_train_b128')\n"
        "assert s.traffic['batch'] == 128\n"
        "record, out = tiny.run('omega_train_b128')\n"
        "print(json.dumps(out))\n"))
    assert line["correct"] and "train_graphs_per_s" in line["metrics"]


# Appended to the copied reference: every prediction and every loss 1 % off.
OFF = """

_predict, _train = predict, train


def predict(*args, **kw):
    return _predict(*args, **kw) * 1.01


def train(*args, **kw):
    losses, grad, after = _train(*args, **kw)
    return [x * 1.01 for x in losses], grad, after
"""


@pytest.mark.parametrize("off", [False, True], ids=["same", "off"])
def test_a_new_family_is_files_and_entries(tmp_path, off):
    """A model family added as files (a family module, its reference, a
    configuration, traffic and limits) and entries runs a training and a
    prediction cell with no file of the harness edited, and its cells are
    judged by the family's own reference: with that reference 1 % off,
    neither cell is correct.  ``reference_smp2d`` is never loaded."""
    pb = _copy(tmp_path)
    ref = (pb / "reference_smp2d.py").read_text()
    (pb / "reference_smp2dcopy.py").write_text(ref + OFF if off else ref)
    fam = (pb / "family_smp2d.py").read_text()
    (pb / "family_smp2dcopy.py").write_text(
        fam.replace("reference_smp2d", "reference_smp2dcopy"))
    cfg = json.loads((pb / "configs/smp_omega_c32_f32.json").read_text())
    (pb / "configs/smp_copy.json").write_text(
        json.dumps(dict(cfg, family="smp2dcopy")))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"] = bench["configs"] + [{
        "name": "smp_copy", "source": "a test",
        "file": "perfbench/configs/smp_copy.json", "reduced": [],
        "why": "a test"}]
    cells = {"copy_train": ("omega_train_b64", "zinc_b64_pool1024",
                            "train_graphs_per_s"),
             "copy_predict": ("omega_predict_b256", "zinc_b256_pool2048",
                              "predict_graphs_per_s")}
    for cell, (like, traffic, _) in cells.items():
        shutil.copy(pb / f"traffic/{traffic}.json",
                    pb / f"traffic/{cell}.json")
        shutil.copy(pb / f"workloads/{like}.json",
                    pb / f"workloads/{cell}.json")
        _add_cell(bench, cell, "smp_copy", cell, like)
    line = _run_in_copy(tmp_path, bench, (
        f"out = {{c: tiny.run(c)[1] for c in {sorted(cells)!r}}}\n"
        "assert 'perfbench.reference_smp2dcopy' in sys.modules\n"
        "out['loaded'] = 'perfbench.reference_smp2d' in sys.modules\n"
        "print(json.dumps(out))\n"))
    assert line.pop("loaded") is False
    for cell, (_, _, metric) in cells.items():
        assert line[cell]["correct"] is not off, line[cell]["check"]
        assert line[cell]["failed"] == 0 and metric in line[cell]["metrics"]
