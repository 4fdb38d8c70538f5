"""Name-by-name coverage of the JAX package by the port.

Every module of ``graphflow_tpu/``, the repo-level ``__graft_entry__.py``,
``examples/`` and ``tools/ablate_bank.py`` is read with ``ast`` (no JAX
runtime needed).  Each public top-level function, class or constant (for a
package's ``__init__.py``: its ``__all__``, else the names it imports) has
one of three fates, and each is checked to exist:

- the port binds the same name at the same path (``graphflow_tpu/x.py`` ->
  ``graphflow_tpu_torch/x.py``; ``__graft_entry__.py`` -> ``entry.py``;
  ``examples/`` and ``tools/ablate_bank.py`` under the package);
- ``RENAMED`` maps it to the port's ``path:name``;
- ``NOT_PORTED`` gives a reason that quotes ROADMAP.md's "Do not port"
  list.

The port's side is read with ``ast`` too, so that a submodule imported
elsewhere does not pass for a name its package binds."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = "graphflow_tpu", "graphflow_tpu_torch"

RENAMED = {
    # The Pallas modules: the hand-written CUDA kernels' wrappers.
    "graphflow_tpu/ops/risi_fused_pallas.py:risi18_level_fused_raw":
        "graphflow_tpu_torch/ops/risi_level.py:risi18_level",
    "graphflow_tpu/ops/risi_fused_pallas.py:risi18_level_fused_v3_raw":
        "graphflow_tpu_torch/ops/risi_level.py:risi18_level",
    "graphflow_tpu/ops/risi_fused_pallas.py:risi18_level_v3t_bwd_raw":
        "graphflow_tpu_torch/ops/risi_level.py:risi18_level_backward",
    "graphflow_tpu/ops/risi_fused_pallas.py:risi18_level_train":
        "graphflow_tpu_torch/ops/risi_level.py:risi18_level",
    "graphflow_tpu/ops/risi_fused_pallas.py:risi18_level":
        "graphflow_tpu_torch/ops/risi_level.py:risi18_level",
    "graphflow_tpu/ops/risi_fused_pallas.py:risi18_aligned_t2":
        "graphflow_tpu_torch/ops/risi_aligned.py:risi18_aligned_t2",
    "graphflow_tpu/ops/risi_pallas.py:risi18_matmul_pallas":
        "graphflow_tpu_torch/ops/risi_bank.py:risi18_bank",
    "graphflow_tpu/ops/risi_pallas.py:risi18_matmul_pallas_bwd":
        "graphflow_tpu_torch/ops/risi_bank.py:risi18_bank_backward",
    "graphflow_tpu/ops/risi_pallas.py:risi18_bank_train":
        "graphflow_tpu_torch/ops/risi_bank.py:risi18_bank",
    "tools/ablate_bank.py:variant":
        "graphflow_tpu_torch/ops/risi_bank_ablate.py:risi18_bank_variant",
    "tools/ablate_bank.py:time_fn":
        "graphflow_tpu_torch/tools/measure.py:time_in_turns",
    # Names that say what they do in a package of many model families.
    "graphflow_tpu/models/smp2d_steerable.py:init_params":
        "graphflow_tpu_torch/models/smp2d_steerable.py:init_steerable_params",
    "graphflow_tpu/models/smp2d_steerable.py:forward":
        "graphflow_tpu_torch/models/smp2d_steerable.py:steerable_forward",
    # orbax and jax have their torch counterparts.
    "graphflow_tpu/utils/checkpoint.py:save_orbax":
        "graphflow_tpu_torch/utils/checkpoint.py:save_torch",
    "graphflow_tpu/utils/checkpoint.py:load_orbax":
        "graphflow_tpu_torch/utils/checkpoint.py:load_torch",
    "graphflow_tpu/utils/profiling.py:time_jax":
        "graphflow_tpu_torch/utils/profiling.py:time_torch",
}

# JAX path (``path:name``, a module or a glob of modules) -> the words of
# ROADMAP.md's "Do not port" list that name it.
NOT_PORTED = {
    "graphflow_tpu/ops/risi_fused_pallas.py:pack_state_cm":
        "`pack_state_cm`, `unpack_state_cm`, `build_xsel`, `radj_dummy`",
    "graphflow_tpu/ops/risi_fused_pallas.py:unpack_state_cm":
        "`pack_state_cm`, `unpack_state_cm`, `build_xsel`, `radj_dummy`",
    "graphflow_tpu/ops/risi_fused_pallas.py:build_xsel":
        "`pack_state_cm`, `unpack_state_cm`, `build_xsel`, `radj_dummy`",
    "graphflow_tpu/ops/risi_fused_pallas.py:radj_dummy":
        "`pack_state_cm`, `unpack_state_cm`, `build_xsel`, `radj_dummy`",
    "graphflow_tpu/ops/risi_fused_pallas.py:_consts": "`_consts*`",
    "graphflow_tpu/ops/risi_fused_pallas.py:_consts_v3": "`_consts*`",
    "graphflow_tpu/ops/risi_fused_pallas.py:_v3_compiler_params":
        "`_v3_compiler_params`",
    "graphflow_tpu/ops/risi_pallas.py:risi18_layer":
        "`risi18_layer`, which has a Pallas forward and an einsum backward",
    "graphflow_tpu/__init__.py:_enable_compilation_cache":
        "`_enable_compilation_cache`",
    "graphflow_tpu/models/smp2d.py:_GATHER_DEFAULT":
        "the `_GATHER_DEFAULT` A/B switch",
    "graphflow_tpu/models/smp2d.py:_t2_frontend_ok":
        "the routing by platform and sublane tile",
    "tools/ablate_v3.py": "their tool `tools/ablate_v3.py`",
    "tools/bench_*.py": "the TPU-only `tools/bench_*.py`",
    "tools/hlo_overlap_check.py": "`tools/hlo_overlap_check.py`",
    "tools/record_scaling.py": "`tools/record_scaling.py`",
}


def _jax_modules():
    mods = sorted(str(p.relative_to(ROOT)) for p in
                  (ROOT / JAX_PKG).rglob("*.py"))
    mods += ["__graft_entry__.py", "tools/ablate_bank.py"]
    mods += sorted(str(p.relative_to(ROOT))
                   for p in (ROOT / "examples").glob("*.py"))
    return mods


MODULES = _jax_modules()


def counterpart(rel: str) -> str:
    """The port's path of a JAX-side module."""
    if rel == "__graft_entry__.py":
        return f"{PORT_PKG}/entry.py"
    if rel.startswith(JAX_PKG + "/"):
        return PORT_PKG + rel[len(JAX_PKG):]
    return f"{PORT_PKG}/{rel}"                      # examples/, tools/


def _tree(rel: str):
    return ast.parse((ROOT / rel).read_text())


def _all(tree):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    return None


def bound_names(rel: str) -> set:
    """Every name a module binds at its top level: definitions,
    assignments and imports."""
    names = set()
    for node in _tree(rel).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
    return names


def port_names(rel: str) -> set:
    """The names the port's counterpart of a JAX-side module binds (none
    where it has no counterpart)."""
    port = counterpart(rel)
    return bound_names(port) if (ROOT / port).is_file() else set()


def public_names(rel: str) -> list:
    """The public top-level functions, classes and constants of a JAX-side
    module; for an ``__init__.py`` its ``__all__``, else what it imports."""
    tree = _tree(rel)
    if rel.endswith("__init__.py"):
        exported = _all(tree)
        if exported is not None:
            return exported
        return [a.asname or a.name for node in tree.body
                if isinstance(node, ast.ImportFrom) for a in node.names
                if not (a.asname or a.name).startswith("_")]
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names += [t.id for t in targets if isinstance(t, ast.Name)]
    return [n for n in dict.fromkeys(names)
            if not n.startswith("_") or n == "__version__"]


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_counterpart(rel):
    names = [n for n in public_names(rel)
             if f"{rel}:{n}" not in RENAMED and f"{rel}:{n}" not in NOT_PORTED]
    if not names:
        return
    port = counterpart(rel)
    assert (ROOT / port).is_file(), f"{rel}: no {port} for {names}"
    missing = sorted(set(names) - bound_names(port))
    assert not missing, f"{rel}: {port} lacks {missing}"


def _split(key):
    path, _, name = key.partition(":")
    return path, name


@pytest.mark.parametrize("key", sorted(RENAMED))
def test_renamed_entries_exist_on_both_sides(key):
    path, name = _split(key)
    assert name in bound_names(path), f"{key}: not in the JAX package"
    assert name not in port_names(path), (
        f"{key}: the port has the name itself; drop the RENAMED entry")
    target, target_name = _split(RENAMED[key])
    assert target_name in bound_names(target), f"{RENAMED[key]} is missing"


def _do_not_port_text():
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("**Do not port.**")
    end = text.index("\n### ", start)
    return " ".join(text[start:end].split())


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_not_ported_entries_exist_and_quote_the_roadmap(key):
    path, name = _split(key)
    files = sorted(ROOT.glob(path))
    assert files, f"{key}: no such file"
    if name:
        assert name in bound_names(path), f"{key}: not in the JAX package"
        assert name not in port_names(path), (
            f"{key}: the port has it; drop the NOT_PORTED entry")
    assert NOT_PORTED[key] in _do_not_port_text(), (
        f"{key}: {NOT_PORTED[key]!r} is not in ROADMAP.md's Do not port list")


def _jax_ops_exports():
    """(name, module) of every name ``graphflow_tpu/ops/__init__.py``
    imports."""
    return [(a.asname or a.name, node.module)
            for node in _tree(f"{JAX_PKG}/ops/__init__.py").body
            if isinstance(node, ast.ImportFrom) for a in node.names]


def test_ops_namespace_exports_every_jax_op_from_the_same_module():
    import graphflow_tpu_torch.ops as ops

    exports = _jax_ops_exports()
    assert len(exports) == 67
    for name, module in exports:
        port_module = sys.modules[PORT_PKG + module[len(JAX_PKG):]]
        assert getattr(ops, name) is getattr(port_module, name), name
    assert callable(ops.launch_counts)


def test_package_namespaces():
    import graphflow_tpu_torch as port
    from graphflow_tpu_torch import core, utils

    version = ast.literal_eval(
        _tree(f"{JAX_PKG}/version.py").body[0].value)
    assert port.__version__ == version
    assert set(port.__all__) == {"__version__", "DenseGraph", "prep", "ops",
                                 "optim", "models"}
    assert port.DenseGraph is core.graph.DenseGraph
    assert port.prep is core.prep and port.ops.__name__ == f"{PORT_PKG}.ops"
    assert (port.optim.__name__, port.models.__name__) == (
        f"{PORT_PKG}.optim", f"{PORT_PKG}.models")
    assert set(core.__all__) == {"DenseGraph", "prep", "batching"}
    assert core.batching.__name__ == f"{PORT_PKG}.core.batching"
    assert {utils.checkpoint.__name__, utils.datasets.__name__} == {
        f"{PORT_PKG}.utils.checkpoint", f"{PORT_PKG}.utils.datasets"}


def test_import_binds_the_namespaces_and_builds_nothing():
    """In a fresh process: ``import graphflow_tpu_torch`` binds its
    namespaces, loads no jax and starts no compiler (no subprocess)."""
    code = "\n".join([
        "import re, subprocess, sys",
        "ran = []",
        "subprocess.run = subprocess.Popen = lambda *a, **k: ran.append(a)",
        "import graphflow_tpu_torch as g",
        "g.ops.matmul, g.optim.adam, g.models.GCN_MW, g.prep.prepare_graph",
        "bad = [m for m in sys.modules",
        "       if re.match(r'(jax|graphflow_tpu)(\\.|$)', m)]",
        "print(bad, ran)",
        "sys.exit(1 if bad or ran else 0)"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
