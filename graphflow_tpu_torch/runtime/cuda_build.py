"""Build and load the port's native libraries.

Each CUDA kernel is one ``ops/csrc/<name>.cu`` with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>.so``
beside the package and loaded with ``ctypes``.  The host C++ graph
preparation (``runtime/csrc/graph_prep.cpp``) is compiled the same way by
``g++`` into ``build/native/libgraphprep.so`` (:func:`build_host_library`).
A build happens at first use in a process (never at import), and again
whenever a source beside it is newer than the library.  Nothing outside
the checkout is read or written apart from the compilers themselves.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "ops" / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
HOST_CSRC_DIR = PACKAGE_DIR / "runtime" / "csrc"
HOST_BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The flags of graphflow_tpu/runtime/Makefile.
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    rebuilt: bool
    seconds: float
    log: str          # nvcc's output (ptxas register and spill report)


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise FileNotFoundError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels build only where the CUDA toolkit is installed")


def _build(find_compiler, flags, src: Path, lib: Path,
           sources) -> BuildResult:
    """Compile ``src`` into ``lib`` with the compiler ``find_compiler()``
    names unless ``lib`` is newer than every file of ``sources``; a failure
    raises with the compiler's output."""
    newest = max(p.stat().st_mtime for p in sources)
    if lib.is_file() and lib.stat().st_mtime >= newest:
        return BuildResult(lib, False, 0.0, "")
    compiler = find_compiler()
    lib.parent.mkdir(parents=True, exist_ok=True)
    # Build beside the target and rename, so that concurrent builds never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, str(src)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(compiler).name} failed ({proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildResult(lib, True, time.perf_counter() - t0,
                       proc.stdout + proc.stderr)


def build_library(name: str, flags=(), suffix: str = "") -> BuildResult:
    """Compile ``ops/csrc/<name>.cu`` unless the library is up to date.
    ``flags`` are further nvcc flags (a ``-D`` that compiles a variant in);
    such a variant is kept apart as ``lib<name><suffix>.so``."""
    sources = [p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh")]
    return _build(find_nvcc, (*NVCC_FLAGS, *flags), CSRC_DIR / f"{name}.cu",
                  BUILD_DIR / f"lib{name}{suffix}.so", sources)


# The kernels of the models' paths: the fused level (K1) and its backward
# (K2), the bank (K4) and its backward (K5), which a partitioned level runs.
MODEL_KERNELS = ("risi18_level", "risi18_level_bwd", "risi18_bank",
                 "risi18_bank_bwd")


def build_libraries(names=MODEL_KERNELS) -> list:
    """:func:`build_library` for each of ``names``, one ``nvcc`` each, all
    at once; the BuildResults in the order of ``names``."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build_library, names))


def find_gxx() -> str:
    """``g++`` from PATH."""
    found = shutil.which("g++")
    if found is None:
        raise FileNotFoundError("g++ not found on PATH: the native graph "
                                "preparation builds only where it is")
    return found


def build_host_library(source: str, name: str) -> BuildResult:
    """Compile ``runtime/csrc/<source>.cpp`` with g++ into
    ``build/native/lib<name>.so`` unless it is up to date."""
    src = HOST_CSRC_DIR / f"{source}.cpp"
    return _build(find_gxx, GXX_FLAGS, src, HOST_BUILD_DIR / f"lib{name}.so",
                  [src])


def load_library(name: str) -> ctypes.CDLL:
    """Build if needed, then load ``lib<name>.so``."""
    return ctypes.CDLL(str(build_library(name).path))
