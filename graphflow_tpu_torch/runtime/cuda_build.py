"""Build and load the port's CUDA kernels.

Each kernel is one ``ops/csrc/<name>.cu`` with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>.so``
beside the package and loaded with ``ctypes``.  The build happens at the
first CUDA launch in a process (never at import), and again whenever a
source in ``ops/csrc/`` is newer than the library.  Nothing outside the
checkout is read or written apart from the CUDA toolkit itself.
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

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def build_library(name: str, flags=(), suffix: str = "") -> BuildResult:
    """Compile ``ops/csrc/<name>.cu`` unless the library is up to date.
    ``flags`` are further nvcc flags (a ``-D`` that compiles a variant in);
    such a variant is kept apart as ``lib<name><suffix>.so``."""
    src = CSRC_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}{suffix}.so"
    newest = max(p.stat().st_mtime for p in CSRC_DIR.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    if lib.is_file() and lib.stat().st_mtime >= newest:
        return BuildResult(lib, False, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build beside the target and rename, so that concurrent builders never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, str(src)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildResult(lib, True, time.perf_counter() - t0,
                       proc.stdout + proc.stderr)


def load_library(name: str) -> ctypes.CDLL:
    """Build if needed, then load ``lib<name>.so``."""
    return ctypes.CDLL(str(build_library(name).path))
