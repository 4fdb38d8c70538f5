"""ctypes binding of the native C++ graph preparation (counterpart of
``graphflow_tpu/runtime/native.py``).

``runtime/csrc/graph_prep.cpp`` is the port's own copy of the JAX
package's source.  It is compiled with g++ at first use into
``build/native/libgraphprep.so`` beside the package
(``runtime/cuda_build.py:build_host_library``), and again whenever the
source is newer; processes that build it at once never load a
half-written library.  A compile error raises with the compiler's output.
:func:`available` is False only where there is no g++ and no library
built already.

:func:`prepare_graph_native` returns the same ``PreparedGraph`` as the
NumPy path of ``core/prep.py:prepare_graph``, bit for bit in every field;
the shortest paths ``sp`` come from the library too (the JAX package
computes them again in NumPy, ``graphflow_tpu/runtime/native.py:97``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_lib = None
# The build of this process's first load (``cuda_build.BuildResult``: the
# library's path, whether it was compiled then, the seconds it took).
build_result = None


def _load() -> ctypes.CDLL:
    global _lib, build_result
    if _lib is None:
        from graphflow_tpu_torch.runtime.cuda_build import build_host_library

        build_result = build_host_library("graph_prep", "graphprep")
        lib = ctypes.CDLL(str(build_result.path))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.gf_prepare_graph.restype = ctypes.c_int
        lib.gf_prepare_graph.argtypes = [
            i32p, f64p, f64p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            f64p, i32p, i32p, i32p, f64p, f64p, i64p,
        ]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library loads, building it first if need be.
    False only without g++ (and no library built already); a compile error
    raises."""
    try:
        _load()
    except FileNotFoundError:
        return False
    return True


def prepare_graph_native(graph, nLevels: int, max_nVertices: int,
                         max_receptive_field: Optional[int], nDepth: int,
                         has_WL_ordering: bool = True,
                         use_coulomb: bool = False,
                         use_wl_features: bool = True,
                         dtype=np.float32):
    """The native twin of ``core/prep.py:prepare_graph`` (no ``fo_idx``)."""
    from graphflow_tpu_torch.core import prep as prep_mod

    lib = _load()
    n, V = graph.nVertices, max_nVertices
    if n > V:
        raise ValueError(f"graph has {n} vertices > max_nVertices={V}")
    P = max_receptive_field if max_receptive_field is not None else V
    L, F = nLevels, graph.nFeatures
    out_fd = F * (nDepth + 1) if use_wl_features else F

    adj_pad = np.zeros((V, V), np.int32)
    adj_pad[:n, :n] = graph.adj
    feat = np.zeros((V, F), np.float64)
    feat[:n] = graph.feature
    cou = np.zeros((V, V), np.float64)
    cou[:n, :n] = graph.coulomb

    wl_feat = np.zeros((V, out_fd), np.float64)
    sizes = np.zeros((L + 1, V), np.int32)
    nbr = np.zeros((L, V, P), np.int32)
    pos = np.full((L, V, P, P), P, np.int32)
    radj = np.zeros((L, V, P, P), np.float64)
    smask = np.zeros((L + 1, V, P, P), np.float64)
    sp_pad = np.full((V, V), prep_mod.INF, np.int64)

    rc = lib.gf_prepare_graph(
        adj_pad, feat, cou, n, V, F, L, P,
        int(max_receptive_field is not None), nDepth,
        int(has_WL_ordering), int(use_coulomb), int(use_wl_features),
        wl_feat, sizes, nbr, pos, radj, smask, sp_pad)
    if rc != 0:
        raise RuntimeError(f"gf_prepare_graph failed with {rc} (n={n}, "
                           f"V={V}, P={P})")

    return prep_mod.PreparedGraph(
        wl_feat=wl_feat.astype(dtype), sizes=sizes, nbr=nbr, pos=pos,
        radj=radj.astype(dtype), smask=smask.astype(dtype), nVertices=n,
        sp=sp_pad, **prep_mod.payload(graph, V, dtype))
