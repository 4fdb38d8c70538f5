#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device   the card (torch's name, nvidia-smi's name and power limit);
  2. build    nvcc builds the level kernel from ops/csrc/ (seconds, ptxas);
  3. kernel   the kernel against its plain PyTorch version on the card at
              three level shapes, float32, inputs from a NumPy seed; then
              both versions' median milliseconds at the production shape;
  4. slice    SMP_omega at full width (V=64, P=16, C=32, two levels) with
              seeded random weights serves 3 requests of 4 random graphs,
              one Predict and one Feature; the kernel's launch count must
              equal nLevels x forward calls, and every output must match
              the same model run through the plain level on the card.
The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.  Any failure raises, so the
script exits non-zero and prints no result.  Without a CUDA device, or
without the package beside this file, it fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
# Kernel vs plain: the bound of tests/test_fused_kernel.py:49-50 (summation
# order on the card differs from the plain version's).
RTOL = 1e-4
LEVEL_SHAPES = [(256, 16, 32, 32), (64, 10, 20, 20), (32, 4, 8, 8)]
MODEL = dict(max_nVertices=64, max_receptive_field=16, nLevels=2,
             nChanels=32, nFeatures=4, nDepth=5)
N_REQUESTS, GRAPHS_PER_REQUEST, ER_P = 3, 4, 0.15


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(what: str, got, ref) -> float:
    """Max abs error of got vs ref; raises beyond RTOL * max(1, max|ref|)
    or on a non-finite value."""
    import torch

    got = torch.as_tensor(got).double().cpu()
    ref = torch.as_tensor(ref).double().cpu()
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    bound = RTOL * max(1.0, float(ref.abs().max()) if ref.numel() else 0.0)
    if err > bound:
        raise AssertionError(f"{what}: max abs err {err:.3e} > {bound:.3e}")
    return err


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the current stream, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("phase 1 device: FAILED, torch.cuda.is_available() "
                         "is false; this script runs only on a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"phase 1 device: {name} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def import_port():
    sys.path.insert(0, str(ROOT))
    import graphflow_tpu_torch

    pkg = Path(graphflow_tpu_torch.__file__).resolve().parent
    if pkg != ROOT / "graphflow_tpu_torch":
        raise SystemExit(f"graphflow_tpu_torch imported from {pkg}, not "
                         f"from this checkout ({ROOT})")
    if any(m == "jax" or m.startswith(("jax.", "graphflow_tpu."))
           or m == "graphflow_tpu" for m in sys.modules):
        raise SystemExit("the port imported jax or graphflow_tpu")


def phase_build():
    from graphflow_tpu_torch.runtime.cuda_build import build_library

    res = build_library("risi18_level")
    log(f"phase 2 build: {res.path.relative_to(ROOT)} "
        f"{'built' if res.rebuilt else 'up to date'} in {res.seconds:.2f} s")
    for line in res.log.splitlines():
        if any(k in line for k in ("registers", "spill", "error", "warning")):
            log(f"  ptxas: {line.strip()}")


def level_inputs(N, P, C, Cout, seed):
    import torch
    from graphflow_tpu_torch.utils.datasets import random_level_case

    d = random_level_case(N, P, C, Cout, seed=seed, empty_vertex=N // 2)
    f32 = {k: torch.as_tensor(d[k], dtype=torch.float32, device="cuda")
           for k in ("state", "radj", "K", "b")}
    i32 = {k: torch.as_tensor(d[k], dtype=torch.int32, device="cuda")
           for k in ("nbr", "pos")}
    return (f32["state"], i32["nbr"], i32["pos"], f32["radj"], f32["K"],
            f32["b"])


def phase_kernel():
    import torch
    from graphflow_tpu_torch.ops.risi_level import (
        risi18_level, risi18_level_reference)

    max_err = 0.0
    for i, (N, P, C, Cout) in enumerate(LEVEL_SHAPES):
        args = level_inputs(N, P, C, Cout, seed=SEED + i)
        got = risi18_level(*args)
        torch.cuda.synchronize()
        ref = risi18_level_reference(*args)
        err = check_close(f"level N={N} P={P} C={C} Cout={Cout}", got, ref)
        max_err = max(max_err, err)
        log(f"phase 3 kernel: N={N} P={P} C={C} Cout={Cout} "
            f"max_abs_err={err:.3e} (max|plain|={float(ref.abs().max()):.3f},"
            f" bound {RTOL:g}*max(1,max|plain|)) ok")
    args = level_inputs(*LEVEL_SHAPES[0], seed=SEED)
    plain_ms = time_ms(lambda: risi18_level_reference(*args))
    kernel_ms = time_ms(lambda: risi18_level(*args))
    log(f"phase 3 kernel: N,P,C,Cout={LEVEL_SHAPES[0]} median kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, 20 reps)")
    return max_err, kernel_ms, plain_ms


def phase_slice():
    import torch
    from graphflow_tpu_torch.models import SMP_omega
    from graphflow_tpu_torch.models.smp2d import smp2d_forward
    from graphflow_tpu_torch.ops.risi_level import (
        risi18_level, risi18_level_reference)
    from graphflow_tpu_torch.utils.datasets import random_graph, toy_molecule

    model = SMP_omega(**MODEL, seed=SEED, device="cuda")
    requests = [[random_graph(MODEL["max_nVertices"], ER_P,
                              seed=GRAPHS_PER_REQUEST * r + i)
                 for i in range(GRAPHS_PER_REQUEST)]
                for r in range(N_REQUESTS)]
    mol = toy_molecule("C2H4")

    risi18_level.launches = 0
    preds, seconds = [], []
    for graphs in requests:
        t0 = time.perf_counter()
        preds.append(model.Threaded_Predict(graphs))
        seconds.append(time.perf_counter() - t0)
    pred_mol = model.Predict(mol)
    feat_mol = model.Feature(mol)
    launches = risi18_level.launches
    forwards = N_REQUESTS + 2
    if launches != MODEL["nLevels"] * forwards:
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{MODEL['nLevels']} levels x {forwards} forwards")

    def plain(graphs):
        with torch.no_grad():
            return smp2d_forward(model.params, model._stack(graphs),
                                 model.cfg, level_fn=risi18_level_reference)

    max_err = 0.0
    for r, graphs in enumerate(requests):
        if preds[r].shape != (GRAPHS_PER_REQUEST,):
            raise AssertionError(f"request {r}: shape {preds[r].shape}")
        ref, _ = plain(graphs)
        max_err = max(max_err, check_close(f"request {r}", preds[r], ref))
    ref_pred, ref_feat = plain([mol])
    max_err = max(max_err, check_close("Predict", [pred_mol], ref_pred),
                  check_close("Feature", feat_mol, ref_feat[0]))
    if feat_mol.shape != (MODEL["nChanels"],):
        raise AssertionError(f"Feature shape {feat_mol.shape}")

    fields = []
    for l in range(1, MODEL["nLevels"] + 1):
        sizes = np.concatenate([model.prepare(g).sizes[l][:g.nVertices]
                                for graphs in requests for g in graphs])
        fields.append(f"level {l} mean {sizes.mean():.2f} max {sizes.max()}")
    log(f"phase 4 slice: receptive fields over {N_REQUESTS * GRAPHS_PER_REQUEST}"
        f" ER graphs (V=64, p={ER_P}): " + "; ".join(fields))
    log(f"phase 4 slice: {N_REQUESTS} requests x {GRAPHS_PER_REQUEST} graphs, "
        f"median {statistics.median(seconds):.4f} s per request (host clock, "
        f"prep included; first request includes warm-up): "
        + ", ".join(f"{s:.4f}" for s in seconds))
    log(f"phase 4 slice: predictions {np.concatenate(preds).round(6).tolist()}"
        f" Predict(C2H4)={pred_mol:.6f}; launches={launches} "
        f"(= {MODEL['nLevels']} levels x {forwards} forwards); "
        f"max abs err vs plain level {max_err:.3e} ok")
    return launches, max_err


def main() -> None:
    name = phase_device()
    import_port()
    import torch

    phase_build()
    level_err, kernel_ms, plain_ms = phase_kernel()
    launches, slice_err = phase_slice()
    torch.cuda.synchronize()
    print(json.dumps({"kernels": [{
        "name": "risi18_level",
        "route": "cuda",
        "source": "graphflow_tpu_torch/ops/csrc/risi18_level.cu",
        "replaces": "graphflow_tpu/ops/risi_fused_pallas.py:526",
        "launches": launches,
        "max_abs_err": max(level_err, slice_err),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
