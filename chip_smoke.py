#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device   the card (torch's name, nvidia-smi's name and power limit);
  2. build    nvcc builds the level forward (K1) and backward (K2) and
              the bank forward (K4) and backward (K5) libraries from
              ops/csrc/, in parallel (seconds, ptxas);
  3. kernel   K1 against its plain PyTorch version on the card at three
              level shapes, float32, inputs from a NumPy seed; then both
              versions' median milliseconds at the production shape;
  4. slice    SMP_omega at full width (V=64, P=16, C=32, two levels) with
              seeded random weights serves 3 requests of 4 random graphs,
              one Predict and one Feature; K1's launch count must equal
              nLevels x forward calls, and every output must match the
              same model run through the plain level on the card;
  5. backward K2 against the plain backward (autograd of the plain level)
              at the three shapes: dstate, dK and db; then the median
              milliseconds of each of K2's two kernels, of both together
              and of the plain backward at the production shape;
  6. train    the same model trains: 3 BatchLearn steps on a batch of 4
              random graphs and one Learn(nIterations=2) on a molecule;
              the loss and every gradient at the first step must match
              the plain level's, every loss must be finite, and K1 and K2
              must launch once per level per forward and per backward.
              Then the seconds per step (prep uncached and cached) and one
              step's split into host batching, forward, backward and Adam;
  7. bank     K4 and K5 against the plain bank and its backward on the
              card at four shapes, in float32 and bfloat16, on slots made
              by the take-gather: Z, dT and dK; then the median
              milliseconds of K4, the plain bank, K5 (both kernels and each
              alone) and the plain backward at the production shape, bf16;
  8. bf16     the same model in bfloat16, whose levels run the take-gather
              and the bank: 3 requests of 4 random graphs served twice
              (prep uncached, then cached), one Predict and one Feature, 3
              BatchLearn steps and one Learn(nIterations=2); outputs, the
              first step's loss and every gradient must match the model
              run through the plain bank on the card, every loss must be
              finite, and K4 and K5 must launch once per level per forward
              and per backward.  Then the seconds per request and per step
              and the peak device memory of a step;
  9. aligned  K7, the aligned neighbour tensor, against its plain version
              (the take-gather) on the card at four shapes in float32: the
              match must be exact.  Then both versions' median milliseconds
              at the production shape, with T's size;
 10. variants SMP_2D_ver6 and ver7 at the same width serve 3 requests of 4
              random graphs twice (prep uncached, then cached), one
              Predict and one Feature through K7 (its
              launch count must equal nLevels x forward calls, every output
              must match the same model through the take-gather), then take
              3 BatchLearn steps and one Learn(nIterations=2) with Momentum
              on the take-gather (finite losses, K7's count unchanged);
              SMP_2D_ver7_classification serves one request ([4, 3] scores)
              and takes 3 BatchLearn steps on integer labels.  Then the
              seconds per request and per step, and one ver7 serving level
              split into K7, the 50-case bank and the rest.
The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.  Any failure raises, so the
script exits non-zero and prints no result.  Without a CUDA device, or
without the package beside this file, it fails.
"""

from __future__ import annotations

import functools
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
# bfloat16: both sides sum in float32 from the same inputs and round to
# bfloat16 (2^-8 relative) where they store; 1e-2 of the scale.
RTOL16 = 1e-2
LEVEL_SHAPES = [(256, 16, 32, 32), (64, 10, 20, 20), (32, 4, 8, 8)]
BANK_SHAPES = LEVEL_SHAPES + [(12, 12, 40, 16)]
MODEL = dict(max_nVertices=64, max_receptive_field=16, nLevels=2,
             nChanels=32, nFeatures=4, nDepth=5)
N_REQUESTS, GRAPHS_PER_REQUEST, ER_P = 3, 4, 0.15
TRAIN_STEPS, TRAIN_LR = 3, 1e-4
# Momentum has no per-element normalisation: at this width the gradients
# reach 1e3-1e5, and the Adam rate above sends the loss to inf in three
# steps (probed on the CPU at V=32, P=8-12, C=16).
MOMENTUM_LR = 1e-10
KERNEL_LIBS = ("risi18_level", "risi18_level_bwd", "risi18_bank",
               "risi18_bank_bwd", "risi_aligned_t2")


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(what: str, got, ref, rtol: float = RTOL) -> float:
    """Max abs error of got vs ref; raises beyond rtol * max(1, max|ref|)
    or on a non-finite value."""
    import torch

    got = torch.as_tensor(got).detach().double().cpu()
    ref = torch.as_tensor(ref).detach().double().cpu()
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    bound = rtol * max(1.0, float(ref.abs().max()) if ref.numel() else 0.0)
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
    from concurrent.futures import ThreadPoolExecutor

    from graphflow_tpu_torch.runtime.cuda_build import build_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_LIBS)) as pool:
        results = list(pool.map(build_library, KERNEL_LIBS))
    for res in results:
        log(f"phase 2 build: {res.path.relative_to(ROOT)} "
            f"{'built' if res.rebuilt else 'up to date'} in "
            f"{res.seconds:.2f} s")
        for line in res.log.splitlines():
            if any(k in line for k in ("registers", "spill", "error",
                                       "warning")):
                log(f"  ptxas: {line.strip()}")
    log(f"phase 2 build: {len(results)} libraries in "
        f"{time.perf_counter() - t0:.2f} s wall")


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


def phase_backward():
    import torch
    from graphflow_tpu_torch.ops.risi_level import (
        _backward_main_kernel, _backward_reduce_kernel, risi18_level,
        risi18_level_backward, risi18_level_backward_reference,
        risi18_level_reference)

    def inputs(N, P, C, Cout, seed):
        g = np.random.default_rng(seed).normal(size=(N, P * P, Cout))
        return (level_inputs(N, P, C, Cout, seed),
                torch.as_tensor(g, dtype=torch.float32, device="cuda"))

    errs = {"dstate": 0.0, "dK": 0.0, "db": 0.0}
    for i, (N, P, C, Cout) in enumerate(LEVEL_SHAPES):
        args, g = inputs(N, P, C, Cout, seed=SEED + i)
        out = risi18_level(*args)
        got = risi18_level_backward(*args, out, g)
        torch.cuda.synchronize()
        ref = risi18_level_backward_reference(*args, g)
        line = []
        for name, x, r in zip(errs, got, ref):
            err = check_close(f"backward {name} N={N} P={P} C={C} "
                              f"Cout={Cout}", x, r)
            errs[name] = max(errs[name], err)
            line.append(f"{name} {err:.3e} (max|plain|="
                        f"{float(r.abs().max()):.3f})")
        log(f"phase 5 backward: N={N} P={P} C={C} Cout={Cout} max_abs_err "
            + ", ".join(line) + f"; bound {RTOL:g}*max(1,max|plain|) ok")

    N, P, C, Cout = LEVEL_SHAPES[0]
    args, g = inputs(N, P, C, Cout, seed=SEED)
    state, nbr, pos, radj, K, b = args
    out = risi18_level(*args)
    leaves = [t.detach().requires_grad_() for t in (state, K, b)]
    plain_out = risi18_level_reference(leaves[0], nbr, pos, radj, leaves[1],
                                       leaves[2])
    _, partial = _backward_main_kernel(state, nbr, pos, radj, K, g, out,
                                       0.01)
    ms = {
        "plain": time_ms(lambda: torch.autograd.grad(
            plain_out, leaves, g, retain_graph=True)),
        "k2": time_ms(lambda: risi18_level_backward(*args, out, g)),
        "main": time_ms(lambda: _backward_main_kernel(
            state, nbr, pos, radj, K, g, out, 0.01)),
        "reduce": time_ms(lambda: _backward_reduce_kernel(partial, C, Cout)),
        "plain_reduce": time_ms(lambda: partial.sum(0)),
    }
    log(f"phase 5 backward: N,P,C,Cout={LEVEL_SHAPES[0]} median K2 (both "
        f"kernels, dstate zero fill included) {ms['k2']:.4f} ms, plain "
        f"backward {ms['plain']:.4f} ms; kernel 1 {ms['main']:.4f} ms, "
        f"kernel 2 {ms['reduce']:.4f} ms ({partial.shape[0]} partial rows; "
        f"plain sum {ms['plain_reduce']:.4f} ms) (CUDA events, 20 reps)")
    return errs, ms


def phase_train():
    import torch
    from graphflow_tpu_torch.models import SMP_omega
    from graphflow_tpu_torch.models.smp2d import smp2d_forward
    from graphflow_tpu_torch.ops.losses import squared_loss
    from graphflow_tpu_torch.ops.risi_level import (
        risi18_level, risi18_level_backward, risi18_level_reference)
    from graphflow_tpu_torch.utils.datasets import random_graph, toy_molecule

    model = SMP_omega(**MODEL, seed=SEED, device="cuda")
    nL = MODEL["nLevels"]
    targets = np.random.default_rng(SEED).normal(
        size=GRAPHS_PER_REQUEST).tolist()

    def er_batch():
        return [random_graph(MODEL["max_nVertices"], ER_P, seed=100 + i)
                for i in range(GRAPHS_PER_REQUEST)]

    # The first step's loss and gradients, kernel against plain level, on
    # graphs of their own so that the counted run prepares its batch anew.
    batch = model._stack(er_batch(), targets)
    params = model.param_dict()

    def loss_and_grads(level_fn):
        pred, _ = smp2d_forward(model.params, batch, model.cfg,
                                level_fn=level_fn)
        loss = squared_loss(pred, batch["target"])
        return loss.detach(), torch.autograd.grad(loss, list(params.values()))

    k_loss, k_grads = loss_and_grads(risi18_level)
    p_loss, p_grads = loss_and_grads(risi18_level_reference)
    grad_err = check_close("train loss", k_loss, p_loss)
    for path, x, r in zip(params, k_grads, p_grads):
        grad_err = max(grad_err, check_close(f"gradient {path}", x, r))

    # The counted run.
    graphs, mol = er_batch(), toy_molecule("C2H4")
    risi18_level.launches = 0
    risi18_level_backward.launches = 0
    risi18_level_backward.reduce_launches = 0
    steps, seconds = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        steps.append(model.BatchLearn(graphs, targets, TRAIN_LR))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    learn = model.Learn(mol, float(mol.nVertices), TRAIN_LR, nIterations=2)
    torch.cuda.synchronize()
    learn_s = time.perf_counter() - t0
    launches = (risi18_level.launches, risi18_level_backward.launches,
                risi18_level_backward.reduce_launches)

    # BatchLearn: one forward with its backward, then the loss-only forward
    # of loss_after.  Learn(nIterations=2): three forwards with backwards.
    fwd, bwd = 2 * TRAIN_STEPS + 3, TRAIN_STEPS + 3
    expected = (nL * fwd, nL * bwd, nL * bwd)
    if launches != expected:
        raise AssertionError(f"launches (K1, K2 kernel 1, K2 kernel 2) = "
                             f"{launches}, expected {expected}: {nL} levels "
                             f"x {fwd} forwards and {bwd} backwards")
    losses = [x for step in steps for x in step] + list(learn)
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss in {losses}")
    grad_err = max(grad_err, check_close("first step loss", steps[0][0],
                                         p_loss))

    # One more step, split on the host clock (each part ends in a sync).
    split = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        split[name] = time.perf_counter() - t0
        return res

    batch = timed("batching", lambda: model._stack(graphs, targets))
    loss = timed("forward", lambda: model._loss(model.params, batch))
    grads = timed("backward", lambda: dict(zip(params, torch.autograd.grad(
        loss, list(params.values())))))
    timed("adam", lambda: model.opt.update(params, model.opt_state, grads,
                                           TRAIN_LR, nBatch=len(graphs)))

    log(f"phase 6 train: first-step loss {float(k_loss):.6f} vs plain level "
        f"{float(p_loss):.6f}; {len(params)} gradients; max abs err "
        f"{grad_err:.3e} (bound {RTOL:g}*max(1,max|plain|)) ok")
    log(f"phase 6 train: BatchLearn (loss_before, loss_after) "
        + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in steps)
        + f"; Learn(C2H4, nIterations=2) ({learn[0]:.6f}, {learn[1]:.6f}); "
        "all finite")
    log(f"phase 6 train: launches K1={launches[0]} K2 kernel 1="
        f"{launches[1]} kernel 2={launches[2]} (= {nL} levels x {fwd} "
        f"forwards, {bwd} backwards)")
    log(f"phase 6 train: seconds per BatchLearn step (host clock, synced): "
        f"prep uncached {seconds[0]:.4f}, prep cached "
        + ", ".join(f"{x:.4f}" for x in seconds[1:])
        + f"; Learn {learn_s:.4f}")
    log("phase 6 train: one step split (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return launches, grad_err


def bank_inputs(N, P, C, Cout, seed, dtype):
    """Level inputs gathered into slots T by the take-gather (absent slots
    are zero), adjacency A, K and a cotangent g; T, K and g in ``dtype``."""
    import torch
    from graphflow_tpu_torch.ops.risi_aligned import (
        _gather_neighbor_tensors_take)

    state, nbr, pos, radj, K, _ = level_inputs(N, P, C, Cout, seed)
    T = _gather_neighbor_tensors_take(
        torch.nn.functional.pad(state, (0, 0, 0, 1, 0, 1)), nbr, pos)
    g = np.random.default_rng(seed).normal(size=(N, P, P, Cout))
    return (T.to(dtype).contiguous(), radj, K.to(dtype),
            torch.as_tensor(g, dtype=dtype, device="cuda"))


def phase_bank():
    import torch
    from graphflow_tpu_torch.ops.risi_bank import (
        _backward_main_kernel, _backward_reduce_kernel, risi18_bank,
        risi18_bank_backward, risi18_bank_backward_reference,
        risi18_bank_reference)

    errs = {"Z": 0.0, "dT": 0.0, "dK": 0.0}
    for dtype, rtol in ((torch.float32, RTOL), (torch.bfloat16, RTOL16)):
        for i, (N, P, C, Cout) in enumerate(BANK_SHAPES):
            T, A, K, g = bank_inputs(N, P, C, Cout, SEED + i, dtype)
            got = (risi18_bank(T, A, K), *risi18_bank_backward(T, A, K, g))
            torch.cuda.synchronize()
            ref = (risi18_bank_reference(T, A, K),
                   *risi18_bank_backward_reference(T, A, K, g))
            line = []
            for name, x, r in zip(errs, got, ref):
                if x.dtype != r.dtype:
                    raise AssertionError(f"bank {name}: dtype {x.dtype}, "
                                         f"plain {r.dtype}")
                err = check_close(f"bank {name} N={N} P={P} C={C} "
                                  f"Cout={Cout} {dtype}", x, r, rtol)
                errs[name] = max(errs[name], err)
                line.append(f"{name} {err:.3e} (max|plain|="
                            f"{float(r.abs().max()):.3f})")
            log(f"phase 7 bank: {str(dtype)[6:]} N={N} P={P} C={C} "
                f"Cout={Cout} max_abs_err " + ", ".join(line)
                + f"; bound {rtol:g}*max(1,max|plain|) ok")

    N, P, C, Cout = BANK_SHAPES[0]
    T, A, K, g = bank_inputs(N, P, C, Cout, SEED, torch.bfloat16)
    leaves = [x.detach().requires_grad_() for x in (T, K)]
    plain_out = risi18_bank_reference(leaves[0], A, leaves[1])
    _, partial = _backward_main_kernel(T, A, K, g)
    ms = {
        "k4": time_ms(lambda: risi18_bank(T, A, K)),
        "plain": time_ms(lambda: risi18_bank_reference(T, A, K)),
        "k5": time_ms(lambda: risi18_bank_backward(T, A, K, g)),
        "main": time_ms(lambda: _backward_main_kernel(T, A, K, g)),
        "reduce": time_ms(lambda: _backward_reduce_kernel(partial, C, Cout)),
        "plain_reduce": time_ms(lambda: partial.sum(0)),
        "plain_bwd": time_ms(lambda: torch.autograd.grad(
            plain_out, leaves, g, retain_graph=True)),
    }
    log(f"phase 7 bank: N,P,C,Cout={BANK_SHAPES[0]} bfloat16, T "
        f"{T.numel() * T.element_size() / 1e6:.1f} MB; median K4 "
        f"{ms['k4']:.4f} ms, plain bank {ms['plain']:.4f} ms; K5 (both "
        f"kernels) {ms['k5']:.4f} ms, kernel 1 {ms['main']:.4f} ms, kernel 2 "
        f"{ms['reduce']:.4f} ms ({partial.shape[0]} partial rows; plain sum "
        f"{ms['plain_reduce']:.4f} ms), plain backward {ms['plain_bwd']:.4f}"
        f" ms (CUDA events, 20 reps)")
    return errs, ms


def phase_bf16():
    import torch
    from graphflow_tpu_torch.models import SMP2D, SMP2DConfig
    from graphflow_tpu_torch.models.smp2d import (
        risi18_bank_level, risi18_bank_level_reference, smp2d_forward)
    from graphflow_tpu_torch.ops.losses import squared_loss
    from graphflow_tpu_torch.ops.risi_bank import (risi18_bank,
                                                   risi18_bank_backward)
    from graphflow_tpu_torch.utils.datasets import random_graph, toy_molecule

    model = SMP2D(SMP2DConfig(**MODEL, dtype="bfloat16"), seed=SEED,
                  device="cuda")
    nL = MODEL["nLevels"]
    requests = [[random_graph(MODEL["max_nVertices"], ER_P,
                              seed=200 + GRAPHS_PER_REQUEST * r + i)
                 for i in range(GRAPHS_PER_REQUEST)]
                for r in range(N_REQUESTS)]
    mol = toy_molecule("C2H4")

    def plain(graphs, targets=None):
        return smp2d_forward(model.params, model._stack(graphs, targets),
                             model.cfg, level_fn=risi18_bank_level_reference)

    # Serving, counted: each request twice (prep uncached, then cached).
    risi18_bank.launches = 0
    preds, seconds = [], {"uncached": [], "cached": []}
    for kind in seconds:
        for graphs in requests:
            t0 = time.perf_counter()
            preds.append(model.Threaded_Predict(graphs))
            seconds[kind].append(time.perf_counter() - t0)
    pred_mol = model.Predict(mol)
    feat_mol = model.Feature(mol)
    serve_launches = risi18_bank.launches
    forwards = 2 * N_REQUESTS + 2
    if serve_launches != nL * forwards:
        raise AssertionError(f"{serve_launches} K4 launches, expected {nL} "
                             f"levels x {forwards} forwards")
    serve_err = 0.0
    with torch.no_grad():
        for r, graphs in enumerate(requests * 2):
            if preds[r].shape != (GRAPHS_PER_REQUEST,):
                raise AssertionError(f"request {r}: shape {preds[r].shape}")
            serve_err = max(serve_err, check_close(
                f"bf16 request {r}", preds[r], plain(graphs)[0], RTOL16))
        ref_pred, ref_feat = plain([mol])
    serve_err = max(serve_err,
                    check_close("bf16 Predict", [pred_mol], ref_pred, RTOL16),
                    check_close("bf16 Feature", feat_mol, ref_feat[0],
                                RTOL16))

    # The first step's loss and gradients, K4/K5 against the plain bank.
    targets = np.random.default_rng(SEED).normal(
        size=GRAPHS_PER_REQUEST).tolist()

    def er_batch():
        return [random_graph(MODEL["max_nVertices"], ER_P, seed=300 + i)
                for i in range(GRAPHS_PER_REQUEST)]

    batch = model._stack(er_batch(), targets)
    params = model.param_dict()

    def loss_and_grads(level_fn):
        pred, _ = smp2d_forward(model.params, batch, model.cfg,
                                level_fn=level_fn)
        loss = squared_loss(pred, batch["target"])
        return loss.detach(), torch.autograd.grad(loss, list(params.values()))

    k_loss, k_grads = loss_and_grads(risi18_bank_level)
    p_loss, p_grads = loss_and_grads(risi18_bank_level_reference)
    grad_err = check_close("bf16 train loss", k_loss, p_loss, RTOL16)
    for path, x, r in zip(params, k_grads, p_grads):
        if x.dtype != torch.bfloat16:
            raise AssertionError(f"gradient {path} has dtype {x.dtype}")
        grad_err = max(grad_err, check_close(f"bf16 gradient {path}", x, r,
                                             RTOL16))

    # Training, counted.
    graphs = er_batch()
    risi18_bank.launches = 0
    risi18_bank_backward.launches = 0
    risi18_bank_backward.reduce_launches = 0
    steps, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        steps.append(model.BatchLearn(graphs, targets, TRAIN_LR))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    learn = model.Learn(mol, float(mol.nVertices), TRAIN_LR, nIterations=2)
    train_launches = (risi18_bank.launches, risi18_bank_backward.launches,
                      risi18_bank_backward.reduce_launches)
    fwd, bwd = 2 * TRAIN_STEPS + 3, TRAIN_STEPS + 3
    expected = (nL * fwd, nL * bwd, nL * bwd)
    if train_launches != expected:
        raise AssertionError(f"launches (K4, K5 kernel 1, K5 kernel 2) = "
                             f"{train_launches}, expected {expected}: {nL} "
                             f"levels x {fwd} forwards and {bwd} backwards")
    losses = [x for step in steps for x in step] + list(learn)
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss in {losses}")
    if not all(p.dtype == torch.bfloat16 for p in model.parameters()):
        raise AssertionError("a parameter left bfloat16")
    grad_err = max(grad_err, check_close("bf16 first step loss", steps[0][0],
                                         p_loss, RTOL16))

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model.BatchLearn(graphs, targets, TRAIN_LR)
    torch.cuda.synchronize()
    step_s.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6

    log(f"phase 8 bf16: {N_REQUESTS} requests x {GRAPHS_PER_REQUEST} graphs, "
        f"seconds per request (host clock, prep uncached) "
        + ", ".join(f"{x:.4f}" for x in seconds["uncached"])
        + "; prep cached " + ", ".join(f"{x:.4f}" for x in seconds["cached"]))
    shown = [round(float(x), 4) for x in np.concatenate(preds[:N_REQUESTS])]
    log(f"phase 8 bf16: predictions {shown} "
        f"Predict(C2H4)={pred_mol:.4f}; K4 launches={serve_launches} (= {nL}"
        f" levels x {forwards} forwards); max abs err vs plain bank "
        f"{serve_err:.3e} (bound {RTOL16:g}*max(1,max|plain|)) ok")
    log(f"phase 8 bf16: first-step loss {float(k_loss):.4f} vs plain bank "
        f"{float(p_loss):.4f}; {len(params)} gradients; max abs err "
        f"{grad_err:.3e} (bound {RTOL16:g}*max(1,max|plain|)) ok")
    log(f"phase 8 bf16: BatchLearn (loss_before, loss_after) "
        + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in steps)
        + f"; Learn(C2H4, nIterations=2) ({learn[0]:.4f}, {learn[1]:.4f}); "
        f"all finite; launches K4={train_launches[0]} K5 kernel 1="
        f"{train_launches[1]} kernel 2={train_launches[2]} (= {nL} levels x "
        f"{fwd} forwards, {bwd} backwards)")
    log(f"phase 8 bf16: seconds per BatchLearn step (host clock, synced): "
        f"prep uncached {step_s[0]:.4f}, prep cached "
        + ", ".join(f"{x:.4f}" for x in step_s[1:])
        + f"; peak device memory of a cached step {peak:.1f} MB above the "
        f"{base / 1e6:.1f} MB held")
    return (serve_launches + train_launches[0], train_launches[1:],
            serve_err, grad_err)


def phase_aligned():
    import torch
    from graphflow_tpu_torch.ops.risi_aligned import (
        risi18_aligned_t2, risi18_aligned_t2_reference)

    max_err = 0.0
    for i, (N, P, C, Cout) in enumerate(BANK_SHAPES):
        state, nbr, pos, *_ = level_inputs(N, P, C, Cout, seed=SEED + i)
        got = risi18_aligned_t2(state, nbr, pos)
        torch.cuda.synchronize()
        ref = risi18_aligned_t2_reference(state, nbr, pos)
        if got.dtype != ref.dtype or got.shape != ref.shape:
            raise AssertionError(f"aligned N={N} P={P} C={C}: {got.dtype} "
                                 f"{tuple(got.shape)}, plain {ref.dtype} "
                                 f"{tuple(ref.shape)}")
        err = float((got - ref).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, ref):
            raise AssertionError(f"aligned N={N} P={P} C={C}: max abs err "
                                 f"{err:.3e}, the copy must be exact")
        log(f"phase 9 aligned: N={N} P={P} C={C} max_abs_err={err:.1f} "
            f"(exact; {int((ref != 0).sum())} of {ref.numel()} elements "
            f"present) ok")
    N, P, C, Cout = LEVEL_SHAPES[0]
    state, nbr, pos, *_ = level_inputs(N, P, C, Cout, seed=SEED)
    ms = {"plain": time_ms(lambda: risi18_aligned_t2_reference(state, nbr,
                                                               pos)),
          "k7": time_ms(lambda: risi18_aligned_t2(state, nbr, pos))}
    mb = N * P ** 3 * C * 4 / 1e6
    log(f"phase 9 aligned: N,P,C={(N, P, C)} float32, T {mb:.1f} MB; median "
        f"K7 {ms['k7']:.4f} ms ({mb / ms['k7']:.1f} GB/s written), plain "
        f"take-gather {ms['plain']:.4f} ms (CUDA events, 20 reps)")
    return max_err, ms


def phase_variants():
    import torch
    from graphflow_tpu_torch.models import (SMP_2D_ver6, SMP_2D_ver7,
                                            SMP_2D_ver7_classification)
    from graphflow_tpu_torch.models.smp2d import (contraction_level,
                                                  smp2d_forward)
    from graphflow_tpu_torch.ops.activations import leaky_relu
    from graphflow_tpu_torch.ops.contractions import (
        risi_contraction_50_matmul)
    from graphflow_tpu_torch.ops.risi_aligned import (
        risi18_aligned_t2, risi18_aligned_t2_reference)
    from graphflow_tpu_torch.utils.datasets import random_graph, toy_molecule

    nL = MODEL["nLevels"]
    requests = [[random_graph(MODEL["max_nVertices"], ER_P,
                              seed=400 + GRAPHS_PER_REQUEST * r + i)
                 for i in range(GRAPHS_PER_REQUEST)]
                for r in range(N_REQUESTS)]
    train_graphs = [random_graph(MODEL["max_nVertices"], ER_P, seed=500 + i)
                    for i in range(GRAPHS_PER_REQUEST)]
    mol = toy_molecule("C2H4")
    targets = np.random.default_rng(SEED).normal(
        size=GRAPHS_PER_REQUEST).tolist()
    labels = [float(x % 3) for x in range(GRAPHS_PER_REQUEST)]

    def plain(model, graphs):
        level_fn = functools.partial(contraction_level, model.cfg.contraction,
                                     risi18_aligned_t2_reference)
        with torch.no_grad():
            return smp2d_forward(model.params, model._stack(graphs),
                                 model.cfg, level_fn=level_fn)

    def train(model, graphs, tgts, learn):
        steps, seconds = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            steps.append(model.BatchLearn(graphs, tgts, MOMENTUM_LR))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        if learn:
            steps.append(model.Learn(mol, float(mol.nVertices), MOMENTUM_LR,
                                     nIterations=2))
        losses = [x for step in steps for x in step]
        if not np.isfinite(losses).all():
            raise AssertionError(f"non-finite loss in {losses}")
        return steps, seconds

    launches, max_err = 0, 0.0
    for ctor in (SMP_2D_ver6, SMP_2D_ver7):
        name = ctor.__name__
        model = ctor(**MODEL, seed=SEED, device="cuda")
        # Serving, counted: each request twice (prep uncached, then cached).
        risi18_aligned_t2.launches = 0
        preds, seconds = [], {"uncached": [], "cached": []}
        for kind in seconds:
            for graphs in requests:
                t0 = time.perf_counter()
                preds.append(model.Threaded_Predict(graphs))
                seconds[kind].append(time.perf_counter() - t0)
        pred_mol = model.Predict(mol)
        feat_mol = model.Feature(mol)
        served = risi18_aligned_t2.launches
        forwards = 2 * N_REQUESTS + 2
        if served != nL * forwards:
            raise AssertionError(f"{name}: {served} K7 launches, expected "
                                 f"{nL} levels x {forwards} forwards")
        err = 0.0
        for r, graphs in enumerate(requests * 2):
            if preds[r].shape != (GRAPHS_PER_REQUEST,):
                raise AssertionError(f"{name} request {r}: shape "
                                     f"{preds[r].shape}")
            err = max(err, check_close(f"{name} request {r}", preds[r],
                                       plain(model, graphs)[0]))
        ref_pred, ref_feat = plain(model, [mol])
        err = max(err, check_close(f"{name} Predict", [pred_mol], ref_pred),
                  check_close(f"{name} Feature", feat_mol, ref_feat[0]))
        # Training, counted: the take-gather, so K7 must not launch.
        steps, step_s = train(model, train_graphs, targets, learn=True)
        if risi18_aligned_t2.launches != served:
            raise AssertionError(f"{name}: training launched K7 "
                                 f"{risi18_aligned_t2.launches - served} "
                                 f"times")
        launches += served
        max_err = max(max_err, err)
        ver7 = model
        shown = np.concatenate(preds[:N_REQUESTS]).astype(float).round(5)
        shown = shown.tolist()
        log(f"phase 10 variants: {name} {N_REQUESTS} requests x "
            f"{GRAPHS_PER_REQUEST} graphs, seconds per request (host clock, "
            f"prep uncached) "
            + ", ".join(f"{x:.4f}" for x in seconds["uncached"])
            + "; prep cached "
            + ", ".join(f"{x:.4f}" for x in seconds["cached"])
            + f"; predictions {shown} "
            f"Predict(C2H4)={pred_mol:.6f}; K7 launches={served} (= {nL} "
            f"levels x {forwards} forwards); max abs err vs take-gather "
            f"{err:.3e} (bound {RTOL:g}*max(1,max|plain|)) ok")
        log(f"phase 10 variants: {name} Momentum lr {MOMENTUM_LR:g} "
            f"BatchLearn (loss_before, loss_after) "
            + ", ".join(f"({a:.6g}, {b:.6g})" for a, b in steps[:-1])
            + f"; Learn(C2H4, nIterations=2) ({steps[-1][0]:.6g}, "
            f"{steps[-1][1]:.6g}); all finite; K7 launches in training 0; "
            f"seconds per step (host clock, synced) prep uncached "
            f"{step_s[0]:.4f}, prep cached "
            + ", ".join(f"{x:.4f}" for x in step_s[1:]))

    # The classification head: one request, then training on labels.
    model = SMP_2D_ver7_classification(**MODEL, nClasses=3, seed=SEED,
                                       device="cuda")
    risi18_aligned_t2.launches = 0
    scores = model.Threaded_Predict(requests[0])
    served = risi18_aligned_t2.launches
    if scores.shape != (GRAPHS_PER_REQUEST, 3) or served != nL:
        raise AssertionError(f"classification: scores {scores.shape}, "
                             f"{served} K7 launches (expected {nL})")
    err = check_close("classification scores", scores,
                      plain(model, requests[0])[0])
    steps, step_s = train(model, train_graphs, labels, learn=False)
    if risi18_aligned_t2.launches != served:
        raise AssertionError("classification training launched K7")
    launches += served
    max_err = max(max_err, err)
    log(f"phase 10 variants: SMP_2D_ver7_classification scores "
        f"{scores.astype(float).round(5).tolist()} (K7 launches={served}, "
        f"max abs err "
        f"{err:.3e}); log-loss BatchLearn on labels {labels} "
        + ", ".join(f"({a:.6g}, {b:.6g})" for a, b in steps)
        + "; all finite; seconds per step "
        + ", ".join(f"{x:.4f}" for x in step_s))

    # One ver7 serving level at the batch's shape, split by CUDA events.
    N, P, C, _ = LEVEL_SHAPES[0]
    state, nbr, pos, radj, _, _ = level_inputs(N, P, C, C, seed=SEED)
    K, b = (ver7.params["levels"][1][k].detach() for k in ("K", "b"))
    smask = torch.ones((N, P, P, 1), device="cuda")
    T = risi18_aligned_t2(state, nbr, pos)
    Z = risi_contraction_50_matmul(T, radj, K)
    level = functools.partial(contraction_level, 50, risi18_aligned_t2)
    ms = {"k7": time_ms(lambda: risi18_aligned_t2(state, nbr, pos)),
          "bank": time_ms(lambda: risi_contraction_50_matmul(T, radj, K)),
          "rest": time_ms(lambda: leaky_relu(Z.reshape(N, P * P, C) + b)
                          .reshape(N, P, P, C) * smask),
          "level": time_ms(lambda: level(state, nbr, pos, radj, K, b))}
    log(f"phase 10 variants: one ver7 serving level at N,P,C={(N, P, C)}: "
        f"K7 {ms['k7']:.4f} ms, 50-case bank {ms['bank']:.4f} ms, bias + "
        f"LeakyReLU + smask {ms['rest']:.4f} ms; whole level "
        f"{ms['level']:.4f} ms (CUDA events, 20 reps)")
    return launches, max_err


def main() -> None:
    name = phase_device()
    import_port()
    import torch

    phase_build()
    level_err, kernel_ms, plain_ms = phase_kernel()
    serve_launches, slice_err = phase_slice()
    bwd_errs, bwd_ms = phase_backward()
    train_launches, train_err = phase_train()
    bank_errs, bank_ms = phase_bank()
    k4_launches, k5_launches, bf16_serve_err, bf16_grad_err = phase_bf16()
    aligned_err, aligned_ms = phase_aligned()
    k7_launches, variants_err = phase_variants()
    torch.cuda.synchronize()
    bwd_source = "graphflow_tpu_torch/ops/csrc/risi18_level_bwd.cu"
    bwd_replaces = "graphflow_tpu/ops/risi_fused_pallas.py:767"
    bank_bwd_source = "graphflow_tpu_torch/ops/csrc/risi18_bank_bwd.cu"
    bank_bwd_replaces = "graphflow_tpu/ops/risi_pallas.py:330"
    print(json.dumps({"kernels": [{
        "name": "risi18_level_kernel",
        "route": "cuda",
        "source": "graphflow_tpu_torch/ops/csrc/risi18_level.cu",
        "replaces": "graphflow_tpu/ops/risi_fused_pallas.py:526",
        "launches": serve_launches + train_launches[0],
        "max_abs_err": max(level_err, slice_err),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "risi18_level_bwd_kernel",
        "route": "cuda",
        "source": bwd_source,
        "replaces": bwd_replaces,
        "launches": train_launches[1],
        "max_abs_err": max(bwd_errs["dstate"], train_err),
        "ms": bwd_ms["main"],
        "plain_ms": bwd_ms["plain"],
    }, {
        "name": "sum_partial_rows (risi18_level_bwd)",
        "route": "cuda",
        "source": bwd_source,
        "replaces": bwd_replaces,
        "launches": train_launches[2],
        "max_abs_err": max(bwd_errs["dK"], bwd_errs["db"]),
        "ms": bwd_ms["reduce"],
        "plain_ms": bwd_ms["plain_reduce"],
    }, {
        "name": "risi18_bank_kernel",
        "route": "cuda",
        "source": "graphflow_tpu_torch/ops/csrc/risi18_bank.cu",
        "replaces": "graphflow_tpu/ops/risi_pallas.py:142",
        "launches": k4_launches,
        "max_abs_err": max(bank_errs["Z"], bf16_serve_err),
        "ms": bank_ms["k4"],
        "plain_ms": bank_ms["plain"],
    }, {
        "name": "risi18_bank_bwd_kernel",
        "route": "cuda",
        "source": bank_bwd_source,
        "replaces": bank_bwd_replaces,
        "launches": k5_launches[0],
        "max_abs_err": max(bank_errs["dT"], bf16_grad_err),
        "ms": bank_ms["main"],
        "plain_ms": bank_ms["plain_bwd"],
    }, {
        "name": "sum_partial_rows (risi18_bank_bwd)",
        "route": "cuda",
        "source": bank_bwd_source,
        "replaces": bank_bwd_replaces,
        "launches": k5_launches[1],
        "max_abs_err": bank_errs["dK"],
        "ms": bank_ms["reduce"],
        "plain_ms": bank_ms["plain_reduce"],
    }, {
        "name": "risi18_aligned_t2_kernel",
        "route": "cuda",
        "source": "graphflow_tpu_torch/ops/csrc/risi_aligned_t2.cu",
        "replaces": "graphflow_tpu/ops/risi_fused_pallas.py:1059",
        "launches": k7_launches,
        "max_abs_err": aligned_err,
        "ms": aligned_ms["k7"],
        "plain_ms": aligned_ms["plain"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
