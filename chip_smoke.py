#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device   the card (torch's name, nvidia-smi's name and power limit);
  2. build    nvcc builds the six kernel libraries from ops/csrc/ (the
              level forward K1 and backward K2, the bank forward K4 and
              backward K5, the aligned tensor K7, the bank's ablation
              variants K6), in parallel (seconds, ptxas);
  3. kernel   K1 against its plain PyTorch version on the card at three
              level shapes (P = 16, 10, 4) and at the four C != Cout shapes
              of a halving channel schedule, in float32 and in bfloat16
              (there also against the float32 kernel on the rounded inputs),
              inputs from a NumPy seed; then both versions' median
              milliseconds at the production shape and at two scheduled
              ones, per dtype;
  4. slice    SMP_omega at full width (V=64, P=16, C=32, two levels) with
              seeded random weights serves 3 requests of 4 random graphs,
              one Predict and one Feature; K1's launch count must equal
              nLevels x forward calls, and every output must match the
              same model run through the plain level on the card;
  5. backward K2 against the plain backward (autograd of the plain level)
              at the same seven shapes in float32 and bfloat16 (there also
              against the float32 kernels on the rounded inputs): dstate, dK
              and db; then the median milliseconds of each of K2's two
              kernels, of both together and of the plain backward at the
              production shape, per dtype;
  6. train    the same model trains: 3 BatchLearn steps on a batch of 4
              random graphs and one Learn(nIterations=2) on a molecule;
              the loss and every gradient at the first step must match
              the plain level's, every loss must be finite, and K1 and K2
              must launch once per level per forward and per backward.
              Then the seconds per step (prep uncached and cached) and one
              step's split into host batching, forward, backward and Adam;
  7. bank     K4 and K5 against the plain bank and its backward on the
              card at ten shapes, in float32 and bfloat16, on slots made
              by the take-gather: Z, dT and dK; then the median
              milliseconds of K4, the plain bank, K5 (both kernels and each
              alone) and the plain backward at the production shape, per
              dtype, with the bounds of the factored functions;
  8. bf16     the same model in bfloat16, whose levels run the fused level
              as in float32: 3 requests of 4 random graphs served twice
              (prep uncached, then cached), one Predict and one Feature, 3
              BatchLearn steps and one Learn(nIterations=2); outputs, the
              first step's loss and every gradient must match the model
              run through the plain level on the card, every loss must be
              finite, K1 and K2 must launch once per level per forward
              and per backward, and K4 and K5 not at all.  Between serving
              and training, one request and one forward with gradients go
              through level_fn=risi18_bank_level (the bank over a
              materialised T): K4 and K5 must launch there and match the
              plain bank route.  Then the seconds per request and per step
              and the peak device memory of a step.  Last, the same model
              with its levels on the bank route, in float32 and bfloat16,
              serves one request and takes 3 BatchLearn steps: K4 and K5
              launch once per level per forward and backward, K1 and K2
              not at all, and the request and the first step's loss match
              the plain bank route;
  9. aligned  K7, the aligned neighbour tensor, against its plain version
              (the take-gather) on the card at eight shapes in float32 and
              bfloat16, channel counts that allow 16-byte accesses and ones
              that do not: the match must be exact.  Then both versions'
              median milliseconds at the production shape, with T's size;
 10. variants SMP_2D_ver6 and ver7 at the same width serve 3 requests of 4
              random graphs twice (prep uncached, then cached), one
              Predict and one Feature through K7 (its
              launch count must equal nLevels x forward calls, every output
              must match the same model through the take-gather), then take
              3 BatchLearn steps and one Learn(nIterations=2) with Momentum
              on the take-gather (finite losses, K7's count unchanged);
              the same two models in bfloat16 serve the same requests
              through K7 and take 2 BatchLearn steps (bfloat16 parameters,
              a step's peak memory); SMP_2D_ver7_classification serves one request ([4, 3] scores)
              and takes 3 BatchLearn steps on integer labels.  Then the
              seconds per request and per step, and one ver7 serving level
              split into K7, the 50-case bank and the rest;
 11. ablate   K6, the five ablation variants of the bank kernel, against
              their plain versions on the card at phase 7's ten shapes in
              float32 and bfloat16, `full` against K4 bit for bit; then
              the tool (graphflow_tpu_torch.tools.ablate_bank) prints the
              five times and the attribution at the production shape in
              both dtypes, with K4 timed in the same rounds;
 12. physics  SMP_omega_physics at full width (V=64, P=16, channels 32, 16,
              8, Coulomb adjacency with negative entries, raw features)
              serves 3 requests of 4 random graphs twice (prep uncached,
              then cached), one Predict and one Feature through K1 at
              C != Cout, then takes 3 BatchLearn steps and one
              Learn(nIterations=2) through K2; outputs, the first step's
              loss and every gradient must match the same model through
              the plain level, and K1 and K2 must launch once per level per
              forward and backward.  SMP_gamma_physics serves and takes a
              step (against the same model on the CPU); SMP_beta with an
              uncapped field (V = P = 16) serves and takes a step through
              K1 and K2; one smp2d_level_features call with a drawn
              case_mask runs the kernels on the scaled K, against the plain
              masked level.
Each kernel's bound is the larger of its bytes (every input read once,
every output written once) over 3.35 TB/s and its operations over the
card's peak for the inputs' type (67 TFLOP/s float32, 989 TFLOP/s
bfloat16), counted from the shapes of this run's inputs.
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
sys.path.insert(0, str(ROOT))
# The full-width model, the batch and the spin-timed timer, shared with the
# tools under graphflow_tpu_torch/tools/.
from graphflow_tpu_torch.tools.measure import (  # noqa: E402
    ADAM_LR as TRAIN_LR, ER_P, FULL_WIDTH as MODEL,
    GRAPHS as GRAPHS_PER_REQUEST, MOMENTUM_LR, bank_route_model, same_signs,
    time_ms)

SEED = 0
# Kernel vs plain: the bound of tests/test_fused_kernel.py:49-50 (summation
# order on the card differs from the plain version's).
RTOL = 1e-4
# bfloat16: both sides sum in float32 from the same inputs and round to
# bfloat16 (2^-8 relative) where they store; 1e-2 of the scale.
RTOL16 = 1e-2
LEVEL_SHAPES = [(256, 16, 32, 32), (64, 10, 20, 20), (32, 4, 8, 8)]
BANK_SHAPES = LEVEL_SHAPES + [(12, 12, 40, 16)]
# The levels of a halving channel schedule (the physics towers): C != Cout,
# down to one channel.
SCHEDULE_SHAPES = [(256, 16, 32, 16), (256, 16, 16, 8), (64, 10, 2, 1),
                   (32, 4, 1, 1)]
# More vertices than a backward kernel has blocks or vertex groups (132 for
# the level, 264 for the bank), so that every block walks several vertices
# and carries its sums of dK and db from one to the next; checked for error,
# not timed.
MANY_VERTEX_SHAPES = [(600, 16, 32, 32), (600, 4, 8, 4)]
N_REQUESTS, TRAIN_STEPS = 3, 3
KERNEL_LIBS = ("risi18_level", "risi18_level_bwd", "risi18_bank",
               "risi18_bank_bwd", "risi_aligned_t2", "risi18_bank_ablate")
PHYSICS = dict(max_nVertices=64, max_receptive_field=16, nLevels=2,
               nChanels=32, nFeatures=4, use_coulomb=True)
BETA = dict(max_nVertices=16, nLevels=2, nChanels=32, nFeatures=4, nDepth=5)
# Published peaks of one H100 SXM: device memory bytes/s, and dense FLOP/s
# for float32 outside the tensor cores and bfloat16 inside them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: float, ops: float, dtype: str = "float32"):
    """(the least milliseconds the card could take, "bytes" or
    "operations"): the larger of bytes over the memory rate and operations
    over the peak rate of ``dtype``."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def level_ops(N, P, C, Cout, elements):
    """Floating-point operations of the fused level, as the function factors
    (ops/risi_level.py:risi18_level_factored_reference): nine [P*P, C] maps
    times a slab of K each, the adjacency applied once to W (2 * P per row
    and output), the vector and scalar cases (four slabs per row x and four
    per vertex), their broadcast with the bias and LeakyReLU (six per
    output), and the shared reductions (about six per present element of
    the gathered slots, ``elements``, and channel)."""
    rows = N * P * P
    return (rows * 9 * C * Cout * 2 + rows * P * Cout * 2
            + (N * P + N) * 4 * C * Cout * 2 + rows * Cout * 6
            + 6 * elements * C)


def level_backward_ops(N, P, C, Cout, elements):
    """The level's adjoint as it factors
    (risi18_level_backward_factored_reference): dK's ten map slabs against
    G or G.Ap and the maps' cotangents from K's ten slabs (a product of
    P*P x C x Cout each), G.Ap (2 * P per row and output), G.R, GA, db and
    LeakyReLU' (eight per output), the vector and scalar cases both ways,
    the forward's reductions again (six per present element and channel)
    and dT's assembly from six maps (twelve)."""
    rows = N * P * P
    return (2 * rows * 10 * C * Cout * 2 + rows * P * Cout * 2
            + rows * Cout * 8 + 2 * (N * P + N) * 4 * C * Cout * 2
            + (6 + 12) * elements * C)


def bank_factored_ops(N, P, C, Cout):
    """Floating-point operations of the bank as K4 factors it
    (ops/risi_bank.py:risi18_bank_factored_reference): ``level_ops`` with
    every element of T present (N * P^3) and no bias or LeakyReLU, so the
    broadcast of U and s costs four per output."""
    rows = N * P * P
    return (rows * 9 * C * Cout * 2 + rows * P * Cout * 2
            + (N * P + N) * 4 * C * Cout * 2 + rows * Cout * 4
            + 6 * rows * P * C)


def bank_backward_factored_ops(N, P, C, Cout):
    """The bank's adjoint as K5 factors it
    (risi18_bank_backward_factored_reference): ``level_backward_ops`` with
    every element of T present and G the cotangent itself, so G.R and GA
    cost four per output (no db, no LeakyReLU')."""
    rows = N * P * P
    return (2 * rows * 10 * C * Cout * 2 + rows * P * Cout * 2
            + rows * Cout * 4 + 2 * (N * P + N) * 4 * C * Cout * 2
            + (6 + 12) * rows * P * C)


def bank_variant_ops(mode, N, P, C, Cout):
    """Operations of K6's variant ``mode`` as K4's block computes it:
    ``full`` and ``novpu`` are the factored bank (bank_factored_ops);
    ``nogroupd`` keeps two map slabs, the vector and scalar cases, and two
    sums per element of T (T_ab, T_bc); ``reduce`` two products, the same
    two sums and three additions per map entry; ``dma`` none."""
    rows, elements = N * P * P, N * P ** 3
    return {"full": bank_factored_ops(N, P, C, Cout),
            "novpu": bank_factored_ops(N, P, C, Cout),
            "nogroupd": (rows * 2 * C * Cout * 2
                         + (N * P + N) * 4 * C * Cout * 2 + rows * Cout * 4
                         + 2 * elements * C),
            "reduce": rows * 2 * C * Cout * 2 + 3 * rows * C
                      + 2 * elements * C,
            "dma": 0}[mode]


def present_elements(nbr, pos) -> int:
    """Elements of the gathered T [N,P,P,P] that are present: slot a of
    vertex v has a neighbour, and positions b and c are set."""
    N, P = nbr.shape
    has_nbr = (nbr >= 0) & (nbr < N)
    set_pos = ((pos >= 0) & (pos < P)).sum(-1)
    return int((has_nbr * set_pos * set_pos).sum())


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


def level_inputs(N, P, C, Cout, seed, dtype=None):
    """One level's inputs on the card from a NumPy seed: state, K and b in
    ``dtype`` (float32 when None; bfloat16 rounds the float32 values), radj
    float32, nbr and pos int32."""
    import torch
    from graphflow_tpu_torch.utils.datasets import random_level_case

    d = random_level_case(N, P, C, Cout, seed=seed, empty_vertex=N // 2)
    f32 = {k: torch.as_tensor(d[k], dtype=torch.float32, device="cuda")
           for k in ("state", "radj", "K", "b")}
    i32 = {k: torch.as_tensor(d[k], dtype=torch.int32, device="cuda")
           for k in ("nbr", "pos")}
    dtype = dtype or torch.float32
    return (f32["state"].to(dtype), i32["nbr"], i32["pos"], f32["radj"],
            f32["K"].to(dtype), f32["b"].to(dtype))


def as_float32(args):
    """The same level inputs with every floating tensor in float32."""
    return tuple(t.float() if t.is_floating_point() else t for t in args)


def dtype_name(dtype) -> str:
    return str(dtype)[6:]


def phase_kernel():
    import torch
    from graphflow_tpu_torch.ops.risi_level import (
        risi18_level, risi18_level_reference)

    errs, ms = {}, {}
    for dtype, rtol in ((torch.float32, RTOL), (torch.bfloat16, RTOL16)):
        name = dtype_name(dtype)
        errs[name] = 0.0
        for i, (N, P, C, Cout) in enumerate(LEVEL_SHAPES + SCHEDULE_SHAPES
                                            + MANY_VERTEX_SHAPES):
            args = level_inputs(N, P, C, Cout, seed=SEED + i, dtype=dtype)
            got = risi18_level(*args)
            torch.cuda.synchronize()
            ref = risi18_level_reference(*args)
            if got.dtype != dtype or ref.dtype != dtype:
                raise AssertionError(f"level {name}: kernel {got.dtype}, "
                                     f"plain {ref.dtype}")
            what = f"level {name} N={N} P={P} C={C} Cout={Cout}"
            err = check_close(what, got, ref, rtol)
            errs[name] = max(errs[name], err)
            second = ""
            if dtype == torch.bfloat16:
                # A second yardstick: the float32 kernel on the rounded
                # inputs, which differs by the one rounding of the output.
                err32 = check_close(what + " vs the float32 kernel", got,
                                    risi18_level(*as_float32(args)), rtol)
                second = (f"; vs the float32 kernel on the rounded inputs "
                          f"{err32:.3e}")
            log(f"phase 3 kernel: {name} N={N} P={P} C={C} Cout={Cout} "
                f"max_abs_err={err:.3e} (max|plain|="
                f"{float(ref.abs().max()):.3f}, bound "
                f"{rtol:g}*max(1,max|plain|)){second} ok")
        N, P, C, Cout = LEVEL_SHAPES[0]
        args = level_inputs(N, P, C, Cout, seed=SEED, dtype=dtype)
        out = risi18_level(*args)
        ms[name] = {
            "plain": time_ms(lambda: risi18_level_reference(*args)),
            "kernel": time_ms(lambda: risi18_level(*args)),
            "bound": bound_ms(nbytes(*args, out), level_ops(
                N, P, C, Cout, present_elements(args[1], args[2])), name)}
        log(f"phase 3 kernel: {name} N,P,C,Cout={LEVEL_SHAPES[0]} median "
            f"kernel {ms[name]['kernel']:.4f} ms, plain "
            f"{ms[name]['plain']:.4f} ms (CUDA events, 20 reps); bound "
            f"{ms[name]['bound'][0]:.4f} ms by {ms[name]['bound'][1]}")
        for i, shape in enumerate(SCHEDULE_SHAPES[:2]):
            sargs = level_inputs(*shape, seed=SEED + len(LEVEL_SHAPES) + i,
                                 dtype=dtype)
            log(f"phase 3 kernel: {name} N,P,C,Cout={shape} median kernel "
                f"{time_ms(lambda: risi18_level(*sargs)):.4f} ms, plain "
                f"{time_ms(lambda: risi18_level_reference(*sargs)):.4f} ms")
    return errs, ms


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
        _backward_finish_kernel_bf16, _backward_main_kernel,
        _backward_reduce_kernel, risi18_level, risi18_level_backward,
        risi18_level_backward_reference, risi18_level_reference)

    def inputs(N, P, C, Cout, seed, dtype):
        g = np.random.default_rng(seed).normal(size=(N, P * P, Cout))
        return (level_inputs(N, P, C, Cout, seed, dtype),
                torch.as_tensor(g, dtype=torch.float32,
                                device="cuda").to(dtype))

    errs, ms = {}, {}
    for dtype, rtol in ((torch.float32, RTOL), (torch.bfloat16, RTOL16)):
        name = dtype_name(dtype)
        errs[name] = {"dstate": 0.0, "dK": 0.0, "db": 0.0}
        for i, (N, P, C, Cout) in enumerate(LEVEL_SHAPES + SCHEDULE_SHAPES
                                            + MANY_VERTEX_SHAPES):
            args, g = inputs(N, P, C, Cout, SEED + i, dtype)
            out = same_signs(risi18_level(*args),
                             risi18_level_reference(*args))
            got = risi18_level_backward(*args, out, g)
            torch.cuda.synchronize()
            ref = risi18_level_backward_reference(*args, g)
            second = None
            if dtype == torch.bfloat16:
                # A second yardstick: the float32 kernels on the rounded
                # inputs and the float32 view of the bfloat16 output.
                second = risi18_level_backward(*as_float32(args),
                                               out.float(), g.float())
            line = []
            for j, (key, x, r) in enumerate(zip(errs[name], got, ref)):
                if x.dtype != dtype or r.dtype != dtype:
                    raise AssertionError(f"backward {key} {name}: kernel "
                                         f"{x.dtype}, plain {r.dtype}")
                what = (f"backward {key} {name} N={N} P={P} C={C} "
                        f"Cout={Cout}")
                err = check_close(what, x, r, rtol)
                errs[name][key] = max(errs[name][key], err)
                text = f"{key} {err:.3e} (max|plain|={float(r.abs().max()):.3f}"
                if second is not None:
                    err32 = check_close(what + " vs the float32 kernels", x,
                                        second[j], rtol)
                    text += f"; vs float32 kernels {err32:.3e}"
                line.append(text + ")")
            log(f"phase 5 backward: {name} N={N} P={P} C={C} Cout={Cout} "
                f"max_abs_err " + ", ".join(line)
                + f"; bound {rtol:g}*max(1,max|plain|) ok")

        N, P, C, Cout = LEVEL_SHAPES[0]
        args, g = inputs(N, P, C, Cout, SEED, dtype)
        state, nbr, pos, radj, K, b = args
        out = risi18_level(*args)
        leaves = [t.detach().requires_grad_() for t in (state, K, b)]
        plain_out = risi18_level_reference(leaves[0], nbr, pos, radj,
                                           leaves[1], leaves[2])
        dstate32, partial = _backward_main_kernel(state, nbr, pos, radj, K, g,
                                                  out, 0.01)
        if dtype == torch.bfloat16:
            # Kernel 2 also rounds kernel 1's float32 dstate; its plain
            # version is the column sum and three casts.
            def kernel2():
                return _backward_finish_kernel_bf16(partial, dstate32, C,
                                                    Cout)

            def plain2():
                return (dstate32.to(dtype), partial.sum(0).to(dtype))
        else:
            def kernel2():
                return _backward_reduce_kernel(partial, C, Cout)

            def plain2():
                return partial.sum(0)
        m = ms[name] = {
            "plain": time_ms(lambda: torch.autograd.grad(
                plain_out, leaves, g, retain_graph=True)),
            "k2": time_ms(lambda: risi18_level_backward(*args, out, g)),
            "main": time_ms(lambda: _backward_main_kernel(
                state, nbr, pos, radj, K, g, out, 0.01)),
            "reduce": time_ms(kernel2),
            "plain_reduce": time_ms(plain2),
        }
        log(f"phase 5 backward: {name} N,P,C,Cout={LEVEL_SHAPES[0]} median "
            f"K2 (both kernels, dstate zero fill included) {m['k2']:.4f} ms, "
            f"plain backward {m['plain']:.4f} ms; kernel 1 {m['main']:.4f} "
            f"ms, kernel 2 {m['reduce']:.4f} ms ({partial.shape[0]} partial "
            f"rows; plain sum{' and casts' if second is not None else ''} "
            f"{m['plain_reduce']:.4f} ms) (CUDA events, 20 reps)")
        dstate, dK, db = risi18_level_backward(*args, out, g)
        # The function's own bytes: kernel 1's float32 dstate buffer and
        # its partial rows are scratch between the two kernels, not counted.
        m["bound"] = bound_ms(
            nbytes(*args[:5], g, out, dstate, dK, db),
            level_backward_ops(N, P, C, Cout, present_elements(nbr, pos)),
            name)
        moved = nbytes(partial, dK, db)
        if dtype == torch.bfloat16:
            moved += nbytes(dstate32, dstate)
        m["reduce_bound"] = bound_ms(moved, partial.numel())
        log(f"phase 5 backward: {name} bounds: kernel 1 {m['bound'][0]:.4f} "
            f"ms by {m['bound'][1]}, kernel 2 {m['reduce_bound'][0]:.4f} ms "
            f"by {m['reduce_bound'][1]}; scratch between them "
            f"{nbytes(dstate32, partial) / 1e6:.1f} MB (float32 dstate and "
            f"partial rows), in no bound of kernel 1")
        for i, shape in enumerate(SCHEDULE_SHAPES[:2]):
            sargs, sg = inputs(*shape, SEED + len(LEVEL_SHAPES) + i, dtype)
            sout = risi18_level(*sargs)
            main_ms = time_ms(lambda: _backward_main_kernel(
                *sargs[:5], sg, sout, 0.01))
            both_ms = time_ms(lambda: risi18_level_backward(*sargs, sout, sg))
            log(f"phase 5 backward: {name} N,P,C,Cout={shape} median K2 "
                f"kernel 1 {main_ms:.4f} ms, both kernels {both_ms:.4f} ms")
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
        for i, (N, P, C, Cout) in enumerate(BANK_SHAPES + SCHEDULE_SHAPES
                                            + MANY_VERTEX_SHAPES):
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
    ms = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        T, A, K, g = bank_inputs(N, P, C, Cout, SEED, dtype)
        leaves = [x.detach().requires_grad_() for x in (T, K)]
        plain_out = risi18_bank_reference(leaves[0], A, leaves[1])
        _, partial = _backward_main_kernel(T, A, K, g)
        m = ms[name] = {
            "k4": time_ms(lambda: risi18_bank(T, A, K)),
            "plain": time_ms(lambda: risi18_bank_reference(T, A, K)),
            "k5": time_ms(lambda: risi18_bank_backward(T, A, K, g)),
            "main": time_ms(lambda: _backward_main_kernel(T, A, K, g)),
            "reduce": time_ms(lambda: _backward_reduce_kernel(partial, C,
                                                              Cout)),
            "plain_reduce": time_ms(lambda: partial.sum(0)),
            "plain_bwd": time_ms(lambda: torch.autograd.grad(
                plain_out, leaves, g, retain_graph=True)),
        }
        log(f"phase 7 bank: N,P,C,Cout={BANK_SHAPES[0]} {name}, T "
            f"{T.numel() * T.element_size() / 1e6:.1f} MB; median K4 "
            f"{m['k4']:.4f} ms, plain bank {m['plain']:.4f} ms; K5 (both "
            f"kernels) {m['k5']:.4f} ms, kernel 1 {m['main']:.4f} ms, kernel "
            f"2 {m['reduce']:.4f} ms ({partial.shape[0]} partial rows; plain "
            f"sum {m['plain_reduce']:.4f} ms), plain backward "
            f"{m['plain_bwd']:.4f} ms (CUDA events, 20 reps)")
        Z = risi18_bank(T, A, K)
        dT, dK = risi18_bank_backward(T, A, K, g)
        # The factored functions' operations (bank_factored_ops); as for K2,
        # the partial rows are scratch and dK is the function's output.
        m["bound"] = bound_ms(nbytes(T, A, K, Z),
                              bank_factored_ops(N, P, C, Cout), name)
        m["bwd_bound"] = bound_ms(nbytes(T, A, K, g, dT, dK),
                                  bank_backward_factored_ops(N, P, C, Cout),
                                  name)
        m["reduce_bound"] = bound_ms(nbytes(partial) + dK.numel() * 4,
                                     partial.numel())
        log(f"phase 7 bank: bounds ({name}): "
            + ", ".join(f"{k} {m[v][0]:.4f} ms by {m[v][1]}" for k, v in (
                ("K4", "bound"), ("K5 kernel 1", "bwd_bound"),
                ("K5 kernel 2", "reduce_bound"))))
    return errs, ms


def phase_bf16():
    import torch
    from graphflow_tpu_torch.models import SMP2D, SMP2DConfig
    from graphflow_tpu_torch.models.smp2d import (
        fused_level, risi18_bank_level, risi18_bank_level_reference,
        smp2d_forward)
    from graphflow_tpu_torch.ops.losses import squared_loss
    from graphflow_tpu_torch.ops.risi_bank import (risi18_bank,
                                                   risi18_bank_backward)
    from graphflow_tpu_torch.ops.risi_level import (
        risi18_level, risi18_level_backward, risi18_level_reference)
    from graphflow_tpu_torch.utils.datasets import random_graph, toy_molecule

    model = SMP2D(SMP2DConfig(**MODEL, dtype="bfloat16"), seed=SEED,
                  device="cuda")
    nL = MODEL["nLevels"]
    requests = [[random_graph(MODEL["max_nVertices"], ER_P,
                              seed=200 + GRAPHS_PER_REQUEST * r + i)
                 for i in range(GRAPHS_PER_REQUEST)]
                for r in range(N_REQUESTS)]
    mol = toy_molecule("C2H4")

    def counts():
        return {"K1": risi18_level.launches,
                "K2 kernel 1": risi18_level_backward.launches,
                "K2 kernel 2": risi18_level_backward.reduce_launches,
                "K4": risi18_bank.launches,
                "K5 kernel 1": risi18_bank_backward.launches,
                "K5 kernel 2": risi18_bank_backward.reduce_launches}

    def reset():
        risi18_level.launches = 0
        risi18_level_backward.launches = 0
        risi18_level_backward.reduce_launches = 0
        risi18_bank.launches = 0
        risi18_bank_backward.launches = 0
        risi18_bank_backward.reduce_launches = 0

    def expect(what, got, **want):
        want = {**dict.fromkeys(got, 0), **want}
        if got != want:
            raise AssertionError(f"bf16 {what}: launches {got}, expected "
                                 f"{want}")

    def plain(graphs, level_fn=risi18_level_reference):
        return smp2d_forward(model.params, model._stack(graphs), model.cfg,
                             level_fn=level_fn)

    # Serving, counted: each request twice (prep uncached, then cached).
    reset()
    preds, seconds = [], {"uncached": [], "cached": []}
    for kind in seconds:
        for graphs in requests:
            t0 = time.perf_counter()
            preds.append(model.Threaded_Predict(graphs))
            seconds[kind].append(time.perf_counter() - t0)
    pred_mol = model.Predict(mol)
    feat_mol = model.Feature(mol)
    served = counts()
    forwards = 2 * N_REQUESTS + 2
    expect("serving", served, K1=nL * forwards)
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

    # The first step's loss and gradients, K1/K2 against the plain level.
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

    def grads_close(what, kernel_fn, plain_fn):
        k_loss, k_grads = loss_and_grads(kernel_fn)
        p_loss, p_grads = loss_and_grads(plain_fn)
        err = check_close(f"bf16 {what} train loss", k_loss, p_loss, RTOL16)
        for path, x, r in zip(params, k_grads, p_grads):
            if x.dtype != torch.bfloat16:
                raise AssertionError(f"gradient {path} has dtype {x.dtype}")
            err = max(err, check_close(f"bf16 {what} gradient {path}", x, r,
                                       RTOL16))
        return k_loss, p_loss, err

    k_loss, p_loss, grad_err = grads_close("fused", fused_level,
                                           risi18_level_reference)

    # The bank route over a materialised T, a level_fn= choice, on the same
    # weights: one request and one forward with its gradients, K4/K5
    # against the plain bank, and the request against the fused route's.
    reset()
    with torch.no_grad():
        bank_pred = plain(requests[0], risi18_bank_level)[0]
        bank_err = check_close(
            "bf16 bank request", bank_pred,
            plain(requests[0], risi18_bank_level_reference)[0], RTOL16)
        route_err = check_close("bf16 bank route vs fused route", bank_pred,
                                preds[0], 3 * RTOL16)
    b_loss, bp_loss, err = grads_close("bank", risi18_bank_level,
                                       risi18_bank_level_reference)
    bank_err = max(bank_err, err)
    banked = counts()
    expect("bank route", banked, **{"K4": 2 * nL, "K5 kernel 1": nL,
                                    "K5 kernel 2": nL})

    # The bank route as a model of its own, in both dtypes, on the same
    # weights: one request and TRAIN_STEPS BatchLearn steps through
    # level_fn=risi18_bank_level, K4 and K5 counted, K1 and K2 not at all;
    # the request and the first step's loss against the plain bank route.
    route = {}
    for dname, rtol in (("float32", RTOL), ("bfloat16", RTOL16)):
        bank_model = bank_route_model(seed=SEED, device="cuda", **MODEL,
                                      dtype=dname)
        graphs = er_batch()
        bbatch = bank_model._stack(graphs, targets)
        with torch.no_grad():
            ref_pred = smp2d_forward(
                bank_model.params, bank_model._stack(requests[0]),
                bank_model.cfg, level_fn=risi18_bank_level_reference)[0]
            ref_loss = squared_loss(smp2d_forward(
                bank_model.params, bbatch, bank_model.cfg,
                level_fn=risi18_bank_level_reference,
                training=True)[0], bbatch["target"])
        reset()
        t0 = time.perf_counter()
        route_pred = bank_model.Threaded_Predict(requests[0])
        req_s = time.perf_counter() - t0
        r_steps, r_step_s = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            r_steps.append(bank_model.BatchLearn(graphs, targets, TRAIN_LR))
            torch.cuda.synchronize()
            r_step_s.append(time.perf_counter() - t0)
        got = counts()
        expect(f"bank route {dname}", got,
               **{"K4": nL * (1 + 2 * TRAIN_STEPS),
                  "K5 kernel 1": nL * TRAIN_STEPS,
                  "K5 kernel 2": nL * TRAIN_STEPS})
        r_losses = [x for step in r_steps for x in step]
        if not np.isfinite(r_losses).all():
            raise AssertionError(f"bank route {dname}: non-finite loss in "
                                 f"{r_losses}")
        r_err = max(check_close(f"bank route {dname} request", route_pred,
                                ref_pred, rtol),
                    check_close(f"bank route {dname} first-step loss",
                                r_steps[0][0], ref_loss, rtol))
        route[dname] = dict(counts=got, err=r_err, steps=r_steps,
                            req_s=req_s, step_s=r_step_s)
        del bank_model

    # Training, counted.
    graphs = er_batch()
    reset()
    steps, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        steps.append(model.BatchLearn(graphs, targets, TRAIN_LR))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    learn = model.Learn(mol, float(mol.nVertices), TRAIN_LR, nIterations=2)
    trained = counts()
    fwd, bwd = 2 * TRAIN_STEPS + 3, TRAIN_STEPS + 3
    expect("training", trained, **{"K1": nL * fwd, "K2 kernel 1": nL * bwd,
                                   "K2 kernel 2": nL * bwd})
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
        f"Predict(C2H4)={pred_mol:.4f}; K1 launches={served['K1']} (= {nL}"
        f" levels x {forwards} forwards), K4=K5=0; max abs err vs plain level "
        f"{serve_err:.3e} (bound {RTOL16:g}*max(1,max|plain|)) ok")
    log(f"phase 8 bf16: first-step loss {float(k_loss):.4f} vs plain level "
        f"{float(p_loss):.4f}; {len(params)} bfloat16 gradients; max abs err "
        f"{grad_err:.3e} (bound {RTOL16:g}*max(1,max|plain|)) ok")
    log(f"phase 8 bf16: BatchLearn (loss_before, loss_after) "
        + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in steps)
        + f"; Learn(C2H4, nIterations=2) ({learn[0]:.4f}, {learn[1]:.4f}); "
        f"all finite; launches K1={trained['K1']} K2 kernel 1="
        f"{trained['K2 kernel 1']} kernel 2={trained['K2 kernel 2']} (= {nL} "
        f"levels x {fwd} forwards, {bwd} backwards), K4=K5=0")
    log(f"phase 8 bf16: seconds per BatchLearn step (host clock, synced): "
        f"prep uncached {step_s[0]:.4f}, prep cached "
        + ", ".join(f"{x:.4f}" for x in step_s[1:])
        + f"; peak device memory of a cached step {peak:.1f} MB above the "
        f"{base / 1e6:.1f} MB held")
    log(f"phase 8 bf16: level_fn=risi18_bank_level (T materialised): one "
        f"request and one forward with gradients, loss {float(b_loss):.4f} vs "
        f"plain bank {float(bp_loss):.4f}; launches K4={banked['K4']} K5 "
        f"kernel 1={banked['K5 kernel 1']} kernel 2={banked['K5 kernel 2']}, "
        f"K1=K2=0; max abs err vs plain bank {bank_err:.3e} (bound "
        f"{RTOL16:g}*max(1,max|plain|)); request vs the fused route "
        f"{route_err:.3e} (two roundings of one function) ok")
    for dname, r in route.items():
        log(f"phase 8 bf16: bank route model, {dname}: one request "
            f"{r['req_s']:.4f} s (host clock, prep uncached), "
            f"{TRAIN_STEPS} BatchLearn (loss_before, loss_after) "
            + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in r["steps"])
            + " (s per step " + ", ".join(f"{x:.4f}" for x in r["step_s"])
            + f"); launches K4={r['counts']['K4']} K5 kernel 1="
            f"{r['counts']['K5 kernel 1']} kernel 2="
            f"{r['counts']['K5 kernel 2']} (= {nL} levels x "
            f"{1 + 2 * TRAIN_STEPS} forwards, {TRAIN_STEPS} backwards), "
            f"K1=K2=0; request and first-step loss vs the plain bank route "
            f"{r['err']:.3e} ok")
    return {"k1": served["K1"] + trained["K1"],
            "k2": (trained["K2 kernel 1"], trained["K2 kernel 2"]),
            "k4": banked["K4"] + sum(r["counts"]["K4"]
                                     for r in route.values()),
            "k5": tuple(banked[k] + sum(r["counts"][k]
                                        for r in route.values())
                        for k in ("K5 kernel 1", "K5 kernel 2")),
            "err": max(serve_err, grad_err),
            "bank_err": max(bank_err, *(r["err"] for r in route.values()))}


def phase_aligned():
    import torch
    from graphflow_tpu_torch.ops.risi_aligned import (
        risi18_aligned_t2, risi18_aligned_t2_reference)

    max_err, ms = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        for i, (N, P, C, Cout) in enumerate(BANK_SHAPES + SCHEDULE_SHAPES):
            state, nbr, pos, *_ = level_inputs(N, P, C, Cout, seed=SEED + i,
                                               dtype=dtype)
            got = risi18_aligned_t2(state, nbr, pos)
            torch.cuda.synchronize()
            ref = risi18_aligned_t2_reference(state, nbr, pos)
            if got.dtype != dtype or got.dtype != ref.dtype \
                    or got.shape != ref.shape:
                raise AssertionError(f"aligned {name} N={N} P={P} C={C}: "
                                     f"{got.dtype} {tuple(got.shape)}, plain "
                                     f"{ref.dtype} {tuple(ref.shape)}")
            err = float((got.float() - ref.float()).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(got, ref):
                raise AssertionError(f"aligned {name} N={N} P={P} C={C}: max "
                                     f"abs err {err:.3e}, the copy must be "
                                     f"exact")
            wide = C % (16 // state.element_size()) == 0
            log(f"phase 9 aligned: {name} N={N} P={P} C={C} max_abs_err="
                f"{err:.1f} (exact; {int((ref != 0).sum())} of {ref.numel()} "
                f"elements present; {'16-byte' if wide else 'one-element'} "
                f"accesses) ok")
        N, P, C, Cout = LEVEL_SHAPES[0]
        state, nbr, pos, *_ = level_inputs(N, P, C, Cout, seed=SEED,
                                           dtype=dtype)
        m = ms[name] = {
            "plain": time_ms(lambda: risi18_aligned_t2_reference(state, nbr,
                                                                 pos)),
            "k7": time_ms(lambda: risi18_aligned_t2(state, nbr, pos))}
        t_bytes = N * P ** 3 * C * state.element_size()
        log(f"phase 9 aligned: N,P,C={(N, P, C)} {name}, T "
            f"{t_bytes / 1e6:.1f} MB; median K7 {m['k7']:.4f} ms "
            f"({t_bytes / 1e6 / m['k7']:.1f} GB/s written), plain "
            f"take-gather {m['plain']:.4f} ms (CUDA events, 20 reps)")
        m["bound"] = bound_ms(nbytes(state, nbr, pos) + t_bytes, 0)
        log(f"phase 9 aligned: {name} bound {m['bound'][0]:.4f} ms by "
            f"{m['bound'][1]}")
    return max_err, ms


def phase_variants():
    import torch
    from graphflow_tpu_torch.models import (SMP2D, SMP_2D_ver6, SMP_2D_ver7,
                                            SMP_2D_ver7_classification,
                                            SMP2DConfig)
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

    def train(model, graphs, tgts, learn, n_steps=TRAIN_STEPS):
        steps, seconds = [], []
        for _ in range(n_steps):
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

    def bf16_variant(contraction):
        return SMP2D(SMP2DConfig(**MODEL, contraction=contraction,
                                 optimizer="momentum", dtype="bfloat16"),
                     seed=SEED, device="cuda")

    # float32: three steps and a Learn; bfloat16: two steps (prep uncached,
    # then cached), every output against the take-gather route at the
    # bfloat16 bound.
    variants = (
        ("SMP_2D_ver6", lambda: SMP_2D_ver6(**MODEL, seed=SEED,
                                            device="cuda"), RTOL),
        ("SMP_2D_ver7", lambda: SMP_2D_ver7(**MODEL, seed=SEED,
                                            device="cuda"), RTOL),
        ("SMP_2D_ver6 bfloat16", lambda: bf16_variant(10), RTOL16),
        ("SMP_2D_ver7 bfloat16", lambda: bf16_variant(50), RTOL16))
    launches, max_err, ver7 = {"float32": 0, "bfloat16": 0}, 0.0, None
    for name, make, rtol in variants:
        model = make()
        bf16 = model.cfg.dtype == "bfloat16"
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
                                       plain(model, graphs)[0], rtol))
        ref_pred, ref_feat = plain(model, [mol])
        err = max(err,
                  check_close(f"{name} Predict", [pred_mol], ref_pred, rtol),
                  check_close(f"{name} Feature", feat_mol, ref_feat[0], rtol))
        # Training, counted: the take-gather, so K7 must not launch.
        steps, step_s = train(model, train_graphs, targets, learn=not bf16,
                              n_steps=2 if bf16 else TRAIN_STEPS)
        if risi18_aligned_t2.launches != served:
            raise AssertionError(f"{name}: training launched K7 "
                                 f"{risi18_aligned_t2.launches - served} "
                                 f"times")
        if not all(p.dtype == model.cfg.torch_dtype
                   for p in model.parameters()):
            raise AssertionError(f"{name}: a parameter left "
                                 f"{model.cfg.dtype}")
        launches[model.cfg.dtype] += served
        max_err = max(max_err, err)
        if name == "SMP_2D_ver7":
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
            f"{err:.3e} (bound {rtol:g}*max(1,max|plain|)) ok")
        learned = steps[-1] if not bf16 else None
        text = (f"phase 10 variants: {name} Momentum lr {MOMENTUM_LR:g} "
                f"BatchLearn (loss_before, loss_after) "
                + ", ".join(f"({a:.6g}, {b:.6g})"
                            for a, b in steps[:len(step_s)]))
        if learned:
            text += (f"; Learn(C2H4, nIterations=2) ({learned[0]:.6g}, "
                     f"{learned[1]:.6g})")
        text += (f"; all finite; K7 launches in training 0; seconds per step "
                 f"(host clock, synced) prep uncached {step_s[0]:.4f}, prep "
                 f"cached " + ", ".join(f"{x:.4f}" for x in step_s[1:]))
        if bf16:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            model.BatchLearn(train_graphs, targets, MOMENTUM_LR)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 1e6
            text += (f"; peak device memory of a cached step {peak:.1f} MB "
                     f"above the {base / 1e6:.1f} MB held")
        log(text)
        del model

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
    launches["float32"] += served
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


def phase_ablate():
    import torch
    from graphflow_tpu_torch.ops.risi_bank import risi18_bank
    from graphflow_tpu_torch.ops.risi_bank_ablate import (
        MODES, risi18_bank_variant, risi18_bank_variant_reference)
    from graphflow_tpu_torch.tools import ablate_bank

    errs = dict.fromkeys(MODES, 0.0)
    for dtype, rtol in ((torch.float32, RTOL), (torch.bfloat16, RTOL16)):
        for i, (N, P, C, Cout) in enumerate(BANK_SHAPES + SCHEDULE_SHAPES
                                            + MANY_VERTEX_SHAPES):
            T, A, K, _ = bank_inputs(N, P, C, Cout, SEED + i, dtype)
            bank = risi18_bank(T, A, K)
            line = []
            for mode in MODES:
                what = (f"ablate {mode} N={N} P={P} C={C} Cout={Cout} "
                        f"{dtype}")
                got = risi18_bank_variant(T, A, K, mode)
                torch.cuda.synchronize()
                ref = risi18_bank_variant_reference(T, A, K, mode)
                if got.dtype != ref.dtype:
                    raise AssertionError(f"{what}: dtype {got.dtype}, plain "
                                         f"{ref.dtype}")
                err = check_close(what, got, ref, rtol)
                if mode == "full" and not torch.equal(got, bank):
                    raise AssertionError(f"{what}: differs from risi18_bank")
                if mode == "dma" and not torch.equal(got, ref):
                    raise AssertionError(f"{what}: the copy must be exact")
                errs[mode] = max(errs[mode], err)
                line.append(f"{mode} {err:.3e}")
            log(f"phase 11 ablate: {str(dtype)[6:]} N={N} P={P} C={C} "
                f"Cout={Cout} max_abs_err " + ", ".join(line)
                + f"; bound {rtol:g}*max(1,max|plain|); full == K4 exactly ok")

    # The tool, counted: five variants and K4 in turns, in both dtypes.
    B, P, C, Cout = BANK_SHAPES[0]
    risi18_bank_variant.launches = dict.fromkeys(MODES, 0)
    tables = {}
    for dtype in ablate_bank.DTYPES:
        tables[str(dtype)[6:]] = ablate_bank.report(
            B, P, C, dtype, out=lambda line: log(f"phase 11 ablate: {line}"))
    launches = dict(risi18_bank_variant.launches)
    expected = len(ablate_bank.DTYPES) * (ablate_bank.REPS
                                          + ablate_bank.WARMUP)
    if any(n != expected for n in launches.values()):
        raise AssertionError(f"K6 launches by mode {launches}, expected "
                             f"{expected} for each")

    # Per variant, bfloat16: the plain version's time, the bound, and for
    # dma the one PyTorch call that computes the same function (a copy).
    T, A, K = ablate_bank.make_inputs(B, P, C, torch.bfloat16)
    Z = risi18_bank_variant(T, A, K, "full")
    ops = {mode: bank_variant_ops(mode, B, P, C, Cout) for mode in MODES}
    # What each function must move: dma returns the first Cout columns of
    # T as [B, P*P, P*C], so it needs Z read and Z written and no more; its
    # kernel streams all of T by design, and that stream's floor is logged
    # beside the bound, under its own name.
    moved = {mode: nbytes(T, A, K, Z) for mode in MODES}
    moved["dma"] = 2 * nbytes(Z)
    stream_floor = bound_ms(nbytes(T, Z), 0, "bfloat16")
    extra_floor = {"stream_floor_ms": stream_floor[0]}
    extra = {}
    for mode in MODES:
        extra[mode] = {
            "plain_ms": time_ms(lambda: risi18_bank_variant_reference(
                T, A, K, mode), reps=10),
            "bound": bound_ms(moved[mode], ops[mode], "bfloat16"),
            "library_ms": None}
    extra["dma"]["library_ms"] = time_ms(
        lambda: T.reshape(B, P * P, P * C)[:, :, :Cout].contiguous())
    extra["dma"].update(extra_floor)
    # The same inputs in float32 hold twice the bytes of T, K and Z.
    full_f32 = bound_ms(2 * nbytes(T, K, Z) + nbytes(A), ops["full"])
    extra["full"]["bound_float32"] = full_f32
    log("phase 11 ablate: bfloat16 plain versions (ms) "
        + ", ".join(f"{m} {extra[m]['plain_ms']:.4f}" for m in MODES)
        + "; bounds (ms) "
        + ", ".join(f"{m} {extra[m]['bound'][0]:.4f} by "
                    f"{extra[m]['bound'][1]}" for m in MODES)
        + f"; full in float32 {full_f32[0]:.4f} by {full_f32[1]}; floor of "
        f"streaming all of T once, which dma's kernel does and its function "
        f"does not need, {stream_floor[0]:.4f} ms; one strided copy for dma "
        f"{extra['dma']['library_ms']:.4f} ms; launches by mode {launches}")
    return errs, tables, launches, extra


def physics_graph(n: int, seed: int):
    """An Erdos-Renyi graph with raw normal features and a symmetric
    Coulomb matrix whose entries, the diagonal included, take both signs."""
    from graphflow_tpu_torch.utils.datasets import random_graph

    g = random_graph(n, ER_P, nFeatures=PHYSICS["nFeatures"], seed=seed)
    rng = np.random.default_rng(seed)
    g.feature = rng.normal(size=(n, PHYSICS["nFeatures"]))
    c = rng.normal(size=(n, n))
    g.coulomb = (c + c.T) / 2
    return g


def phase_physics():
    import torch
    from graphflow_tpu_torch.models import (SMP_beta, SMP_gamma_physics,
                                            SMP_omega_physics)
    from graphflow_tpu_torch.models.smp2d import (case_mask_level_reference,
                                                  smp2d_forward,
                                                  smp2d_level_features)
    from graphflow_tpu_torch.ops.contractions import dropout_case_mask
    from graphflow_tpu_torch.ops.losses import squared_loss
    from graphflow_tpu_torch.ops.risi_level import (
        risi18_level, risi18_level_backward, risi18_level_reference)
    from graphflow_tpu_torch.utils.datasets import random_graph

    V, nL = PHYSICS["max_nVertices"], PHYSICS["nLevels"]
    model = SMP_omega_physics(**PHYSICS, seed=SEED, device="cuda")
    schedule = model.cfg.channel_schedule
    requests = [[physics_graph(V, 600 + GRAPHS_PER_REQUEST * r + i)
                 for i in range(GRAPHS_PER_REQUEST)]
                for r in range(N_REQUESTS)]
    small = physics_graph(6, 650)
    targets = np.random.default_rng(SEED).normal(
        size=GRAPHS_PER_REQUEST).tolist()

    def counts():
        return (risi18_level.launches, risi18_level_backward.launches,
                risi18_level_backward.reduce_launches)

    def reset():
        risi18_level.launches = 0
        risi18_level_backward.launches = 0
        risi18_level_backward.reduce_launches = 0

    def plain(graphs):
        with torch.no_grad():
            return model._forward(model.params, model._stack(graphs),
                                  level_fn=risi18_level_reference)

    # Serving, counted: each request twice (prep uncached, then cached).
    reset()
    preds, seconds = [], {"uncached": [], "cached": []}
    for kind in seconds:
        for graphs in requests:
            t0 = time.perf_counter()
            preds.append(model.Threaded_Predict(graphs))
            seconds[kind].append(time.perf_counter() - t0)
    pred_small = model.Predict(small)
    feat_small = model.Feature(small)
    served = counts()
    forwards = 2 * N_REQUESTS + 2
    if served != (nL * forwards, 0, 0):
        raise AssertionError(f"physics serving launches {served}, expected "
                             f"K1 {nL} levels x {forwards} forwards, no K2")
    serve_err = 0.0
    for r, graphs in enumerate(requests * 2):
        if preds[r].shape != (GRAPHS_PER_REQUEST,):
            raise AssertionError(f"physics request {r}: {preds[r].shape}")
        serve_err = max(serve_err, check_close(f"physics request {r}",
                                               preds[r], plain(graphs)[0]))
    ref_pred, ref_feat = plain([small])
    serve_err = max(serve_err,
                    check_close("physics Predict", [pred_small], ref_pred),
                    check_close("physics Feature", feat_small, ref_feat[0]))
    if feat_small.shape != (sum(schedule),):
        raise AssertionError(f"physics Feature shape {feat_small.shape}")
    radj = model._stack(requests[0])["radj"]
    if not bool((radj < 0).any()):
        raise AssertionError("the Coulomb adjacency has no negative entry")

    # The first step's loss and gradients, K1/K2 against the plain level.
    def batch_of(seed0):
        return [physics_graph(V, seed0 + i)
                for i in range(GRAPHS_PER_REQUEST)]

    batch = model._stack(batch_of(700), targets)
    params = model.param_dict()

    def loss_and_grads(level_fn):
        loss = model._loss(model.params, batch, level_fn=level_fn)
        return loss.detach(), torch.autograd.grad(loss, list(params.values()))

    k_loss, k_grads = loss_and_grads(None)
    p_loss, p_grads = loss_and_grads(risi18_level_reference)
    grad_err = check_close("physics train loss", k_loss, p_loss)
    for path, x, r in zip(params, k_grads, p_grads):
        grad_err = max(grad_err, check_close(f"physics gradient {path}", x,
                                             r))

    # Training, counted.
    graphs = batch_of(700)
    reset()
    steps, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        steps.append(model.BatchLearn(graphs, targets, TRAIN_LR))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    learn = model.Learn(small, 1.0, TRAIN_LR, nIterations=2)
    trained = counts()
    fwd, bwd = 2 * TRAIN_STEPS + 3, TRAIN_STEPS + 3
    if trained != (nL * fwd, nL * bwd, nL * bwd):
        raise AssertionError(f"physics training launches (K1, K2 kernel 1, "
                             f"K2 kernel 2) = {trained}, expected {nL} levels"
                             f" x {fwd} forwards and {bwd} backwards")
    losses = [x for step in steps for x in step] + list(learn)
    if not np.isfinite(losses).all():
        raise AssertionError(f"physics: non-finite loss in {losses}")
    grad_err = max(grad_err, check_close("physics first step loss",
                                         steps[0][0], p_loss))
    log(f"phase 12 physics: SMP_omega_physics V={V} P={model.cfg.P} channels "
        f"{schedule} Coulomb ({int((radj < 0).sum())} negative entries in a "
        f"request): seconds per request (host clock, prep uncached) "
        + ", ".join(f"{x:.4f}" for x in seconds["uncached"]) + "; prep cached "
        + ", ".join(f"{x:.4f}" for x in seconds["cached"])
        + f"; predictions {np.concatenate(preds[:N_REQUESTS]).round(6).tolist()}"
        f" Predict={pred_small:.6f}; K1 launches={served[0]} (= {nL} levels x"
        f" {forwards} forwards); max abs err vs plain level {serve_err:.3e} "
        f"(bound {RTOL:g}*max(1,max|plain|)) ok")
    log(f"phase 12 physics: first-step loss {float(k_loss):.6f} vs plain "
        f"level {float(p_loss):.6f}; {len(params)} gradients; max abs err "
        f"{grad_err:.3e} ok; BatchLearn (loss_before, loss_after) "
        + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in steps)
        + f"; Learn(nIterations=2) ({learn[0]:.6f}, {learn[1]:.6f}); all "
        f"finite; launches K1={trained[0]} K2 kernel 1={trained[1]} kernel 2="
        f"{trained[2]} (= {nL} levels x {fwd} forwards, {bwd} backwards); "
        f"seconds per step (host clock, synced) prep uncached "
        f"{step_s[0]:.4f}, prep cached "
        + ", ".join(f"{x:.4f}" for x in step_s[1:]))
    k1 = served[0] + trained[0]
    k2 = [trained[1], trained[2]]
    max_err = max(serve_err, grad_err)

    # The masked tower: the kernels on the scaled K against the plain level
    # that masks the bank's cases.
    mask = dropout_case_mask(torch.Generator().manual_seed(SEED), 9, True,
                             device="cuda")
    stacked = model._stack(requests[0])
    tower = model.params["tower"]
    reset()
    with torch.no_grad():
        got = smp2d_level_features(tower, stacked, model.cfg, case_mask=mask)
        ref = smp2d_level_features(
            tower, stacked, model.cfg, level_fn=functools.partial(
                case_mask_level_reference, 18, mask))
    if counts() != (nL, 0, 0):
        raise AssertionError(f"masked tower launches {counts()}, expected "
                             f"K1 {nL}")
    mask_err = max(check_close(f"masked level feature {l}", x, r)
                   for l, (x, r) in enumerate(zip(got, ref)))
    k1 += nL
    log(f"phase 12 physics: smp2d_level_features with case_mask "
        f"{mask.int().tolist()} (widths {[x.shape[1] for x in got]}): K1 "
        f"launches={nL}; max abs err vs the masked plain level "
        f"{mask_err:.3e} ok")
    max_err = max(max_err, mask_err)

    # SMP_gamma_physics (4 cases, no kernel on its path): one request and
    # one step, against the same model on the CPU.
    gamma = SMP_gamma_physics(**PHYSICS, seed=SEED, device="cuda")
    gamma_cpu = SMP_gamma_physics(**PHYSICS, seed=SEED, device="cpu")
    g_pred = gamma.Threaded_Predict(requests[0])
    g_err = check_close("gamma physics request", g_pred,
                        gamma_cpu.Threaded_Predict(requests[0]))
    g_step = gamma.BatchLearn(graphs, targets, TRAIN_LR)
    g_err = max(g_err, check_close("gamma physics first loss", g_step[0],
                                   gamma_cpu.getLoss(graphs, targets)))
    if not np.isfinite(g_step).all():
        raise AssertionError(f"gamma physics: non-finite loss {g_step}")
    log(f"phase 12 physics: SMP_gamma_physics predictions "
        f"{g_pred.round(6).tolist()}, BatchLearn ({g_step[0]:.6f}, "
        f"{g_step[1]:.6f}); max abs err vs the CPU {g_err:.3e} ok")

    # SMP_beta: no cap, so P = V = 16; through K1 and K2.
    beta = SMP_beta(**BETA, seed=SEED, device="cuda")
    b_graphs = [random_graph(BETA["max_nVertices"], 0.25, seed=800 + i)
                for i in range(GRAPHS_PER_REQUEST)]
    reset()
    b_pred = beta.Threaded_Predict(b_graphs)
    b_step = beta.BatchLearn(b_graphs, targets, TRAIN_LR)
    b_counts = counts()
    if b_counts != (3 * nL, nL, nL):
        raise AssertionError(f"SMP_beta launches {b_counts}, expected K1 "
                             f"{3 * nL}, K2 {nL}")
    beta2 = SMP_beta(**BETA, seed=SEED, device="cuda")
    with torch.no_grad():
        ref, _ = smp2d_forward(beta2.params, beta2._stack(b_graphs),
                               beta2.cfg, level_fn=risi18_level_reference)
        stacked = beta2._stack(b_graphs, targets)
        ref_loss = squared_loss(smp2d_forward(
            beta2.params, stacked, beta2.cfg,
            level_fn=risi18_level_reference)[0], stacked["target"])
    b_err = max(check_close("SMP_beta request", b_pred, ref),
                check_close("SMP_beta first loss", b_step[0], ref_loss))
    if not np.isfinite(b_step).all():
        raise AssertionError(f"SMP_beta: non-finite loss {b_step}")
    k1 += b_counts[0]
    k2 = [k2[0] + b_counts[1], k2[1] + b_counts[2]]
    log(f"phase 12 physics: SMP_beta V=P={beta.cfg.P} C=32 predictions "
        f"{b_pred.round(6).tolist()}, BatchLearn ({b_step[0]:.6f}, "
        f"{b_step[1]:.6f}); launches K1={b_counts[0]} K2={b_counts[1]}; max "
        f"abs err vs plain level {b_err:.3e} ok")
    return k1, k2, max(max_err, g_err, b_err)


def main() -> None:
    t_start = time.perf_counter()
    name = phase_device()
    import_port()
    import torch

    phase_build()
    level_errs, level_ms = phase_kernel()
    serve_launches, slice_err = phase_slice()
    bwd_errs, bwd_ms = phase_backward()
    train_launches, train_err = phase_train()
    bank_errs, bank_ms = phase_bank()
    bf16 = phase_bf16()
    aligned_err, aligned_ms = phase_aligned()
    k7_launches, variants_err = phase_variants()
    ablate_errs, ablate_tables, ablate_launches, ablate_extra = phase_ablate()
    physics_k1, physics_k2, physics_err = phase_physics()
    torch.cuda.synchronize()
    log(f"total: {time.perf_counter() - t_start:.1f} s, the kernels' build "
        f"included")

    csrc = "graphflow_tpu_torch/ops/csrc/"
    fused, bank = ("graphflow_tpu/ops/risi_fused_pallas.py:",
                   "graphflow_tpu/ops/risi_pallas.py:")

    def kernel(name, source, replaces, launches, err, ms, plain, bound,
               library_ms=None, **more):
        return {"name": name, "route": "cuda", "source": csrc + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms, **more}

    def in_bf16(ms, plain, bound):
        """The bfloat16 numbers of a kernel whose main entry is float32."""
        return {"ms_bfloat16": ms, "plain_ms_bfloat16": plain,
                "bound_ms_bfloat16": bound[0],
                "bound_by_bfloat16": bound[1]}

    # K1, K2, K4, K5 and K7: ms, plain_ms and bound_ms in float32 with the
    # bfloat16 ones beside; launches and max_abs_err cover both dtypes.
    f32, b16 = "float32", "bfloat16"
    kernels = [
        kernel("risi18_level_kernel", "risi18_level.cu", fused + "526",
               serve_launches + train_launches[0] + physics_k1 + bf16["k1"],
               max(*level_errs.values(), slice_err, physics_err, bf16["err"]),
               level_ms[f32]["kernel"], level_ms[f32]["plain"],
               level_ms[f32]["bound"],
               **in_bf16(level_ms[b16]["kernel"], level_ms[b16]["plain"],
                         level_ms[b16]["bound"])),
        kernel("risi18_level_bwd_kernel", "risi18_level_bwd.cu",
               fused + "767",
               train_launches[1] + physics_k2[0] + bf16["k2"][0],
               max(bwd_errs[f32]["dstate"], bwd_errs[b16]["dstate"],
                   train_err, physics_err, bf16["err"]),
               bwd_ms[f32]["main"], bwd_ms[f32]["plain"],
               bwd_ms[f32]["bound"],
               **in_bf16(bwd_ms[b16]["main"], bwd_ms[b16]["plain"],
                         bwd_ms[b16]["bound"])),
        kernel("sum_partial_rows, finish_bf16_kernel (risi18_level_bwd)",
               "risi18_level_bwd.cu", fused + "767",
               train_launches[2] + physics_k2[1] + bf16["k2"][1],
               max(bwd_errs[d][k] for d in (f32, b16) for k in ("dK", "db")),
               bwd_ms[f32]["reduce"], bwd_ms[f32]["plain_reduce"],
               bwd_ms[f32]["reduce_bound"],
               library_ms=bwd_ms[f32]["plain_reduce"],
               **in_bf16(bwd_ms[b16]["reduce"], bwd_ms[b16]["plain_reduce"],
                         bwd_ms[b16]["reduce_bound"])),
        kernel("risi18_bank_kernel", "risi18_bank.cu", bank + "142",
               bf16["k4"], max(bank_errs["Z"], bf16["bank_err"]),
               bank_ms[f32]["k4"], bank_ms[f32]["plain"],
               bank_ms[f32]["bound"],
               **in_bf16(bank_ms[b16]["k4"], bank_ms[b16]["plain"],
                         bank_ms[b16]["bound"])),
        kernel("risi18_bank_bwd_kernel", "risi18_bank_bwd.cu", bank + "330",
               bf16["k5"][0], max(bank_errs["dT"], bf16["bank_err"]),
               bank_ms[f32]["main"], bank_ms[f32]["plain_bwd"],
               bank_ms[f32]["bwd_bound"],
               **in_bf16(bank_ms[b16]["main"], bank_ms[b16]["plain_bwd"],
                         bank_ms[b16]["bwd_bound"])),
        kernel("sum_partial_rows (risi18_bank_bwd)", "risi18_bank_bwd.cu",
               bank + "330", bf16["k5"][1], bank_errs["dK"],
               bank_ms[f32]["reduce"], bank_ms[f32]["plain_reduce"],
               bank_ms[f32]["reduce_bound"],
               library_ms=bank_ms[f32]["plain_reduce"],
               **in_bf16(bank_ms[b16]["reduce"], bank_ms[b16]["plain_reduce"],
                         bank_ms[b16]["reduce_bound"])),
        kernel("risi18_aligned_t2_kernel", "risi_aligned_t2.cu",
               fused + "1059", sum(k7_launches.values()), aligned_err,
               aligned_ms[f32]["k7"], aligned_ms[f32]["plain"],
               aligned_ms[f32]["bound"],
               launches_bfloat16=k7_launches[b16],
               **in_bf16(aligned_ms[b16]["k7"], aligned_ms[b16]["plain"],
                         aligned_ms[b16]["bound"])),
    ]
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError("a kernel of the path was launched no time: "
                             + str({k["name"]: k["launches"]
                                    for k in kernels}))
    if k7_launches[b16] <= 0 or bf16["k1"] <= 0 or min(bf16["k2"]) <= 0:
        raise AssertionError("a bfloat16 path launched no kernel")
    # K6: one kernel per variant; times in bfloat16 as K4's, float32 beside.
    # dma also names the floor of streaming all of T, which its kernel does
    # by design; full the bound of its float32 inputs.
    for mode, extra in ablate_extra.items():
        more = {"ms_float32": ablate_tables["float32"][0][mode]}
        if "stream_floor_ms" in extra:
            more["stream_floor_ms"] = extra["stream_floor_ms"]
        if "bound_float32" in extra:
            more["bound_ms_float32"], more["bound_by_float32"] = (
                extra["bound_float32"])
        kernels.append(kernel(
            f"risi18_bank_ablate_kernel[{mode}]", "risi18_bank_ablate.cu",
            "tools/ablate_bank.py:28", ablate_launches[mode],
            ablate_errs[mode], ablate_tables["bfloat16"][0][mode],
            extra["plain_ms"], extra["bound"], extra["library_ms"], **more))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
