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
              milliseconds at the production shape and at K3's two shapes
              (64,10,20,20), (32,4,8,8), each with its bound, and at two
              scheduled ones, per dtype; last, at phase 18's field
              (64,64,32,32), where K1 spreads a vertex's row tiles over a
              cluster of blocks: the error, the plan (with its blocks a
              cluster, tiles a block and whether the products run on the
              tensor cores), both times and the bound;
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
              production shape, per dtype; last, kernel 1's cluster
              plan (a vertex's row tiles over a cluster of blocks) at
              (140,64,32,32), whose clusters walk two vertices, for
              errors, and at (64,64,32,32): errors, the plan, times and
              bound, and kernel 0 (GAp and the row sums of geff once a
              vertex, launched before kernel 1 on a cluster plan and
              asserted so at every shape) against its plain version, its
              time and bound, with kernel 1 alone on its scratch; then
              kernel 1 at the beta pairs' field (160,40,32,16), where the
              grid fills the card: plan, time, bound;
  6. train    the same model trains: 3 BatchLearn steps on a batch of 4
              random graphs and one Learn(nIterations=2) on a molecule;
              the loss and every gradient at the first step must match
              the plain level's on the same weights in float64, every loss
              must be finite, and K1 and K2
              must launch once per level per forward and per backward.
              Then the seconds per step (prep uncached and cached) and one
              step's split into host batching, forward, backward and Adam;
  7. bank     K4 and K5 against the plain bank and its backward on the
              card at ten shapes, in float32 and bfloat16, on slots made
              by the take-gather: Z, dT and dK; then the median
              milliseconds of K4, the plain bank, K5 (both kernels and each
              alone) and the plain backward at the production shape, per
              dtype, with the bounds of the factored functions; then K4 and
              K5 kernel 1 on their cluster plans (asserted from the plans,
              each launched once, K5's kernel 0 once before it) at
              (140,64,32,32) (errors, times, bounds), at (256,64,32,32)
              (errors against the plain versions run 64 vertices at a
              time) and at (64,64,32,32) the same way with the plain
              versions' times, and K5's kernel 0 against its plain
              version (error, times, bound);
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
              float32 and bfloat16, `full` against K4 bit for bit (where
              one block holds the field, as K4 does there); then
              the tool (graphflow_tpu_torch.tools.ablate_bank) prints the
              five times and the attribution at the production shape in
              both dtypes, with K4 timed in the same rounds; then each
              variant at (16,64,32,32) in bfloat16 on the row-tiled block
              of one block a vertex (K4 runs a cluster plan there, and
              `full` is held against it within the tolerance): error,
              time, plain time and bound;
 12. physics  SMP_omega_physics at full width (V=64, P=16, channels 32, 16,
              8, Coulomb adjacency with negative entries, raw features)
              serves 3 requests of 4 random graphs twice (prep uncached,
              then cached), one Predict and one Feature through K1 at
              C != Cout, then takes 3 BatchLearn steps and one
              Learn(nIterations=2) through K2; outputs, the first step's
              loss and every gradient must match the same weights through
              the plain level in float64, and K1 and K2 must launch once
              per level per
              forward and backward.  SMP_gamma_physics serves and takes a
              step (against the same model on the CPU); SMP_beta with an
              uncapped field (V = P = 16) serves and takes a step through
              K1 and K2; one smp2d_level_features call with a drawn
              case_mask runs the kernels on the scaled K, against the plain
              masked level.
 13. native   the native graph preparation (runtime/csrc/graph_prep.cpp,
              built with g++ at its first use in phase 4): its build
              seconds; every field of the SMP_omega graphs (V=64, P=16, two
              levels, nDepth=5) and of the physics graphs (Coulomb, no WL)
              equal bit for bit to the NumPy path's; host ms per graph for
              each backend; an uncached and a cached 4-graph request and
              step of SMP_omega and SMP_omega_physics with each backend,
              in turns.  After phase 18: every graph phases 4-18 prepared
              went through the native library but the sparse first-order
              route's fo_degree prep, which takes the NumPy path as in the
              JAX package, and the ELL route's prepare_graph_sparse;
 14. bucketed SMP_omega (V <= 64, P=16, C=32) on graphs of 6-64 vertices
              bucketed by size (8, 16, 32, 64): one step per bucket goes
              through K1 and K2 (P = 16 > V = 8 in the smallest) and its
              loss, gradients and predictions match the plain level in
              float64 on the same weights; the bucket-padded predictions
              match the V=64 ones; fit_bucketed trains 4 epochs, K1 and K2
              launching once per level per step, and the loss falls;
 15. first order  SMP_theta (V=64, P=16, C=32), SMP_1D and
              Unrestricted_SMP_1D (P = V = 64), SMP_1D_ver3_classification
              and SMP_theta_physics (channels 32, 16, 8) at full width
              serve 3 requests of 4 graphs and take 3 BatchLearn steps:
              outputs and the first loss match the same model on the CPU,
              the loss falls, and the cached request and step walls are
              printed; SMP_theta with sparse_max_degree (the fo_idx
              ELLPACK sum) matches its dense route;
 16. steerable  SMP_2D, its classification head, ver2, ver3 (the
              TENSORMUL-cast filter), ver4, its classification head, ver5
              and Unrestricted_SMP_2D at full width (V = P = 64, C = 32,
              two levels), Unrestricted_SMP_2D_ver2 at V = 16 (its 4-D
              filter would take 8.7 GB at V = 64): each serves 2 requests
              of 4 graphs and takes 2 BatchLearn steps (Momentum); one
              graph's prediction and first-step gradients match the same
              model on the CPU, the loss falls, and the cached request and
              step walls and the step's peak memory are printed;
 17. gcn      GCN_1D/2D/3D and their _Distance twins (V = 64, H = 32,
              max_Radius 2), GCN_MW and NeuralFingerprint on the dense
              route (V = 64) and on the ELL route (V = 4096, edge lists
              prepared by prepare_graph_sparse) do the same; at V = 1024
              the ELL route matches the dense one; prepare_graph_sparse's
              host ms a graph at V = 4096.  No kernel of the seven launches
              in phases 16-17: the JAX package runs these families without
              Pallas;
 18. large field  SMP_beta at V = P = 64 (no receptive-field cap), C = 32,
              two levels, in float32 and bfloat16, and SMP_beta_physics at
              V = 64: fields whose maps one block does not hold, which K1
              and K2 kernel 1 walk in row tiles.  Each serves one request
              of 4 graphs and takes one BatchLearn step (K1 and K2 counted:
              2 levels x 3 forwards, 1 backward, and kernel 0 once a
              level's backward); the request and the first
              loss match the same model through the plain level on the
              card, and the gradients of the batch (256 vertices: blocks
              of kernel 1 walk two) the sum of the plain level's per
              graph (in float64 for a float32 model); the request's and step's walls and peak memory are
              printed.  Then the bank route (level_fn=risi18_bank_level,
              K4 and K5 kernel 1 on cluster plans, asserted from the
              levels' plans and printed) at V = 64 on 3 graphs, the same
              way;
 19. pairs    SMP_omega_pairgraphs(64, 64, 16, 2, 32, 4, 4) (V = 64,
              P = 16, towers 32 -> 16 -> 8, head 112 -> 56 -> 28) serves two
              requests of 4 pairs (Predict per pair) and takes 3 BatchLearn
              steps with the loss falling, K1 and K2 counted (2 towers x 2
              levels per forward, per backward); the first pair's prediction
              and every gradient match the same weights in float64 on the
              CPU.  SMP_sigma_pairgraphs: the masked towers' loss and
              gradients through K1/K2 on the scaled K against the plain
              masked level, then steps with a fresh mask each.
              SMP_beta_pairgraphs at V1 = 24, V2 = 40 (P = 40 > V1) against
              the plain level in float64 on the card.  SMP_gamma, SMP_theta,
              CCN_1D and GCN_1D/2D/3D_Kernel (V = 64, H = 32) against the
              same model on the CPU, no kernel launched.  Each prints its
              cached request and step walls and the step's peak memory;
 20. graphs   GRU_GCN_1D/2D/3D, GCA_1D, CGCN_1D/2D and LCNN(64, 4, 10, 2,
              32, 32, 32) at V = 64 and hidden 32, as phases 16-17 do;
              no kernel launched;
 21. library  LSTM and GRU (28 features, 128 hidden, 10 classes, 28
              steps): getLoss, the logits and Learn against the CPU twin;
              MLP([784, 128, 10]) (Momentum) and CNN() (SGD) on 64 seeded
              28 x 28 images: a step's loss and parameters against the CPU
              twin, then 3 steps with the loss falling; no kernel launched.
 22. parallel the full-width SMP_omega (V=64, P=16, C=32, two levels, 4
              Erdos-Renyi graphs p=0.15) on four spawned ranks, data x
              graph = 2 x 2, all on the one card over gloo: a data-parallel
              step over "data" (2 ranks a group; K1, K2) whose loss and
              summed gradients match the single-process step on the card;
              the vertex-partitioned forward with both halos and the
              partitioned train step over both axes (the bank: K4, K5),
              whose predictions, loss and gradients match the unsharded
              model through level_fn=risi18_bank_level on the card and the
              plain level in float64; every rank's launches counted per
              kernel, the replicas bit-identical after an Adam step, a
              failing rank failing the phase.  Then the partitioned step's
              wall per rank, rank 0's device busy and kernels, the halo
              rows per level, and K4 and K5 at the partition's shape;
 23. entry    entry() against the plain level; dryrun_multichip(4); the five
              examples for 3 epochs (1 for the CNN), K1/K2 or K4/K5
              launched where each belongs, in this process and in the
              ranks; the npz and torch.save round trips of a model on the
              card; time_torch on a K1 launch;
 24. oplib    the op library that no model calls, at a model's widths (sets
              of 64 vectors of 32 channels, [16, 16, 32] maps, RisiLayer3D
              at D = 32, [256, 256] products, the case-table engine's 10-,
              18- and 50-case banks, risi18_matmul_reference and
              smp2d_layer_fused at (B, N, C, Cout) = (256, 16, 32, 32)):
              every function of ops/activations.py (dropout, masking,
              norm3d), ops/linalg.py and ops/reductions.py in float32 (and
              matmul in bfloat16) on the card against the same function on
              the CPU in float64, values and gradients; the production
              banks and risi18_matmul_fused against the spec engine;
              dropout from a CUDA generator (keep rate, the same draw for
              the same seed, a CPU generator refused); no kernel launched.
              Then K4 against risi18_matmul_reference in float32 and
              bfloat16 at phase 7's tolerances, and the median ms of the
              18-case spec engine, the production bank, the unfused and
              fused products and K4 at that shape, with the card's name and
              power limit.
Each kernel's bound is the larger of its bytes (every input read once,
every output written once) over 3.35 TB/s and its operations over the
card's peak for the inputs' type (67 TFLOP/s float32, 989 TFLOP/s
bfloat16), counted from the shapes of this run's inputs.
The line before the last is a JSON object describing each kernel (K1's,
K2's, K4's and K5's entries add "tiled_plan", the cluster plan each takes
at (64,64,32,32) per dtype); the last line is {"ok": true, "device":
{...}}.  Any failure raises, so the
script exits non-zero and prints no result.  Without a CUDA device, or
without the package beside this file, it fails.
"""

from __future__ import annotations

import contextlib
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
    GRAPHS as GRAPHS_PER_REQUEST, MOMENTUM_LR, bank_route_model, edge_graph,
    same_signs, time_ms)

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
# Fields beyond one block: SMP_beta and SMP_beta_physics at V = P = 64 (the
# row-tiled K1, K2 kernel 1, K4, K5 kernel 1 and K6), phase 18; the kernel
# phases check and time the levels' shape there (64 vertices, one graph).
BETA64 = dict(max_nVertices=64, nLevels=2, nChanels=32, nFeatures=4, nDepth=5)
LARGE_SHAPE = (64, 64, 32, 32)
# SMP_beta's field on more vertices than the backward kernels' 132 vertex
# groups, so that blocks of the row-tiled kernel 1 (K2, K5) walk two
# vertices and carry dK, db and their buffers from one to the next; checked
# for error, not timed.
LARGE_MANY_SHAPE = (140, 64, 32, 32)
# SMP_beta's batch of 4 graphs at V = 64 (phase 18's request and step): the
# bank's cluster plans there take one block a cluster (T is 8.6 GB in
# float32; the plain versions run 64 vertices at a time).
LARGE_BATCH_SHAPE = (256, 64, 32, 32)
# The beta pairs' field (phase 19: P = 40, 160 vertices, C -> Cout 32 ->
# 16), where the grid of K2 kernel 1 fills the card without clusters.
PAIR_SHAPE = (160, 40, 32, 16)
# Repetitions of a plain version's timing at P = 64 (each call moves
# gigabytes: T is 2.1 GB in float32 at LARGE_SHAPE).
LARGE_PLAIN_REPS = 3
# Published peaks of one H100 SXM: device memory bytes/s, and dense FLOP/s
# for float32 outside the tensor cores and bfloat16 inside them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(what: str, got, ref, rtol: float = RTOL) -> float:
    """Max abs error of got vs ref; raises beyond rtol * max(1, max|ref|)
    or on a non-finite value.  In float64, on the card where both lie
    there, 2^25 elements at a time (a gradient of T holds a billion)."""
    import torch

    got = torch.as_tensor(got).detach()
    ref = torch.as_tensor(ref).detach()
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}")
    device = got.device if got.device == ref.device else "cpu"
    got, ref = got.reshape(-1), ref.reshape(-1)
    err = scale = 0.0
    for i in range(0, got.numel(), 1 << 25):
        x = got[i:i + (1 << 25)].to(device).double()
        r = ref[i:i + (1 << 25)].to(device).double()
        if not (torch.isfinite(x).all() and torch.isfinite(r).all()):
            raise AssertionError(f"{what}: non-finite output")
        err = max(err, float((x - r).abs().max()))
        scale = max(scale, float(r.abs().max()))
    bound = rtol * max(1.0, scale)
    if err > bound:
        raise AssertionError(f"{what}: max abs err {err:.3e} > {bound:.3e}")
    return err


def check_rel(what: str, got, ref, rtol: float = RTOL) -> float:
    """check_close's error as a share of its scale, max(1, max|ref|)."""
    import torch

    err = check_close(what, got, ref, rtol)
    ref = torch.as_tensor(ref).detach()
    return err / max(1.0, float(ref.abs().max()) if ref.numel() else 0.0)


def float64_tree(tree):
    """``tree`` (dicts, lists and tuples of tensors) with every floating
    tensor in float64: a float32 model's weights or batch for the plain
    level in float64, the yardstick of the float32 kernels (the plain level
    in float32 can put an output on the other side of LeakyReLU's kink)."""
    if isinstance(tree, dict):
        return {k: float64_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(float64_tree(v) for v in tree)
    if hasattr(tree, "is_floating_point") and tree.is_floating_point():
        return tree.double()
    return tree


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


def sums_ops(N, P, Cout, gather):
    """Kernel 0 of the row-tiled backward plans
    (csrc/risi18_backward_block.cuh:backward_sums_kernel): GAp (2 * P per
    row and output), the row sums GR, GAx and GSx (six per row and output)
    and, for the level (``gather``), LeakyReLU' (one)."""
    rows = N * P * P
    return rows * Cout * (2 * P + 6 + (1 if gather else 0))


def present_elements(nbr, pos) -> int:
    """Elements of the gathered T [N,P,P,P] that are present: slot a of
    vertex v has a neighbour, and positions b and c are set."""
    N, P = nbr.shape
    has_nbr = (nbr >= 0) & (nbr < N)
    set_pos = ((pos >= 0) & (pos < P)).sum(-1)
    return int((has_nbr * set_pos * set_pos).sum())


def card_line() -> str:
    """nvidia-smi's ``name, power.limit`` of the card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("phase 1 device: FAILED, torch.cuda.is_available() "
                         "is false; this script runs only on a GPU")
    name = torch.cuda.get_device_name(0)
    card = card_line()
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
    from graphflow_tpu_torch.runtime.cuda_build import build_libraries

    t0 = time.perf_counter()
    results = build_libraries(KERNEL_LIBS)
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


def level_counts():
    from graphflow_tpu_torch.ops.risi_level import (risi18_level,
                                                    risi18_level_backward)
    return (risi18_level.launches, risi18_level_backward.launches,
            risi18_level_backward.reduce_launches)


def reset_level_counts():
    from graphflow_tpu_torch.ops.risi_level import (risi18_level,
                                                    risi18_level_backward)
    risi18_level.launches = 0
    risi18_level.tma_launches = 0
    risi18_level_backward.sums_launches = 0
    risi18_level_backward.launches = 0
    risi18_level_backward.tma_launches = 0
    risi18_level_backward.scatter_tma_launches = 0
    risi18_level_backward.reduce_launches = 0


def tma_counts():
    """Of K1's and K2 kernel 1's launches, those whose stream took one
    tensor copy a gathered row, issued by the block's producer warp (their
    plan's ``stream`` "tma_producer")."""
    from graphflow_tpu_torch.ops.risi_level import (risi18_level,
                                                    risi18_level_backward)
    return (risi18_level.tma_launches, risi18_level_backward.tma_launches)


def expect_tma(what, plan, before, which):
    """Raises unless ``plan`` (K1's, which = 0; K2 kernel 1's, 1) names
    the tensor-copy route with its producer warp and the one launch since
    the counts ``before`` took it."""
    got = tma_counts()[which] - before[which]
    if plan["stream"] != "tma_producer" or got != 1:
        raise AssertionError(f"{what}: plan {plan}, {got} launches on the "
                             f"tensor-copy route, expected 1")


def scatter_count():
    """Of K2 kernel 1's launches, those that added dT by tensor reduces of
    rows staged in the neighbour's storage order (their plan's
    ``scatter`` "tma_reduce")."""
    from graphflow_tpu_torch.ops.risi_level import risi18_level_backward
    return risi18_level_backward.scatter_tma_launches


def expect_scatter(what, plan, before):
    """Raises unless K2 kernel 1's ``plan`` names the staged scatter and
    the one launch since the count ``before`` took it."""
    got = scatter_count() - before
    if plan["scatter"] != "tma_reduce" or got != 1:
        raise AssertionError(f"{what}: plan {plan}, {got} launches on the "
                             f"staged scatter, expected 1")


def sums_counts():
    """Launches of kernel 0 (the row-tiled backward plans' sums of G once a
    vertex): K2's, K5's."""
    from graphflow_tpu_torch.ops.risi_bank import risi18_bank_backward
    from graphflow_tpu_torch.ops.risi_level import risi18_level_backward
    return (risi18_level_backward.sums_launches,
            risi18_bank_backward.sums_launches)


def expect_sums(what, before, cluster, which=0):
    """Raises unless kernel 0 (K2's, which = 0; K5's, 1) launched once
    since the counts ``before`` on a cluster plan (``cluster`` > 0), and
    not at all on another."""
    got = sums_counts()[which] - before[which]
    if got != int(cluster > 0):
        raise AssertionError(f"{what}: kernel 0 launched {got} times on a "
                             f"plan of cluster {cluster}")


def synced_s(fn):
    """(fn(), seconds on the host clock, ended by a synchronise)."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_kernel():
    import torch
    from graphflow_tpu_torch.ops.risi_level import (
        level_plan, risi18_level, risi18_level_reference)

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
        # K3's shapes (P not a multiple of 16 on the TPU: the same kernel
        # here), with their bounds.
        ms[name]["k3"] = {}
        for i, shape in enumerate(LEVEL_SHAPES[1:], start=1):
            kargs = level_inputs(*shape, seed=SEED + i, dtype=dtype)
            kout = risi18_level(*kargs)
            k3 = {"kernel": time_ms(lambda: risi18_level(*kargs)),
                  "plain": time_ms(lambda: risi18_level_reference(*kargs)),
                  "bound": bound_ms(nbytes(*kargs, kout), level_ops(
                      *shape, present_elements(kargs[1], kargs[2])), name)}
            ms[name]["k3"][str(shape)] = k3
            log(f"phase 3 kernel: {name} N,P,C,Cout={shape} (K3) median "
                f"kernel {k3['kernel']:.4f} ms, plain {k3['plain']:.4f} ms; "
                f"bound {k3['bound'][0]:.4f} ms by {k3['bound'][1]} "
                f"({100 * k3['bound'][0] / k3['kernel']:.1f} % of the "
                f"kernel's time)")
        for i, shape in enumerate(SCHEDULE_SHAPES[:2]):
            sargs = level_inputs(*shape, seed=SEED + len(LEVEL_SHAPES) + i,
                                 dtype=dtype)
            log(f"phase 3 kernel: {name} N,P,C,Cout={shape} median kernel "
                f"{time_ms(lambda: risi18_level(*sargs)):.4f} ms, plain "
                f"{time_ms(lambda: risi18_level_reference(*sargs)):.4f} ms")
        # SMP_beta's field at V = 64: the row-tiled block.
        N, P, C, Cout = LARGE_SHAPE
        largs = level_inputs(N, P, C, Cout, seed=SEED + 64, dtype=dtype)
        before = tma_counts()
        lout = risi18_level(*largs)
        expect_tma(f"level {name} N={N} P={P}", level_plan(N, P, C, Cout,
                                                           dtype), before, 0)
        torch.cuda.synchronize()
        err = check_close(f"level {name} N={N} P={P} C={C} Cout={Cout}",
                          lout, risi18_level_reference(*largs), rtol)
        errs[name] = max(errs[name], err)
        p64 = ms[name]["p64"] = {
            "kernel": time_ms(lambda: risi18_level(*largs)),
            "plain": time_ms(lambda: risi18_level_reference(*largs),
                             reps=LARGE_PLAIN_REPS),
            "bound": bound_ms(nbytes(*largs, lout), level_ops(
                N, P, C, Cout, present_elements(largs[1], largs[2])), name),
            "plan": level_plan(N, P, C, Cout, dtype)}
        log(f"phase 3 kernel: {name} N,P,C,Cout={LARGE_SHAPE} (row tiles: "
            f"{p64['plan']}) max_abs_err={err:.3e} ok; median kernel "
            f"{p64['kernel']:.4f} ms, plain {p64['plain']:.4f} ms; bound "
            f"{p64['bound'][0]:.4f} ms by {p64['bound'][1]} "
            f"({100 * p64['bound'][0] / p64['kernel']:.2f} % of the "
            f"kernel's time)")
        del largs, lout
        torch.cuda.empty_cache()
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
        _backward_reduce_kernel, _backward_sums_kernel, level_backward_plan,
        level_plan, risi18_level, risi18_level_backward,
        risi18_level_backward_reference, risi18_level_backward_sums_reference,
        risi18_level_reference)

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
            before = sums_counts()
            got = risi18_level_backward(*args, out, g)
            expect_sums(f"backward {name} N={N} P={P}", before,
                        level_backward_plan(N, P, C, Cout, dtype)["cluster"])
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
        # SMP_beta's field: the row-tiled kernel 1, at V = 64 and on more
        # vertices than it has vertex groups.
        def check_tiled(shape, seed):
            N, P, C, Cout = shape
            largs, lg = inputs(N, P, C, Cout, seed, dtype)
            routes = tma_counts()
            kout = risi18_level(*largs)
            expect_tma(f"level {name} N={N} P={P}", level_plan(
                N, P, C, Cout, dtype), routes, 0)
            lout = same_signs(kout, risi18_level_reference(*largs))
            before, routes = sums_counts(), tma_counts()
            scattered = scatter_count()
            got = risi18_level_backward(*largs, lout, lg)
            expect_sums(f"backward {name} N={N} P={P}", before, True)
            expect_tma(f"backward {name} N={N} P={P}", level_backward_plan(
                N, P, C, Cout, dtype), routes, 1)
            expect_scatter(f"backward {name} N={N} P={P}",
                           level_backward_plan(N, P, C, Cout, dtype),
                           scattered)
            torch.cuda.synchronize()
            ref = risi18_level_backward_reference(*largs, lg)
            line = []
            for key, x, r in zip(errs[name], got, ref):
                err = check_close(f"backward {key} {name} N={N} P={P} C={C} "
                                  f"Cout={Cout}", x, r, rtol)
                errs[name][key] = max(errs[name][key], err)
                line.append(f"{key} {err:.3e}")
            return largs, lg, lout, ", ".join(line)

        line = check_tiled(LARGE_MANY_SHAPE, SEED + 140)[3]
        log(f"phase 5 backward: {name} N,P,C,Cout={LARGE_MANY_SHAPE} (row "
            f"tiles; more vertices than kernel 1's 132 vertex groups) "
            f"max_abs_err {line} ok")
        torch.cuda.empty_cache()
        N, P, C, Cout = LARGE_SHAPE
        largs, lg, lout, line = check_tiled(LARGE_SHAPE, SEED + 64)
        leaves = [t.detach().requires_grad_() for t in
                  (largs[0], largs[4], largs[5])]
        plain_out = risi18_level_reference(leaves[0], *largs[1:4], leaves[1],
                                           leaves[2])
        p64 = ms[name]["p64"] = {
            "main": time_ms(lambda: _backward_main_kernel(
                *largs[:5], lg, lout, 0.01)),
            "k2": time_ms(lambda: risi18_level_backward(*largs, lout, lg)),
            "plain": time_ms(lambda: torch.autograd.grad(
                plain_out, leaves, lg, retain_graph=True),
                reps=LARGE_PLAIN_REPS),
            "plan": level_backward_plan(N, P, C, Cout, dtype)}
        del plain_out, leaves
        dstate, dK, db = risi18_level_backward(*largs, lout, lg)
        p64["bound"] = bound_ms(
            nbytes(*largs[:5], lg, lout, dstate, dK, db),
            level_backward_ops(N, P, C, Cout,
                               present_elements(largs[1], largs[2])), name)
        # Kernel 0 (GAp and the row sums of geff once a vertex), which the
        # cluster plan launches before kernel 1: against its plain
        # version (float32 sums on both sides), alone.
        sums = _backward_sums_kernel(largs[3], lg, lout, 0.01)
        sums_ref = risi18_level_backward_sums_reference(largs[3], lg, lout)
        k0 = p64["sums"] = {
            "err": max(check_close(f"kernel 0 {key} {name} "
                                   f"N,P,C,Cout={LARGE_SHAPE}", x, r, RTOL)
                       for key, x, r in zip(("gap", "sums"), sums,
                                            sums_ref)),
            "ms": time_ms(lambda: _backward_sums_kernel(largs[3], lg, lout,
                                                        0.01)),
            "plain_ms": time_ms(lambda: risi18_level_backward_sums_reference(
                largs[3], lg, lout)),
            "bound": bound_ms(nbytes(largs[3], lg, lout, *sums),
                              sums_ops(N, P, Cout, True), name)}
        # Kernel 1 alone, on the scratch kernel 0 left.
        p64["kernel1"] = time_ms(lambda: _backward_main_kernel(
            *largs[:5], lg, lout, 0.01, sums=sums))
        log(f"phase 5 backward: {name} N,P,C,Cout={LARGE_SHAPE} (row tiles:"
            f" {p64['plan']}; scatter {p64['plan']['scatter']}, launched) "
            f"max_abs_err {line} ok; median "
            f"kernels 0 and 1 {p64['main']:.4f} ms (kernel 0 "
            f"{k0['ms']:.4f}, kernel 1 {p64['kernel1']:.4f}), both kernels "
            f"{p64['k2']:.4f} ms, plain backward {p64['plain']:.4f} ms; "
            f"kernel 1's bound {p64['bound'][0]:.4f} ms by {p64['bound'][1]} "
            f"({100 * p64['bound'][0] / p64['main']:.2f} % of kernels 0 and "
            f"1); kernel 0 max_abs_err {k0['err']:.3e} (bound "
            f"{RTOL:g}*max(1,max|plain|)), plain {k0['plain_ms']:.4f} ms, "
            f"bound {k0['bound'][0]:.4f} ms by {k0['bound'][1]}, scratch "
            f"{nbytes(*sums) / 1e6:.1f} MB")
        del largs, lg, lout, dstate, sums, sums_ref
        torch.cuda.empty_cache()
        # The beta pairs' field, where 132 vertex groups x chunks already
        # fill the card: kernel 1 on its plan there.
        N, P, C, Cout = PAIR_SHAPE
        pargs, pg = inputs(N, P, C, Cout, SEED + 40, dtype)
        pout = risi18_level(*pargs)
        p40 = ms[name]["p40"] = {
            "main": time_ms(lambda: _backward_main_kernel(
                *pargs[:5], pg, pout, 0.01)),
            "plan": level_backward_plan(N, P, C, Cout, dtype),
            "bound": bound_ms(
                nbytes(*pargs[:5], pg, pout,
                       *risi18_level_backward(*pargs, pout, pg)),
                level_backward_ops(N, P, C, Cout,
                                   present_elements(pargs[1], pargs[2])),
                name)}
        log(f"phase 5 backward: {name} N,P,C,Cout={PAIR_SHAPE} (plan "
            f"{p40['plan']}): median kernel 1 {p40['main']:.4f} ms; bound "
            f"{p40['bound'][0]:.4f} ms by {p40['bound'][1]}")
        del pargs, pg, pout
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

    # The first step's loss and gradients, kernel against the plain level
    # in float64 (the same weights), on graphs of their own so that the
    # counted run prepares its batch anew.
    first = er_batch()
    params = model.param_dict()
    model64 = SMP_omega(**MODEL, seed=SEED, device="cuda").double()

    def loss_and_grads(m, level_fn):
        batch = m._stack(first, targets)
        pred, _ = smp2d_forward(m.params, batch, m.cfg, level_fn=level_fn)
        loss = squared_loss(pred, batch["target"])
        return loss.detach(), torch.autograd.grad(
            loss, list(m.param_dict().values()))

    k_loss, k_grads = loss_and_grads(model, risi18_level)
    p_loss, p_grads = loss_and_grads(model64, risi18_level_reference)
    del model64
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
        f"in float64 {float(p_loss):.6f}; {len(params)} gradients; max abs "
        f"err {grad_err:.3e} (bound {RTOL:g}*max(1,max|plain|)) ok")
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
        _backward_main_kernel, _backward_reduce_kernel,
        _backward_sums_kernel, bank_backward_plan, bank_plan, risi18_bank,
        risi18_bank_backward, risi18_bank_backward_reference,
        risi18_bank_backward_sums_reference, risi18_bank_reference)

    errs = {"Z": 0.0, "dT": 0.0, "dK": 0.0}
    for dtype, rtol in ((torch.float32, RTOL), (torch.bfloat16, RTOL16)):
        for i, (N, P, C, Cout) in enumerate(BANK_SHAPES + SCHEDULE_SHAPES
                                            + MANY_VERTEX_SHAPES):
            T, A, K, g = bank_inputs(N, P, C, Cout, SEED + i, dtype)
            before = sums_counts()
            got = (risi18_bank(T, A, K), *risi18_bank_backward(T, A, K, g))
            expect_sums(f"bank N={N} P={P} {dtype}", before,
                        bank_backward_plan(N, P, C, Cout, dtype)["cluster"], 1)
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

    # SMP_beta's field on the bank route: K4 and K5 kernel 1 on their
    # cluster plans at V = 64 (T is 2.1 GB in float32), on more vertices
    # than K5's kernel 1 has vertex groups (T 4.7 GB) and at a batch of 4
    # graphs (T 8.6 GB; the plain versions 64 vertices at a time: each
    # vertex's Z and dT are its own, dK sums over them in float32).
    def plain(T, A, K, g, step):
        Z, dT, dK = [], [], 0.0
        for i in range(0, T.shape[0], step):
            s = slice(i, i + step)
            Z.append(risi18_bank_reference(T[s], A[s], K))
            d, k = risi18_bank_backward_reference(T[s].float(), A[s],
                                                  K.float(), g[s].float())
            dT.append(d.to(T.dtype))
            dK = dK + k
        return torch.cat(Z), torch.cat(dT), dK.to(K.dtype)

    def check_tiled(shape, seed, dtype, rtol, step=None):
        N, P, C, Cout = shape
        T, A, K, g = bank_inputs(N, P, C, Cout, seed, dtype)
        plans = (bank_plan(N, P, C, Cout, dtype),
                 bank_backward_plan(N, P, C, Cout, dtype))
        if not all(p is not None and p["cluster"] >= 1 for p in plans):
            raise AssertionError(f"bank N={N} P={P} C={C} Cout={Cout} "
                                 f"{dtype}: plans {plans}, expected cluster "
                                 f"plans for K4 and K5 kernel 1")
        before = (risi18_bank.launches, risi18_bank_backward.launches)
        k0 = sums_counts()
        got = (risi18_bank(T, A, K), *risi18_bank_backward(T, A, K, g))
        torch.cuda.synchronize()
        if (risi18_bank.launches - before[0],
                risi18_bank_backward.launches - before[1]) != (1, 1):
            raise AssertionError(f"bank N={N} P={P}: K4 and K5 kernel 1 "
                                 f"must launch once each")
        expect_sums(f"bank N={N} P={P} {dtype}", k0, True, 1)
        ref = (plain(T, A, K, g, step) if step else
               (risi18_bank_reference(T, A, K),
                *risi18_bank_backward_reference(T, A, K, g)))
        line = []
        for key, x, r in zip(errs, got, ref):
            err = check_close(f"bank {key} N={N} P={P} C={C} Cout={Cout} "
                              f"{dtype}", x, r, rtol)
            errs[key] = max(errs[key], err)
            line.append(f"{key} {err:.3e}")
        del ref
        return (T, A, K, g), got, ", ".join(line), plans

    def cluster_line(plans):
        return ", ".join(f"{k} cluster {p['cluster']} x {p['tiles_per_block']}"
                         f" tiles (rows {p['rows']}, chunk {p['chunk']}, "
                         f"pieces {p['pieces']}, mma {p['mma']})"
                         for k, p in zip(("K4", "K5 kernel 1"), plans))

    N, P, C, Cout = LARGE_SHAPE
    for dtype, rtol in ((torch.float32, RTOL), (torch.bfloat16, RTOL16)):
        name = dtype_name(dtype)
        for shape, seed, step in ((LARGE_MANY_SHAPE, SEED + 140, None),
                                  (LARGE_BATCH_SHAPE, SEED + 256, 64)):
            (T, A, K, g), got, line, plans = check_tiled(shape, seed, dtype,
                                                         rtol, step)
            timed = ""
            if shape == LARGE_MANY_SHAPE:
                Z, dT, dK = got
                k4 = time_ms(lambda: risi18_bank(T, A, K))
                k5 = time_ms(lambda: _backward_main_kernel(T, A, K, g))
                b4 = bound_ms(nbytes(T, A, K, Z),
                              bank_factored_ops(*shape), name)
                b5 = bound_ms(nbytes(T, A, K, g, dT, dK),
                              bank_backward_factored_ops(*shape), name)
                timed = (f"; median K4 {k4:.4f} ms (bound {b4[0]:.4f} by "
                         f"{b4[1]}), K5 kernels 0 and 1 {k5:.4f} ms (bound "
                         f"{b5[0]:.4f} by {b5[1]})")
            log(f"phase 7 bank: {name} N,P,C,Cout={shape} ("
                f"{cluster_line(plans)}; one launch each) max_abs_err {line}"
                f" ok{timed}")
            del T, A, K, g, got
            torch.cuda.empty_cache()
        (T, A, K, g), got, line, plans = check_tiled(LARGE_SHAPE, SEED + 64,
                                                     dtype, rtol)
        Z, dT, dK = got
        leaves = [x.detach().requires_grad_() for x in (T, K)]
        plain_out = risi18_bank_reference(leaves[0], A, leaves[1])
        p64 = ms[name]["p64"] = {
            "k4": time_ms(lambda: risi18_bank(T, A, K)),
            "main": time_ms(lambda: _backward_main_kernel(T, A, K, g)),
            "plain": time_ms(lambda: risi18_bank_reference(T, A, K),
                             reps=LARGE_PLAIN_REPS),
            "plain_bwd": time_ms(lambda: torch.autograd.grad(
                plain_out, leaves, g, retain_graph=True),
                reps=LARGE_PLAIN_REPS),
            "plans": plans,
            "bound": bound_ms(nbytes(T, A, K, Z),
                              bank_factored_ops(N, P, C, Cout), name),
            "bwd_bound": bound_ms(nbytes(T, A, K, g, dT, dK),
                                  bank_backward_factored_ops(N, P, C, Cout),
                                  name)}
        # Kernel 0 (GAp and the row sums of g once a vertex), which the
        # cluster plan launches before kernel 1: against its plain
        # version (float32 sums on both sides), alone; then kernel 1 alone
        # on its scratch.
        sums = _backward_sums_kernel(A, g)
        k0 = p64["sums"] = {
            "err": max(check_close(f"K5 kernel 0 {key} {name} "
                                   f"N,P,C,Cout={LARGE_SHAPE}", x, r, RTOL)
                       for key, x, r in zip(
                           ("gap", "sums"), sums,
                           risi18_bank_backward_sums_reference(A, g))),
            "ms": time_ms(lambda: _backward_sums_kernel(A, g)),
            "plain_ms": time_ms(lambda: risi18_bank_backward_sums_reference(
                A, g)),
            "bound": bound_ms(nbytes(A, g, *sums),
                              sums_ops(N, P, Cout, False), name)}
        p64["kernel1"] = time_ms(lambda: _backward_main_kernel(
            T, A, K, g, sums=sums))
        log(f"phase 7 bank: {name} N,P,C,Cout={LARGE_SHAPE} "
            f"({cluster_line(plans)}; K4 {plans[0]}, K5 {plans[1]}) "
            f"max_abs_err {line} ok; median K4 {p64['k4']:.4f} ms "
            f"(bound {p64['bound'][0]:.4f} by {p64['bound'][1]}), K5 kernels "
            f"0 and 1 {p64['main']:.4f} ms (kernel 0 {k0['ms']:.4f}, kernel "
            f"1 {p64['kernel1']:.4f}; bound {p64['bwd_bound'][0]:.4f} by "
            f"{p64['bwd_bound'][1]}); plain bank {p64['plain']:.4f} ms, plain "
            f"backward {p64['plain_bwd']:.4f} ms; K5 kernel 0 max_abs_err "
            f"{k0['err']:.3e} (bound {RTOL:g}*max(1,max|plain|)), plain "
            f"{k0['plain_ms']:.4f} ms, bound {k0['bound'][0]:.4f} ms by "
            f"{k0['bound'][1]}")
        del T, A, K, g, got, Z, dT, dK, leaves, plain_out, sums
        torch.cuda.empty_cache()
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
    from graphflow_tpu_torch.ops.risi_bank import bank_plan, risi18_bank
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

    # SMP_beta's field: every variant on the row-tiled block of one block a
    # vertex at P = 64, in bfloat16 (the tool's dtype), 16 vertices (T 268
    # MB).  K4 runs a cluster plan there: `full` is the other block, held
    # against K4 within the tolerance.
    Nl, Pl, Cl, Coutl = 16, *LARGE_SHAPE[1:]
    T, A, K, _ = bank_inputs(Nl, Pl, Cl, Coutl, SEED + 64, torch.bfloat16)
    bank = risi18_bank(T, A, K)
    k4_plan = bank_plan(Nl, Pl, Cl, Coutl, torch.bfloat16)
    if not k4_plan["cluster"]:
        raise AssertionError(f"K4 at N={Nl} P={Pl}: plan {k4_plan}, "
                             f"expected a cluster plan")
    p64 = {}
    for mode in MODES:
        what = f"ablate {mode} N={Nl} P={Pl} C={Cl} Cout={Coutl} bfloat16"
        got = risi18_bank_variant(T, A, K, mode)
        torch.cuda.synchronize()
        ref = risi18_bank_variant_reference(T, A, K, mode)
        err = check_close(what, got, ref, RTOL16)
        if mode == "full":
            check_close(what + " vs K4's cluster plan", got, bank, RTOL16)
        if mode == "dma" and not torch.equal(got, ref):
            raise AssertionError(f"{what}: the copy must be exact")
        errs[mode] = max(errs[mode], err)
        moved = (2 * nbytes(got) if mode == "dma"
                 else nbytes(T, A, K, got))
        p64[mode] = {
            "ms": time_ms(lambda: risi18_bank_variant(T, A, K, mode)),
            "plain_ms": time_ms(lambda: risi18_bank_variant_reference(
                T, A, K, mode), reps=LARGE_PLAIN_REPS),
            "bound": bound_ms(moved, bank_variant_ops(mode, Nl, Pl, Cl,
                                                      Coutl), "bfloat16"),
            "max_abs_err": err,
            # dma's function is one strided copy, which PyTorch does alone.
            "library_ms": time_ms(lambda: T.reshape(
                Nl, Pl * Pl, Pl * Cl)[:, :, :Coutl].contiguous())
            if mode == "dma" else None}
    log(f"phase 11 ablate: bfloat16 N,P,C,Cout={(Nl, Pl, Cl, Coutl)} (the "
        f"row-tiled block one a vertex; K4 a cluster of "
        f"{k4_plan['cluster']}) " + ", ".join(
            f"{m} err {v['max_abs_err']:.3e}, {v['ms']:.4f} ms (plain "
            f"{v['plain_ms']:.4f}, bound {v['bound'][0]:.4f} by "
            f"{v['bound'][1]}"
            + (f"; .contiguous() {v['library_ms']:.4f} ms"
               if v["library_ms"] is not None else "") + ")"
            for m, v in p64.items()) + "; full within "
        "1e-2 of K4's cluster plan, dma exact ok")
    del T, A, K, bank
    torch.cuda.empty_cache()

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
    for mode in MODES:
        extra[mode]["p64"] = {"shape": [Nl, Pl, Cl, Coutl],
                              "dtype": "bfloat16", "ms": p64[mode]["ms"],
                              "plain_ms": p64[mode]["plain_ms"],
                              "bound_ms": p64[mode]["bound"][0],
                              "bound_by": p64[mode]["bound"][1],
                              "library_ms": p64[mode]["library_ms"]}
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
    from graphflow_tpu_torch.ops.risi_level import risi18_level_reference
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

    counts, reset = level_counts, reset_level_counts
    # The yardstick: the same weights through the plain level in float64.
    model64 = SMP_omega_physics(**PHYSICS, seed=SEED, device="cuda").double()

    def plain(graphs):
        with torch.no_grad():
            return model64._forward(model64.params, model64._stack(graphs),
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

    params = model.param_dict()

    def loss_and_grads(m, level_fn):
        loss = m._loss(m.params, m._stack(batch_of(700), targets),
                       level_fn=level_fn)
        return loss.detach(), torch.autograd.grad(
            loss, list(m.param_dict().values()))

    k_loss, k_grads = loss_and_grads(model, None)
    p_loss, p_grads = loss_and_grads(model64, risi18_level_reference)
    del model64
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
        f" {forwards} forwards); max abs err vs plain level in float64 "
        f"{serve_err:.3e} (bound {RTOL:g}*max(1,max|plain|)) ok")
    log(f"phase 12 physics: first-step loss {float(k_loss):.6f} vs plain "
        f"level in float64 {float(p_loss):.6f}; {len(params)} gradients; "
        f"max abs err "
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
            float64_tree(tower), float64_tree(stacked), model.cfg,
            level_fn=functools.partial(case_mask_level_reference, 18, mask))
    if counts() != (nL, 0, 0):
        raise AssertionError(f"masked tower launches {counts()}, expected "
                             f"K1 {nL}")
    mask_err = max(check_close(f"masked level feature {l}", x, r)
                   for l, (x, r) in enumerate(zip(got, ref)))
    k1 += nL
    log(f"phase 12 physics: smp2d_level_features with case_mask "
        f"{mask.int().tolist()} (widths {[x.shape[1] for x in got]}): K1 "
        f"launches={nL}; max abs err vs the masked plain level in float64 "
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
    beta2 = SMP_beta(**BETA, seed=SEED, device="cuda").double()
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
        f"abs err vs plain level in float64 {b_err:.3e} ok")
    return k1, k2, max(max_err, g_err, b_err)


FIRST_ORDER = dict(max_nVertices=64, nLevels=2, nChanels=32, nFeatures=4,
                   nDepth=5)
BUCKETS = (8, 16, 32, 64)
# Graphs of 6..64 vertices, three to each bucket: in the smallest the
# receptive field (P = 16) is larger than the bucket (V = 8).
BUCKET_SIZES = (6, 7, 8, 10, 13, 16, 20, 26, 32, 40, 52, 64)
BUCKET_EPOCHS = 4


@contextlib.contextmanager
def numpy_prep():
    """Within the block, every ``prepare_graph`` call of the package takes
    the NumPy path (``backend="python"``), as a caller would ask for it."""
    from graphflow_tpu_torch.core import prep

    original = prep.prepare_graph
    prep.prepare_graph = functools.partial(original, backend="python")
    try:
        yield
    finally:
        prep.prepare_graph = original


def phase_native_prep():
    """Phase 13: the native graph preparation against the NumPy path."""
    import dataclasses

    import torch
    from graphflow_tpu_torch.core import prep
    from graphflow_tpu_torch.models import SMP_omega, SMP_omega_physics
    from graphflow_tpu_torch.runtime import native
    from graphflow_tpu_torch.utils.datasets import random_graph

    kept = prep.ROUTES.copy()
    if not native.available():
        raise AssertionError("the native graph preparation is unavailable")
    built = native.build_result
    log(f"phase 13 native prep: {built.path.relative_to(ROOT)} "
        f"{'built with g++' if built.rebuilt else 'up to date'} in "
        f"{built.seconds:.2f} s at its first use (phase 4)")

    omega = dict(nLevels=MODEL["nLevels"],
                 max_nVertices=MODEL["max_nVertices"],
                 max_receptive_field=MODEL["max_receptive_field"],
                 nDepth=MODEL["nDepth"])
    physics = dict(nLevels=PHYSICS["nLevels"],
                   max_nVertices=PHYSICS["max_nVertices"],
                   max_receptive_field=PHYSICS["max_receptive_field"],
                   nDepth=0, has_WL_ordering=False, use_wl_features=False,
                   use_coulomb=True)
    cases = {
        "SMP_omega": ([random_graph(MODEL["max_nVertices"], ER_P, seed=900 + i)
                       for i in range(8)], omega),
        "physics": ([physics_graph(PHYSICS["max_nVertices"], 950 + i)
                     for i in range(8)], physics),
    }
    per_graph = {}
    for what, (graphs, kw) in cases.items():
        for g in graphs:
            a = prep.prepare_graph(g, **kw)
            b = prep.prepare_graph(g, backend="python", **kw)
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                same = (x == y if not isinstance(x, np.ndarray) else
                        x.dtype == y.dtype and np.array_equal(x, y))
                if not same:
                    raise AssertionError(f"native prep {what}: field "
                                         f"{f.name} differs from NumPy's")
        per_graph[what] = {}
        for backend in ("auto", "python"):
            t0 = time.perf_counter()
            for g in graphs:
                prep.prepare_graph(g, backend=backend, **kw)
            per_graph[what][backend] = ((time.perf_counter() - t0)
                                        / len(graphs) * 1e3)
        log(f"phase 13 native prep: {what} graphs (V={kw['max_nVertices']}, "
            f"P={kw['max_receptive_field']}, {kw['nLevels']} levels, "
            f"nDepth={kw['nDepth']}"
            f"{', Coulomb, no WL' if what == 'physics' else ''}): every "
            f"field of {len(graphs)} graphs equal bit for bit; host ms per "
            f"graph native {per_graph[what]['auto']:.3f}, NumPy "
            f"{per_graph[what]['python']:.3f} "
            f"({per_graph[what]['python'] / per_graph[what]['auto']:.1f}x)")

    # One uncached request and step of 4 new graphs with each backend, in
    # turns (native, NumPy, native, NumPy), and the cached ones beside.
    walls = {"native": [], "numpy": []}
    targets = np.random.default_rng(SEED).normal(
        size=GRAPHS_PER_REQUEST).tolist()
    for what, make, graph in (
            ("SMP_omega", lambda: SMP_omega(**MODEL, seed=SEED,
                                            device="cuda"),
             lambda s: random_graph(MODEL["max_nVertices"], ER_P, seed=s)),
            ("SMP_omega_physics", lambda: SMP_omega_physics(
                **PHYSICS, seed=SEED, device="cuda"),
             lambda s: physics_graph(PHYSICS["max_nVertices"], s))):
        model = make()
        model.Threaded_Predict([graph(990)])          # warm
        row = {}
        for rnd, backend in enumerate(("native", "numpy") * 2):
            graphs = [graph(1000 + 10 * rnd + i)
                      for i in range(GRAPHS_PER_REQUEST)]
            ctx = (numpy_prep() if backend == "numpy"
                   else contextlib.nullcontext())
            with ctx:
                _, req = synced_s(lambda: model.Threaded_Predict(graphs))
                step_graphs = [graph(2000 + 10 * rnd + i)
                               for i in range(GRAPHS_PER_REQUEST)]
                _, step = synced_s(lambda: model.BatchLearn(
                    step_graphs, targets, TRAIN_LR))
            _, req_c = synced_s(lambda: model.Threaded_Predict(graphs))
            _, step_c = synced_s(lambda: model.BatchLearn(
                step_graphs, targets, TRAIN_LR))
            row.setdefault(backend, []).append((req, step, req_c, step_c))
        walls[what] = row
        text = []
        for backend, rows in row.items():
            r = np.median(np.array(rows), axis=0) * 1e3
            text.append(f"{backend}: uncached request {r[0]:.2f}, step "
                        f"{r[1]:.2f}; cached request {r[2]:.2f}, step "
                        f"{r[3]:.2f}")
        log(f"phase 13 native prep: {what}, {GRAPHS_PER_REQUEST} new graphs, "
            f"ms (host clock, synced; median of 2 turns): " + "; ".join(text))
        torch.cuda.synchronize()
    # Phase 13's own preparations are not those of the paths it checks.
    prep.ROUTES.clear()
    prep.ROUTES.update(kept)
    return per_graph


def bucket_batches(model, graphs, targets):
    """{bucket: (stacked batch on the card, graphs)} as fit_bucketed
    prepares them."""
    from graphflow_tpu_torch.core import batching

    out = {}
    for b, (gs, ts) in batching.bucket_by_size(graphs, targets,
                                               BUCKETS).items():
        pgs = [model._prepare(g, pad_nVertices=b) for g in gs]
        out[b] = (batching.stack_graphs(pgs, ts, device=model.device,
                                        dtype=model.dtype), gs)
    return out


def phase_bucketed():
    """Phase 14: fit_bucketed on the card through K1 and K2."""
    import torch
    from graphflow_tpu_torch.models import SMP_omega, fit_bucketed
    from graphflow_tpu_torch.models.smp2d import smp2d_forward
    from graphflow_tpu_torch.ops.losses import squared_loss
    from graphflow_tpu_torch.ops.risi_level import risi18_level_reference
    from graphflow_tpu_torch.utils.convert import unflatten
    from graphflow_tpu_torch.utils.datasets import random_graph

    nL = MODEL["nLevels"]
    model = SMP_omega(**MODEL, seed=SEED, device="cuda")
    graphs = [random_graph(n, max(ER_P, 2.5 / n), seed=1100 + n)
              for n in BUCKET_SIZES]
    targets = [0.1 * g.nVertices for g in graphs]
    batches = bucket_batches(model, graphs, targets)
    if sorted(batches) != list(BUCKETS):
        raise AssertionError(f"buckets {sorted(batches)}, expected {BUCKETS}")

    params = model.param_dict()
    # The yardstick: the same weights and batches through the plain level
    # in float64.
    params64 = {k: p.detach().double().requires_grad_()
                for k, p in params.items()}
    tree64 = unflatten(params64)

    def plain_loss_and_grads(batch):
        batch = float64_tree(batch)
        pred, _ = smp2d_forward(tree64, batch, model.cfg,
                                level_fn=risi18_level_reference,
                                training=True)
        loss = squared_loss(pred, batch["target"])
        grads = torch.autograd.grad(loss, list(params64.values()))
        return float(loss.detach()), dict(zip(params64, grads))

    # One step per bucket through K1 and K2, held leaf by leaf against the
    # plain level on the same batch and weights; then each bucket's
    # per-graph predictions against the plain level's.
    per_bucket, err, before, by_bucket = {}, 0.0, 0.0, {}
    for b, (batch, gs) in batches.items():
        reset_level_counts()
        loss, grads = model._loss_and_grads(batch)
        counts = level_counts()
        if counts != (nL, nL, nL):
            raise AssertionError(f"bucket V={b}: launches (K1, K2 kernel 1, "
                                 f"K2 kernel 2) {counts}, expected {nL} each")
        p_loss, p_grads = plain_loss_and_grads(batch)
        err = max(err, check_close(f"bucket V={b} loss", loss, p_loss))
        for path in params:
            err = max(err, check_close(f"bucket V={b} gradient {path}",
                                       grads[path], p_grads[path]))
        with torch.no_grad():
            pred, _ = model._forward(model.params, batch)
            plain, _ = smp2d_forward(tree64, float64_tree(batch), model.cfg,
                                     level_fn=risi18_level_reference)
        err = max(err, check_close(f"bucket V={b} predictions", pred, plain))
        by_bucket.update({id(g): float(p) for g, p in zip(gs, pred)})
        per_bucket[b] = counts
        before += loss
    # Predictions padded to V=64 against the bucket's padding.
    padded = model.Threaded_Predict(graphs)
    err = max(err, check_close("bucketed vs V=64 predictions",
                               [by_bucket[id(g)] for g in graphs], padded))

    reset_level_counts()
    last, seconds = synced_s(lambda: fit_bucketed(
        model, graphs, targets, TRAIN_LR, BUCKET_EPOCHS, boundaries=BUCKETS,
        seed=SEED))
    trained = level_counts()
    steps = BUCKET_EPOCHS * len(BUCKETS)
    if trained != (nL * steps,) * 3:
        raise AssertionError(f"fit_bucketed launches {trained}, expected "
                             f"{nL} levels x {steps} steps of each")
    with torch.no_grad():
        after = sum(float(squared_loss(model._forward(model.params, batch)[0],
                                       batch["target"]))
                    for batch, _ in batches.values())
    if not (np.isfinite(last) and after < before):
        raise AssertionError(f"fit_bucketed: loss {before} -> {after} "
                             f"(last epoch {last})")
    log(f"phase 14 bucketed: SMP_omega V<={max(BUCKETS)} P={model.cfg.P} C="
        f"{MODEL['nChanels']}, {len(graphs)} graphs of "
        f"{min(BUCKET_SIZES)}-{max(BUCKET_SIZES)} vertices in buckets "
        f"{BUCKETS}: one step per bucket launches (K1, K2 kernel 1, K2 "
        f"kernel 2) " + ", ".join(f"V={b}: {c}" for b, c in
                                  per_bucket.items())
        + f"; loss, {len(params)} gradients and predictions vs plain level "
        f"in float64 in each bucket, predictions vs V=64 padding: max abs err "
        f"{err:.3e} (bound {RTOL:g}*max(1,max|plain|)) ok")
    log(f"phase 14 bucketed: fit_bucketed {BUCKET_EPOCHS} epochs, Adam lr "
        f"{TRAIN_LR:g}: summed loss {before:.6f} -> {after:.6f} (last epoch "
        f"{last:.6f}); launches K1={trained[0]} K2 kernel 1={trained[1]} "
        f"kernel 2={trained[2]} (= {nL} levels x {steps} steps); "
        f"{seconds:.3f} s (host clock, synced, prep included)")
    return list(per_bucket.values()), trained, err


def first_order_models():
    """(name, constructor, graph maker, targets) of phase 15."""
    from graphflow_tpu_torch import models
    from graphflow_tpu_torch.utils.datasets import random_graph

    def er(s):
        return random_graph(FIRST_ORDER["max_nVertices"], ER_P, seed=s)

    regression = np.random.default_rng(SEED).normal(
        size=GRAPHS_PER_REQUEST).tolist()
    labels = [float(i % 3) for i in range(GRAPHS_PER_REQUEST)]
    return [
        ("SMP_theta", lambda dev: models.SMP_theta(
            **MODEL, seed=SEED, device=dev), er, regression),
        ("SMP_1D", lambda dev: models.SMP_1D(
            **FIRST_ORDER, seed=SEED, device=dev), er, regression),
        ("Unrestricted_SMP_1D", lambda dev: models.Unrestricted_SMP_1D(
            **FIRST_ORDER, seed=SEED, device=dev), er, regression),
        ("SMP_1D_ver3_classification",
         lambda dev: models.SMP_1D_ver3_classification(
             **FIRST_ORDER, nClasses=3, seed=SEED, device=dev), er, labels),
        ("SMP_theta_physics", lambda dev: models.SMP_theta_physics(
            PHYSICS["max_nVertices"], PHYSICS["max_receptive_field"],
            PHYSICS["nLevels"], PHYSICS["nChanels"], PHYSICS["nFeatures"],
            seed=SEED, device=dev),
         lambda s: physics_graph(PHYSICS["max_nVertices"], s), regression),
    ]


def phase_first_order():
    """Phase 15: the first-order family at full width on the card."""
    import dataclasses

    import torch
    from graphflow_tpu_torch.core import prep
    from graphflow_tpu_torch.models import SMP1D

    err = 0.0
    walls = {}
    for k, (name, make, graph, targets) in enumerate(first_order_models()):
        model, cpu = make("cuda"), make("cpu")
        requests = [[graph(1300 + 100 * k + GRAPHS_PER_REQUEST * r + i)
                     for i in range(GRAPHS_PER_REQUEST)]
                    for r in range(N_REQUESTS)]
        preds = [model.Threaded_Predict(gs) for gs in requests]
        for r, (gs, p) in enumerate(zip(requests, preds)):
            expected = ((GRAPHS_PER_REQUEST, 3) if model.cfg.nClasses
                        else (GRAPHS_PER_REQUEST,))
            if p.shape != expected:
                raise AssertionError(f"{name} request {r}: shape {p.shape}")
            err = max(err, check_close(f"{name} request {r} vs the CPU", p,
                                       cpu.Threaded_Predict(gs)))
        feat = model.Feature(requests[0][0])
        err = max(err, check_close(f"{name} Feature vs the CPU", feat,
                                   cpu.Feature(requests[0][0])))
        req_s = [synced_s(lambda: model.Threaded_Predict(gs))[1]
                 for gs in requests]

        graphs = requests[0]
        first = cpu.getLoss(graphs, targets)
        if model.cfg.optimizer == "adam":
            lr, how = TRAIN_LR, f"Adam lr {TRAIN_LR:g}"
        else:
            # Momentum takes lr * gradient: a step the first-order model
            # says cuts the loss by 5 %, from the first gradient.
            loss, grads = model._loss_and_grads(model._stack(graphs, targets))
            norm2 = sum(float((g.double() ** 2).sum()) for g in grads.values())
            lr = 0.05 * loss * len(graphs) / norm2
            how = f"Momentum lr {lr:.3e} (0.05 loss nBatch / |g|^2)"
        steps, step_s = [], []
        for _ in range(TRAIN_STEPS):
            out, secs = synced_s(lambda: model.BatchLearn(graphs, targets,
                                                          lr))
            steps.append(out)
            step_s.append(secs)
        err = max(err, check_close(f"{name} first loss vs the CPU",
                                   steps[0][0], first))
        losses = [x for st in steps for x in st]
        if not (np.isfinite(losses).all() and steps[-1][1] < steps[0][0]):
            raise AssertionError(f"{name}: the loss did not fall: {steps}")
        walls[name] = (statistics.median(req_s), statistics.median(
            step_s[1:]))
        shown = np.concatenate(preds).astype(np.float64).round(4).tolist()
        channels = [model.cfg.channels_at(l)
                    for l in range(model.cfg.nLevels + 1)]
        log(f"phase 15 first order: {name} ({model.cfg.filter}, "
            f"P={model.cfg.P}, channels {channels}"
            f"): predictions {shown[:8]}...; max abs err vs the same model on "
            f"the CPU so far {err:.3e}; BatchLearn {how} (loss_before, "
            f"loss_after) " + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in
                                         steps)
            + f"; cached request {walls[name][0] * 1e3:.2f} ms, cached step "
            f"{walls[name][1] * 1e3:.2f} ms (host clock, synced, medians)")

    # SMP_theta's sparse first-order sum against its dense one.
    name, make, graph, targets = first_order_models()[0]
    dense = make("cuda")
    graphs = [graph(1300 + i) for i in range(GRAPHS_PER_REQUEST)]
    degree = max(int((g.adj > 0).sum(axis=1).max()) + 1 for g in graphs)
    sparse = SMP1D(dataclasses.replace(dense.cfg, sparse_max_degree=degree),
                   seed=SEED, device="cuda")
    before = prep.ROUTES["numpy_fo_degree"]
    got = sparse.Threaded_Predict(graphs)
    if prep.ROUTES["numpy_fo_degree"] - before != len(graphs):
        raise AssertionError("the sparse route did not prepare fo_idx")
    loss_s = sparse.getLoss(graphs, targets)
    sparse_err = max(
        check_close("SMP_theta sparse vs dense", got,
                    dense.Threaded_Predict(graphs), 1e-5),
        check_close("SMP_theta sparse vs dense loss", loss_s,
                    dense.getLoss(graphs, targets), 1e-5))
    torch.cuda.synchronize()
    log(f"phase 15 first order: SMP_theta sparse_max_degree={degree} (the "
        f"largest closed degree) against the dense route: max abs err "
        f"{sparse_err:.3e} (bound 1e-05*max(1,max|dense|)) ok")
    return walls, max(err, sparse_err)


# Phases 16 and 17: the steerable family at full width (P = V = 64) and
# Unrestricted_SMP_2D_ver2 at V = 16, whose per-size 4-D filter is
# (V+1) V^2 prevC C floats (8.7 GB at level 2 in float32 at V = 64); then
# the GCN family, GCN_MW and NeuralFingerprint also on the ELL route.
STEERABLE = dict(max_nVertices=64, nLevels=2, nChanels=32, nFeatures=4,
                 nDepth=5)
STEERABLE_4D_V = 16
GCN = dict(nLevels=2, max_nVertices=64, nFeatures=4, nHiddens=32, nDepth=5,
           max_Radius=2)
ONE_HOP = dict(nLevels=2, nFeatures=4, nHiddens=32)
# The ELL route's graphs (``tools/measure.py:edge_graph``, about 8
# neighbours a vertex).  At V = 1024 both routes run and must agree, on
# graphs of 512 vertices (the dense route's prep is cubic in the vertices).
ELL_V, BOTH_ROUTES_V, BOTH_ROUTES_N = 4096, 1024, 512
NEW_PHASE_STEPS = 2


def kernel_counts():
    """Every launch count of the seven kernels' wrappers."""
    from graphflow_tpu_torch.ops.risi_aligned import risi18_aligned_t2
    from graphflow_tpu_torch.ops.risi_bank import (risi18_bank,
                                                   risi18_bank_backward)
    from graphflow_tpu_torch.ops.risi_bank_ablate import risi18_bank_variant

    return (level_counts()
            + (risi18_bank.launches, risi18_bank_backward.launches,
               risi18_bank_backward.reduce_launches,
               risi18_aligned_t2.launches)
            + tuple(risi18_bank_variant.launches.values()))


def falling_lr(model, learn, lr0, n_steps=NEW_PHASE_STEPS, every=False):
    """The first learning rate of lr0 / 4^k whose ``n_steps`` steps
    (``learn(lr)`` -> (loss_before, loss_after)) cut the loss (``every``:
    each step cuts its own), taken on the model and then undone
    (parameters and optimizer state)."""
    lr = lr0
    model.cache_parameters()
    for _ in range(12):
        steps = [learn(lr) for _ in range(n_steps)]
        model.restore_parameters()
        cut = (all(b < a for a, b in steps) if every
               else steps[-1][1] < steps[0][0])
        if np.isfinite(steps).all() and cut:
            return lr
        lr /= 4
    raise AssertionError(f"no learning rate down to {lr:.3e} cuts the loss")


def momentum_lr(model, graphs, targets):
    """A Momentum learning rate for NEW_PHASE_STEPS steps (falling_lr) from
    lr0, which cuts the loss by 5 % in one step to first order
    (lr0 |g|^2 / nBatch = 0.05 loss)."""
    loss, grads = model._loss_and_grads(model._stack(graphs, targets))
    norm2 = sum(float((g.double() ** 2).sum()) for g in grads.values())
    return falling_lr(model, lambda lr: model.BatchLearn(graphs, targets, lr),
                      0.05 * loss * len(graphs) / norm2)


def serve_and_train(what, model, cpu, requests, targets, nClasses=None,
                    out_shape=()):
    """Phases 16, 17 and 20 for one model: its requests, the first
    request's first graph and its first-step gradients against the same
    model on the CPU, then NEW_PHASE_STEPS BatchLearn steps on the first
    request's graphs.  A graph's output has the shape ``out_shape`` (the
    autoencoder's [V, V]), or [nClasses] scores.  Returns the text to
    log."""
    import torch

    preds = [model.Threaded_Predict(gs) for gs in requests]
    for r, p in enumerate(preds):
        expected = (len(requests[r]),) + ((nClasses,) if nClasses
                                          else out_shape)
        if p.shape != expected or not np.isfinite(p).all():
            raise AssertionError(f"{what} request {r}: shape {p.shape}, "
                                 f"finite {np.isfinite(p).all()}")
    one, t_one = requests[0][:1], targets[:1]
    err = check_close(f"{what} prediction vs the CPU", preds[0][:1],
                      cpu.Threaded_Predict(one))
    _, grads = model._loss_and_grads(model._stack(one, t_one))
    _, cpu_grads = cpu._loss_and_grads(cpu._stack(one, t_one))
    for path, g in grads.items():
        err = max(err, check_close(f"{what} gradient {path} vs the CPU", g,
                                   cpu_grads[path]))
    _, req_s = synced_s(lambda: model.Threaded_Predict(requests[0]))

    graphs = requests[0]
    lr = momentum_lr(model, graphs, targets)
    steps, step_s = [], []
    for k in range(NEW_PHASE_STEPS):
        if k == NEW_PHASE_STEPS - 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        out, secs = synced_s(lambda: model.BatchLearn(graphs, targets, lr))
        steps.append(out)
        step_s.append(secs)
    peak = (torch.cuda.max_memory_allocated() - held) / 1e6
    losses = [x for st in steps for x in st]
    if not (np.isfinite(losses).all() and steps[-1][1] < steps[0][0]):
        raise AssertionError(f"{what}: the loss did not fall: {steps}")
    shown = np.concatenate(preds).astype(np.float64).reshape(-1).round(
        4).tolist()
    return (
        f"predictions {shown[:4]}...; one graph's prediction and "
        f"{len(grads)} gradients vs the CPU, max abs err {err:.3e} (bound "
        f"1e-4*max(1,max|cpu|)); BatchLearn Momentum lr {lr:.3e} (loss_before,"
        f" loss_after) " + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in steps)
        + f"; cached request {req_s * 1e3:.2f} ms, cached step "
        f"{step_s[-1] * 1e3:.2f} ms (host clock, synced); the step's peak "
        f"device memory {peak:.1f} MB above the "
        f"{held / 1e6:.1f} MB held")


def no_kernel_launched(phase, before):
    """Raise unless no kernel counter moved since ``before``: the JAX
    package runs these families without Pallas."""
    if kernel_counts() != before:
        raise AssertionError(f"{phase}: a TPU-kernel counterpart launched "
                             f"({before} -> {kernel_counts()})")


def er_requests(n, base_seed, nFeatures=4):
    """Two requests of GRAPHS_PER_REQUEST Erdos-Renyi graphs (p = ER_P) of
    n vertices."""
    from graphflow_tpu_torch.utils.datasets import random_graph

    return [[random_graph(n, ER_P, nFeatures=nFeatures,
                          seed=base_seed + GRAPHS_PER_REQUEST * r + i)
             for i in range(GRAPHS_PER_REQUEST)] for r in range(2)]


def phase_steerable():
    """Phase 16: the steerable family, served and trained on the card."""
    from graphflow_tpu_torch import models

    t0, before = time.perf_counter(), kernel_counts()
    regression = np.random.default_rng(SEED).normal(
        size=GRAPHS_PER_REQUEST).tolist()
    labels = [float(i % 3) for i in range(GRAPHS_PER_REQUEST)]
    names = ["SMP_2D", "SMP_2D_classification", "SMP_2D_ver2", "SMP_2D_ver3",
             "SMP_2D_ver4", "SMP_2D_ver4_classification", "SMP_2D_ver5",
             "Unrestricted_SMP_2D", "Unrestricted_SMP_2D_ver2"]
    for k, name in enumerate(names):
        kw = dict(STEERABLE)
        if name == "Unrestricted_SMP_2D_ver2":
            kw["max_nVertices"] = STEERABLE_4D_V
        if "classification" in name:
            kw["nClasses"] = 3
        model = getattr(models, name)(**kw, seed=SEED, device="cuda")
        cpu = getattr(models, name)(**kw, seed=SEED, device="cpu")
        requests = er_requests(kw["max_nVertices"], 1600 + 100 * k)
        text = serve_and_train(
            name, model, cpu, requests,
            labels if "classification" in name else regression,
            kw.get("nClasses"))
        channels = [model.cfg.channels_at(l)
                    for l in range(model.cfg.nLevels + 1)]
        cast = (", TENSORMUL cast"
                if model.cfg.filter in ("matrix", "unrestricted4d") else "")
        log(f"phase 16 steerable: {name} ({model.cfg.filter}, "
            f"V=P={model.cfg.P}, channels {channels}{cast}): {text}")
    no_kernel_launched("phase 16", before)
    log(f"phase 16 steerable: none of the seven kernels launched (the JAX "
        f"package runs this family without Pallas); "
        f"{time.perf_counter() - t0:.1f} s")


def as_dense(eg):
    """An edge-list graph as a DenseGraph, the dense route's input."""
    from graphflow_tpu_torch.core.graph import DenseGraph

    return DenseGraph.from_edges(eg.nVertices, eg.feature.shape[1], eg.edges,
                                 eg.feature)


def phase_gcn():
    """Phase 17: the GCN family, served and trained on the card."""
    from graphflow_tpu_torch import models
    from graphflow_tpu_torch.core import prep

    t0, before = time.perf_counter(), kernel_counts()
    targets = np.random.default_rng(SEED).normal(
        size=GRAPHS_PER_REQUEST).tolist()
    requests = er_requests(GCN["max_nVertices"], 1700)
    for r, gs in enumerate(requests):
        for i, g in enumerate(gs):
            # Geometric distances: points in the unit cube.
            x = np.random.default_rng(1800 + 10 * r + i).random(
                (g.nVertices, 3))
            g.distance = np.linalg.norm(x[:, None] - x[None], axis=-1)
    for name in ("GCN_1D", "GCN_2D", "GCN_3D", "GCN_1D_Distance",
                 "GCN_2D_Distance", "GCN_3D_Distance"):
        model = getattr(models, name)(**GCN, seed=SEED, device="cuda")
        cpu = getattr(models, name)(**GCN, seed=SEED, device="cpu")
        text = serve_and_train(name, model, cpu, requests, targets)
        log(f"phase 17 gcn: {name} (order {model.cfg.order}, "
            f"V={GCN['max_nVertices']}, H={GCN['nHiddens']}"
            f"{', radius uncapped' if model.cfg.uncapped_radius else ''}): "
            f"{text}")

    def one_hop(name, V, aggregation, device, nDepth=GCN["nDepth"]):
        kw = dict(ONE_HOP, max_nVertices=V, aggregation=aggregation,
                  seed=SEED, device=device)
        if name == "GCN_MW":
            kw["nDepth"] = 0 if aggregation == "ell" else nDepth
        return getattr(models, name)(**kw)

    edge_requests = [[edge_graph(ELL_V, 1900 + GRAPHS_PER_REQUEST * r + i)
                      for i in range(GRAPHS_PER_REQUEST)] for r in range(2)]
    t0 = time.perf_counter()
    for eg in edge_requests[0]:
        prep.prepare_graph_sparse(eg, ELL_V)
    prep_ms = (time.perf_counter() - t0) * 1e3 / GRAPHS_PER_REQUEST
    degree = np.mean([2 * len(eg.edges) / eg.nVertices
                      for eg in edge_requests[0]])
    for name in ("GCN_MW", "NeuralFingerprint"):
        for aggregation, V, reqs in (("dense", GCN["max_nVertices"],
                                      requests),
                                     ("ell", ELL_V, edge_requests)):
            model = one_hop(name, V, aggregation, "cuda")
            cpu = one_hop(name, V, aggregation, "cpu")
            sparse_before = prep.ROUTES["sparse"]
            text = serve_and_train(name, model, cpu, reqs, targets)
            if (prep.ROUTES["sparse"] > sparse_before) != (aggregation
                                                          == "ell"):
                raise AssertionError(f"{name} {aggregation}: prepared by "
                                     f"the wrong route")
            shape = f"V={V}, H={ONE_HOP['nHiddens']}" + (
                f", mean degree {degree:.2f}" if aggregation == "ell" else "")
            log(f"phase 17 gcn: {name} {aggregation} route ({shape}): "
                f"{text}")
        # Where both routes run: V = 1024, nDepth = 0.
        graphs = [edge_graph(BOTH_ROUTES_N, 2000 + i)
                  for i in range(GRAPHS_PER_REQUEST)]
        dense_graphs = [as_dense(g) for g in graphs]
        dense = one_hop(name, BOTH_ROUTES_V, "dense", "cuda", nDepth=0)
        ell = one_hop(name, BOTH_ROUTES_V, "ell", "cuda")
        both = max(
            check_close(f"{name} ELL vs dense route",
                        ell.Threaded_Predict(graphs),
                        dense.Threaded_Predict(dense_graphs), 1e-5),
            check_close(f"{name} ELL vs dense loss",
                        ell.getLoss(graphs, targets),
                        dense.getLoss(dense_graphs, targets), 1e-5))
        log(f"phase 17 gcn: {name} at V={BOTH_ROUTES_V} (graphs of "
            f"{BOTH_ROUTES_N} vertices), nDepth=0: the ELL route against the "
            f"dense one, max abs err {both:.3e} (bound 1e-05*max(1,"
            f"max|dense|)) ok")
    log(f"phase 17 gcn: prepare_graph_sparse from an edge list at V={ELL_V} "
        f"(mean degree {degree:.2f}): {prep_ms:.2f} ms a graph (host clock)")
    no_kernel_launched("phase 17", before)
    log(f"phase 17 gcn: none of the seven kernels launched (the JAX package "
        f"runs this family without Pallas); {time.perf_counter() - t0:.1f} s")


def phase_large_field():
    """Phase 18: SMP_beta, whose receptive field is the whole graph, at
    V = P = 64 and full width (C = 32, two levels), in float32 and bfloat16,
    then SMP_beta_physics at V = 64 and the bank route at V = 64: fields
    whose maps one block does not hold, which the level kernels walk in row
    tiles.  Each model serves one request of 4 graphs (the bank route 3)
    and takes one BatchLearn step, counted; the request and the step's loss against the
    same model through the plain level on the card (its T is 8.6 GB in
    float32 at 4 graphs), the gradients of the batch against the sum of the
    plain level's per graph (its backward on 4 graphs would hold several
    times that)."""
    import torch
    from graphflow_tpu_torch.models import (SMP2D, SMP2DConfig, SMPPhysics,
                                            SMP_beta_physics)
    from graphflow_tpu_torch.models.smp2d import (
        fused_level, risi18_bank_level, risi18_bank_level_reference,
        smp2d_forward)
    from graphflow_tpu_torch.ops.losses import squared_loss
    from graphflow_tpu_torch.ops.risi_bank import (bank_backward_plan,
                                                   bank_plan, risi18_bank,
                                                   risi18_bank_backward)
    from graphflow_tpu_torch.ops.risi_level import (level_backward_plan,
                                                    risi18_level_reference)
    from graphflow_tpu_torch.utils.datasets import random_graph

    V, nL = BETA64["max_nVertices"], BETA64["nLevels"]
    targets = np.random.default_rng(SEED).normal(
        size=GRAPHS_PER_REQUEST).tolist()
    result = {"k1": 0, "k2": [0, 0], "k4": 0, "k5": [0, 0], "k0": [0, 0],
              "err": 0.0, "bank_err": 0.0}

    def beta(dtype):
        return SMP2D(SMP2DConfig(**BETA64, max_receptive_field=None,
                                 dtype=dtype), seed=SEED, device="cuda")

    def forward_of(model, level_fn):
        if isinstance(model, SMPPhysics):
            return lambda batch: model._forward(model.params, batch,
                                                level_fn=level_fn)[0]
        return lambda batch: smp2d_forward(model.params, batch, model.cfg,
                                           level_fn=level_fn)[0]

    def run(label, model, fresh, graphs, rtol, kernel_fn=fused_level,
            plain_fn=risi18_level_reference, bank=False):
        """Serve and step, counted; then the checks on a fresh copy."""
        if model.cfg.P != V:
            raise AssertionError(f"{label}: P={model.cfg.P}, expected {V}")
        reset_level_counts()
        risi18_bank.launches = 0
        risi18_bank_backward.sums_launches = 0
        risi18_bank_backward.launches = 0
        risi18_bank_backward.reduce_launches = 0
        tgts = targets[:len(graphs)]
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pred, req_s = synced_s(lambda: model.Threaded_Predict(graphs))
        step, step_s = synced_s(lambda: model.BatchLearn(graphs, tgts,
                                                         TRAIN_LR))
        peak = (torch.cuda.max_memory_allocated() - base) / 1e6
        levels = level_counts()
        banks = (risi18_bank.launches, risi18_bank_backward.launches,
                 risi18_bank_backward.reduce_launches)
        sums = sums_counts()
        # A request: one forward; a step: a forward with its backward, then
        # the loss-only forward of loss_after.  Kernel 0 runs once a level's
        # backward where its plan is a cluster plan (the levels of 32 -> 32
        # channels; a physics tower's halved ones take the one-block row
        # tiles).
        sched = [model.cfg.channels_at(l) for l in range(nL + 1)]
        n = len(graphs) * V
        bwd_plan = bank_backward_plan if bank else level_backward_plan
        k0 = sum(bwd_plan(n, V, c, co, model.dtype)["cluster"] > 0
                 for c, co in zip(sched, sched[1:]))
        want = (3 * nL, nL, nL)
        got, other = (banks, levels) if bank else (levels, banks)
        if (got != want or any(other)
                or sums != ((0, k0) if bank else (k0, 0))):
            raise AssertionError(
                f"{label}: launches (forward, backward kernel 1, kernel 2) "
                f"{got}, expected {want}; the other route {other}; kernel "
                f"0 (K2's, K5's) {sums}")
        # The stream's route: every K1 launch and every K2 kernel 1 launch
        # on a cluster plan (those that launch kernel 0) took one tensor
        # copy a gathered row from the producer warp; the bank's stored
        # slots never do.
        routes = tma_counts()
        if bank:
            stored = [p["stream"] for c, co in zip(sched, sched[1:])
                      for p in (bank_plan(n, V, c, co, model.dtype),
                                bank_backward_plan(n, V, c, co,
                                                   model.dtype))]
            if any(r != "cp_async" for r in stored):
                raise AssertionError(f"{label}: K4, K5 routes {stored}")
        elif routes != (got[0], k0):
            raise AssertionError(
                f"{label}: launches on the tensor-copy route (K1, K2 kernel "
                f"1) {routes}, expected ({got[0]}, {k0})")
        # K2 kernel 1's scatter: the staged rows' tensor reduces on every
        # level whose plan names them (SMP_beta's cluster plans at P = 64,
        # both dtypes), the atomics elsewhere; none on the bank.
        staged = 0 if bank else sum(
            level_backward_plan(n, V, c, co, model.dtype)["scatter"]
            == "tma_reduce" for c, co in zip(sched, sched[1:]))
        if scatter_count() != staged or (label.startswith("SMP_beta ")
                                         and not bank
                                         and not 1 <= staged == k0):
            raise AssertionError(
                f"{label}: K2 kernel 1 launches on the staged scatter "
                f"{scatter_count()}, its plans name {staged}; cluster "
                f"plans {k0}")
        if not np.isfinite(step).all() or pred.shape != (len(graphs),):
            raise AssertionError(f"{label}: request {pred.shape}, step "
                                 f"{step}")
        plans = ""
        if bank:
            # The levels' plans for the batch's vertices: cluster plans.
            levels = [(bank_plan(n, V, c, co, model.dtype),
                       bank_backward_plan(n, V, c, co, model.dtype))
                      for c, co in zip(sched, sched[1:])]
            if not all(p["cluster"] >= 1 for pair in levels for p in pair):
                raise AssertionError(f"{label}: plans {levels}, expected "
                                     f"cluster plans for K4 and K5 kernel 1")
            plans = "; K4, K5 kernel 1 clusters per level " + ", ".join(
                f"{c}->{co}: {f['cluster']} x {f['tiles_per_block']}, "
                f"{b['cluster']} x {b['tiles_per_block']} tiles"
                for (c, co), (f, b) in zip(zip(sched, sched[1:]), levels))
        # The checks: the untrained copy through the plain level; errors
        # as a share of each check's scale.
        batch = fresh._stack(graphs, tgts)
        with torch.no_grad():
            ref = forward_of(fresh, plain_fn)(batch)
            err = check_rel(f"{label} request", pred, ref, rtol)
            ref_loss = squared_loss(ref, batch["target"])
            err = max(err, check_rel(f"{label} first step loss", step[0],
                                     ref_loss, rtol))
        del ref
        torch.cuda.empty_cache()
        # The step's gradients, on every graph of the batch through the
        # kernels (blocks of kernel 1 walk several vertices), against the
        # sum of the plain level's per graph (the loss is a sum over
        # graphs; the plain backward of the whole batch would hold several
        # times its 8.6 GB T).  A float32 model's plain gradients are taken
        # in float64 as well, and held against: the plain level in float32
        # can put an output near zero on the other side of LeakyReLU's kink
        # than the kernels and float64 do, which moves every gradient
        # upstream of it; its distance from float64 is printed.
        params = fresh.param_dict()

        def grads_of(fn, which):
            one = fresh._stack([graphs[i] for i in which],
                               [tgts[i] for i in which])
            loss = squared_loss(forward_of(fresh, fn)(one), one["target"])
            return torch.autograd.grad(loss,
                                       list(fresh.param_dict().values()))

        def plain_sum():
            total = [torch.zeros_like(x, dtype=torch.float64)
                     for x in kgrads]
            for i in range(len(graphs)):
                for r, x in zip(total, grads_of(plain_fn, [i])):
                    r += x.double()
                torch.cuda.empty_cache()
            return total

        kgrads = grads_of(kernel_fn, range(len(graphs)))
        in_f32 = fresh.dtype == torch.float32
        pgrads = plain_sum()
        drift = ""
        if in_f32:
            plain32 = pgrads
            fresh.double()
            pgrads = plain_sum()
            drift = (f"; the plain float32 level's gradients against "
                     f"float64: " + "%.3e" % max(
                         float((x - r).abs().max()) / max(
                             1.0, float(r.abs().max()))
                         for x, r in zip(plain32, pgrads))
                     + " of max(1,max|float64|)")
            del plain32
        for path, x, r in zip(params, kgrads, pgrads):
            err = max(err, check_rel(
                f"{label} gradient {path} ({len(graphs)} graphs, plain "
                f"{'float64' if in_f32 else 'bfloat16'})", x, r, rtol))
        del kgrads, pgrads
        torch.cuda.empty_cache()
        key = "bank_err" if bank else "err"
        result[key] = max(result[key], err)
        result["k0"] = [a + b for a, b in zip(result["k0"], sums)]
        if bank:
            result["k4"] += got[0]
            result["k5"] = [result["k5"][0] + got[1],
                            result["k5"][1] + got[2]]
        else:
            result["k1"] += got[0]
            result["k2"] = [result["k2"][0] + got[1],
                            result["k2"][1] + got[2]]
        log(f"phase 18 large field: {label} V=P={V} C={BETA64['nChanels']} "
            f"predictions {np.round(pred, 4).tolist()}, BatchLearn "
            f"({step[0]:.6f}, {step[1]:.6f}); launches {got} (= {nL} levels "
            f"x 3 forwards, 1 backward{plans}), kernel 0 "
            f"{sums[1] if bank else sums[0]}, stream "
            f"{'cp.async (stored slots)' if bank else 'tensor copies: '}"
            f"{'' if bank else f'{routes[0]} K1, {routes[1]} K2 kernel 1'}"
            f"{'' if bank else f', scatter tensor reduces {staged}'}; "
            f"request {1e3 * req_s:.1f} "
            f"ms, step "
            f"(prep uncached) {1e3 * step_s:.1f} ms (host clock, synced); "
            f"peak device memory of the request and step {peak:.1f} MB above "
            f"{base / 1e6:.1f} MB held; max err vs plain (request, first "
            f"loss, {len(params)} gradients of the batch against the sum "
            f"per graph) {err:.3e} of max(1,max|plain|) (bound {rtol:g}) "
            f"ok{drift}")

    graphs = [random_graph(V, ER_P, seed=1800 + i)
              for i in range(GRAPHS_PER_REQUEST)]
    for dtype, rtol in (("float32", RTOL), ("bfloat16", RTOL16)):
        run(f"SMP_beta {dtype}", beta(dtype), beta(dtype), graphs, rtol)
    pgraphs = [physics_graph(V, 1900 + i) for i in range(GRAPHS_PER_REQUEST)]

    def physics():
        return SMP_beta_physics(max_nVertices=V, nLevels=nL,
                                nChanels=BETA64["nChanels"],
                                nFeatures=PHYSICS["nFeatures"],
                                use_coulomb=True, seed=SEED, device="cuda")

    # (The physics model's own level for the kernels: level_fn=None.)
    run("SMP_beta_physics float32", physics(), physics(), pgraphs, RTOL,
        kernel_fn=None)

    # The bank route: the take-gather into T (6.4 GB at three graphs in
    # float32, 192 vertices: more than K5 kernel 1's 132 vertex groups),
    # then K4 and K5.
    def bank_model():
        return bank_route_model(seed=SEED, device="cuda", **BETA64,
                                max_receptive_field=None)

    run("SMP_beta bank route float32", bank_model(), bank_model(),
        graphs[:3], RTOL, kernel_fn=risi18_bank_level,
        plain_fn=risi18_bank_level_reference, bank=True)
    return result


# Phases 19-21: the pair models (SMP_omega_pairgraphs(64, 64, 16, 2, 32, 4,
# 4): V = 64, P = 16, towers 32 -> 16 -> 8, head 112 -> 56 -> 28), the other
# graph families at V = 64 and hidden 32, and the library models at the
# reference's sizes (MNIST-shaped inputs, random from a seed).
PAIR = dict(max_nVertices_1=64, max_nVertices_2=64, max_receptive_field=16,
            nLevels=2, nChanels=32, nFeatures_1=4, nFeatures_2=4)
BETA_PAIR_V = (24, 40)
GCN_KERNEL = dict(nLevels=2, max_nVertices=64, nFeatures=4, nHiddens=32,
                  nDepth=5, max_Radius=2)
ADAM_LR0 = 1e-3
SEQUENCE = dict(nFeatures=28, nHiddens=128, nClasses=10, max_nLevels=28)
IMAGES = 64


def pair_requests(V1, V2, base_seed):
    """Two requests of GRAPHS_PER_REQUEST pairs of Erdos-Renyi graphs
    (p = ER_P), each request ([graphs of tower 1], [graphs of tower 2])."""
    from graphflow_tpu_torch.utils.datasets import random_graph

    def graphs(V, seed):
        return [random_graph(V, ER_P, seed=seed + i)
                for i in range(GRAPHS_PER_REQUEST)]

    return [(graphs(V1, base_seed + 10 * r), graphs(V2, base_seed + 10 * r
                                                     + 5))
            for r in range(2)]


def pair_grads(model, g1, g2, targets, **kw):
    """(the loss, the gradients in param_order) of the pairs, through the
    model's own route or the one ``kw`` names (level_fn, case_mask)."""
    import torch

    batch = model._stack(g1, g2, targets)
    loss = model._loss(model.params, batch, **kw)
    return loss.detach(), torch.autograd.grad(
        loss, list(model.param_dict().values()))


def serve_and_train_pairs(what, model, ref, requests, targets, lr0,
                          n_steps=NEW_PHASE_STEPS, rtol=RTOL, **ref_kw):
    """Phase 19 for one pair model: two requests (Predict for each pair),
    counted, the first pair's prediction and gradients against ``ref`` (the
    same weights on the CPU, or on the card through the plain level,
    ``ref_kw``), then ``n_steps`` BatchLearn steps, counted, on the first
    request's pairs at the first rate of lr0 / 4^k that cuts the loss.
    -> (the text to log, K1/K2 launches while serving, while training, the
    largest error against the reference as a share of max(1,
    max|reference|))."""
    import torch

    reset_level_counts()
    preds = [[model.Predict(a, b) for a, b in zip(*req)] for req in requests]
    served = level_counts()
    if not np.isfinite(preds).all():
        raise AssertionError(f"{what}: non-finite predictions {preds}")
    (g1, g2), one = requests[0], slice(0, 1)
    with torch.no_grad():
        batch = ref._stack(g1[one], g2[one])
        err = check_rel(f"{what} first pair's prediction vs the reference",
                          preds[0][0], ref._forward(ref.params, batch,
                                                    **ref_kw)[0])
    _, grads = pair_grads(model, g1[one], g2[one], targets[one])
    _, ref_grads = pair_grads(ref, g1[one], g2[one], targets[one], **ref_kw)
    for path, x, r in zip(model.param_dict(), grads, ref_grads):
        err = max(err, check_rel(f"{what} gradient {path} vs the "
                                 f"reference", x, r, rtol))
    _, req_s = synced_s(lambda: [model.Predict(a, b)
                                 for a, b in zip(g1, g2)])

    lr = falling_lr(model, lambda lr: model.BatchLearn(g1, g2, targets, lr),
                    lr0, n_steps, every=True)
    reset_level_counts()
    steps, step_s = [], []
    for k in range(n_steps):
        if k == n_steps - 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        out, secs = synced_s(lambda: model.BatchLearn(g1, g2, targets, lr))
        steps.append(out)
        step_s.append(secs)
    trained = level_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 1e6
    if not (np.isfinite(steps).all() and all(b < a for a, b in steps)):
        raise AssertionError(f"{what}: the loss did not fall: {steps}")
    shown = np.round(np.asarray(preds, np.float64).reshape(-1), 4).tolist()
    return (
        f"predictions {shown[:4]}...; the first pair's prediction and "
        f"{len(grads)} gradients vs the reference, max err {err:.3e} of "
        f"max(1,max|ref|) (bound {rtol:g}); BatchLearn lr {lr:.3e} "
        f"(loss_before, loss_after) "
        + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in steps)
        + f"; cached request ({len(g1)} Predict) {req_s * 1e3:.2f} ms, "
        f"cached step {step_s[-1] * 1e3:.2f} ms (host clock, synced); the "
        f"step's peak device memory {peak:.1f} MB above the "
        f"{held / 1e6:.1f} MB held"), served, trained, err


def phase_pairs():
    """Phase 19: the pair models on the card.  SMP_omega_pairgraphs at full
    width serves two requests and takes three steps through K1 and K2
    (counted), against the same weights in float64 on the CPU; sigma's
    masked towers against the plain masked level; beta pairs at V1 = 24,
    V2 = 40 (P = 40 > V1: row-tiled) against the plain level in float64 on
    the card; gamma, theta, CCN_1D and the GCN kernels against the same
    model on the CPU, with no kernel launched.  -> (K1 launches, [K2
    kernel 1, kernel 2] launches, the largest error of the kernels' paths,
    as a share of max(1, max|reference|))."""
    import torch
    from graphflow_tpu_torch import models
    from graphflow_tpu_torch.models.smp2d import case_mask_level_reference
    from graphflow_tpu_torch.ops.contractions import dropout_case_mask
    from graphflow_tpu_torch.ops.risi_level import (level_backward_plan,
                                                    level_plan,
                                                    risi18_level_reference)

    nL, towers = PAIR["nLevels"], 2
    targets = np.random.default_rng(SEED).normal(
        size=GRAPHS_PER_REQUEST).tolist()
    k1, k2 = 0, [0, 0]
    t0 = time.perf_counter()

    def count(what, served, trained, n_predict, n_steps):
        """The launches a path must make: K1 once per level and tower per
        forward (a Predict, a step's two), K2 once per backward."""
        nonlocal k1
        want_served = (towers * nL * n_predict, 0, 0)
        want_trained = (towers * nL * 2 * n_steps, towers * nL * n_steps,
                        towers * nL * n_steps)
        if served != want_served or trained != want_trained:
            raise AssertionError(
                f"{what}: launches (K1, K2 kernel 1, K2 kernel 2) serving "
                f"{served}, training {trained}; expected {want_served}, "
                f"{want_trained}")
        k1 += served[0] + trained[0]
        k2[0] += trained[1]
        k2[1] += trained[2]
        return (f"launches K1={served[0]} serving, K1={trained[0]} K2 "
                f"kernel 1={trained[1]} kernel 2={trained[2]} training (= "
                f"{towers} towers x {nL} levels x {n_predict} Predict, x 2 "
                f"forwards and 1 backward x {n_steps} steps)")

    # The slice at full width, against float64 on the CPU.
    omega = models.SMP_omega_pairgraphs(**PAIR, seed=SEED, device="cuda")
    cpu = models.SMP_omega_pairgraphs(**PAIR, seed=SEED,
                                      device="cpu").double()
    V = PAIR["max_nVertices_1"]
    requests = pair_requests(V, V, 1900)
    text, served, trained, err = serve_and_train_pairs(
        "SMP_omega_pairgraphs", omega, cpu, requests, targets, ADAM_LR0,
        n_steps=TRAIN_STEPS)
    worst = err
    launches = count("SMP_omega_pairgraphs", served, trained,
                     2 * GRAPHS_PER_REQUEST, TRAIN_STEPS)
    schedule = omega.cfg1.channel_schedule
    log(f"phase 19 pairs: SMP_omega_pairgraphs V={V} "
        f"P={omega.cfg1.P} towers {schedule} head "
        f"{2 * sum(schedule)}->{omega.head_dims[0]}->{omega.head_dims[1]} "
        f"(reference: the same weights in float64 on the CPU): {text}; "
        f"{launches}")

    # sigma: the kernels on the scaled K against the plain masked level.
    sigma = models.SMP_sigma_pairgraphs(*PAIR.values(), seed=SEED,
                                        device="cuda")
    mask = dropout_case_mask(torch.Generator().manual_seed(SEED), 9, True,
                             device="cuda")
    plain = functools.partial(case_mask_level_reference, 18, mask)
    g1, g2 = requests[1]
    reset_level_counts()
    loss, grads = pair_grads(sigma, g1, g2, targets, case_mask=mask)
    masked = level_counts()
    ref_loss, ref_grads = pair_grads(sigma, g1, g2, targets, case_mask=mask,
                                     level_fn=plain)
    want = (towers * nL, towers * nL, towers * nL)
    if masked != want:
        raise AssertionError(f"sigma masked step launches {masked}, "
                             f"expected {want}")
    k1, k2 = k1 + masked[0], [k2[0] + masked[1], k2[1] + masked[2]]
    err = check_rel("sigma masked loss vs the plain masked level", loss,
                    ref_loss)
    for path, x, r in zip(sigma.param_dict(), grads, ref_grads):
        err = max(err, check_rel(f"sigma gradient {path} vs the plain masked "
                                 f"level", x, r))
    reset_level_counts()
    steps = [sigma.BatchLearn(g1, g2, targets, ADAM_LR0 / 4)
             for _ in range(NEW_PHASE_STEPS)]
    stepped = level_counts()
    want = tuple(towers * nL * n * NEW_PHASE_STEPS for n in (2, 1, 1))
    if stepped != want or not np.isfinite(steps).all():
        raise AssertionError(f"sigma steps {steps}: launches {stepped}, "
                             f"expected {want}")
    k1, k2 = k1 + stepped[0], [k2[0] + stepped[1], k2[1] + stepped[2]]
    worst = max(worst, err)
    log(f"phase 19 pairs: SMP_sigma_pairgraphs (same widths) with the case "
        f"mask {mask.int().tolist()}: the masked loss and "
        f"{len(grads)} gradients through K1/K2 on the scaled K against the "
        f"plain masked level, max err {err:.3e} of max(1,max|plain|) ok; "
        f"launches (K1, K2 kernel 1, kernel 2) {masked}; BatchLearn with a "
        f"fresh mask each step (loss_before, loss_after) "
        + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in steps)
        + f", launches {stepped}")

    # beta pairs: P = max(V1, V2) = 40 for both towers, tower 1 has P > V.
    V1, V2 = BETA_PAIR_V
    beta_args = (V1, V2, PAIR["nLevels"], PAIR["nChanels"], 4, 4)
    beta = models.SMP_beta_pairgraphs(*beta_args, seed=SEED, device="cuda")
    ref = models.SMP_beta_pairgraphs(*beta_args, seed=SEED,
                                     device="cuda").double()
    text, served, trained, err = serve_and_train_pairs(
        "SMP_beta_pairgraphs", beta, ref, pair_requests(V1, V2, 1950),
        targets, ADAM_LR0, level_fn=risi18_level_reference)
    worst = max(worst, err)
    launches = count("SMP_beta_pairgraphs", served, trained,
                     2 * GRAPHS_PER_REQUEST, NEW_PHASE_STEPS)
    sched, P = beta.cfg1.channel_schedule, beta.cfg1.P
    N = GRAPHS_PER_REQUEST * P   # (the tiling does not depend on N)
    plans = {f"{c}->{co}": (level_plan(N, P, c, co)["tiled"],
                            level_backward_plan(N, P, c, co)["tiled"])
             for c, co in zip(sched, sched[1:])}
    log(f"phase 19 pairs: SMP_beta_pairgraphs V1={V1} V2={V2} P={P} towers "
        f"{sched}, row-tiled (K1, K2 kernel 1) per level {plans} "
        f"(reference: the plain level in float64 on the card): {text}; "
        f"{launches}")
    mid = time.perf_counter()

    # The torch-op towers: no kernel launched (the level counts are reset
    # per model, so they start from 0 here).
    reset_level_counts()
    before = kernel_counts()
    args = tuple(PAIR.values())
    others = [
        ("SMP_gamma_pairgraphs", lambda dev: models.SMP_gamma_pairgraphs(
            *args, seed=SEED, device=dev), ADAM_LR0),
        ("SMP_theta_pairgraphs", lambda dev: models.SMP_theta_pairgraphs(
            *args, seed=SEED, device=dev), ADAM_LR0),
        ("CCN_1D", lambda dev: models.CCN_1D(*args, seed=SEED, device=dev),
         ADAM_LR0)]
    for name in ("GCN_1D_Kernel", "GCN_2D_Kernel", "GCN_3D_Kernel"):
        others.append((name, lambda dev, n=name: getattr(models, n)(
            **GCN_KERNEL, seed=SEED, device=dev), None))
    for k, (name, make, lr0) in enumerate(others):
        model, cpu = make("cuda"), make("cpu")
        reqs = pair_requests(V, V, 2100 + 20 * k)
        if lr0 is None:                                  # Momentum
            g1, g2 = reqs[0]
            loss, grads = pair_grads(model, g1, g2, targets)
            norm2 = sum(float((g.double() ** 2).sum()) for g in grads)
            lr0 = 0.05 * float(loss) * len(g1) / norm2
        text, _, _, _ = serve_and_train_pairs(name, model, cpu, reqs,
                                              targets, lr0)
        shape = (f"GCN order {model.cfg.order}, H={model.cfg.nHiddens}"
                 if name.startswith("GCN") else
                 f"P={model.cfg1.P}, towers {model.cfg1.channel_schedule}")
        log(f"phase 19 pairs: {name} (V={V}, {shape}; reference: the same "
            f"model on the CPU): {text}")
    no_kernel_launched("phase 19 (gamma, theta, CCN_1D, GCN kernels)",
                       before)
    log(f"phase 19 pairs: gamma, theta, CCN_1D and the GCN kernels launched "
        f"none of the seven kernels; {mid - t0:.1f} s + "
        f"{time.perf_counter() - mid:.1f} s")
    return k1, k2, worst


def phase_graph_families():
    """Phase 20: GRU_GCN_1D/2D/3D, GCA_1D, CGCN_1D/2D and LCNN at V = 64 and
    hidden 32, each served and trained against the same model on the CPU
    (serve_and_train); no kernel launches (the JAX package runs these
    families without Pallas)."""
    from graphflow_tpu_torch import models

    t0, before = time.perf_counter(), kernel_counts()
    targets = np.random.default_rng(SEED).normal(
        size=GRAPHS_PER_REQUEST).tolist()
    V, nF, H, nD = (GCN["max_nVertices"], GCN["nFeatures"], GCN["nHiddens"],
                    GCN["nDepth"])
    makes = {
        name: (lambda dev, n=name: getattr(models, n)(**GCN, seed=SEED,
                                                      device=dev))
        for name in ("GRU_GCN_1D", "GRU_GCN_2D", "GRU_GCN_3D", "GCA_1D")}
    for name in ("CGCN_1D", "CGCN_2D"):
        makes[name] = (lambda dev, n=name: getattr(models, n)(
            GCN["nLevels"], V, nF, nD, seed=SEED, device=dev))
    makes["LCNN"] = lambda dev: models.LCNN(V, nF, 10, 2, H, H, H, seed=SEED,
                                            device=dev)
    for k, (name, make) in enumerate(makes.items()):
        model, cpu = make("cuda"), make("cpu")
        text = serve_and_train(name, model, cpu,
                               er_requests(V, 2200 + 100 * k), targets,
                               out_shape=(V, V) if name == "GCA_1D" else ())
        log(f"phase 20 graphs: {name} (V={V}, hidden {H}): {text}")
    no_kernel_launched("phase 20", before)
    log(f"phase 20 graphs: none of the seven kernels launched (the JAX "
        f"package runs these families without Pallas); "
        f"{time.perf_counter() - t0:.1f} s")


def phase_library():
    """Phase 21: LSTM and GRU (28 features, 128 hidden, 10 classes, a
    28-step sequence), MLP([784, 128, 10]) and CNN() on 64 images of 28 x 28,
    random from the seed: each against its twin on the CPU (the same seed),
    stepped with its default optimizer with the loss falling; no kernel
    launches."""
    import torch
    from graphflow_tpu_torch import models

    t0, before = time.perf_counter(), kernel_counts()
    rng = np.random.default_rng(SEED)
    xs = rng.normal(size=(SEQUENCE["max_nLevels"], SEQUENCE["nFeatures"]))
    ts = rng.integers(0, SEQUENCE["nClasses"], size=len(xs))
    for name in ("LSTM", "GRU"):
        model = getattr(models, name)(**SEQUENCE, seed=SEED, device="cuda")
        cpu = getattr(models, name)(**SEQUENCE, seed=SEED, device="cpu")
        loss, req_s = synced_s(lambda: model.getLoss(xs, ts))
        err = check_close(f"{name} loss vs the CPU", loss, cpu.getLoss(xs, ts))
        with torch.no_grad():
            logits = model._logits(model.params, model._inputs(xs))
            err = max(err, check_close(
                f"{name} logits vs the CPU", logits,
                cpu._logits(cpu.params, cpu._inputs(xs))))
        labels = model.Predict(xs)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        learned, learn_s = synced_s(lambda: model.Learn(xs, ts, 3, 0.1))
        peak = (torch.cuda.max_memory_allocated() - held) / 1e6
        err = max(err, check_close(f"{name} Learn vs the CPU", learned,
                                   cpu.Learn(xs, ts, 3, 0.1)))
        if not (np.isfinite(learned).all() and learned[1] < learned[0]):
            raise AssertionError(f"{name}: Learn did not cut the loss: "
                                 f"{learned}")
        log(f"phase 21 library: {name} ({SEQUENCE['nFeatures']} features, "
            f"{SEQUENCE['nHiddens']} hidden, {SEQUENCE['nClasses']} classes, "
            f"{len(xs)} steps): loss {loss:.6f}, labels {labels[:8].tolist()}"
            f"...; Learn(3 iterations, lr 0.1, Momentum, L1 clipping) "
            f"(first, best) ({learned[0]:.6f}, {learned[1]:.6f}); max abs "
            f"err vs the CPU {err:.3e} ok; cached getLoss {req_s * 1e3:.2f} "
            f"ms, Learn {learn_s * 1e3:.2f} ms (host clock, synced); its peak "
            f"device memory {peak:.1f} MB above the {held / 1e6:.1f} MB held")

    images = rng.random((IMAGES, 28, 28))
    labels = rng.integers(0, 10, size=IMAGES)
    for name, make, how in (
            ("MLP", lambda dev: models.MLP([784, 128, 10], seed=SEED,
                                           device=dev), "Momentum"),
            ("CNN", lambda dev: models.CNN(seed=SEED, device=dev), "SGD")):
        model, cpu = make("cuda"), make("cpu")
        xs_t = model._inputs(images)
        ys_t = torch.as_tensor(labels, device="cuda")

        def learn(lr):
            before = model.BatchLearn(images, labels, lr)
            with torch.no_grad():
                return before, float(model._batch_loss(model.params, xs_t,
                                                       ys_t))

        # From the rate that cuts the summed loss by 5 % in one step to
        # first order (no nBatch: lr0 |g|^2 = 0.05 loss).
        loss = model._batch_loss(model.params, xs_t, ys_t)
        grads = torch.autograd.grad(loss, list(model.param_dict().values()))
        lr0 = 0.05 * float(loss.detach()) / sum(
            float((g.double() ** 2).sum()) for g in grads)
        lr = falling_lr(model, learn, lr0, TRAIN_STEPS + 1, every=True)
        first = model.BatchLearn(images, labels, lr)
        err = check_close(f"{name} first loss vs the CPU", first,
                          cpu.BatchLearn(images, labels, lr))
        for path, p in model.param_dict().items():
            err = max(err, check_close(f"{name} {path} after a step vs the "
                                       f"CPU", p, cpu.param_dict()[path]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        steps, step_s = [], []
        for _ in range(TRAIN_STEPS):
            out, secs = synced_s(lambda: learn(lr))
            steps.append(out)
            step_s.append(secs)
        peak = (torch.cuda.max_memory_allocated() - held) / 1e6
        if not all(b < a for a, b in steps):
            raise AssertionError(f"{name}: the loss did not fall: {steps}")
        _, req_s = synced_s(lambda: model.Predict(images))
        accuracy = model.accuracy(images, labels)
        log(f"phase 21 library: {name} ({IMAGES} images 28x28, {how} lr "
            f"{lr:g}): "
            f"first-step loss and every parameter after it vs the CPU, max "
            f"abs err {err:.3e} ok; BatchLearn (loss_before, loss_after) "
            + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in steps)
            + f"; training accuracy {accuracy:.3f}; cached Predict of the "
            f"batch {req_s * 1e3:.2f} ms, cached step {step_s[-1] * 1e3:.2f} "
            f"ms (host clock, synced); a step's peak device memory "
            f"{peak:.1f} MB above the {held / 1e6:.1f} MB held")
    no_kernel_launched("phase 21", before)
    log(f"phase 21 library: none of the seven kernels launched; "
        f"{time.perf_counter() - t0:.1f} s")


# Phase 22: the full-width model on data x graph = 2 x 2 ranks (all on the
# one card over gloo), on graphs of its own.
PAR_MESH = {"data": 2, "graph": 2}
PAR_GRAPH_SEED = 3000
PAR_TIMED_STEPS = 5
# Phase 23: epochs of each example.
EXAMPLE_EPOCHS = 3


def reset_model_counts():
    """Zero the launch counts of K1, K2, K4 and K5."""
    from graphflow_tpu_torch.ops.risi_bank import (risi18_bank,
                                                   risi18_bank_backward)

    reset_level_counts()
    risi18_bank.launches = 0
    risi18_bank_backward.launches = 0
    risi18_bank_backward.reduce_launches = 0


def parallel_batch():
    """Phase 22's GRAPHS_PER_REQUEST Erdos-Renyi graphs at the full width,
    and their targets."""
    from graphflow_tpu_torch.utils.datasets import random_graph

    graphs = [random_graph(MODEL["max_nVertices"], ER_P,
                           seed=PAR_GRAPH_SEED + i)
              for i in range(GRAPHS_PER_REQUEST)]
    return graphs, np.random.default_rng(SEED).normal(size=len(graphs))


def parallel_rank(rank, device):
    """Phase 22 on one rank of the data x graph mesh: a data-parallel step
    over "data" (2 ranks a group), the partitioned forward with both halos
    and the partitioned train step over both axes, each counted.  A step
    with SGD at lr = nBatch moves every parameter by exactly its summed
    gradient (nBatch is a power of two), which the parent holds against
    the references; the Adam steps are the optimizer's own."""
    import torch
    from graphflow_tpu_torch import parallel
    from graphflow_tpu_torch.models import SMP_omega
    from graphflow_tpu_torch.ops import launch_counts
    from graphflow_tpu_torch.optim import make_optimizer
    from graphflow_tpu_torch.tools.profile_step import profile
    from graphflow_tpu_torch.utils.convert import unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = SMP_omega(**MODEL, seed=SEED, device=device)
    p0 = {k: v.detach().clone() for k, v in model.param_dict().items()}
    graphs, targets = parallel_batch()
    mesh = parallel.make_mesh(PAR_MESH)
    out = {"coords": mesh.coords}

    def counted(fn):
        reset_model_counts()
        res = fn()
        torch.cuda.synchronize()
        return res, launch_counts()

    def fresh():
        return {k: v.clone().requires_grad_() for k, v in p0.items()}

    def moved(params):
        return {k: (p0[k] - params[k].detach()).cpu() for k in p0}

    def kept(params):
        return {k: v.detach().cpu() for k, v in params.items()}

    sgd = make_optimizer("sgd")
    batch = parallel.shard_batch(model._stack(graphs, targets), mesh)
    step = parallel.make_dp_train_step(model._loss, sgd, mesh, "data")
    (params, _, loss), n = counted(
        lambda: step(fresh(), (), batch, float(len(graphs))))
    out["dp_sgd"] = (float(loss), moved(params), n)
    step = parallel.make_dp_train_step(model._loss, model.opt, mesh, "data")
    (params, _, loss), n = counted(
        lambda: step(fresh(), model.opt.init(p0), batch, TRAIN_LR))
    out["dp_adam"] = (float(loss), kept(params), n)

    plan = parallel.plan_partition_batch([model.prepare(g) for g in graphs],
                                         PAR_MESH["graph"])
    inputs = parallel.shard_inputs(plan, mesh, device=device)
    for halo in ("targeted", "all_gather"):
        fwd = parallel.make_partitioned_forward(model.cfg, plan, mesh,
                                                halo=halo, device=device)
        with torch.no_grad():
            (pred, feat), n = counted(lambda: fwd(unflatten(p0), inputs))
        out[("forward", halo)] = (pred.cpu(), feat.cpu(), n)
    step = parallel.make_partitioned_train_step(model.cfg, plan, sgd, mesh,
                                                device=device)
    (params, _, loss), n = counted(
        lambda: step(fresh(), (), inputs, targets, float(plan.batch)))
    out["part_sgd"] = (float(loss), moved(params), n)
    adam = make_optimizer("adam")
    step = parallel.make_partitioned_train_step(model.cfg, plan, adam, mesh,
                                                device=device)
    params = fresh()
    (params, state, loss), n = counted(
        lambda: step(params, adam.init(params), inputs, targets, TRAIN_LR))
    out["part_adam"] = (float(loss), kept(params), n)

    # The step's wall on the host clock (every rank), then one profiled
    # step on rank 0 (device busy and kernels; the others step beside it).
    def one_step():
        nonlocal params, state
        params, state, _ = step(params, state, inputs, targets, TRAIN_LR)

    walls = [synced_s(one_step)[1] for _ in range(PAR_TIMED_STEPS)]
    out["walls"] = walls
    out["profile"] = profile(one_step, 1) if rank == 0 else None
    if rank:
        synced_s(one_step)
    return out


def phase_parallel():
    """Phase 22 (module docstring); returns the ranks' summed launches,
    the largest error as a share of its scale, and K4's and K5's times at
    the partition's shape."""
    import torch
    from graphflow_tpu_torch import parallel
    from graphflow_tpu_torch.models import SMP_omega
    from graphflow_tpu_torch.models.smp2d import (risi18_bank_level,
                                                  smp2d_forward)
    from graphflow_tpu_torch.ops.losses import squared_loss
    from graphflow_tpu_torch.ops.risi_bank import (
        _backward_main_kernel, risi18_bank, risi18_bank_backward,
        risi18_bank_reference)
    from graphflow_tpu_torch.ops.risi_level import risi18_level_reference
    from graphflow_tpu_torch.utils.convert import unflatten

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    world = int(np.prod(list(PAR_MESH.values())))
    backend, devices = parallel.placement(world)
    ranks = parallel.run_ranks(parallel_rank, world)
    spawned = time.perf_counter() - t0

    model = SMP_omega(**MODEL, seed=SEED, device="cuda")
    graphs, targets = parallel_batch()
    batch = model._stack(graphs, targets)
    plan = parallel.plan_partition_batch([model.prepare(g) for g in graphs],
                                         PAR_MESH["graph"])
    nL, P, C = MODEL["nLevels"], MODEL["max_receptive_field"], MODEL["nChanels"]
    blocks = int(plan.n_interior > 0) + int(plan.n_interior < plan.Vs)

    def reference(level_fn, dtype):
        p = {k: v.detach().to(dtype).requires_grad_()
             for k, v in model.param_dict().items()}
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
        pred, feat = smp2d_forward(unflatten(p), b, model.cfg,
                                   level_fn=level_fn, training=True)
        loss = squared_loss(pred, b["target"])
        grads = torch.autograd.grad(loss, list(p.values()))
        return {"pred": pred.detach(), "feat": feat.detach(),
                "loss": loss.detach(), "grads": dict(zip(p, grads))}

    # The single-process step (the fused level, K1 and K2), the unsharded
    # bank route (K4 and K5, as the partition) and the plain level in
    # float64.
    refs = {"single": reference(None, torch.float32),
            "bank": reference(risi18_bank_level, torch.float32),
            "plain64": reference(risi18_level_reference, torch.float64)}
    # Each rank's largest error as a share of max(1, max|ref|).
    rel = [0.0] * world

    def hold(what, got, ref):
        r = int(what.split()[1])
        rel[r] = max(rel[r], check_rel(f"phase 22 {what}", got, ref))

    def expect(what, n, **want):
        want = {k: want.get(k, 0) for k in n}
        if n != want:
            raise AssertionError(f"phase 22 {what}: launches {n}, expected "
                                 f"{want}")

    one = {"K1": nL, "K2": nL, "K2r": nL}
    banked = {"K4": nL * blocks, "K5": nL * blocks, "K5r": nL * blocks}
    launches = {k: 0 for k in ranks[0]["dp_sgd"][2]}
    for r, out in enumerate(ranks):
        d = out["coords"]["data"]
        share = slice(2 * d, 2 * d + 2)
        for name in ("dp_sgd", "dp_adam", "part_sgd", "part_adam",
                     ("forward", "targeted"), ("forward", "all_gather")):
            for k, v in out[name][-1].items():
                launches[k] += v
        loss, grads, n = out["dp_sgd"]
        expect(f"rank {r} DP step", n, **one)
        expect(f"rank {r} DP Adam step", out["dp_adam"][2], **one)
        hold(f"rank {r} DP loss", loss, refs["single"]["loss"])
        hold(f"rank {r} DP Adam loss", out["dp_adam"][0],
             refs["single"]["loss"])
        for k, g in grads.items():
            hold(f"rank {r} DP gradient {k}", g, refs["single"]["grads"][k])
        for halo in ("targeted", "all_gather"):
            pred, feat, n = out[("forward", halo)]
            # all_gather runs every vertex against the gathered rows.
            expect(f"rank {r} {halo} forward", n,
                   K4=nL * (blocks if halo == "targeted" else 1))
            for ref in ("bank", "plain64"):
                hold(f"rank {r} {halo} prediction vs {ref}", pred,
                     refs[ref]["pred"][share])
                hold(f"rank {r} {halo} feature vs {ref}", feat,
                     refs[ref]["feat"][share])
        loss, grads, n = out["part_sgd"]
        expect(f"rank {r} partitioned step", n, **banked)
        expect(f"rank {r} partitioned Adam step", out["part_adam"][2],
               **banked)
        for ref in ("bank", "plain64"):
            hold(f"rank {r} partitioned loss vs {ref}", loss,
                 refs[ref]["loss"])
            hold(f"rank {r} partitioned Adam loss vs {ref}",
                 out["part_adam"][0], refs[ref]["loss"])
            for k, g in grads.items():
                hold(f"rank {r} partitioned gradient {k} vs {ref}", g,
                     refs[ref]["grads"][k])
    # Replicas: the DP groups (one per graph coordinate) and all four
    # ranks after the partitioned step hold the same bits.
    for name, same in (("dp_adam", lambda a, b: a["coords"]["graph"]
                        == b["coords"]["graph"]),
                       ("part_adam", lambda a, b: True)):
        for a in ranks:
            for b in ranks:
                if same(a, b) and not all(torch.equal(a[name][1][k],
                                                      b[name][1][k])
                                          for k in a[name][1]):
                    raise AssertionError(f"phase 22 {name}: replicas differ "
                                         f"after the step")

    # K4 and K5 at the partition's boundary block: a data share of graphs
    # times its rows.
    N = GRAPHS_PER_REQUEST // PAR_MESH["data"] * (plan.Vs - plan.n_interior)
    T, A, K, g = bank_inputs(N, P, C, C, SEED, torch.float32)
    leaves = [x.detach().requires_grad_() for x in (T, K)]
    plain_out = risi18_bank_reference(leaves[0], A, leaves[1])
    Z = risi18_bank(T, A, K)
    dT, dK = risi18_bank_backward(T, A, K, g)
    times = {
        "k4": {"ms": time_ms(lambda: risi18_bank(T, A, K)),
               "plain_ms": time_ms(lambda: risi18_bank_reference(T, A, K)),
               "bound": bound_ms(nbytes(T, A, K, Z),
                                 bank_factored_ops(N, P, C, C))},
        "k5": {"ms": time_ms(lambda: _backward_main_kernel(T, A, K, g)),
               "plain_ms": time_ms(lambda: torch.autograd.grad(
                   plain_out, leaves, g, retain_graph=True)),
               "bound": bound_ms(nbytes(T, A, K, g, dT, dK),
                                 bank_backward_factored_ops(N, P, C, C))}}
    busy_ms, rows = ranks[0]["profile"]
    kernel_ms = {key: sum(ms for name, ms, _ in rows if key in name)
                 for key in ("risi18_bank_kernel", "risi18_bank_bwd_kernel",
                             "sum_partial_rows")}
    walls = [statistics.median(out["walls"]) * 1e3 for out in ranks]
    log(f"phase 22 parallel: {world} ranks on {', '.join(devices)} over "
        f"{backend} (data x graph = {PAR_MESH['data']} x "
        f"{PAR_MESH['graph']}), spawned, run "
        f"and joined in {spawned:.1f} s; SMP_omega V={MODEL['max_nVertices']}"
        f" P={P} C={C} {nL} levels nDepth={MODEL['nDepth']}, "
        f"{len(graphs)} Erdos-Renyi graphs p={ER_P}")
    log(f"phase 22 parallel: plan Vs={plan.Vs}, interior prefix "
        f"{plan.n_interior}, shifts {plan.shift_sizes}; halo rows a shard "
        f"and level {plan.rows_targeted} targeted vs {plan.rows_allgather} "
        f"all_gather; per level (targeted max, mean; all_gather) "
        + ", ".join(f"({c['targeted_max']}, {c['targeted_mean']:.1f}; "
                    f"{c['allgather']})" for c in plan.comm_per_level))
    for r, out in enumerate(ranks):
        log(f"phase 22 parallel: rank {r} {out['coords']}: launches DP "
            f"{out['dp_sgd'][2]}, partitioned forward "
            f"{out[('forward', 'targeted')][2]}, partitioned step "
            f"{out['part_sgd'][2]}; DP loss {out['dp_sgd'][0]:.6f}, "
            f"partitioned loss {out['part_sgd'][0]:.6f} (references: single "
            f"{float(refs['single']['loss']):.6f}, bank route "
            f"{float(refs['bank']['loss']):.6f}, plain float64 "
            f"{float(refs['plain64']['loss']):.6f}); largest error "
            f"{rel[r]:.3e} of max(1, max|ref|)")
    log(f"phase 22 parallel: the DP step's loss and summed gradients vs the "
        f"single-process step (K1, K2), the partitioned forward (both "
        f"halos), loss and gradients vs the unsharded bank route (K4, K5) "
        f"and the plain level in float64: largest error {max(rel):.3e} of "
        f"max(1, max|ref|) (bound {RTOL:g}) ok; replicas bit-identical "
        f"after the Adam steps")
    log(f"phase 22 parallel: partitioned Adam step wall (host clock, synced, "
        f"median of {PAR_TIMED_STEPS}) per rank "
        + ", ".join(f"{w:.2f}" for w in walls)
        + f" ms; rank 0's device busy {busy_ms:.3f} ms a step, of it K4 "
        f"{kernel_ms['risi18_bank_kernel']:.3f} ms, K5 kernel 1 "
        f"{kernel_ms['risi18_bank_bwd_kernel']:.3f} ms, K5 kernel 2 "
        f"{kernel_ms['sum_partial_rows']:.3f} ms; top kernels "
        + ", ".join(f"{name[:60]} {ms:.3f} ms x{cnt:g}"
                    for name, ms, cnt in rows[:6]))
    for key, label in (("k4", "K4"), ("k5", "K5 kernel 1")):
        t = times[key]
        log(f"phase 22 parallel: {label} at the boundary block's shape "
            f"({N},{P},{C},{C}) float32: {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms by "
            f"{t['bound'][1]} (CUDA events behind a spin, 20 reps)")
    log(f"phase 22 parallel: launches over the ranks {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "rel": max(rel), "shape": [N, P, C, C],
            "times": times}


def phase_entry_examples():
    """Phase 23 (module docstring); returns the launches of K1, K2, K4 and
    K5 in this process and in the ranks."""
    import tempfile

    import torch
    from graphflow_tpu_torch import entry as port_entry
    from graphflow_tpu_torch.examples import (multichip_data_parallel,
                                              partitioned_training,
                                              permutation_invariance,
                                              train_mnist_cnn,
                                              train_smp_omega)
    from graphflow_tpu_torch.models import SMP_omega
    from graphflow_tpu_torch.models.smp2d import SMP2DConfig, smp2d_forward
    from graphflow_tpu_torch.ops import launch_counts
    from graphflow_tpu_torch.ops.risi_level import (risi18_level,
                                                    risi18_level_reference)
    from graphflow_tpu_torch.utils import checkpoint, profiling

    t0 = time.perf_counter()
    launches = {k: 0 for k in launch_counts()}

    def counted(what, fn, **want):
        reset_model_counts()
        res = fn()
        torch.cuda.synchronize()
        n = launch_counts()
        for k, v in n.items():
            launches[k] += v
        missing = [k for k in want if not n[k]]
        if missing:
            raise AssertionError(f"phase 23 {what}: {missing} launched no "
                                 f"time ({n})")
        return res, n

    def ranks_launched(what, reports, *kernels):
        for r, rep in enumerate(reports):
            for k, v in rep["launches"].items():
                launches[k] += v
            missing = [k for k in kernels if not rep["launches"][k]]
            if missing:
                raise AssertionError(f"phase 23 {what}: rank {r} launched "
                                     f"no {missing} ({rep['launches']})")
        return reports[0]["launches"]

    # entry(): SMP_omega(10, 4, 2, 16, 4, 5) on the toy molecules.
    fn, (params, batch) = port_entry.entry()
    with torch.no_grad():
        pred, n = counted("entry()", lambda: fn(params, batch), K1=True)
        plain, _ = smp2d_forward(params, batch, SMP2DConfig(
            max_nVertices=10, max_receptive_field=4, nLevels=2, nChanels=16,
            nFeatures=4, nDepth=5), level_fn=risi18_level_reference)
    err = check_close("phase 23 entry()", pred, plain)
    log(f"phase 23 entry: entry() forward {pred.cpu().numpy().round(4)} "
        f"(K1 {n['K1']} launches), max abs err vs the plain level "
        f"{err:.3e} ok")

    reports = port_entry.dryrun_multichip(4)
    n = ranks_launched("dryrun_multichip(4)", reports, "K1", "K2", "K4",
                       "K5")
    log("phase 23 entry: dryrun_multichip(4) ok on every rank: DP loss "
        f"{reports[0]['dp'][0]:.6f} vs one process {reports[0]['dp'][1]:.6f}"
        f", partitioned forward {reports[0]['forward'][0]:.6f} vs "
        f"{reports[0]['forward'][1]:.6f}, partitioned step loss "
        f"{reports[0]['train'][0]:.6f} vs {reports[0]['train'][1]:.6f}; "
        f"rank 0 launches {n}")

    losses, n = counted("train_smp_omega", lambda: train_smp_omega.main(
        EXAMPLE_EPOCHS), K1=True, K2=True)
    if not np.isfinite(losses).all():
        raise AssertionError(f"train_smp_omega: non-finite loss {losses}")
    gaps, _ = counted("permutation_invariance",
                      lambda: permutation_invariance.main(2), K1=True)
    if not (np.isfinite(gaps).all() and max(gaps) < 1e-3):
        raise AssertionError(f"permutation_invariance: gaps {gaps}")
    accuracy, _ = counted("train_mnist_cnn",
                          lambda: train_mnist_cnn.main(1))
    dp = multichip_data_parallel.main(EXAMPLE_EPOCHS)
    dp_n = ranks_launched("multichip_data_parallel", dp, "K1", "K2")
    part = partitioned_training.main(EXAMPLE_EPOCHS)
    part_n = ranks_launched("partitioned_training", part, "K4", "K5")
    for name, reports in (("multichip_data_parallel", dp),
                          ("partitioned_training", part)):
        if not np.isfinite([r["losses"] for r in reports]).all():
            raise AssertionError(f"{name}: a non-finite loss")
    log(f"phase 23 entry: examples for {EXAMPLE_EPOCHS} epochs: "
        f"train_smp_omega (loss_before, loss_after) "
        + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in losses)
        + f"; permutation_invariance L1 gaps {gaps}; train_mnist_cnn "
        f"(synthetic digits, 1 epoch) accuracy {accuracy}; "
        f"multichip_data_parallel losses {dp[0]['losses']} (rank 0 "
        f"launches {dp_n}); partitioned_training losses "
        f"{part[0]['losses']}, halo rows {part[0]['rows']} (rank 0 "
        f"launches {part_n})")

    # Checkpoints of a model on the card, and the timer on a K1 launch
    # (not counted: a measurement).
    model = SMP_omega(**MODEL, seed=SEED, device="cuda")
    params = model.param_dict()
    template = {k: torch.zeros_like(v) for k, v in params.items()}
    with tempfile.TemporaryDirectory() as d:
        for what, save, load in (("npz", checkpoint.save_npz,
                                  checkpoint.load_npz),
                                 ("pt", checkpoint.save_torch,
                                  checkpoint.load_torch)):
            path = f"{d}/params.{what}"
            save(path, params)
            back = load(path, template)
            if not all(back[k].device == params[k].device
                       and torch.equal(back[k], params[k]) for k in params):
                raise AssertionError(f"phase 23 {what} round trip differs")
    args = level_inputs(*LEVEL_SHAPES[0], SEED)
    stats = profiling.time_torch(risi18_level, *args, iters=20)
    reset_model_counts()
    if set(stats) != {"mean", "min", "max", "std"} or not stats["min"] > 0:
        raise AssertionError(f"phase 23 time_torch: {stats}")
    log(f"phase 23 entry: npz and torch.save round trips of the full-width "
        f"model on the card equal bit for bit; time_torch(K1 at "
        f"{LEVEL_SHAPES[0]}) " + ", ".join(
            f"{k} {v * 1e3:.4f} ms" for k, v in stats.items())
        + " (host clock, each call synchronised)")
    log(f"phase 23 entry: launches here and in the ranks {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# The op library that no model calls (phase 24), at a model's widths: sets
# of 64 vertices of 32 channels, a level's [P, P, C] = [16, 16, 32] maps,
# RisiLayer3D at D = 32, [256, 256] products, and the contraction banks at
# (B, N, C) = (256, 16, 32), Cout = 32.
OPLIB_V, OPLIB_P, OPLIB_C = 64, 16, 32
OPLIB_BANK = BANK_SHAPES[0]
OPLIB_DROPOUT_P = 0.3


class Fixed:
    """An input of an op library check that is not differentiated."""

    def __init__(self, value):
        self.value = value


def oplib_cases(rng, V=OPLIB_V, P=OPLIB_P, C=OPLIB_C):
    """{name: (function of the inputs, inputs)}: one or more checks of every
    function of ops/activations.py (dropout, masking, norm3d),
    ops/linalg.py and ops/reductions.py.  Inputs are float64 arrays, each
    differentiated unless ``Fixed``."""
    from graphflow_tpu_torch import ops

    def x(*shape):
        return rng.normal(size=shape)

    mask = (rng.random(V) < 0.8).astype(np.float64)
    ties = rng.integers(0, V, size=32 * V).astype(np.float64)
    seq = Fixed(rng.permutation(V)[:V // 2] + rng.random(V // 2) * 0.99)
    return {
        "masking": (ops.masking, [x(V, C), x(V, C)]),
        "norm3d": (ops.norm3d, [x(V, P, C)]),
        "dropout (eval)": (lambda t: ops.dropout(t, None, OPLIB_DROPOUT_P,
                                                 False), [x(V, C)]),
        "add": (ops.add, [x(V, C), x(V, C)]),
        "subtract": (ops.subtract, [x(V, C), x(V, C)]),
        "multiply": (ops.multiply, [x(V, C), x(V, C)]),
        "inner_product": (ops.inner_product, [x(V, C), x(V, C)]),
        "outer_product": (ops.outer_product, [x(V), x(C)]),
        "transpose": (ops.transpose, [x(4 * V, 4 * V)]),
        "scalar_matmul": (ops.scalar_matmul, [x(1), x(4 * V, 4 * V)]),
        "mat_vec_mul": (ops.mat_vec_mul, [x(4 * V, 4 * V), x(4 * V)]),
        "matmul": (ops.matmul, [x(4 * V, 4 * V), x(4 * V, 4 * V)]),
        "mat_tensor_mul": (ops.mat_tensor_mul, [x(P, P), x(P, P, C)]),
        "tensor_mat_mul": (ops.tensor_mat_mul, [x(P, P, C), x(P, P)]),
        "tensor_mul": (ops.tensor_mul, [x(P, P, C), x(P, P, C)]),
        "tensor4d_tensor3d_mul": (ops.tensor4d_tensor3d_mul,
                                  [x(P, P, C, C), x(P, P, C)]),
        "custom_matmul_tensor": (ops.custom_matmul_tensor,
                                 [x(C, C), x(P, P, C)]),
        "vector_broadcast_mat": (ops.vector_broadcast_mat, [x(C), x(P, P)]),
        "mat_broadcast_mat": (ops.mat_broadcast_mat, [x(C, C), x(P, P)]),
        "vector_add_matrix": (ops.vector_add_matrix, [x(C), x(V, C)]),
        "vector_add_tensor": (ops.vector_add_tensor, [x(C), x(P, P, C)]),
        "linear_gram": (ops.linear_gram, [x(V, C)]),
        "sum_components": (ops.sum_components, [x(V, C)]),
        "sum_vectors": (ops.sum_vectors, [x(V, C), mask]),
        "average_vectors": (ops.average_vectors, [x(V, C), mask]),
        "sum_matrices": (ops.sum_matrices, [x(V, P, C), mask]),
        "sum_tensor3d": (ops.sum_tensor3d, [x(V, P, P, C), mask]),
        "sum_rows": (ops.sum_rows, [x(V, C)]),
        "shrink_matrix": (lambda m: ops.shrink_matrix(m, 1), [x(V, C)]),
        "shrink_tensor": (ops.shrink_tensor, [x(P, P, C)]),
        "concat": (lambda a, b: ops.concat([a, b]), [x(V), x(P, C)]),
        "matrix_concat": (lambda a, b: ops.matrix_concat([a, b]),
                          [x(V, C), x(P, C)]),
        "tensor3d_concat": (lambda a, b: ops.tensor3d_concat([a, b]),
                            [x(P, P, C), x(P, P, 8)]),
        "tensor4d_concat": (lambda a, b: ops.tensor4d_concat([a, b]),
                            [x(P, P, P, C), x(P, P, P, 8)]),
        "stack_tensor3d": (lambda *t: ops.stack_tensor3d(list(t)),
                           [x(P, P, C) for _ in range(4)]),
        "shuffle_matrix": (ops.shuffle_matrix, [x(V, C), seq]),
        "sort_vector": (ops.sort_vector, [ties]),
        "kmax": (lambda v: ops.kmax(v, C), [ties]),
        "vertex_representation": (
            lambda f, w: ops.vertex_representation(f, w, 5, V),
            [x(C), x(C)]),
        "risi_layer_1d": (ops.risi_layer_1d, [x(V, C), mask]),
        "risi_layer_2d": (ops.risi_layer_2d, [x(V, C), mask]),
        "risi_layer_3d": (ops.risi_layer_3d, [x(V, C), mask]),
        "reshape2d": (lambda t: ops.reshape2d(t, V, P * C), [x(V, P, C)]),
        "reshape3d": (lambda t: ops.reshape3d(t, V, P, C), [x(V, P * C)]),
        "reshape4d": (lambda t: ops.reshape4d(t, V, P, P, C // P),
                      [x(V, P, C)]),
    }


def oplib_check(what, fn, inputs, device, dtype, rtol, seed):
    """fn on ``device`` in ``dtype`` against fn on the CPU in float64 on the
    same (rounded) values: the output and the gradient of every input not
    ``Fixed``, for one seeded cotangent.  Returns the largest error as a
    share of its scale (raises beyond rtol)."""
    import torch

    def leaves(dev, dt):
        out = []
        for v in inputs:
            fixed = isinstance(v, Fixed)
            t = torch.as_tensor(v.value if fixed else v).to(dtype)
            t = t.to(device=dev, dtype=dt)
            out.append(t if fixed else t.requires_grad_())
        return out

    card, host = leaves(device, dtype), leaves("cpu", torch.float64)
    got, ref = fn(*card), fn(*host)
    rel = check_rel(f"oplib {what} {dtype_name(dtype)}", got, ref, rtol)
    free = [i for i, v in enumerate(inputs) if not isinstance(v, Fixed)]
    if not ref.requires_grad:
        return rel
    g = torch.as_tensor(np.random.default_rng(seed).normal(
        size=tuple(ref.shape))).to(dtype)
    grads = [torch.autograd.grad(o, [x[i] for i in free], c,
                                 allow_unused=True)
             for o, x, c in ((got, card, g.to(device)),
                             (ref, host, g.double()))]
    for i, a, b in zip(free, *grads):
        if a is None and b is None:
            continue
        if a is None or b is None:
            raise AssertionError(f"oplib {what}: gradient {i} defined on "
                                 f"one side only")
        rel = max(rel, check_rel(f"oplib {what} {dtype_name(dtype)} "
                                 f"gradient {i}", a, b, rtol))
    return rel


def oplib_bank_cases(T, A, K, b):
    """{name: (function, inputs)} of the contraction engine and the banks
    held against it, over T [B, N, N, N, C], A [B, N, N], K [18C, Cout] and
    b [Cout] (NumPy float64)."""
    from graphflow_tpu_torch.ops import contractions as tc
    from graphflow_tpu_torch.ops import fused

    A = Fixed(A)
    return {
        "risi_contraction_10_spec": (tc.risi_contraction_10_spec, [T, A]),
        "risi_contraction_18_spec": (tc.risi_contraction_18_spec, [T, A]),
        "risi_contraction_50_spec": (tc.risi_contraction_50_spec, [T, A]),
        "risi_contraction_18_batched": (tc.risi_contraction_18_batched,
                                        [T, A]),
        "risi18_matmul_reference": (fused.risi18_matmul_reference,
                                    [T, A, K]),
        "smp2d_layer_fused": (fused.smp2d_layer_fused, [T, A, K, b]),
    }


def oplib_checks(device, rng, bank_shape=OPLIB_BANK, **widths):
    """Every op library check on ``device`` (float32, and bfloat16 for
    matmul) against the CPU in float64; returns {name: largest relative
    error}."""
    import torch

    errs = {}
    for i, (name, (fn, inputs)) in enumerate(oplib_cases(rng,
                                                         **widths).items()):
        errs[name] = oplib_check(name, fn, inputs, device, torch.float32,
                                 RTOL, SEED + i)
        if name == "matmul":
            errs["matmul bfloat16"] = oplib_check(
                name, fn, inputs, device, torch.bfloat16, RTOL16, SEED + i)
    N, P, C, Cout = bank_shape
    T = rng.normal(size=(N, P, P, P, C))
    A = rng.normal(size=(N, P, P))
    K = rng.normal(size=(18 * C, Cout)) / np.sqrt(18 * C)
    b = rng.normal(size=Cout)
    for i, (name, (fn, inputs)) in enumerate(
            oplib_bank_cases(T, A, K, b).items()):
        errs[name] = oplib_check(name, fn, inputs, device, torch.float32,
                                 RTOL, SEED + 100 + i)
    return errs


def phase_oplib():
    """Phase 24 (module docstring); returns K4's error against the spec
    engine as a share of its scale, its launches there and the times."""
    import torch
    from graphflow_tpu_torch import ops
    from graphflow_tpu_torch.models.gcn import GCN_MW, GCNMWConfig
    from graphflow_tpu_torch.ops import activations
    from graphflow_tpu_torch.ops import contractions as tc
    from graphflow_tpu_torch.ops import fused, losses
    from graphflow_tpu_torch.ops.risi_bank import risi18_bank

    t0 = time.perf_counter()
    before = kernel_counts()
    errs = oplib_checks("cuda", np.random.default_rng(SEED + 24))
    for name, err in errs.items():
        log(f"phase 24 oplib: {name} vs float64 on the CPU, values and "
            f"gradients: max err {err:.3e} of scale (bound "
            f"{RTOL16 if 'bfloat16' in name else RTOL:g}) ok")

    # The production banks and the fused product against the spec engine,
    # on the card: float32 against float64.
    N, P, C, Cout = OPLIB_BANK
    T, A, K, _ = bank_inputs(N, P, C, Cout, SEED + 24, torch.float32)
    T64, A64, K64 = T.double(), A.double(), K.double()
    for what, got, ref in (
            ("risi_contraction_10", lambda: tc.risi_contraction_10(T, A),
             lambda: tc.risi_contraction_10_spec(T64, A64)),
            ("risi_contraction_18", lambda: tc.risi_contraction_18(T, A),
             lambda: tc.risi_contraction_18_spec(T64, A64)),
            ("risi_contraction_50", lambda: tc.risi_contraction_50(T, A),
             lambda: tc.risi_contraction_50_spec(T64, A64)),
            ("risi18_matmul_fused", lambda: fused.risi18_matmul_fused(T, A, K),
             lambda: fused.risi18_matmul_reference(T64, A64, K64))):
        err = check_rel(f"oplib {what} vs the spec engine", got(), ref())
        errs[what + " vs spec"] = err
        log(f"phase 24 oplib: {what} (float32) vs the spec engine (float64) "
            f"at N,P,C={(N, P, C)}: max err {err:.3e} of scale ok")
    if not (losses.LOG_ZERO == -1e9 and GCN_MW(
            2, 64, 4, 32, 0, device="cuda").cfg == GCNMWConfig(2, 64, 4, 32,
                                                               0)):
        raise AssertionError("oplib: LOG_ZERO or GCN_MW.cfg")

    # Dropout from a CUDA generator: the keep rate, the same draw again, no
    # rescale, and a CPU generator refused.
    x = torch.ones(1024, 1024, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kept = ops.dropout(x, gen, OPLIB_DROPOUT_P, train=True)
    rate = float(kept.mean())
    again = ops.dropout(x, torch.Generator(device="cuda").manual_seed(SEED),
                        OPLIB_DROPOUT_P, train=True)
    if not (abs(rate - OPLIB_DROPOUT_P) < 2e-3 and torch.equal(kept, again)
            and set(kept.unique().tolist()) <= {0.0, 1.0}):
        raise AssertionError(f"oplib dropout: keep rate {rate}")
    try:
        ops.dropout(x, torch.Generator(), OPLIB_DROPOUT_P, train=True)
    except RuntimeError:
        pass
    else:
        raise AssertionError("oplib dropout drew a CUDA tensor's uniforms "
                             "from a CPU generator")
    u = torch.rand(x.shape, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(SEED))
    if not torch.equal(kept, activations.dropout_apply(x, u,
                                                       OPLIB_DROPOUT_P)):
        raise AssertionError("oplib dropout: not the mask of its uniforms")
    log(f"phase 24 oplib: dropout(p={OPLIB_DROPOUT_P}) from a CUDA "
        f"generator keeps {rate:.5f} of 1048576 entries, no rescale, the "
        f"same draw for the same seed; a CPU generator refused")
    no_kernel_launched("phase 24 oplib", before)

    # K4 against the spec engine's unfused product, a yardstick independent
    # of the factored plain bank of phase 7, at phase 7's tolerances.
    k4 = {}
    launches = risi18_bank.launches
    for dtype, rtol in ((torch.float32, RTOL), (torch.bfloat16, RTOL16)):
        Td, Ad, Kd, _ = bank_inputs(N, P, C, Cout, SEED + 24, dtype)
        got = risi18_bank(Td, Ad, Kd)
        ref = fused.risi18_matmul_reference(Td.double(), Ad.double(),
                                            Kd.double())
        k4[dtype_name(dtype)] = check_rel(
            f"K4 vs risi18_matmul_reference {dtype_name(dtype)}", got, ref,
            rtol)
        log(f"phase 24 oplib: K4 {dtype_name(dtype)} at {OPLIB_BANK} vs "
            f"risi18_matmul_reference (the spec engine in float64): max err "
            f"{k4[dtype_name(dtype)]:.3e} of scale (bound {rtol:g}) ok")
    launches = risi18_bank.launches - launches
    if launches != 2:
        raise AssertionError(f"phase 24 oplib: K4 launches {launches}, "
                             f"expected 2 (one a dtype)")

    ms = {"risi_contraction_18_spec":
          time_ms(lambda: tc.risi_contraction_18_spec(T, A)),
          "risi_contraction_18": time_ms(lambda: tc.risi_contraction_18(T, A)),
          "risi18_matmul_reference":
          time_ms(lambda: fused.risi18_matmul_reference(T, A, K)),
          "risi18_matmul_fused":
          time_ms(lambda: fused.risi18_matmul_fused(T, A, K)),
          "risi18_bank (K4)": time_ms(lambda: risi18_bank(T, A, K))}
    log(f"phase 24 oplib: median ms at N,P,C,Cout={OPLIB_BANK} float32 on "
        f"{card_line()}: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
        + " (CUDA events behind a spin, 20 reps)")
    log(f"phase 24 oplib: {len(errs)} checks, largest error "
        f"{max(errs.values()):.3e} of scale; {time.perf_counter() - t0:.1f} s")
    return {"err_spec": max(k4.values()), "launches_spec": launches,
            "spec_ms": ms, "err": max(errs.values())}


def main() -> None:
    t_start = time.perf_counter()
    name = phase_device()
    import_port()
    import torch

    from graphflow_tpu_torch.core import prep

    phase_build()
    level_errs, level_ms = phase_kernel()
    prep.ROUTES.clear()         # phases 4-17 prepare every graph natively
    serve_launches, slice_err = phase_slice()
    bwd_errs, bwd_ms = phase_backward()
    train_launches, train_err = phase_train()
    bank_errs, bank_ms = phase_bank()
    bf16 = phase_bf16()
    aligned_err, aligned_ms = phase_aligned()
    k7_launches, variants_err = phase_variants()
    ablate_errs, ablate_tables, ablate_launches, ablate_extra = phase_ablate()
    physics_k1, physics_k2, physics_err = phase_physics()
    phase_native_prep()
    per_bucket, bucket_launches, bucket_err = phase_bucketed()
    # Launches of phase 14 by kernel: one step per bucket, then fit_bucketed.
    bucketed = [sum(c[k] for c in per_bucket) + bucket_launches[k]
                for k in range(3)]
    phase_first_order()
    phase_steerable()
    phase_gcn()
    large = phase_large_field()
    pair_k1, pair_k2, pair_err = phase_pairs()
    phase_graph_families()
    phase_library()
    par = phase_parallel()
    ent = phase_entry_examples()
    oplib = phase_oplib()
    # Phases 22-23's launches, here and in the ranks, by kernel.
    spread = {k: par["launches"][k] + ent[k] for k in ent}
    routes = dict(prep.ROUTES)
    if set(routes) - {"native", "numpy_fo_degree", "sparse"} or not (
            routes.get("native") and routes.get("sparse")):
        raise AssertionError(f"phases 4-23 prepared graphs by routes "
                             f"{routes}: every one must be native but the "
                             f"sparse first-order route's fo_degree prep "
                             f"and the ELL route's prepare_graph_sparse")
    log(f"phase 13 native prep: phases 4-23 prepared {routes['native']} "
        f"graphs natively, {routes.get('numpy_fo_degree', 0)} on the NumPy "
        f"path with fo_degree (the sparse first-order route, NumPy in the "
        f"JAX package too) and {routes['sparse']} by prepare_graph_sparse "
        f"(the ELL route), none otherwise")
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
    # The row-tiled kernels add their times at SMP_beta's field (P = 64)
    # as "p64", per dtype, and phase 18's largest error of the models there
    # as a share of its scale, max(1, max|plain|), as "max_rel_err_p64"
    # (random weights give outputs of ~1e3 and losses of ~1e6-1e10).
    f32, b16 = "float32", "bfloat16"

    def p64(per_dtype, ms_key, plain_key, bound_key="bound"):
        return {"shape": list(LARGE_SHAPE), **{d: {
            "ms": per_dtype[d]["p64"][ms_key],
            "plain_ms": per_dtype[d]["p64"][plain_key],
            "bound_ms": per_dtype[d]["p64"][bound_key][0],
            "bound_by": per_dtype[d]["p64"][bound_key][1]}
            for d in (f32, b16)}}

    def sums_kernel(label, per_dtype, launches, replaces):
        """Kernel 0 of a backward's cluster plans at SMP_beta's field
        (phase 5 or 7), float32 with bfloat16 beside; its launches are
        phase 18's."""
        k = {d: per_dtype[d]["p64"]["sums"] for d in (f32, b16)}
        return kernel(f"backward_sums_kernel ({label}, kernel 0)",
                      "risi18_backward_block.cuh", replaces, launches,
                      max(k[d]["err"] for d in (f32, b16)), k[f32]["ms"],
                      k[f32]["plain_ms"], k[f32]["bound"],
                      shape=list(LARGE_SHAPE),
                      **in_bf16(k[b16]["ms"], k[b16]["plain_ms"],
                                k[b16]["bound"]))

    def partition(key):
        """A kernel's float32 numbers at phase 22's boundary block."""
        t = par["times"][key]
        return {"shape": par["shape"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1]}

    kernels = [
        kernel("risi18_level_kernel", "risi18_level.cu", fused + "526",
               serve_launches + train_launches[0] + physics_k1 + bf16["k1"]
               + bucketed[0] + large["k1"] + pair_k1 + spread["K1"],
               max(*level_errs.values(), slice_err, physics_err, bf16["err"],
                   bucket_err),
               level_ms[f32]["kernel"], level_ms[f32]["plain"],
               level_ms[f32]["bound"],
               **in_bf16(level_ms[b16]["kernel"], level_ms[b16]["plain"],
                         level_ms[b16]["bound"]),
               k3_shapes={d: {shape: {"ms": t["kernel"],
                                      "plain_ms": t["plain"],
                                      "bound_ms": t["bound"][0],
                                      "bound_by": t["bound"][1]}
                              for shape, t in level_ms[d]["k3"].items()}
                          for d in (f32, b16)},
               launches_bucketed=bucketed[0], launches_pairs=pair_k1,
               launches_parallel=spread["K1"],
               max_rel_err_pairs=pair_err, launches_p64=large["k1"],
               max_rel_err_p64=large["err"],
               p64=p64(level_ms, "kernel", "plain"),
               tiled_plan={d: level_ms[d]["p64"]["plan"]
                           for d in (f32, b16)}),
        kernel("risi18_level_bwd_kernel", "risi18_level_bwd.cu",
               fused + "767",
               train_launches[1] + physics_k2[0] + bf16["k2"][0]
               + bucketed[1] + large["k2"][0] + pair_k2[0] + spread["K2"],
               max(bwd_errs[f32]["dstate"], bwd_errs[b16]["dstate"],
                   train_err, physics_err, bf16["err"], bucket_err),
               bwd_ms[f32]["main"], bwd_ms[f32]["plain"],
               bwd_ms[f32]["bound"],
               **in_bf16(bwd_ms[b16]["main"], bwd_ms[b16]["plain"],
                         bwd_ms[b16]["bound"]),
               launches_pairs=pair_k2[0], max_rel_err_pairs=pair_err,
               launches_parallel=spread["K2"],
               launches_p64=large["k2"][0], max_rel_err_p64=large["err"],
               p64=p64(bwd_ms, "main", "plain"),
               p64_kernel1_ms={d: bwd_ms[d]["p64"]["kernel1"]
                               for d in (f32, b16)},
               tiled_plan={d: bwd_ms[d]["p64"]["plan"]
                           for d in (f32, b16)}),
        kernel("sum_partial_rows, finish_bf16_kernel (risi18_level_bwd)",
               "risi18_level_bwd.cu", fused + "767",
               train_launches[2] + physics_k2[1] + bf16["k2"][1]
               + bucketed[2] + large["k2"][1] + pair_k2[1] + spread["K2r"],
               max(bwd_errs[d][k] for d in (f32, b16) for k in ("dK", "db")),
               bwd_ms[f32]["reduce"], bwd_ms[f32]["plain_reduce"],
               bwd_ms[f32]["reduce_bound"],
               library_ms=bwd_ms[f32]["plain_reduce"],
               launches_parallel=spread["K2r"],
               **in_bf16(bwd_ms[b16]["reduce"], bwd_ms[b16]["plain_reduce"],
                         bwd_ms[b16]["reduce_bound"])),
        kernel("risi18_bank_kernel", "risi18_bank.cu", bank + "142",
               bf16["k4"] + large["k4"] + spread["K4"],
               max(bank_errs["Z"], bf16["bank_err"]),
               bank_ms[f32]["k4"], bank_ms[f32]["plain"],
               bank_ms[f32]["bound"],
               **in_bf16(bank_ms[b16]["k4"], bank_ms[b16]["plain"],
                         bank_ms[b16]["bound"]),
               launches_p64=large["k4"], max_rel_err_p64=large["bank_err"],
               p64=p64(bank_ms, "k4", "plain"),
               tiled_plan={d: bank_ms[d]["p64"]["plans"][0]
                           for d in (f32, b16)},
               launches_parallel=spread["K4"],
               max_rel_err_parallel=par["rel"],
               partition=partition("k4"),
               max_rel_err_spec=oplib["err_spec"],
               launches_spec=oplib["launches_spec"],
               spec_ms=oplib["spec_ms"]),
        kernel("risi18_bank_bwd_kernel", "risi18_bank_bwd.cu", bank + "330",
               bf16["k5"][0] + large["k5"][0] + spread["K5"],
               max(bank_errs["dT"], bf16["bank_err"]),
               bank_ms[f32]["main"], bank_ms[f32]["plain_bwd"],
               bank_ms[f32]["bwd_bound"],
               **in_bf16(bank_ms[b16]["main"], bank_ms[b16]["plain_bwd"],
                         bank_ms[b16]["bwd_bound"]),
               launches_p64=large["k5"][0],
               max_rel_err_p64=large["bank_err"],
               p64=p64(bank_ms, "main", "plain_bwd", "bwd_bound"),
               p64_kernel1_ms={d: bank_ms[d]["p64"]["kernel1"]
                               for d in (f32, b16)},
               tiled_plan={d: bank_ms[d]["p64"]["plans"][1]
                           for d in (f32, b16)},
               launches_parallel=spread["K5"],
               max_rel_err_parallel=par["rel"],
               partition=partition("k5")),
        sums_kernel("risi18_level_bwd", bwd_ms, large["k0"][0],
                    fused + "767"),
        sums_kernel("risi18_bank_bwd", bank_ms, large["k0"][1],
                    bank + "330"),
        kernel("sum_partial_rows (risi18_bank_bwd)", "risi18_bank_bwd.cu",
               bank + "330", bf16["k5"][1] + large["k5"][1] + spread["K5r"],
               bank_errs["dK"],
               bank_ms[f32]["reduce"], bank_ms[f32]["plain_reduce"],
               bank_ms[f32]["reduce_bound"],
               library_ms=bank_ms[f32]["plain_reduce"],
               launches_parallel=spread["K5r"],
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
        more = {"ms_float32": ablate_tables["float32"][0][mode],
                "p64": extra["p64"]}
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
