"""Where a cached training step and a cached request spend their time on
the card, for one model configuration after another.

For each named configuration, at the width ``chip_smoke.py`` drives (V=64,
P=16, C=32, two levels, 4 Erdos-Renyi graphs a batch, seeded weights), it
warms the model up (so that host preparation is cached and the kernels are
built), then prints
- the median wall milliseconds of 5 ``BatchLearn`` steps and of 5
  ``Threaded_Predict`` requests (host clock, each ended by a synchronise),
- from one ``torch.profiler`` run over 5 more of each: the device-busy
  milliseconds per step and per request (the sum of every device kernel's
  and copy's time) and the kernels that take most of it, with their
  launches per step or request,
- the peak device memory of one step above what the model holds.

Usage: python -m graphflow_tpu_torch.tools.profile_step [NAME ...]
Names: omega_f32, omega_bf16, omega_bf16_bank (the bank route over a
materialised T, ``level_fn=risi18_bank_level``: K4 serving, K4 and K5
training; ``tools/measure.py:bank_route_model``), ver6_f32, ver6_bf16,
ver7_f32, ver7_bf16, beta_f32 and beta_bf16 (``beta`` names both:
SMP_beta, whose field is the whole graph, at V = P = 64, C = 32, two
levels: K1 and K2 kernel 1 on their cluster plans), the first-order theta
(SMP_theta) and
theta_physics (SMP_theta_physics, channels 32, 16, 8, raw normal
features; Adam), and three models without a kernel of their own, with
Momentum: steerable (SMP_2D, uncapped: P = V = 64), gcn_3d (GCN_3D, H = 32,
max_Radius 2) and gcn_mw_ell (GCN_MW on the ELL route at V = 4096,
edge-list graphs of about 8 neighbours a vertex); and the models of
``chip_smoke.py`` phases 19-21 at their widths there (:data:`LATER`): the
pair models (a request is a Predict for each of 4 pairs, a step one
BatchLearn on them; omega_pairs, sigma_pairs and beta_pairs (V1 = 24,
V2 = 40) run the level kernels, and beta_pairs_bf16 is beta_pairs cast to
bfloat16 by ``.bfloat16()``), the other graph families (V = 64, hidden
32), LSTM and GRU (28 features, 128 hidden, a 28-step sequence: a request
is Predict, a step one Learn iteration) and MLP and CNN (64 images of
28 x 28: Predict and BatchLearn) (default: all).  Needs a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from graphflow_tpu_torch.tools.measure import (ADAM_LR, ER_P,
                                               FULL_WIDTH as MODEL, GRAPHS,
                                               MOMENTUM_LR, bank_route_model,
                                               edge_graph)

ROUNDS, TOP = 5, 8
# (contraction, dtype, optimizer, learning rate, through the bank route).
CONFIGS = {
    "omega_f32": (18, "float32", "adam", ADAM_LR, False),
    "omega_bf16": (18, "bfloat16", "adam", ADAM_LR, False),
    "omega_bf16_bank": (18, "bfloat16", "adam", ADAM_LR, True),
    "ver6_f32": (10, "float32", "momentum", MOMENTUM_LR, False),
    "ver6_bf16": (10, "bfloat16", "momentum", MOMENTUM_LR, False),
    "ver7_f32": (50, "float32", "momentum", MOMENTUM_LR, False),
    "ver7_bf16": (50, "bfloat16", "momentum", MOMENTUM_LR, False),
}
# SMP_beta at V = P = 64 (no receptive-field cap), Adam: name -> dtype.
BETA = {"beta_f32": "float32", "beta_bf16": "bfloat16"}
# The first-order models, float32, Adam: name -> (constructor, raw normal
# features in place of the one-hot ones).
FIRST_ORDER = {"theta": ("SMP_theta", False),
               "theta_physics": ("SMP_theta_physics", True)}
# Models without a kernel of their own (Momentum), and GCN_MW's vertices
# on the ELL route.
NO_KERNEL = ("steerable", "gcn_3d", "gcn_mw_ell")
ELL_V = 4096
# chip_smoke.py phases 19-21: name -> constructor in graphflow_tpu_torch.
# models; the pair models take SMP_omega_pairgraphs(64, 64, 16, 2, 32, 4,
# 4)'s arguments (beta its own), the graph families V = 64, hidden 32.
LATER = {"omega_pairs": "SMP_omega_pairgraphs",
         "sigma_pairs": "SMP_sigma_pairgraphs",
         "beta_pairs": "SMP_beta_pairgraphs",
         "beta_pairs_bf16": "SMP_beta_pairgraphs",
         "gamma_pairs": "SMP_gamma_pairgraphs",
         "theta_pairs": "SMP_theta_pairgraphs", "ccn_1d": "CCN_1D",
         "gcn_1d_kernel": "GCN_1D_Kernel", "gcn_2d_kernel": "GCN_2D_Kernel",
         "gcn_3d_kernel": "GCN_3D_Kernel", "gru_gcn_1d": "GRU_GCN_1D",
         "gru_gcn_2d": "GRU_GCN_2D", "gru_gcn_3d": "GRU_GCN_3D",
         "gca_1d": "GCA_1D", "cgcn_1d": "CGCN_1D", "cgcn_2d": "CGCN_2D",
         "lcnn": "LCNN", "lstm": "LSTM", "gru": "GRU", "mlp": "MLP",
         "cnn": "CNN"}
BETA_PAIR_V = (24, 40)


def _later(name):
    """(request, step) callables of a LATER model on the card, at the
    widths of chip_smoke.py phases 19-21 (seeded weights and inputs)."""
    from graphflow_tpu_torch import models
    from graphflow_tpu_torch.utils.datasets import random_graph

    ctor, V = getattr(models, LATER[name]), MODEL["max_nVertices"]
    C, F, D = MODEL["nChanels"], MODEL["nFeatures"], MODEL["nDepth"]
    rng = np.random.default_rng(0)
    targets = rng.normal(size=GRAPHS).tolist()

    def er(n, seed):
        return [random_graph(n, ER_P, seed=seed + i) for i in range(GRAPHS)]

    if name in ("lstm", "gru"):
        model = ctor(28, 128, 10, 28, seed=0, device="cuda")
        xs, ts = rng.normal(size=(28, 28)), rng.integers(0, 10, size=28)
        return (lambda: model.Predict(xs),
                lambda: model.Learn(xs, ts, 1, 0.1))
    if name in ("mlp", "cnn"):
        model = (ctor([784, 128, 10], seed=0, device="cuda")
                 if name == "mlp" else ctor(seed=0, device="cuda"))
        xs, ys = rng.random((64, 28, 28)), rng.integers(0, 10, size=64)
        return (lambda: model.Predict(xs),
                lambda: model.BatchLearn(xs, ys, 1e-4))
    V1, V2, lr = V, V, ADAM_LR
    if name.startswith("beta_pairs"):
        V1, V2 = BETA_PAIR_V
        model = ctor(V1, V2, 2, C, F, F, seed=0, device="cuda")
        if name.endswith("_bf16"):
            model = model.bfloat16()
    elif name.endswith("_pairs") or name == "ccn_1d":
        model = ctor(V, V, MODEL["max_receptive_field"], 2, C, F, F, seed=0,
                     device="cuda")
    elif name.startswith("cgcn"):
        model, lr = ctor(2, V, F, D, seed=0, device="cuda"), MOMENTUM_LR
    elif name == "lcnn":
        model, lr = (ctor(V, F, 10, 2, C, C, C, seed=0, device="cuda"),
                     MOMENTUM_LR)
    else:               # the GCN kernels and the GRU_GCN and GCA families
        model, lr = ctor(2, V, F, C, D, 2, seed=0, device="cuda"), MOMENTUM_LR
    if "_pairs" in name or name.endswith("_kernel") or name == "ccn_1d":
        g1, g2 = er(V1, 100), er(V2, 200)
        return (lambda: [model.Predict(a, b) for a, b in zip(g1, g2)],
                lambda: model.BatchLearn(g1, g2, targets, lr))
    graphs = er(V, 100)
    return (lambda: model.Threaded_Predict(graphs),
            lambda: model.BatchLearn(graphs, targets, lr))


def _no_kernel_family(name):
    """(model on the card, its graphs) of a NO_KERNEL name, at
    chip_smoke.py's phase 16 and 17 widths."""
    from graphflow_tpu_torch import models
    from graphflow_tpu_torch.utils.datasets import random_graph

    V = MODEL["max_nVertices"]
    er = [random_graph(V, ER_P, seed=100 + i) for i in range(GRAPHS)]
    if name == "steerable":
        return models.SMP_2D(V, 2, MODEL["nChanels"], MODEL["nFeatures"],
                             MODEL["nDepth"], seed=0, device="cuda"), er
    if name == "gcn_3d":
        return models.GCN_3D(2, V, MODEL["nFeatures"], MODEL["nChanels"],
                             MODEL["nDepth"], 2, seed=0, device="cuda"), er
    return (models.GCN_MW(2, ELL_V, MODEL["nFeatures"], MODEL["nChanels"], 0,
                          seed=0, aggregation="ell", device="cuda"),
            [edge_graph(ELL_V, 100 + i) for i in range(GRAPHS)])


def build(name):
    """(model on the card, its learning rate) of configuration ``name``."""
    from graphflow_tpu_torch import models

    if name in BETA:
        return models.SMP2D(models.SMP2DConfig(
            **MODEL | {"max_receptive_field": None}, dtype=BETA[name]),
            seed=0, device="cuda"), ADAM_LR
    if name in FIRST_ORDER:
        ctor, _ = FIRST_ORDER[name]
        if ctor == "SMP_theta":
            return models.SMP_theta(**MODEL, seed=0, device="cuda"), ADAM_LR
        return models.SMP_theta_physics(
            MODEL["max_nVertices"], MODEL["max_receptive_field"],
            MODEL["nLevels"], MODEL["nChanels"], MODEL["nFeatures"], seed=0,
            device="cuda"), ADAM_LR
    contraction, dtype, optimizer, lr, bank_route = CONFIGS[name]
    config = dict(MODEL, contraction=contraction, dtype=dtype,
                  optimizer=optimizer)
    return (bank_route_model(seed=0, device="cuda", **config) if bank_route
            else models.SMP2D(models.SMP2DConfig(**config), seed=0,
                              device="cuda")), lr


def device_time_us(event) -> float:
    """An averaged profiler event's own device time in microseconds (the
    attribute's name changed between torch versions)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def wall_ms(fn, rounds=ROUNDS):
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile(fn, rounds=ROUNDS):
    """(device-busy ms per call, [(kernel name, ms per call, launches per
    call)] by time) over ``rounds`` calls of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize()
    # Device events only: a host operator's entry repeats the time of the
    # kernels it launched.
    rows = [(e.key, device_time_us(e) / 1e3 / rounds, e.count / rounds)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_time_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def _workload(name):
    """(request, step) callables of configuration ``name``."""
    from graphflow_tpu_torch.utils.datasets import random_graph

    if name in LATER:
        return _later(name)
    if name in NO_KERNEL:
        (model, graphs), lr = _no_kernel_family(name), MOMENTUM_LR
    else:
        model, lr = build(name)
        graphs = [random_graph(MODEL["max_nVertices"], ER_P, seed=100 + i)
                  for i in range(GRAPHS)]
    if FIRST_ORDER.get(name, (None, False))[1]:
        rng = np.random.default_rng(0)
        for g in graphs:
            g.feature = rng.normal(size=g.feature.shape)
    targets = np.random.default_rng(0).normal(size=GRAPHS).tolist()
    return (lambda: model.Threaded_Predict(graphs),
            lambda: model.BatchLearn(graphs, targets, lr))


def report(name, out=print):
    request, step = _workload(name)

    for what, call in (("step", step), ("request", request)):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        wall = wall_ms(call)
        busy, rows = profile(call)
        out(f"{name} cached {what}: wall {wall:.3f} ms (median of {ROUNDS}, "
            f"host clock, synced); device busy {busy:.4f} ms per {what} "
            f"({100 * busy / wall:.0f} % of the wall)")
        for key, ms, count in rows[:TOP]:
            out(f"{name} {what}:   {ms:8.4f} ms  {count:5.1f} launches  "
                f"{key[:90]}")
        if what == "step":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            call()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 1e6
            out(f"{name} cached step: peak device memory {peak:.1f} MB above "
                f"the {base / 1e6:.1f} MB held")


def main(argv=None):
    known = (list(CONFIGS) + list(BETA) + list(FIRST_ORDER) + list(NO_KERNEL)
             + list(LATER))
    names = list(sys.argv[1:] if argv is None else argv) or known
    names = [n for name in names
             for n in (list(BETA) if name == "beta" else [name])]
    unknown = [n for n in names if n not in known]
    if unknown:
        raise SystemExit(f"unknown configuration {unknown}; known: {known}")
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step profiles CUDA work: no CUDA device "
                           "is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in names:
        report(name)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
