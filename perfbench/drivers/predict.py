"""Closed-loop batch prediction, one caller: ``GraphModel.
Threaded_Predict`` on a request of graphs drawn without replacement from a
pool prepared in set-up, the pool reshuffled every epoch.  A request's
latency runs from the call to the returned NumPy array.

Once the window has closed, a sample of its requests, drawn from the
seed, is predicted again by the reference.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench import compare, graphs, harness
from perfbench.drivers import common
from perfbench.trace import Tracer

KIND = "predict"
FORWARDS, BACKWARDS = 1, 0
WARM_REQUESTS = 2


def reference_predictions(spec, pool, indices, weights, dev, precision=None):
    """The family's reference's predictions of the pool's graphs
    ``indices``."""
    chk, ref = spec.check, harness.family(spec).REFERENCE
    preps = [ref.prepare(*pool[i], spec.config) for i in indices]
    out = []
    step = chk["reference_graphs_per_call"]
    for k in range(0, len(preps), step):
        out.append(ref.predict(
            preps[k:k + step], weights, spec.config,
            precision=precision or chk["reference"],
            block_elements=chk["block_elements"], device=dev))
    return np.concatenate(out)


def sample(seed, n_requests, k):
    return np.sort(np.random.default_rng([seed, 6]).choice(
        n_requests, size=min(k, n_requests), replace=False))


def run(spec, seed, seconds, trace, device, t0, hooks):
    t0 = time.perf_counter() if t0 is None else t0
    harness.call_hooks(hooks)
    dev = common.device_of(device)
    fam = harness.family(spec)
    cfg, tr, chk = spec.config, spec.traffic, spec.check
    common.build_kernels(fam, KIND, dev)
    pool, _ = graphs.make_pool(seed, tr)
    model, weights, dense, prep_s = common.model_and_pool(fam, cfg, seed,
                                                          dev, pool)
    it = common.batches_of(seed, tr)
    for _ in range(WARM_REQUESTS):
        model.Threaded_Predict([dense[i] for i in next(it)])
    common.sync(dev)
    common.settle()
    setup_s = time.perf_counter() - t0
    harness.log(f"setup_s {setup_s:.3f} (prep {prep_s:.3f} s for "
                f"{len(dense)} graphs)")

    requests, answers, latencies = [], [], []
    with Tracer(trace) as tracer, common.GcClock() as gc_clock:
        with tracer.window():
            w0 = time.perf_counter()
            while True:
                idx = next(it)
                t = time.perf_counter()
                with tracer.span("request"):
                    out = model.Threaded_Predict([dense[i] for i in idx])
                latencies.append(time.perf_counter() - t)
                requests.append(idx)
                answers.append(out)
                if time.perf_counter() - w0 >= seconds:
                    break
            window_s = time.perf_counter() - w0
    facts = common.device_facts(dev)
    failed = sum(not np.isfinite(a).all() for a in answers)
    lat_ms = np.asarray(latencies) * 1e3
    harness.log(f"window {window_s:.3f} s, {len(requests)} requests; "
                f"latency median {np.median(lat_ms):.3f} ms, p95 "
                f"{np.percentile(lat_ms, 95):.3f} ms over "
                f"{len(lat_ms)} requests")
    harness.log(gc_clock.line())
    del model, dense
    common.free(dev)

    chosen = sample(seed, len(requests), chk["requests_checked"])
    idx = np.concatenate([requests[r] for r in chosen])
    prog = np.concatenate([answers[r] for r in chosen])
    t = time.perf_counter()
    ref = reference_predictions(spec, pool, idx, weights, dev)
    harness.log(f"reference {time.perf_counter() - t:.3f} s")
    check, correct = harness.judge(compare.prediction_numbers(prog, ref),
                                   chk["limits"])
    work = (common.window_work(fam, cfg, pool, requests, FORWARDS, BACKWARDS)
            if trace else None)
    return dict(facts, count=1, kernels=fam.KERNELS,
                attempted=len(requests), failed=failed,
                correct=correct, check=check, setup_s=setup_s,
                window_s=window_s, kind=KIND, steps=len(requests),
                graphs=len(requests) * tr["batch"], prep_s=prep_s,
                prep_graphs=len(pool), latencies_s=latencies,
                ranks=[{"trace": tracer.summary, "work": work,
                        "steps": len(requests)}])
