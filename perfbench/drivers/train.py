"""Closed-loop training, one trainer: ``GraphModel.BatchLearn`` on a batch
drawn without replacement from a pool prepared in set-up, the pool
reshuffled every epoch.

Set-up builds the model and drives it through the first steps that the
reference follows; the window takes the same object on from there.
"""

from __future__ import annotations

import math
import time

from perfbench import compare, graphs, harness
from perfbench.drivers import common
from perfbench.trace import Tracer

KIND = "train"
# A BatchLearn step computes the loss and its gradients, then the loss
# after the update: two forwards and a backward.
FORWARDS, BACKWARDS = 2, 1


def first_steps(spec, model, dense, targets, it):
    """The followed steps, the batches drawn from ``it`` -> (batches,
    losses before each, the first step's gradient as the program's
    optimizer took it, the parameters after the last)."""
    fam, lr = harness.family(spec), spec.traffic["learning_rate"]
    batches, losses, grad = [], [], None
    for k in range(spec.check["steps_followed"]):
        idx = next(it)
        loss, _ = model.BatchLearn([dense[i] for i in idx], targets[idx], lr)
        batches.append(idx)
        losses.append(loss)
        if k == 0:
            grad = fam.first_gradient(model, spec.config)
    after = {p: x.detach().double().cpu()
             for p, x in model.param_dict().items()}
    return batches, losses, grad, after


def follow(spec, pool, targets, batches, weights, dev, precision=None):
    """The family's reference's losses, first gradient and parameters
    after the followed steps."""
    cfg, chk, ref = spec.config, spec.check, harness.family(spec).REFERENCE
    steps = [([ref.prepare(*pool[i], cfg) for i in idx], targets[idx])
             for idx in batches]
    return ref.train(
        steps, weights, cfg, spec.traffic["learning_rate"],
        precision=precision or chk["reference"],
        block_elements=chk["block_elements"], device=dev)


def judge_steps(spec, prog, ref, weights):
    """(check, correct, the numbers only logged) of the followed steps:
    ``prog`` as ``first_steps`` returns it, ``ref`` as ``follow`` does."""
    w0 = {k: v.double().cpu() for k, v in weights.items()}

    def side(losses, grad, after):
        return {"losses": losses, "grad": grad,
                "change": {k: after[k] - w0[k] for k in w0}}

    numbers, logged = compare.training_numbers(side(*prog[1:]), side(*ref))
    harness.log("not compared: " + ", ".join(f"{k} {v!r}" for k, v in
                                             logged.items()))
    return harness.judge(numbers, spec.check["limits"]) + (logged,)


def run(spec, seed, seconds, trace, device, t0, hooks):
    t0 = time.perf_counter() if t0 is None else t0
    harness.call_hooks(hooks)
    dev = common.device_of(device)
    fam = harness.family(spec)
    cfg, tr = spec.config, spec.traffic
    common.build_kernels(fam, KIND, dev)
    pool, targets = graphs.make_pool(seed, tr)
    model, weights, dense, prep_s = common.model_and_pool(fam, cfg, seed,
                                                          dev, pool)
    it = common.batches_of(seed, tr)
    prog = first_steps(spec, model, dense, targets, it)
    common.sync(dev)
    common.settle()
    setup_s = time.perf_counter() - t0
    harness.log(f"setup_s {setup_s:.3f} (prep {prep_s:.3f} s for "
                f"{len(dense)} graphs)")

    steps, failed, window = 0, 0, []
    with Tracer(trace) as tracer, common.GcClock() as gc_clock:
        with tracer.window():
            w0 = time.perf_counter()
            while True:
                idx = next(it)
                with tracer.span("step"):
                    lb, la = model.BatchLearn([dense[i] for i in idx],
                                              targets[idx],
                                              tr["learning_rate"])
                steps += 1
                window.append(idx)
                failed += not (math.isfinite(lb) and math.isfinite(la))
                if time.perf_counter() - w0 >= seconds:
                    break
            common.sync(dev)
            window_s = time.perf_counter() - w0
    facts = common.device_facts(dev)
    harness.log(f"window {window_s:.3f} s, {steps} steps; loss "
                f"{prog[1][0]:.6g} at the first step, {lb:.6g} at the last")
    harness.log(gc_clock.line())
    del model, dense
    common.free(dev)

    t = time.perf_counter()
    check, correct, _ = judge_steps(
        spec, prog, follow(spec, pool, targets, prog[0], weights, dev),
        weights)
    harness.log(f"reference {time.perf_counter() - t:.3f} s")
    work = (common.window_work(fam, cfg, pool, window, FORWARDS, BACKWARDS)
            if trace else None)
    return dict(facts, count=1, kernels=fam.KERNELS, attempted=steps,
                failed=failed,
                correct=correct, check=check, setup_s=setup_s,
                window_s=window_s, kind=KIND, steps=steps,
                graphs=steps * tr["batch"], prep_s=prep_s,
                prep_graphs=len(pool), latencies_s=None,
                ranks=[{"trace": tracer.summary, "work": work,
                        "steps": steps}])
