"""Set-up and bookkeeping the traffic drivers share."""

from __future__ import annotations

import time

import numpy as np

from perfbench import counts, graphs, harness


def device_of(device):
    """The run's device: the card, or what a test names.  Products run in
    the configuration's float32: TF32 is off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(device or "cuda")


def build_kernels(fam, kind: str, dev) -> None:
    """Build (or find built) the family's kernel libraries that a driver
    of ``kind`` loads, and the native prep, before anything is timed as
    traffic."""
    from graphflow_tpu_torch.runtime import native

    if dev.type == "cuda":
        from graphflow_tpu_torch.runtime.cuda_build import build_libraries

        for r in build_libraries(fam.LIBRARIES[kind]):
            if r.rebuilt:
                harness.log(f"built {r.path.name} in {r.seconds:.1f} s")
    native.available()


def model_and_pool(fam, cfg, seed, dev, pool):
    """The program's model with the seed's weights, the pool as the
    program's graphs, and the host prep of the whole pool -> (model,
    weights, graphs, prep seconds)."""
    weights = fam.make_weights(cfg, seed, dev)
    model = fam.build_model(cfg, weights, dev)
    dense = [fam.program_graph(a, f) for a, f in pool]
    t = time.perf_counter()
    for g in dense:
        model.prepare(g)
    return model, weights, dense, time.perf_counter() - t


def device_facts(dev) -> dict:
    import torch

    if dev.type == "cuda":
        return {"platform": "gpu",
                "kind_name": torch.cuda.get_device_name(dev),
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind_name": "cpu", "memory_peak_bytes": 0}


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def settle() -> None:
    """The end of set-up: collect, then move every object set-up made (the
    pool, its prep, the model) out of the collector's sight, so that the
    window's collections scan only what the window makes."""
    import gc

    gc.collect()
    gc.freeze()


class GcClock:
    """The collector's passes and seconds while it is entered."""

    def __enter__(self):
        import gc

        self.passes, self.seconds, self._t = 0, 0.0, None
        gc.callbacks.append(self._tick)
        return self

    def _tick(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.passes += 1
            self.seconds += time.perf_counter() - self._t

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._tick)

    def line(self) -> str:
        return (f"garbage collector in the window: {self.passes} passes, "
                f"{self.seconds * 1e3:.3f} ms")


def free(dev) -> None:
    """Give back what the program held, set-up's objects included."""
    import gc

    import torch

    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def window_work(fam, cfg, pool, batch_list, forwards: int,
                backwards: int) -> dict:
    """The work of the window's batches: the sums of each level's least
    time by bytes and by operations (a forward and a backward), and the
    model's operations (``forwards`` and ``backwards`` a batch)."""
    elems = {}
    dt = cfg["dtype"]
    out = {"fwd": np.zeros(3), "bwd": np.zeros(3), "model_ops": 0.0,
           "batches": len(batch_list), "levels": cfg["nLevels"],
           "peak_flops": counts.PEAK_FLOPS[dt]}
    for idx in batch_list:
        for i in idx:
            if i not in elems:
                elems[i] = fam.graph_elements(cfg, pool[i][0])
        e = np.sum([elems[i] for i in idx], axis=0)
        w = fam.batch_work(cfg, len(idx), e)
        for key in ("fwd", "bwd"):
            for b, o in w[key]:
                by, op = counts.bound_s(b, o, dt)
                out[key] += (max(by, op), by, op)
        out["model_ops"] += (forwards * sum(o for _, o in w["fwd"])
                             + backwards * sum(o for _, o in w["bwd"]))
    out["fwd"], out["bwd"] = ({"bound_s": float(a[0]), "bytes_s": float(a[1]),
                               "ops_s": float(a[2])}
                              for a in (out["fwd"], out["bwd"]))
    return out


def batches_of(seed, traffic):
    return graphs.batches(seed, traffic["pool"], traffic["batch"])
