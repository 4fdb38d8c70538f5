"""The reduction of a profiler trace: busy time is the union of device
intervals inside the window, and an idle gap takes the name of the
innermost host operation that covers its middle."""

import types

from perfbench import trace


def event(name, device, start, dur, kind, thread=1):
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: types.SimpleNamespace(
            name=device), start_ns=lambda: start, duration_ns=lambda: dur,
        activity_type=lambda: kind, start_thread_id=lambda: thread)


def test_summarize():
    ev = [event(trace.WINDOW, "CPU", 0, 1000, "user_annotation"),
          event("perfbench.step", "CPU", 0, 1000, "user_annotation"),
          event("aten::copy_", "CPU", 100, 300, "cpu_op"),
          event("k_a", "CUDA", 50, 100, "kernel"),
          event("k_a", "CUDA", 120, 100, "kernel"),       # overlaps the first
          event("Memcpy HtoD (Pageable -> Device)", "CUDA", 400, 100,
                "gpu_memcpy"),
          event("perfbench.step", "CUDA", 0, 1000, "gpu_user_annotation"),
          event("k_b", "CUDA", 900, 300, "kernel")]       # cut at the window
    s = trace.summarize(ev)
    assert s["window_s"] == 1e-6
    assert abs(s["busy_s"] - (170 + 100 + 100) / 1e9) < 1e-15
    assert s["kernels"]["k_a"][0] == 2
    assert trace.match(s["kernels"], ("k_",)) == (3, (100 + 100 + 100) / 1e9)
    names = dict(s["idle_gaps"])
    assert abs(names["aten::copy_"] - 180e-9) < 1e-15    # 220-400 in copy_
    assert abs(names["perfbench.step"] - (50 + 400) / 1e9) < 1e-15


def test_no_window_no_summary():
    assert trace.summarize([event("k", "CUDA", 0, 10, "kernel")]) is None
