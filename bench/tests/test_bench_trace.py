"""The trace reduction's ``ranges``: the program's own ``record_function``
ranges by name, with their host time inside the traced window, their count
and the device time of the work launched inside them; the reduction's
other keys as they were before ``ranges`` came."""
import pytest
from _tiny import run_tiny

from bench import trace
from bench.runners import deploy


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(corr, ts, kind, name, start, dur):
    call = "cudaMemcpyAsync" if kind == "gpu_memcpy" else "cudaLaunchKernel"
    return [_x("cuda_runtime", call, ts, 4, 1, corr), _x(kind, name, start, dur, 7, corr)]


# microseconds; the traced window is 0 .. 2000
EVENTS = [
    _x("user_annotation", "bench.window", 0, 2000),
    _x("user_annotation", "bench.region.update", 0, 100),
    _x("user_annotation", "bench.maybe_flush", 100, 900),
    _x("user_annotation", "easycrash.flush", 110, 880),
    _x("user_annotation", "easycrash.flush.mask", 120, 180),
    _x("user_annotation", "easycrash.arena.flush", 400, 500),
    _x("user_annotation", "easycrash.arena.mix", 450, 400),
    _x("user_annotation", "easycrash.writer", 100, 900, tid=2),  # launches none of these
    _x("user_annotation", "bench.maybe_flush", 1200, 300),
    _x("user_annotation", "easycrash.flush", 1200, 300),
    _x("user_annotation", "easycrash.restore", 1800, 500),       # ends past the window
    _x("user_annotation", "easycrash.late", 2100, 100),          # wholly past it
    *_launch(1, 20, "kernel", "k1", 30, 50),
    *_launch(2, 150, "kernel", "dirty_vec16_kernel<x>", 200, 5),
    *_launch(3, 310, "gpu_memcpy", "Memcpy DtoH", 320, 80),
    *_launch(4, 460, "kernel", "k2", 470, 10),                   # runs after arena.mix's launch
    *_launch(7, 1250, "kernel", "k2", 1300, 20),
    *_launch(8, 1260, "kernel", "k3", 1310, 20),                 # overlaps the one before
    *_launch(5, 1900, "gpu_memcpy", "Memcpy HtoD", 1910, 80),
    *_launch(6, 2100, "kernel", "k1", 2150, 10),                 # launched past the window
    _x("gpu_memset", "Memset", 60, 10),                          # no launch in the trace
]

# what the reduction gave on EVENTS before it had ``ranges``
PARENT = {
    "busy_s": 0.000265, "window_s": 0.002,
    "kernels": {"k1": {"seconds": 5.9999999999999995e-05, "count": 2},
                "dirty_vec16_kernel<x>": {"seconds": 4.9999999999999996e-06, "count": 1},
                "Memcpy DtoH": {"seconds": 7.999999999999999e-05, "count": 1},
                "k2": {"seconds": 2.9999999999999997e-05, "count": 2},
                "k3": {"seconds": 1.9999999999999998e-05, "count": 1},
                "Memcpy HtoD": {"seconds": 7.999999999999999e-05, "count": 1},
                "Memset": {"seconds": 9.999999999999999e-06, "count": 1}},
    "device_ops": [["Memcpy DtoH", 7.999999999999999e-05], ["Memcpy HtoD", 7.999999999999999e-05],
                   ["k1", 5.9999999999999995e-05], ["k2", 2.9999999999999997e-05],
                   ["k3", 1.9999999999999998e-05], ["Memset", 9.999999999999999e-06],
                   ["dirty_vec16_kernel<x>", 4.9999999999999996e-06]],
    "idle_gaps": [["maybe_flush", 0.001125], ["outside bench spans", 0.00074],
                  ["region.update", 2.9999999999999997e-05]],
}


def _ranges():
    return trace.reduce_events(EVENTS, 2e-3)["ranges"]


def test_every_other_key_as_before():
    r = trace.reduce_events(EVENTS, 2e-3)
    assert list(r) == list(PARENT) + ["ranges"]
    assert {k: v for k, v in r.items() if k != "ranges"} == PARENT


def test_nested_ranges_take_the_work_launched_inside_them():
    r = _ranges()
    assert not any(name.startswith("bench.") for name in r)
    # flush holds the mask (200..205), the copy (320..400) and arena.mix's
    # kernel (470..480); its second time two overlapping kernels (1300..1330)
    assert r["easycrash.flush"] == {"host_s": pytest.approx(1180e-6), "count": 2,
                                    "device_s": pytest.approx(125e-6)}
    assert r["easycrash.flush.mask"] == {"host_s": pytest.approx(180e-6), "count": 1,
                                         "device_s": pytest.approx(5e-6)}
    for name, host in (("easycrash.arena.flush", 500e-6), ("easycrash.arena.mix", 400e-6)):
        assert r[name] == {"host_s": pytest.approx(host), "count": 1,
                           "device_s": pytest.approx(10e-6)}


def test_ranges_clipped_to_the_window_and_kept_to_their_thread():
    r = _ranges()
    assert "easycrash.late" not in r
    # 1800..2000 of 1800..2300; the launch at 2100 is past the window
    assert r["easycrash.restore"] == {"host_s": pytest.approx(200e-6), "count": 1,
                                      "device_s": pytest.approx(80e-6)}
    assert r["easycrash.writer"] == {"host_s": pytest.approx(900e-6), "count": 1,
                                     "device_s": 0.0}
    assert trace.reduce_events([e for e in EVENTS if e["name"] != "bench.window"],
                               2e-3)["ranges"]["easycrash.late"]["count"] == 1


def test_tiny_traced_flush_reads_the_managers_ranges(monkeypatch):
    """On the CPU the profiler sees the port's ranges (no device work): the
    traced flush's ``easycrash.arena.flush`` time is the arena seconds the
    manager counted in it."""
    got = {}
    reduce, window = trace.Tracer.reduce, deploy.window

    def keep_reduce(self):
        got["trace"] = reduce(self)
        return got["trace"]

    def keep_window(s, seconds, tracer):
        got["rec"] = window(s, seconds, tracer)
        return got["rec"]

    monkeypatch.setattr(trace.Tracer, "reduce", keep_reduce)
    monkeypatch.setattr(deploy, "window", keep_window)
    out = run_tiny("heat-32768-flush8", 3.0, trace=True)
    assert out["correct"], out["checks"]
    ranges = got["trace"]["ranges"]
    flushes = [u for u in got["rec"]["units"] if u["traced"] and "arena_s" in u]
    assert flushes and ranges["easycrash.flush"]["count"] == len(flushes)
    assert ranges["easycrash.arena.flush"]["count"] >= len(flushes)  # one a leaf and the step
    assert ranges["easycrash.arena.flush"]["host_s"] == pytest.approx(
        sum(u["arena_s"] for u in flushes), abs=1e-3)
    assert all(row["device_s"] == 0.0 for row in ranges.values())
