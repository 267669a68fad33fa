"""Each metric reader on canned timers and a canned profile, and the
reduction of a trace to busy time, device operations and idle gaps."""
import pytest

from kabench import harness, peaks, trace
from kabench.harness import RunData

SPEC = harness.load_spec()


def read(name, run):
    return harness.load_file(harness.ROOT / "kabench" / "metrics" / f"{name}.py",
                             f"t_{name.replace('.', '_')}").read(run)


def plan_run(trace_summary=None):
    recs = [{"ok": True, "t0": 0.1 * i, "t1": 0.1 * i + 0.08 + 0.001 * i,
             "timers": {"encode": 10.0 + i, "place": 5.0, "leadership": 16.0,
                        "decode": 40.0}} for i in range(20)]
    shapes = {"topics": 2000, "partitions": 100, "rf": 3, "brokers": 5000}
    return RunData(None, "plan", shapes, 12.5, 2.0, recs, trace_summary)


def sweep_run(trace_summary=None):
    recs = [{"ok": True, "t0": i, "t1": i + 0.9, "units": 256,
             "sweep": {"prep": 100.0, "compose": 0.0, "sweep": 800.0, "rescue": 4.0}}
            for i in range(4)]
    return RunData(None, "whatif", {}, 20.0, 4.0, recs, trace_summary)


def test_end_to_end_readers():
    run = plan_run()
    assert read("plan_ms", run) == pytest.approx(2.0e3 / 20)
    assert read("plan_tail_ms", run) == pytest.approx(80.0 + 0.95 * 19 * 1.0, rel=1e-6)
    assert read("setup_s", run) == 12.5
    assert read("scenarios_per_s", run) is None
    run = sweep_run()
    assert read("scenarios_per_s", run) == pytest.approx(4 * 256 / 4.0)
    assert read("plan_ms", run) is None and read("plan_tail_ms", run) is None


def test_plan_layer_readers():
    run = plan_run()
    assert read("encode_ms.plan", run) == pytest.approx(10.0 + 9.5)
    assert read("place_ms.plan", run) == 5.0
    assert read("leadership_ms.plan", run) == 16.0
    assert read("decode_ms.plan", run) == 40.0
    # K1's bytes at config 4 (the arithmetic PERF.md's kernel table keeps,
    # on the real rows: 5,728,000 B) over 3.35 TB/s, against 16 ms.
    assert peaks.leadership_bytes(2000, 100, 3, 5000) == 5_728_000
    assert read("leadership_roofline", run) == pytest.approx(
        100 * 5_728_000 / 3.35e12 / 0.016)
    assert read("device_idle_share.plan", run) is None
    for name in ("whatif_host_ms", "whatif_sweep_ms", "device_idle_share.whatif"):
        assert read(name, run) is None


def test_sweep_layer_readers():
    run = sweep_run({"busy_s": 1.0, "window_s": 4.0})
    assert read("whatif_host_ms", run) == 100.0
    assert read("whatif_sweep_ms", run) == 804.0
    assert read("device_idle_share.whatif", run) == pytest.approx(75.0)
    assert read("device_idle_share.plan", run) is None
    assert read("encode_ms.plan", run) is None


def test_every_metric_has_a_reader_that_agrees():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        mod = harness.load_file(harness.ROOT / "kabench" / "metrics" / f"{m['name']}.py",
                                f"s_{m['name'].replace('.', '_')}")
        assert mod.SOURCE == m["source"]
        assert getattr(mod, "MOVES", None) == m.get("moves")


class Ev:
    def __init__(self, name, start, dur, kind="cpu_op"):
        self._n, self._s, self._d, self._k = name, start, dur, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._k


def test_trace_reduction():
    ms = 1_000_000
    events = [
        Ev(trace.WINDOW, 0, 100 * ms, "user_annotation"),
        Ev(trace.REQUEST, 10 * ms, 40 * ms, "user_annotation"),
        Ev(trace.REQUEST, 60 * ms, 40 * ms, "user_annotation"),
        Ev(trace.REQUEST, 20 * ms, 7 * ms, "gpu_user_annotation"),  # the device copy
        Ev("k1", 20 * ms, 5 * ms, "kernel"),
        Ev("k1", 22 * ms, 5 * ms, "kernel"),       # overlaps: union 20-27
        Ev("copy", 70 * ms, 12 * ms, "gpu_memcpy"),
        Ev("aten::add", 30 * ms, 30 * ms, "cpu_op"),  # host work is not busy
        Ev("late", 99 * ms, 5 * ms, "kernel"),      # clipped to the window
    ]
    phases = [("plan", "end", [("encode", 10.0), ("decode", 20.0)]),
              ("plan", "end", [("encode", 10.0), ("decode", 20.0)])]
    out = trace.reduce_events(events, phases)
    assert out["busy_s"] == pytest.approx((7 + 12 + 1) * 1e-3)
    assert out["window_s"] == pytest.approx(0.1)
    assert out["device_ops"][0] == ["copy", pytest.approx(0.012)]
    assert dict(out["device_ops"])["k1"] == pytest.approx(0.010)
    idle = dict(out["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(0.1 - out["busy_s"])
    # Request 1 (10-50 ms): other 10-20, encode 20-30, decode 30-50; busy
    # 20-27. Request 2 (60-100): other 60-70, encode 70-80, decode 80-100;
    # busy 70-82 and 99-100.
    assert idle["harness/between_requests"] == pytest.approx(0.020)
    assert idle["plan/other"] == pytest.approx(0.020)
    assert idle["plan/encode"] == pytest.approx(0.003)
    assert idle["plan/decode"] == pytest.approx(0.020 + 0.017)
