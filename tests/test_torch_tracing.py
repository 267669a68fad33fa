"""The port's tracing on the profiler's clock (``obs/trace.py``), on the CPU
unless marked:

- under ``torch.profiler`` every phase of a plan and of a what-if sweep is a
  ``ka/<name>`` label around exactly the interval its timer in
  ``TorchSolver.last_timers`` or ``whatif.last_sweep`` measures, in phase
  order, nested under ``ka/dispatch`` in a ``KA_OBS_PROFILE_DIR`` trace;
- with no profiler, no capture, no sink and no log a span is the shared
  no-op and takes no label path;
- ``report=False`` spans label and sink but stay out of the run report;
- the host time no span shows, under a profiler only: the collector's
  pauses (``gc``), placement's wait in device reads (``place_wait``) and
  the sweep's device reads (``syncs``, ``wait``), counted where they
  happen;
- a ``/debug/profile`` window records every thread: the dispatcher's
  packed call is a live label there;
- on the card (a ``cuda``-marked test), the labels of a traced solve are
  host events with no device-side copy, none of them device activity.
"""
from __future__ import annotations

import gc
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kafka_assigner_tpu_torch.assigner import TopicAssigner
from kafka_assigner_tpu_torch.daemon import dispatch
from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster
from kafka_assigner_tpu_torch.obs import profile as obs_profile
from kafka_assigner_tpu_torch.obs import trace
from kafka_assigner_tpu_torch.obs.profile import DISPATCH_LABEL
from kafka_assigner_tpu_torch.ops import assignment as tops
from kafka_assigner_tpu_torch.parallel import whatif

PLAN_PHASES = ("infer", "encode", "place", "leadership", "decode")
SWEEP_PHASES = ("ka/whatif/prep", "ka/whatif/chunk", "ka/whatif/compose",
                "ka/whatif/rescue_phase", "ka/whatif/rescue")
#: ``last_sweep``'s phase timers and the label around each one's interval.
SWEEP_TIMERS = {"prep": "ka/whatif/prep", "compose": "ka/whatif/compose",
                "rescue": "ka/whatif/rescue_phase"}
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    for knob in ("KA_OBS_PROFILE_DIR", "KA_PROFILE", "KA_OBS_ENABLE", "KA_OBS_REPORT",
                 "KA_WHATIF_INCREMENTAL", "KA_WHATIF_MEMBUDGET", "KA_FAULTS_SPEC"):
        monkeypatch.delenv(knob, raising=False)


def _labels(prof):
    """The host-side ``ka/`` events of a profile: ``(name, start_ns,
    end_ns)`` in start order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        # torch 2.11's events carry no activity type; there the device
        # type tells an annotation's device-side copy apart.
        kind = getattr(e, "activity_type", None)
        on_device = (kind().startswith("gpu") if kind is not None
                     else str(e.device_type()).endswith("CUDA"))
        if e.name().startswith(trace.LABEL_PREFIX) and not on_device:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda x: x[1])


def _ms(label) -> float:
    return (label[2] - label[1]) / 1e6


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _plan_cluster():
    """30 brokers in 3 racks, 4 topics; broker 0 replaced by 30, so the
    plan places orphans."""
    tm, live, racks = rack_striped_cluster(30, 4, 24, 3, 3, extra_brokers=1)
    return tm, (set(live) - {0}) | {30}, racks


def _sweep_cluster():
    tm, live, racks = rack_striped_cluster(30, 4, 24, 3, 3)
    return tm, live, racks, [[0], [1], [2, 3], [4]]


def _rescue_cluster():
    """One topic of 2,000 partitions on 100 brokers in 5 racks; the first
    scenario takes 4 brokers off every rack, so the fast leg strands it and
    the rescue re-runs it."""
    tm, live, racks = rack_striped_cluster(100, 1, 2000, 3, 5, name_fmt="rescue-{:02d}")
    by_rack = {}
    for b in sorted(live):
        by_rack.setdefault(racks[b], []).append(b)
    return tm, live, racks, [sorted(b for r in sorted(by_rack) for b in by_rack[r][:4]),
                             [0]]


def test_plan_labels_cover_their_timers_in_phase_order():
    tm, live, racks = _plan_cluster()
    assigner = TopicAssigner(device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assigner.generate_assignments(tm, live, racks)
    timers = assigner.solver.last_timers
    labels = _labels(prof)
    phases = [lab for lab in labels if lab[0][3:] in PLAN_PHASES]
    assert [lab[0] for lab in phases] == [f"ka/{p}" for p in PLAN_PHASES]
    for lab in phases:
        assert abs(_ms(lab) - timers[lab[0][3:]]) < 1.0, (lab, timers)
    (solve,) = [lab for lab in labels if lab[0] == "ka/solve"]
    assert _inside(phases[2], solve) and _inside(phases[3], solve)
    assert 0.0 <= timers["place_wait"] <= timers["place"]


def test_dispatch_trace_nests_the_plan_labels_under_the_dispatch(monkeypatch, tmp_path):
    monkeypatch.setenv("KA_OBS_PROFILE_DIR", str(tmp_path))
    tm, live, racks = _plan_cluster()
    TopicAssigner(device="cpu").generate_assignments(tm, live, racks)
    (path,) = tmp_path.iterdir()
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("ka/")]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events),
                   key=lambda x: x[1])
    (outer,) = [s for s in spans if s[0] == DISPATCH_LABEL]
    phases = [s for s in spans if s[0][3:] in PLAN_PHASES]
    assert [s[0] for s in phases] == [f"ka/{p}" for p in PLAN_PHASES]
    assert all(_inside(s, outer) for s in phases)


def test_dense_sweep_labels_each_chunk_once(monkeypatch):
    tm, live, racks, scenarios = _sweep_cluster()
    monkeypatch.setenv("KA_WHATIF_INCREMENTAL", "0")
    # One scenario a placement call: four chunks.
    monkeypatch.setattr(tops, "SWEEP_CHUNK_ELEMS", 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        whatif.evaluate_removal_scenarios(tm, live, racks, scenarios, device="cpu")
    last = whatif.last_sweep
    assert last["path"] == "dense" and last["chunks"] == 4 and last["rescued"] == 0
    labels = _labels(prof)
    names = [lab[0] for lab in labels if lab[0] in SWEEP_PHASES]
    assert names == (["ka/whatif/prep"] + ["ka/whatif/chunk"] * last["chunks"]
                     + ["ka/whatif/rescue_phase"])
    by_name = {lab[0]: lab for lab in labels}
    for key in ("prep", "rescue"):
        assert abs(_ms(by_name[SWEEP_TIMERS[key]]) - last[key]) < 1.0, (key, last)


def test_incremental_sweep_labels_its_compose():
    # 100 topics of 2 partitions on 200 brokers: a single removal touches a
    # few topics, so the incremental path runs.
    tm, live, racks = rack_striped_cluster(200, 100, 2, 3, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        whatif.evaluate_removal_scenarios(tm, live, racks, [[0], [7], [11]],
                                          device="cpu")
    last = whatif.last_sweep
    assert last["path"] == "incremental"
    labels = _labels(prof)
    names = [lab[0] for lab in labels if lab[0] in SWEEP_PHASES]
    assert names[0] == "ka/whatif/prep" and names[-2:] == ["ka/whatif/compose",
                                                           "ka/whatif/rescue_phase"]
    assert names.count("ka/whatif/chunk") == last["chunks"]
    by_name = {lab[0]: lab for lab in labels}
    for key in ("prep", "compose", "rescue"):
        assert abs(_ms(by_name[SWEEP_TIMERS[key]]) - last[key]) < 1.0, (key, last)


def test_rescued_sweep_labels_the_rescue_once_inside_its_phase(monkeypatch):
    tm, live, racks, scenarios = _rescue_cluster()
    monkeypatch.setenv("KA_WHATIF_INCREMENTAL", "0")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        whatif.evaluate_removal_scenarios(tm, live, racks, scenarios, device="cpu")
    last = whatif.last_sweep
    assert last["path"] == "dense" and last["rescued"] == 1
    labels = [lab for lab in _labels(prof) if lab[0] in SWEEP_PHASES]
    names = [lab[0] for lab in labels]
    head = ["ka/whatif/prep"] + ["ka/whatif/chunk"] * last["chunks"]
    assert names[:len(head) + 2] == head + ["ka/whatif/rescue_phase", "ka/whatif/rescue"]
    phase, rescue = labels[len(head)], labels[len(head) + 1]
    # The rescue's own placement calls are chunks inside the reference's
    # rescue span, which sits inside the phase the ``rescue`` timer times.
    tail = labels[len(head) + 2:]
    assert tail and all(lab[0] == "ka/whatif/chunk" and _inside(lab, rescue)
                        for lab in tail)
    assert _inside(rescue, phase)
    assert abs(_ms(phase) - last["rescue"]) < 1.0, last


def test_no_profiler_takes_no_label_path(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a label made with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not trace.profiling()
    assert trace.span("encode") is trace.NULL_SPAN
    assert trace.span("infer", report=False) is trace.NULL_SPAN
    sink = {}
    with trace.span("infer", sink=sink, report=False):
        pass
    assert set(sink) == {"infer"}
    tm, live, racks = _plan_cluster()
    assigner = TopicAssigner(device="cpu")
    assigner.generate_assignments(tm, live, racks)
    assert set(assigner.solver.last_timers) == {"infer", "encode", "place",
                                                "leadership", "decode"}
    tm, live, racks, scenarios = _sweep_cluster()
    whatif.evaluate_removal_scenarios(tm, live, racks, scenarios, device="cpu")
    assert "syncs" not in whatif.last_sweep and "wait" not in whatif.last_sweep
    with tops.host_reads() as reads:
        assert reads is None


def test_unreported_spans_label_and_sink_but_stay_out_of_the_run():
    sink = {}
    with trace.run_capture() as run, profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("encode"):
            with trace.span("infer", sink=sink, report=False):
                pass
    assert [s["name"] for s in run.spans] == ["encode"]
    assert set(sink) == {"infer"}
    assert [lab[0] for lab in _labels(prof)] == ["ka/encode", "ka/infer"]


def test_collector_pauses_only_under_a_profiler_and_label_full_collections():
    tm, live, racks = _plan_cluster()
    assigner = TopicAssigner(device="cpu")
    with trace.run_capture():
        assigner.generate_assignments(tm, live, racks)
    assert "gc" not in assigner.solver.last_timers
    with profile(activities=[ProfilerActivity.CPU]):
        assigner.generate_assignments(tm, live, racks)
    assert assigner.solver.last_timers["gc"] >= 0.0
    sink = {}
    with trace.collector_pauses(sink):
        gc.collect()
    assert sink == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.collector_pauses(sink):
            gc.collect(0)
            gc.collect()
    assert sink["gc"] > 0.0
    assert [lab[0] for lab in _labels(prof)] == ["ka/gc"]
    assert all(not isinstance(cb, trace._Pauses) for cb in gc.callbacks)


def test_sweep_syncs_repeat_and_count_waves_plus_fixed_reads(monkeypatch):
    tm, live, racks, scenarios = _sweep_cluster()
    monkeypatch.setenv("KA_WHATIF_INCREMENTAL", "0")
    monkeypatch.setattr(tops, "SWEEP_CHUNK_ELEMS", 1)
    runs = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            whatif.evaluate_removal_scenarios(tm, live, racks, scenarios, device="cpu")
        runs.append(dict(whatif.last_sweep))
    first, second = runs
    assert first["syncs"] == second["syncs"]
    assert first["rescued"] == 0
    # A chunk: the fast leg's wave loop reads once a wave and once to stop,
    # the stranded rows once, its bincount once; the call's three outputs.
    waves = sum(first["waves"].values())
    assert first["syncs"] == waves + 3 * first["chunks"] + 3
    assert 0.0 <= first["wait"] <= first["sweep"] + first["rescue"]


def test_rescue_reads_count_in_the_sweeps_syncs():
    """A sweep whose fast leg strands re-runs the flagged scenarios on the
    full chain: their reads add to ``syncs``, the same on every run."""
    tm, live, racks, scenarios = _rescue_cluster()
    runs = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            whatif.evaluate_removal_scenarios(tm, live, racks, scenarios, device="cpu")
        runs.append(dict(whatif.last_sweep))
    assert runs[0]["rescued"] >= 1
    assert runs[0]["syncs"] == runs[1]["syncs"]
    main = sum(runs[0]["waves"].values()) + 3 * runs[0]["chunks"] + 3
    assert runs[0]["syncs"] > main + sum(runs[0]["rescue_waves"].values())


def test_place_batched_counts_its_reads_under_a_profiler():
    tm, live, racks = _plan_cluster()
    from kafka_assigner_tpu_torch.models.problem import encode_topic_group

    items = list(tm.items())
    encs, cur, jh, pr = encode_topic_group(items, racks, live, [3] * len(items))
    args = (torch.as_tensor(cur), torch.as_tensor(encs[0].rack_idx), torch.as_tensor(jh),
            torch.as_tensor(pr), encs[0].n, 3, "fast")
    with profile(activities=[ProfilerActivity.CPU]), tops.host_reads() as reads:
        res = tops.place_batched(*args, r_cap=encs[0].r_cap)
    # The wave loop once a wave and once to stop, then the stranded rows.
    assert reads.syncs == res.waves["fast"] + 2
    assert reads.wait >= 0.0


def test_this_torch_has_the_host_label_event():
    """Labels are ``torch._C._profiler._RecordFunctionFast`` host events, a
    private torch API: a torch without it would label nothing."""
    assert hasattr(torch._C._profiler, "_RecordFunctionFast")


def test_window_capture_labels_the_dispatchers_packed_call(monkeypatch, tmp_path):
    """A ``/debug/profile`` window (``capture_window``) records every
    thread: the packed call on the dispatcher thread and a span on a
    request thread are labels in its trace."""
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "0")
    d = dispatch.SolveDispatcher()
    window = threading.Thread(target=obs_profile.capture_window, args=(1.0, str(tmp_path)))
    try:
        window.start()
        deadline = time.monotonic() + 30.0
        while not trace.profiling():
            assert time.monotonic() < deadline, "the window never started"
            time.sleep(0.005)
        with trace.span("infer", sink={}, report=False):
            out = d.submit_rows("place_batched", "k", {"x": np.arange(4)}, 4,
                                lambda rows: (rows["x"] * 2,))
        assert out[0].tolist() == [0, 2, 4, 6]
    finally:
        window.join()
        d.close()
    assert not trace.profiling()
    (path,) = tmp_path.iterdir()
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("ka/")]
    by_name = {e["name"]: e for e in events}
    assert {"ka/dispatch/packed", "ka/infer"} <= set(by_name)
    assert by_name["ka/dispatch/packed"]["tid"] != by_name["ka/infer"]["tid"]


@pytest.mark.cuda
def test_card_trace_holds_the_labels_as_host_events(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    tm, live, racks = _plan_cluster()
    assigner = TopicAssigner(device="cuda")
    assigner.generate_assignments(tm, live, racks)  # builds the kernel
    monkeypatch.setenv("KA_OBS_PROFILE_DIR", str(tmp_path))
    assigner.generate_assignments(tm, live, racks)
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    ours = [e for e in events if str(e.get("name", "")).startswith("ka/")]
    names = {e["name"] for e in ours}
    assert {f"ka/{p}" for p in PLAN_PHASES} <= names
    assert not [e for e in ours if e.get("cat") in DEVICE_ACTIVITIES]
    # No device-side copy of a span's label (the dispatch block is a
    # record_function annotation, which has one).
    assert not [e for e in ours if e["name"] != DISPATCH_LABEL
                and str(e.get("cat", "")).startswith("gpu")]
    assert any(e.get("cat") == "kernel" for e in events)
