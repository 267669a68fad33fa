"""The port's ingest-overlapped warm-up (``solvers/warmup.py``, the thread in
``generator.py``) and ``ka-warm`` (``cli.py:run_warm``) against the JAX
package's, on the CPU:

- ``predict_group_signature`` equals the reference's on the same cluster
  and topics;
- a warm-up makes its signature resident (``warmed``, then ``hit``; ``jit``
  with the store off) and, racing a solve, leaves the solver's
  ``last_timers``/``last_codec``, ``models.problem.last_codec`` and the
  kernel launch count as a solve alone leaves them;
- mode 3 with the warm-up on, crashed by ``warmup:0=crash`` and off: the
  same stdout, the reference's stderr line and counters;
- ``ka-warm`` in snapshot mode, buckets mode, with the store off and on a
  usage error, each against the reference's ``run_warm`` where the
  reference is deterministic here (its first process on an empty store,
  its store off, its usage errors), on both leadership lanes named
  explicitly (the two packages' ``KA_LEADERSHIP=auto`` take different
  lanes).

``cuda``-marked cases: the warm-up launches the leadership kernel no time,
and a solve after it is bit-equal to one without it.
"""
from __future__ import annotations

import contextlib
import io
import json
import threading

import numpy as np
import pytest
import torch

from kafka_assigner_tpu import faults as jax_faults
from kafka_assigner_tpu.cli import run_tool as jax_run_tool
from kafka_assigner_tpu.cli import run_warm as jax_run_warm
from kafka_assigner_tpu.generator import join_warmup_threads as jax_join
from kafka_assigner_tpu.models.problem import encode_cluster as jax_encode_cluster
from kafka_assigner_tpu.solvers.warmup import (
    predict_group_signature as jax_predict,
)
from kafka_assigner_tpu.utils import programstore as jax_store
from kafka_assigner_tpu_torch import cli
from kafka_assigner_tpu_torch import faults
from kafka_assigner_tpu_torch.generator import join_warmup_threads
from kafka_assigner_tpu_torch.models import problem
from kafka_assigner_tpu_torch.models.problem import encode_cluster, group_pads
from kafka_assigner_tpu_torch.native import build as nbuild
from kafka_assigner_tpu_torch.obs import run_capture
from kafka_assigner_tpu_torch.ops import leadership
from kafka_assigner_tpu_torch.solvers import torch_solver as ts
from kafka_assigner_tpu_torch.solvers import warmup
from kafka_assigner_tpu_torch.solvers.base import Context
from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver
from kafka_assigner_tpu_torch.utils import programstore


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    """Both packages on one empty store, nothing resident, no faults, no
    warm-up thread left over."""
    monkeypatch.setenv("KA_PROGRAM_STORE_DIR", str(tmp_path / "store"))
    for knob in ("KA_PROGRAM_STORE", "KA_WARMUP", "KA_FAULTS_SPEC", "KA_LEADERSHIP",
                 "KA_ZK_INGEST_CHUNK", "KA_OBS_REPORT", "KA_OBS_ENABLE"):
        monkeypatch.delenv(knob, raising=False)

    def _reset():
        for join, store, f in ((jax_join, jax_store, jax_faults),
                               (join_warmup_threads, programstore, faults)):
            join()
            store.clear_memory()
            f.reset()

    _reset()
    yield
    _reset()


@pytest.fixture()
def snapshot(tmp_path):
    cluster = {
        "brokers": [
            {"id": 100 + i, "host": f"h{i}", "port": 9092, "rack": f"r{i % 3}"}
            for i in range(6)
        ],
        "topics": {
            f"topic-{t}": {str(p): [100 + (p + t + r) % 6 for r in range(3)]
                           for p in range(8 + 3 * t)}
            for t in range(5)
        },
    }
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(cluster))
    return str(path), cluster


def _run(fn, argv, out_kw=False):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv, out=out) if out_kw else fn(argv)
    return rc, out.getvalue(), err.getvalue()


def _lines(err: str, prefixes=("ka-warm:", "error:", "kafka-assigner: warm-up")):
    """The tool's own stderr lines (XLA's logging left out)."""
    return [ln for ln in err.splitlines() if ln.startswith(prefixes)]


# --- the signature ---------------------------------------------------------------

@pytest.mark.parametrize("n_brokers,racks,n_topics,p_pad,width,rf", [
    (6, 3, 5, 8, 3, 3), (12, 4, 1, 16, 2, 2), (40, 5, 33, 64, 4, 3), (7, 1, 2, 8, 3, 5),
])
def test_predict_group_signature_matches_the_reference(n_brokers, racks, n_topics,
                                                       p_pad, width, rf):
    rack_map = {b: f"r{b % racks}" for b in range(n_brokers)}
    got = warmup.predict_group_signature(
        encode_cluster(rack_map, set(rack_map)), n_topics, p_pad, width, rf)
    want = jax_predict(jax_encode_cluster(rack_map, set(rack_map)), n_topics, p_pad,
                       width, rf)
    assert got == want


def test_group_pads_match_the_reference(snapshot):
    from kafka_assigner_tpu.models.problem import group_pads as jax_group_pads

    _, cluster = snapshot
    currents = [{int(p): r for p, r in t.items()} for t in cluster["topics"].values()]
    assert group_pads(currents) == jax_group_pads(currents) == (24, 3)


def test_warmup_predicts_the_solves_shapes(snapshot, monkeypatch):
    """The signature the mode-3 warm-up made resident is the one the solve
    then placed at."""
    path, _ = snapshot
    seen = []
    real = ts.place_batched

    def _spy(currents, *args, **kw):
        seen.append(tuple(currents.shape))
        return real(currents, *args, **kw)

    monkeypatch.setattr(ts, "place_batched", _spy)
    rc, _, _ = _run(cli.run_tool, ["--zk_string", f"file://{path}", "--mode",
                                   "PRINT_REASSIGNMENT", "--device", "cpu"], out_kw=True)
    assert rc == 0
    (shape,) = seen
    (key,) = programstore._RESIDENT
    assert key[0] == "solve_batched" and key[2:5] == shape


# --- residency and what the warm-up leaves alone -----------------------------------

def _cluster(brokers=12, racks=3):
    rack_map = {b: f"r{b % racks}" for b in range(brokers)}
    return encode_cluster(rack_map, set(rack_map)), rack_map


def test_warm_makes_the_signature_resident_then_hits():
    cluster, _ = _cluster()
    nbuild.prebuild_native_libraries()
    with run_capture() as run:
        assert warmup.warm_solver_programs(cluster, 4, 16, 3, 3, device="cpu") \
            == {"solve_batched": "warmed"}
    assert warmup.warm_solver_programs(cluster, 4, 16, 3, 3, device="cpu") \
        == {"solve_batched": "hit"}
    # Another signature is another residency.
    assert warmup.warm_solver_programs(cluster, 9, 16, 3, 3, device="cpu") \
        == {"solve_batched": "warmed"}
    assert set(run.counters) <= {"compile.store.hits", "compile.store.misses"}
    assert not run.spans


def test_warm_with_the_store_off_is_jit(monkeypatch):
    monkeypatch.setenv("KA_PROGRAM_STORE", "0")
    cluster, _ = _cluster()
    assert warmup.warm_solver_programs(cluster, 4, 16, 3, 3, device="cpu") \
        == {"solve_batched": "jit"}


def test_warm_on_the_host_lane_names_the_references_program(monkeypatch):
    monkeypatch.setenv("KA_LEADERSHIP", "native")
    nbuild.prebuild_native_libraries()
    cluster, _ = _cluster()
    assert warmup.warm_solver_programs(cluster, 4, 16, 3, 3, device="cpu") \
        == {"place_scan_narrow": "warmed"}


def test_warm_failure_is_an_error_outcome_not_a_raise(monkeypatch, capsys):
    cluster, _ = _cluster()

    def _boom(*a, **k):
        raise RuntimeError("no device here")

    monkeypatch.setattr(warmup, "_make_resident", _boom)
    assert warmup.warm_solver_programs(cluster, 4, 16, 3, 3, device="cpu") \
        == {"solve_batched": "error"}
    assert "warm(solve_batched) failed (RuntimeError: no device here)" \
        in capsys.readouterr().err


def test_warm_runs_its_steps_in_order(monkeypatch):
    # The steps the warm-start bench times: host libraries, then (on cuda)
    # the context and the kernel's library, then the inert pass.
    cluster, _ = _cluster()
    seen = []
    for step in ("load_libraries", "create_context", "load_kernel", "inert_pass"):
        real = getattr(warmup, f"_{step}")
        monkeypatch.setattr(warmup, f"_{step}",
                            lambda *a, _s=step, _r=real: (seen.append(_s), _r(*a))[1])
    assert warmup.warm_solver_programs(cluster, 4, 16, 3, 3, device="cpu") \
        == {"solve_batched": "warmed"}
    assert seen == ["load_libraries", "inert_pass"]  # no context on the CPU


def test_a_warmup_outliving_its_join_stays_listed(capsys):
    import threading

    from kafka_assigner_tpu_torch import generator

    release = threading.Event()
    t = threading.Thread(target=release.wait, daemon=True)
    t.start()
    with generator._WARMUP_LOCK:
        generator._LIVE_WARMUPS.append(t)
    try:
        join_warmup_threads(timeout=0.01)
        assert generator._LIVE_WARMUPS == [t]
        assert "1 warm-up thread(s) still running" in capsys.readouterr().err
    finally:
        release.set()
    join_warmup_threads()
    assert generator._LIVE_WARMUPS == [] and not t.is_alive()
    assert capsys.readouterr().err == ""


def test_warm_for_assignments_derives_the_signature():
    cluster, _ = _cluster()
    topics = {f"t{i}": {p: [p % 12, (p + 1) % 12] for p in range(10 + i)}
              for i in range(3)}
    assert warmup.warm_for_assignments(cluster, topics, device="cpu") \
        == {"solve_batched": "warmed"}
    (key,) = programstore._RESIDENT
    assert key[2:6] == (4, 16, 2, 2)  # b_pad, p_pad, width, rf
    assert warmup.warm_for_assignments(cluster, {}, device="cpu") == {}


def test_warmup_racing_a_solve_leaves_solver_state_untouched():
    nbuild.prebuild_native_libraries()
    cluster, rack_map = _cluster()
    topics = [(f"t{i}", {p: [p % 12, (p + 4) % 12, (p + 8) % 12] for p in range(16)})
              for i in range(4)]
    alone = TorchSolver("cpu")
    want = alone.assign_many(topics, rack_map, set(rack_map), 3, Context())
    want_codec = dict(problem.last_codec)
    launches = dict(leadership.launches)

    # The warm-up alone writes none of the solve's state.
    with run_capture() as run:
        warmup.warm_solver_programs(cluster, 4, 16, 3, 3, device="cpu")
    assert problem.last_codec == want_codec
    assert leadership.launches == launches
    assert not run.spans and not run.gauges

    for i in range(3):
        programstore.clear_memory()
        solver = TorchSolver("cpu")
        stop = threading.Event()

        def _race():
            while not stop.is_set():
                programstore.clear_memory()
                warmup.warm_solver_programs(cluster, 4 + i, 16, 3, 3, device="cpu")

        t = threading.Thread(target=_race)
        t.start()
        try:
            got = solver.assign_many(topics, rack_map, set(rack_map), 3, Context())
        finally:
            stop.set()
            t.join()
        assert got == want
        assert set(solver.last_timers) == set(alone.last_timers)
        assert solver.last_codec == alone.last_codec
        assert problem.last_codec == want_codec
        assert leadership.launches == launches


# --- mode 3 with the warm-up on, crashed and off ----------------------------------

def _both_mode3(path, tmp_path):
    argv = ["--zk_string", f"file://{path}", "--mode", "PRINT_REASSIGNMENT"]
    a, b = tmp_path / "ref.json", tmp_path / "port.json"
    ref = _run(jax_run_tool, argv + ["--solver", "tpu", "--report-json", str(a)])
    got = _run(cli.run_tool, argv + ["--device", "cpu", "--report-json", str(b)],
               out_kw=True)
    return ref, got, json.loads(a.read_text()), json.loads(b.read_text())


def _warm_part(report):
    counters = report["metrics"]["counters"]
    return ({k: v for k, v in counters.items() if k.startswith("warmup.")},
            sorted((s["path"], s["status"]) for s in report["spans"]
                   if s["name"] == "warmup"))


@pytest.mark.parametrize("case,env,want", [
    ("on", {}, ({"warmup.warmed": 1}, [("warmup", "ok")])),
    ("crash", {"KA_FAULTS_SPEC": "warmup:0=crash"}, ({"warmup.failures": 1}, [])),
    ("crash-one-topic-chunks", {"KA_FAULTS_SPEC": "warmup:0=crash",
                                "KA_ZK_INGEST_CHUNK": "1"},
     ({"warmup.failures": 1}, [])),
    ("off", {"KA_WARMUP": "0"}, ({}, [])),
])
def test_mode3_warmup_matches_the_reference(snapshot, tmp_path, monkeypatch, case, env,
                                            want):
    """The same stdout with the warm-up on, crashed (also when the crash
    consumes the in-loop start site and the tail site must not retry) and
    off; the reference's stderr line; the same ``warmup.*`` counters and
    ``warmup`` span."""
    path, _ = snapshot
    base = _run(cli.run_tool, ["--zk_string", f"file://{path}", "--mode",
                               "PRINT_REASSIGNMENT", "--device", "cpu",
                               "--failure-policy", "strict"], out_kw=True)
    join_warmup_threads()
    programstore.clear_memory()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref, got, ra, rb = _both_mode3(path, tmp_path)
    assert ref[0] == got[0] == 0
    assert got[1] == ref[1] == base[1]
    assert _lines(got[2]) == _lines(ref[2])
    if case.startswith("crash"):
        assert _lines(got[2]) == [
            "kafka-assigner: warm-up failed (InjectedWarmupCrash: injected fault: "
            "warm-up thread crash (store/compile failure stand-in)); continuing on "
            "the cold compile path"]
    assert _warm_part(rb) == _warm_part(ra) == want


# --- ka-warm -----------------------------------------------------------------------

@pytest.mark.parametrize("lane", ["device", "native"])
def test_ka_warm_seeds_store_for_snapshot(snapshot, tmp_path, monkeypatch, lane):
    path, _ = snapshot
    monkeypatch.setenv("KA_LEADERSHIP", lane)
    ref = _run(jax_run_warm, ["--zk_string", f"file://{path}"])
    got = _run(cli.run_warm, ["--zk_string", f"file://{path}", "--device", "cpu"])
    assert ref[0] == got[0] == 0
    assert _lines(got[2]) == _lines(ref[2])
    program = "solve_batched" if lane == "device" else "place_scan_narrow"
    assert _lines(got[2]) == [
        f"ka-warm: {program}: warmed",
        "ka-warm: store seeded for 5 topic(s), p_pad=24, width=3, rf=3, n=6"]
    port_entries = sorted(p.name.split("-")[0]
                          for p in (tmp_path / "store").rglob("torch-*/*.so"))
    assert port_entries == ["greedy", "hostcodec"]
    # A fresh process (its stand-in: nothing in memory) loads, never builds.
    programstore.clear_memory()
    with run_capture() as run:
        rc, _, _ = _run(cli.run_tool, ["--zk_string", f"file://{path}", "--mode",
                                       "PRINT_REASSIGNMENT", "--device", "cpu"],
                        out_kw=True)
    assert rc == 0
    assert run.counters.get("compile.store.hits") == 2
    assert not run.counters.get("compile.store.misses")


def test_ka_warm_buckets_mode(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_LEADERSHIP", "device")
    ref = _run(jax_run_warm, ["--buckets", "8,16,3,12,3"])
    got = _run(cli.run_warm, ["--buckets", "8,16,3,12,3", "--device", "cpu"])
    assert ref[0] == got[0] == 0
    assert _lines(got[2]) == _lines(ref[2]) == [
        "ka-warm: solve_batched: warmed",
        "ka-warm: store seeded for 8 topic(s), p_pad=16, width=3, rf=3, n=12"]
    assert len(list((tmp_path / "store").rglob("torch-*/*.so"))) == 2


def test_ka_warm_with_the_store_off_persists_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_PROGRAM_STORE", "0")
    monkeypatch.setenv("KA_LEADERSHIP", "device")
    ref = _run(jax_run_warm, ["--buckets", "8,16,3,12,3"])
    got = _run(cli.run_warm, ["--buckets", "8,16,3,12,3", "--device", "cpu"])
    assert ref[0] == got[0] == 1
    assert _lines(got[2]) == _lines(ref[2])
    assert "NOTHING persisted" in _lines(got[2])[-1]
    assert not list((tmp_path / "store").rglob("*.so"))


@pytest.mark.parametrize("argv", [[], ["--buckets", "not,numbers"],
                                  ["--buckets", "8,0,3,12"],
                                  ["--buckets", "8,16,3,12", "--zk_string", "x"]])
def test_ka_warm_usage_errors(argv):
    ref = _run(jax_run_warm, argv)
    got = _run(cli.run_warm, argv + ["--device", "cpu"])
    assert ref[0] == got[0] == 1
    assert _lines(got[2]) == _lines(ref[2])


def test_ka_warm_on_cuda_without_a_card_is_incomplete():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc, _, err = _run(cli.run_warm, ["--buckets", "8,16,3,12,3"])
    assert rc == 1
    assert _lines(err)[-1] == "ka-warm: warm-up incomplete (see warnings above)"


# --- on the card -------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_warmup_launches_no_kernel_and_the_solve_after_it_is_bit_equal(cuda_device):
    nbuild.prebuild_native_libraries()
    cluster, rack_map = _cluster(50, 5)
    rng = np.random.default_rng(3)
    topics = [(f"t{i}", {p: [int(x) for x in rng.choice(50, 3, replace=False)]
                         for p in range(40)}) for i in range(6)]
    cold = TorchSolver("cuda").assign_many(topics, rack_map, set(rack_map), 3, Context())
    before = leadership.launches["leadership"]
    assert warmup.warm_solver_programs(cluster, 6, 40, 3, 3, device="cuda") \
        == {"solve_batched": "warmed"}
    torch.cuda.synchronize()
    assert leadership.launches["leadership"] == before
    warm = TorchSolver("cuda").assign_many(topics, rack_map, set(rack_map), 3, Context())
    assert leadership.launches["leadership"] == before + 1
    assert warm == cold
