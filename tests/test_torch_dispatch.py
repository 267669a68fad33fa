"""The port's dispatch plane (``kafka_assigner_tpu_torch/daemon/dispatch.py``
and the routes into it) against the JAX package's under ``KA_DISPATCH=1``,
on the CPU.

- ``SolveDispatcher`` alone, as ``tests/test_dispatch.py:152-479`` pins the
  reference's: packing of compatible jobs and none of incompatible keys,
  the window and size triggers, a crash failing its batch only, ``close``
  flushing and refusing, identical-body dedup (one leader, a leader's crash
  isolating its followers, a version change splitting them), ``batch_key``
  (equal to the reference's key on the same operands) and the thread-local
  scope. The port packs without padding to a power of two.
- Row independence of ``place_batched``: two jobs' rows placed in one call
  equal each job placed alone, bit for bit, with rows that escalate
  through ``dense``, ``balance`` and ``seq`` beside rows that finish on
  ``fast``, and a mixed-RF job beside an equal-RF one.
- The daemon, the twins of ``tests/test_dispatch.py:480-835``: concurrent
  ``/plan`` and ``/whatif`` byte-identical to solo runs and to the reference
  daemon's, each with its own request ID; cross-cluster placement and
  scenario rows packing with no growth of the library store's misses;
  incompatible statics never packing; identical bodies running once (one
  leadership ordering for four plans); the groups sweep of two clusters in
  one group-pack call; a packed call's crash degrading per job; the kill
  switch; the drain flushing the gather queue.
- ``python -m kafka_assigner_tpu_torch.daemon --device cpu`` over two
  clusters from one snapshot, the twin of ``scripts/dispatch_smoke.py``.
- The bounded HTTP worker pool under a burst of 64 connections, idle
  keep-alive connections past the read timeout, and a stop with a full
  hand-off queue.

Every wait has its own bound; resyncs are kept out of the comparisons.
"""
from __future__ import annotations

import contextlib
import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kafka_assigner_tpu import faults as jax_faults
from kafka_assigner_tpu.daemon import AssignerDaemon as JaxDaemon
from kafka_assigner_tpu.daemon import dispatch as jax_dispatch
from kafka_assigner_tpu.models.problem import encode_topic_group as jax_encode
from kafka_assigner_tpu.obs import flight as jax_flight
from kafka_assigner_tpu.obs import metrics as jax_metrics
from kafka_assigner_tpu.obs import names as jax_names
from kafka_assigner_tpu.ops import assignment as jops
from kafka_assigner_tpu.utils import env as jax_env
from kafka_assigner_tpu_torch import faults as torch_faults
from kafka_assigner_tpu_torch.carry import to_tensor
from kafka_assigner_tpu_torch.daemon import AssignerDaemon
from kafka_assigner_tpu_torch.daemon.dispatch import (
    SolveDispatcher,
    active_broker,
    batch_key,
    dispatch_scope,
)
from kafka_assigner_tpu_torch.models.problem import encode_topic_group
from kafka_assigner_tpu_torch.obs import flight as torch_flight
from kafka_assigner_tpu_torch.obs import metrics as torch_metrics
from kafka_assigner_tpu_torch.obs import names as torch_names
from kafka_assigner_tpu_torch.obs import promtext
from kafka_assigner_tpu_torch.ops import assignment as tops
from kafka_assigner_tpu_torch.ops import group_pack
from kafka_assigner_tpu_torch.solvers import torch_solver
from kafka_assigner_tpu_torch.utils import env as torch_env

from .jute_server import JuteZkServer, cluster_tree, exec_snapshot_cluster
from .test_torch_daemon import JAX_LANE, _await, both_clis

ROOT = Path(__file__).resolve().parent.parent
DISPATCH_KNOBS = ("KA_DISPATCH", "KA_DISPATCH_WINDOW_MS", "KA_DISPATCH_MAX_BATCH",
                  "KA_DISPATCH_WINDOW_MAX_MS", "KA_DAEMON_HTTP_WORKERS")
UNSET = DISPATCH_KNOBS + (
    "KA_FAULTS_SPEC", "KA_FAILURE_POLICY", "KA_OBS_REPORT", "KA_OBS_ENABLE",
    "KA_OBS_ACCESS_LOG", "KA_OBS_FLIGHT_DUMP", "KA_DAEMON_MAX_INFLIGHT",
    "KA_DAEMON_DRAIN_TIMEOUT", "KA_DAEMON_WATCH", "KA_ZK_PIPELINE", "KA_HOSTCODEC",
    "KA_LEADERSHIP",
)


def _reset_planes():
    for mod in (jax_faults, torch_faults):
        mod.reset()
    for mod in (jax_metrics, torch_metrics):
        mod.disable_cumulative()
    for mod in (jax_flight, torch_flight):
        mod.disable()


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    for knob in UNSET:
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("KA_ZK_CLIENT", "wire")
    # No resync inside a comparison: each daemon serves its first sync.
    monkeypatch.setenv("KA_DAEMON_RESYNC_INTERVAL", "3600")
    monkeypatch.setenv("KA_DAEMON_JOURNAL_DIR", str(tmp_path))
    _reset_planes()
    yield
    _reset_planes()


@pytest.fixture()
def server():
    s = JuteZkServer(cluster_tree())
    s.start()
    yield s
    s.shutdown()


# --- SolveDispatcher alone ---------------------------------------------------------------


def _rows_job(d, key, values, calls, results, idx, call=None, entry="unit"):
    rows = {"x": np.asarray(values, dtype=np.int64)}

    def default_call(r):
        calls.append(len(r["x"]))
        return (np.asarray(r["x"]) * 2,)

    results[idx] = d.submit_rows(entry, key, rows, len(values), call or default_call)


def _run_threads(threads, timeout=30):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)


@contextlib.contextmanager
def dispatcher():
    d = SolveDispatcher(err=io.StringIO())
    try:
        yield d
    finally:
        d.close()


def test_compatible_jobs_pack_into_one_unpadded_call(monkeypatch):
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "250")
    with dispatcher() as d:
        calls, results = [], {}
        _run_threads([threading.Thread(
            target=_rows_job, args=(d, "k1", [10 * i + 1, 10 * i + 2], calls, results, i))
            for i in range(3)])
        # One call on the 6 real rows: the port pads to no power of two.
        assert calls == [6]
        for i in range(3):
            assert list(results[i][0]) == [2 * (10 * i + 1), 2 * (10 * i + 2)]


def test_incompatible_keys_never_pack(monkeypatch):
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "250")
    with dispatcher() as d:
        calls, results = [], {}
        _run_threads([threading.Thread(
            target=_rows_job, args=(d, f"k{i}", [i + 1], calls, results, i))
            for i in range(2)])
        assert sorted(calls) == [1, 1]
        for i in range(2):
            assert list(results[i][0]) == [2 * (i + 1)]


@pytest.mark.parametrize("trigger,knobs,jobs,least_s", [
    # A lone job waits out the window, and no more.
    ("window", {"KA_DISPATCH_WINDOW_MS": "50"}, 1, 0.04),
    # A window far past the test's budget: only the size trigger releases.
    ("size", {"KA_DISPATCH_WINDOW_MS": "30000", "KA_DISPATCH_MAX_BATCH": "2"}, 2, 0.0),
])
def test_a_gather_cycle_ends_on_its_trigger(monkeypatch, trigger, knobs, jobs, least_s):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    with dispatcher() as d:
        calls, results = [], {}
        t0 = time.perf_counter()
        _run_threads([threading.Thread(
            target=_rows_job, args=(d, "k", [i + 7], calls, results, i))
            for i in range(jobs)], timeout=20)
        elapsed = time.perf_counter() - t0
        assert least_s <= elapsed < 10.0, trigger
        assert calls == [jobs]
        assert [list(results[i][0]) for i in range(jobs)] == [[2 * (i + 7)]
                                                             for i in range(jobs)]


def test_a_crash_fails_only_its_batch(monkeypatch):
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "250")
    with dispatcher() as d:
        calls, results, errors = [], {}, {}

        def crashing(rows):
            raise RuntimeError("batch boom")

        def crash_job():
            try:
                _rows_job(d, "bad", [1], calls, results, 0, call=crashing)
            except RuntimeError as e:
                errors[0] = e

        _run_threads([threading.Thread(target=crash_job), threading.Thread(
            target=_rows_job, args=(d, "good", [5], calls, results, 1))])
        assert isinstance(errors.get(0), RuntimeError)
        assert list(results[1][0]) == [10]
        # The thread survived for the next job.
        _rows_job(d, "good", [6], calls, results, 2)
        assert list(results[2][0]) == [12]


def test_close_flushes_the_queue_and_refuses_new_jobs(monkeypatch):
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "30000")
    d = SolveDispatcher(err=io.StringIO())
    calls, results = [], {}
    t = threading.Thread(target=_rows_job, args=(d, "k", [3], calls, results, 0))
    t.start()
    assert _await(lambda: d._queue, timeout=10)  # parked in the 30 s window
    t0 = time.perf_counter()
    d.close()
    t.join(timeout=20)
    assert time.perf_counter() - t0 < 10.0, "close() must flush, not wait"
    assert list(results[0][0]) == [6]
    assert d.closed and d.submit_rows(
        "unit", "k", {"x": np.zeros(1, dtype=np.int64)}, 1, lambda r: (r["x"],)) is None
    assert d.run_job("k", lambda out: False, io.StringIO()) is None


def test_identical_bodies_run_once_and_serve_every_waiter():
    with dispatcher() as d:
        ran, gate = [], threading.Event()

        def fn(out):
            ran.append(1)
            gate.wait(10)  # the leader waits until every follower joined
            out.write("PLAN-BYTES")
            return False

        outs = [io.StringIO() for _ in range(4)]
        results = {}
        threads = [threading.Thread(target=lambda i=i: results.update(
            {i: d.run_job("key", fn, outs[i])})) for i in range(4)]
        for t in threads:
            t.start()
        assert _await(lambda: d._plan_entries.get("key") is not None
                      and d._plan_entries["key"].followers == 3, timeout=10)
        gate.set()
        for t in threads:
            t.join(timeout=30)
        assert len(ran) == 1
        assert [o.getvalue() for o in outs] == ["PLAN-BYTES"] * 4
        assert sorted(results.values()) == [(False, False)] + [(False, True)] * 3


def test_a_leaders_crash_is_the_leaders_and_its_follower_runs_alone():
    with dispatcher() as d:
        attempts, gate = [], threading.Event()

        def fn(out):
            attempts.append(threading.current_thread().name)
            if len(attempts) == 1:
                gate.wait(10)
                raise RuntimeError("leader boom")
            out.write("RECOVERED")
            return True

        outs = [io.StringIO() for _ in range(2)]
        results, errors = {}, {}

        def one(i):
            try:
                results[i] = d.run_job("key", fn, outs[i])
            except RuntimeError as e:
                errors[i] = e

        first = threading.Thread(target=one, args=(0,))
        first.start()
        assert _await(lambda: "key" in d._plan_entries, timeout=10)
        second = threading.Thread(target=one, args=(1,))
        second.start()
        assert _await(lambda: d._plan_entries["key"].followers == 1, timeout=10)
        gate.set()
        for t in (first, second):
            t.join(timeout=30)
        assert list(errors) == [0] and list(results) == [1]
        assert outs[1].getvalue() == "RECOVERED" and results[1] == (True, False)
        assert len(attempts) == 2


def test_a_version_change_splits_the_followers():
    with dispatcher() as d:
        version = {"v": 1}
        gates = {"V1": threading.Event(), "V2": threading.Event()}
        ran = []

        def make_fn(tag):
            def fn(out):
                ran.append(tag)
                if ran.count(tag) == 1:
                    gates[tag].wait(10)
                out.write(tag)
                return False
            return fn

        outs = {i: io.StringIO() for i in range(4)}
        results = {}

        def one(i, tag):
            results[i] = d.run_job("key", make_fn(tag), outs[i],
                                   version=lambda: version["v"])

        threads = [threading.Thread(target=one, args=(i, "V1" if i < 2 else "V2"))
                   for i in range(4)]
        threads[0].start()
        assert _await(lambda: "key" in d._plan_entries, timeout=10)
        threads[1].start()  # the same version: a follower of the leader
        assert _await(lambda: d._plan_entries["key"].followers == 1, timeout=10)
        version["v"] = 2  # a resync lands mid-flight
        threads[2].start()
        threads[3].start()
        time.sleep(0.3)
        assert ran == ["V1"], "arrivals after the resync must not join the old leader"
        gates["V1"].set()
        assert _await(lambda: ran == ["V1", "V2"], timeout=10)
        assert _await(lambda: d._plan_entries.get("key") is not None
                      and d._plan_entries["key"].followers == 1, timeout=10)
        gates["V2"].set()
        for t in threads:
            t.join(timeout=30)
        assert [outs[i].getvalue() for i in range(4)] == ["V1", "V1", "V2", "V2"]
        assert results[1] == (False, True)
        assert sorted(results[i][1] for i in (2, 3)) == [False, True]


_A = np.arange(12, dtype=np.int32).reshape(3, 4)


@pytest.mark.parametrize("other,equal", [
    (("e", (_A.copy(),), (1, 2)), True),
    (("e", (np.where(_A == 0, 99, _A).astype(np.int32),), (1, 2)), False),
    (("e", (_A,), (1, 3)), False),
    (("f", (_A,), (1, 2)), False),
    (("e", (_A.astype(np.int64),), (1, 2)), False),
    (("e", (_A.reshape(4, 3),), (1, 2)), False),
])
def test_batch_key_fingerprints_content_and_statics(other, equal):
    assert (batch_key("e", (_A,), (1, 2)) == batch_key(*other)) is equal
    # The same digest as the reference's, on the same operands.
    assert batch_key(*other) == jax_dispatch.batch_key(*other)


def test_dispatch_scope_is_thread_local():
    with dispatcher() as d:
        assert active_broker() is None
        seen = {}
        with dispatch_scope(d):
            assert active_broker() is d
            t = threading.Thread(target=lambda: seen.update(other=active_broker()))
            t.start()
            t.join(timeout=10)
            with dispatch_scope(None):
                assert active_broker() is None
            assert active_broker() is d
        assert seen["other"] is None and active_broker() is None


@pytest.mark.parametrize("base,cap,depth", [
    ("3", "25", 1), ("3", "25", 4), ("3", "25", 40), ("50", "25", 3), ("0", "25", 9),
])
def test_the_adaptive_window_is_the_references(monkeypatch, base, cap, depth):
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", base)
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MAX_MS", cap)
    assert SolveDispatcher._window_s(depth) == jax_dispatch.SolveDispatcher._window_s(depth)


def test_knobs_and_names_are_the_references():
    for name in DISPATCH_KNOBS:
        ref = jax_env.KNOBS[name]
        assert (torch_env.KNOBS[name].default, torch_env.KNOBS[name].floor) == (
            ref.default, ref.floor), name
    ours = {n for n in torch_names.METRIC_NAMES if n.startswith("dispatch.")}
    assert ours | {"daemon.solve.queue_ms"} <= jax_names.METRIC_NAMES
    assert len(ours) == 7 and "dispatch" in torch_names.SPAN_NAMES
    assert "dispatch" in jax_names.SPAN_NAMES


# --- row independence of place_batched ----------------------------------------------------

#: Fifteen live brokers in five racks (broker 100 removed): with five
#: partitions at RF 3 the cap is 1, so a topic's replicas on broker 100
#: orphan slots whose placement escalates per the seed. The seeds' RF-3
#: topics reach: 0 fast only, 13 fast and dense, 4 up to balance, 11 up to
#: seq.
_RACKS = {**{100 + i: f"r{i % 5}" for i in range(15)}, 115: "r0"}
_LIVE = set(range(101, 116))
_RACK_MAP = {b: _RACKS[b] for b in _LIVE}


def _topic(seed, rf=3, p=5):
    rng = np.random.default_rng(seed)
    return {q: [int(x) for x in rng.choice(np.arange(100, 116), size=rf, replace=False)]
            for q in range(p)}


def _encoded(seeds_rfs):
    items = [(f"t{seed}-{rf}", _topic(seed, rf)) for seed, rf in seeds_rfs]
    rfs = [rf for _, rf in seeds_rfs]
    encs, cur, jh, pr = encode_topic_group(items, _RACK_MAP, _LIVE, rfs)
    rfs_arr = np.full(cur.shape[0], max(rfs), dtype=np.int32)
    rfs_arr[: len(rfs)] = rfs
    return encs, cur, jh, pr, rfs_arr


def _place(enc0, cur, jh, pr, rfs):
    res = tops.place_batched(
        to_tensor(cur), to_tensor(enc0.rack_idx), to_tensor(jh), to_tensor(pr), enc0.n,
        3, "auto", None if rfs is None else to_tensor(rfs), r_cap=enc0.r_cap)
    return [t.numpy() for t in res[:4]], res.waves


@pytest.mark.parametrize("job_a,job_b", [
    # Rows that end on fast beside rows that escalate to dense, balance, seq.
    ([(0, 3), (11, 3), (13, 3)], [(4, 3), (0, 3), (13, 3), (11, 3)]),
    # A mixed-RF job beside an equal-RF one (its rows take the batch RF).
    ([(11, 3), (7, 2), (0, 3)], [(13, 3), (4, 3)]),
])
def test_rows_placed_together_equal_each_job_placed_alone(job_a, job_b):
    a, b = _encoded(job_a), _encoded(job_b)
    assert a[1].shape[1:] == b[1].shape[1:] and np.array_equal(a[0][0].rack_idx,
                                                               b[0][0].rack_idx)
    mixed = len({rf for _, rf in job_a + job_b}) > 1
    packed, waves = _place(a[0][0], *(np.concatenate([x, y]) for x, y in zip(a[1:], b[1:])))
    assert {"fast", "dense", "balance", "seq"} <= set(waves)
    off = 0
    for job, enc in ((job_a, a), (job_b, b)):
        equal_rf = len({rf for _, rf in job}) == 1
        alone, _ = _place(enc[0][0], *enc[1:4], None if equal_rf and mixed else enc[4])
        rows = slice(off, off + enc[1].shape[0])
        for got, want in zip(packed, alone):
            np.testing.assert_array_equal(got[rows], want)
        off += enc[1].shape[0]
        # Each job alone is the reference's placement of it.
        jencs, jcur, jjh, jpr = jax_encode(
            [(f"t{s}-{rf}", _topic(s, rf)) for s, rf in job], _RACK_MAP, _LIVE,
            [rf for _, rf in job])
        ref = jax.device_get(jops.place_scan_jit(
            jnp.asarray(jcur), jnp.asarray(jencs[0].rack_idx), jnp.asarray(jjh),
            jnp.asarray(jpr), n=jencs[0].n, rf=3, wave_mode="auto",
            rfs=None if equal_rf else jnp.asarray(enc[4]), r_cap=jencs[0].r_cap))
        for got, want in zip(alone, ref[:4]):
            np.testing.assert_array_equal(got, np.asarray(want))


def test_a_fast_only_job_alone_runs_only_the_fast_leg():
    # The packed call above ran every leg; this job alone needs one.
    _, waves = _place(*(lambda e: (e[0][0], *e[1:]))(_encoded([(0, 3)])))
    assert set(waves) == {"fast"}


# --- the daemon -------------------------------------------------------------------------------


def req(port, method, path, payload=None, timeout=120.0, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, headers=headers or {},
                     body=None if payload is None else json.dumps(payload))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), dict(resp.getheaders())
    finally:
        conn.close()


def scrape(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        assert resp.status == 200
        fams = promtext.parse(resp.read().decode("utf-8"))
    finally:
        conn.close()
    for data in fams.values():
        if data["type"] == "histogram":
            assert promtext.check_histogram(data) == []
    return fams


def total(fams, fam):
    data = fams.get(fam)
    return 0.0 if data is None else sum(v for _n, _l, v in data["samples"])


@contextlib.contextmanager
def running(pkg, spec, solver="greedy", **kw):
    """A started daemon of ``pkg``: one cluster (a connect string) or many
    (a dict)."""
    clusters = spec if isinstance(spec, dict) else None
    zk = None if clusters is not None else spec
    if pkg == "torch":
        d = AssignerDaemon(zk, clusters=clusters, solver=solver, device="cpu",
                           err=io.StringIO(), **kw)
    else:
        d = JaxDaemon(zk, clusters=clusters, solver=JAX_LANE[solver], err=io.StringIO(),
                      **kw)
    d.start()
    try:
        yield d
    finally:
        d.shutdown()


def barrier_round(port, calls, timeout=120.0):
    """``calls`` (method, path, payload) released together; their replies
    in order."""
    results = {}
    barrier = threading.Barrier(len(calls))

    def one(i, method, path, payload):
        barrier.wait(timeout=60)
        results[i] = req(port, method, path, payload, timeout=timeout)

    _run_threads([threading.Thread(target=one, args=(i, *c)) for i, c in enumerate(calls)],
                 timeout=timeout)
    assert len(results) == len(calls), "request(s) hung"
    return [results[i] for i in range(len(calls))]


#: Two topics on four brokers in two racks (``tests/test_dispatch.py``'s
#: packing snapshot).
PACK_SNAP = {
    "brokers": [{"id": i, "host": f"b{i}", "port": 9092, "rack": f"r{i % 2}"}
                for i in range(4)],
    "topics": {
        "events": {str(p): [p % 4, (p + 1) % 4] for p in range(8)},
        "logs": {str(p): [(p + 2) % 4, (p + 3) % 4] for p in range(3)},
    },
}


def write(tmp_path, name, content) -> str:
    path = tmp_path / name
    path.write_text(json.dumps(content))
    return str(path)


def test_concurrent_plans_and_whatifs_are_solo_bytes_in_both_packages(server, monkeypatch):
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "150")
    spec = f"127.0.0.1:{server.port}"
    base_plan = both_clis(spec, "--solver", "greedy")
    base_whatif = both_clis(spec, mode="RANK_DECOMMISSION")
    calls = [("POST", p, {}) for _ in range(4) for p in ("/plan", "/whatif")]
    seen = {}
    for pkg in ("torch", "jax"):
        with running(pkg, spec) as d:
            assert d.dispatcher is not None
            replies = barrier_round(d.http_port, calls)
            seen[pkg] = scrape(d.http_port)
        ids = set()
        for (_m, path, _p), (status, body, headers) in zip(calls, replies):
            assert status == 200 and body["status"] == "ok", (pkg, path, body)
            assert body["result"]["stdout"] == (base_plan if path == "/plan"
                                                else base_whatif), (pkg, path)
            assert body["result"]["request_id"] == headers["X-Request-Id"]
            ids.add(headers["X-Request-Id"])
        assert len(ids) == len(calls)
    for fams in seen.values():
        assert total(fams, "ka_dispatch_jobs_total") >= 8
        assert total(fams, "ka_dispatch_batches_total") >= 1
        for fam in ("ka_daemon_solve_queue_ms", "ka_dispatch_batch_size",
                    "ka_dispatch_queue_depth", "ka_dispatch_window_ms",
                    "ka_dispatch_pad_waste_frac"):
            assert fam in fams, fam


@pytest.mark.parametrize("path,mode", [("/plan", "PRINT_REASSIGNMENT"),
                                       ("/whatif", "RANK_DECOMMISSION")])
def test_cross_cluster_rows_pack_with_no_new_library(tmp_path, monkeypatch, path, mode):
    # Two clusters read from one snapshot encode alike: their placement (or
    # scenario) rows share a key and one call, and each reply stays its
    # solo bytes. A warm round builds no library.
    snap = write(tmp_path, "cluster.json", PACK_SNAP)
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "300")
    base = both_clis(snap, "--solver", "device", mode=mode)
    calls = [("POST", f"/clusters/{n}{path}", {}) for n in ("a", "b")]
    for pkg in ("torch", "jax"):
        with running(pkg, {"a": snap, "b": snap}, solver="device") as d:
            first = barrier_round(d.http_port, calls)
            fams0 = scrape(d.http_port)
            second = barrier_round(d.http_port, calls)
            fams1 = scrape(d.http_port)
        for status, body, _h in first + second:
            assert status == 200 and body["result"]["stdout"] == base, (pkg, body)
        assert total(fams1, "ka_dispatch_batches_total") > total(
            fams0, "ka_dispatch_batches_total"), pkg
        assert total(fams1, "ka_compile_store_misses_total") == total(
            fams0, "ka_compile_store_misses_total"), pkg


def test_budgeted_sweep_blocks_are_jobs_that_pack_with_nothing(tmp_path, monkeypatch):
    # Past KA_WHATIF_MEMBUDGET the dense sweep runs in blocks; under the
    # dispatcher each block is a job of its own, and no two blocks (of one
    # request or of two) share a call.
    snap = write(tmp_path, "cluster.json", PACK_SNAP)
    monkeypatch.setenv("KA_WHATIF_INCREMENTAL", "0")
    monkeypatch.setenv("KA_WHATIF_MEMBUDGET", "1")
    base = both_clis(snap, mode="RANK_DECOMMISSION")
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "300")
    with running("torch", {"a": snap, "b": snap}, solver="device") as d:
        replies = barrier_round(d.http_port, [("POST", f"/clusters/{n}/whatif", {})
                                              for n in ("a", "b")])
        events = [e for e in torch_flight.recorder().snapshot()
                  if e["kind"] == "dispatch" and e["entry"] == "whatif_sweep"]
    for status, body, _h in replies:
        assert status == 200 and body["result"]["stdout"] == base
    # Four brokers ranked: four one-scenario blocks a request, each its own
    # call; then each request's rescue of its four stranded scenarios (one
    # key for both requests, so they may share a call).
    blocks = [e for e in events if e["rows"] == 1]
    assert len(blocks) == 8 and {e["jobs"] for e in blocks} == {1}
    assert sum(e["rows"] for e in events if e["rows"] > 1) == 8


def test_incompatible_plan_statics_never_pack(tmp_path, monkeypatch):
    snap_b = {
        "brokers": [{"id": i, "host": f"b{i}", "port": 9092, "rack": f"r{i % 3}"}
                    for i in range(6)],
        "topics": {
            "events": {str(p): [p % 6, (p + 1) % 6] for p in range(8)},
            "logs": {str(p): [(p + 2) % 6, (p + 3) % 6] for p in range(3)},
        },
    }
    path_a, path_b = write(tmp_path, "a.json", PACK_SNAP), write(tmp_path, "b.json", snap_b)
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "300")
    base = {n: both_clis(p, "--solver", "device") for n, p in (("a", path_a), ("b", path_b))}
    with running("torch", {"a": path_a, "b": path_b}, solver="device") as d:
        replies = barrier_round(d.http_port, [("POST", f"/clusters/{n}/plan", {})
                                              for n in ("a", "b")])
        fams = scrape(d.http_port)
    for name, (status, body, _h) in zip(("a", "b"), replies):
        assert status == 200 and body["result"]["stdout"] == base[name], name
    assert total(fams, "ka_dispatch_jobs_total") >= 2
    assert total(fams, "ka_dispatch_batches_total") == 0


def test_identical_plans_run_once_with_one_leadership_ordering(tmp_path, monkeypatch):
    snap = write(tmp_path, "cluster.json", PACK_SNAP)
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "300")
    base = both_clis(snap, "--solver", "device")
    orders = []
    real = torch_solver.leadership_order
    monkeypatch.setattr(torch_solver, "leadership_order",
                        lambda *a, **k: orders.append(1) or real(*a, **k))
    with running("torch", snap, solver="device") as d:
        replies = barrier_round(d.http_port, [("POST", "/plan", {})] * 4)
        fams = scrape(d.http_port)
        events = torch_flight.recorder().snapshot()
    for status, body, _h in replies:
        assert status == 200 and body["result"]["stdout"] == base
    # One leader ran the body and ordered its leaders once; the three
    # followers took its bytes.
    assert len(orders) == 1
    assert [e["jobs"] for e in events
            if e["kind"] == "dispatch" and e["entry"] == "body"] == [4]
    assert total(fams, "ka_dispatch_batches_total") == 1


def test_two_clusters_group_sweeps_share_one_group_pack_call(tmp_path, monkeypatch):
    snap = write(tmp_path, "groups.json", {**exec_snapshot_cluster(), "groups": {
        "ingest": {"members": {"c-0": 40.0, "c-1": None, "c-2": 25.0},
                   "assignment": {"events": {"0": "c-0", "1": "c-1", "4": "c-9"},
                                  "logs": {"2": "c-2"}},
                   "lag": {"events": {str(p): 10 * (p + 1) for p in range(6)},
                           "logs": {"1": 7}}}}})
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "300")
    calls = [("GET", f"/clusters/{n}/groups/sweep?counts=1,2,3&scales=100,150", None)
             for n in ("a", "b")] + [("GET", f"/clusters/{n}/recommendations", None)
                                     for n in ("a", "b")]
    scans = []
    real = group_pack.pack_scan
    monkeypatch.setattr(group_pack, "pack_scan",
                        lambda *a, **k: scans.append(a[0].shape[0]) or real(*a, **k))
    seen = {}
    for pkg in ("torch", "jax"):
        with running(pkg, {"a": snap, "b": snap}, solver="device") as d:
            seen[pkg] = barrier_round(d.http_port, calls)
    with running("torch", {"a": snap, "b": snap}, solver="device") as d:
        solo = [req(d.http_port, *c) for c in calls]

    def scrub(body):
        return json.loads(json.dumps(body).replace('"solver": "tpu"', '"solver": "device"'))

    for got, ref, alone in zip(seen["torch"], seen["jax"], solo):
        assert got[0] == ref[0] == alone[0] == 200
        assert scrub(got[1]) == scrub(ref[1]) == scrub(alone[1])
    # The concurrent round: one scan at 2 x 6 candidates; the solo round one
    # of 6 a request.
    assert scans == [12, 6, 6]


def test_a_packed_plan_call_that_crashes_degrades_per_job(tmp_path, monkeypatch):
    snap = write(tmp_path, "cluster.json", PACK_SNAP)
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "300")
    base = both_clis(snap, "--solver", "device")
    torch_faults.install(torch_faults.FaultInjector(torch_faults.parse_spec(
        "dispatch:0=crash")))
    with running("torch", {"a": snap, "b": snap}, solver="device") as d:
        replies = barrier_round(d.http_port, [("POST", f"/clusters/{n}/plan", {})
                                              for n in ("a", "b")])
        assert [str(e) for e in torch_faults.active_injector().fired] == [
            "dispatch:0=crash"]
        for status, body, _h in replies:
            assert status == 200 and body["result"]["stdout"] == base
        fams = scrape(d.http_port)
        assert total(fams, "ka_dispatch_solo_fallbacks_total") >= 2
        # The dispatcher's thread survived.
        status, body, _h = req(d.http_port, "POST", "/clusters/a/plan", {})
        assert status == 200 and body["result"]["stdout"] == base


def test_a_packed_whatif_call_that_crashes_degrades_per_job(server, monkeypatch):
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "150")
    spec = f"127.0.0.1:{server.port}"
    base = both_clis(spec, mode="RANK_DECOMMISSION")
    torch_faults.install(torch_faults.FaultInjector(torch_faults.parse_spec(
        "dispatch:0=crash")))
    with running("torch", spec) as d:
        replies = barrier_round(d.http_port, [("POST", "/whatif", {})] * 3)
        assert [str(e) for e in torch_faults.active_injector().fired] == [
            "dispatch:0=crash"]
        for status, body, _h in replies + [req(d.http_port, "POST", "/whatif", {})]:
            assert status == 200 and body["result"]["stdout"] == base
        assert total(scrape(d.http_port), "ka_dispatch_solo_fallbacks_total") >= 1


@pytest.mark.parametrize("lane", ["greedy", "device"])
def test_the_kill_switch_restores_the_lock_with_the_same_bytes(tmp_path, monkeypatch, lane):
    monkeypatch.setenv("KA_DISPATCH", "0")
    snap = write(tmp_path, "cluster.json", PACK_SNAP)
    base_plan = both_clis(snap, "--solver", lane)
    base_whatif = both_clis(snap, mode="RANK_DECOMMISSION")
    calls = [("POST", f"/clusters/{n}{p}", {}) for n in ("a", "b")
             for p in ("/plan", "/whatif")]
    with running("torch", {"a": snap, "b": snap}, solver=lane) as d:
        assert d.dispatcher is None
        assert all(s._dispatcher is None for s in d.supervisors.values())
        replies = barrier_round(d.http_port, calls)
        fams = scrape(d.http_port)
    for (_m, path, _p), (status, body, _h) in zip(calls, replies):
        assert status == 200 and body["status"] == "ok"
        assert body["result"]["stdout"] == (base_plan if path.endswith("/plan")
                                            else base_whatif)
    assert not [f for f in fams if f.startswith("ka_dispatch_")]
    assert "ka_daemon_solve_queue_ms" not in fams


def test_shutdown_flushes_the_gather_queue(server, monkeypatch):
    # A window far past the drain's budget: only close() can answer.
    monkeypatch.setenv("KA_DISPATCH_WINDOW_MS", "30000")
    monkeypatch.setenv("KA_DAEMON_DRAIN_TIMEOUT", "1.0")
    spec = f"127.0.0.1:{server.port}"
    base = both_clis(spec, mode="RANK_DECOMMISSION")
    d = AssignerDaemon(spec, solver="greedy", device="cpu", err=io.StringIO())
    d.start()
    result = {}
    t = threading.Thread(target=lambda: result.update(
        r=req(d.http_port, "POST", "/whatif", {})))
    t.start()
    assert _await(lambda: d.dispatcher._queue, timeout=30)  # parked in the window
    t0 = time.perf_counter()
    d.shutdown()
    t.join(timeout=60)
    assert time.perf_counter() - t0 < 20.0
    status, body, _h = result["r"]
    assert status == 200 and body["result"]["stdout"] == base


def test_a_burst_of_64_connections_on_4_workers(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_DAEMON_HTTP_WORKERS", "4")
    snap = write(tmp_path, "cluster.json", PACK_SNAP)
    with running("torch", snap) as d:
        workers = [t for t in threading.enumerate() if t.name.startswith("ka-http-")]
        replies = barrier_round(d.http_port, [("GET", "/state", None)] * 32
                                + [("POST", "/plan", {})] * 32)
        after = [t for t in threading.enumerate() if t.name.startswith("ka-http-")]
    assert len(workers) == 4 and after == workers
    assert [r[0] for r in replies] == [200] * 64
    assert len({r[1]["result"]["stdout"] for r in replies[32:]}) == 1


def test_telemetry_records_run_in_the_order_of_the_replies():
    """A record whose reply went out later waits for the earlier ones."""
    from kafka_assigner_tpu_torch.daemon.service import _ReplyOrder

    order, ran = _ReplyOrder(), []
    first, second, third = (order.ticket() for _ in range(3))
    order.emit(third, lambda: ran.append("third"))
    order.emit(second, lambda: ran.append("second"))
    assert ran == []
    order.emit(first, lambda: ran.append("first"))
    assert ran == ["first", "second", "third"]


def _keep_alive(port):
    """A connection that has had one reply and stays open, idle."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    resp.read()
    assert resp.status == 200
    return conn


def test_idle_keep_alive_connections_free_their_workers(tmp_path, monkeypatch):
    """As many idle keep-alive connections as workers: each closes after
    the read timeout, and a new request is answered."""
    from kafka_assigner_tpu_torch.daemon import service

    monkeypatch.setenv("KA_DAEMON_HTTP_WORKERS", "2")
    monkeypatch.setattr(service, "KEEPALIVE_TIMEOUT_S", 0.5)
    snap = write(tmp_path, "cluster.json", PACK_SNAP)
    with running("torch", snap) as d:
        idle = [_keep_alive(d.http_port) for _ in range(2)]
        t0 = time.monotonic()
        status, body, _h = req(d.http_port, "POST", "/plan", {}, timeout=20)
        assert status == 200 and body["status"] == "ok"
        assert time.monotonic() - t0 < 15
        for conn in idle:
            assert conn.sock.recv(1) == b""  # the daemon closed it
            conn.close()


def test_a_stop_is_not_held_by_a_full_hand_off_queue(tmp_path, monkeypatch):
    """One worker pinned by an idle keep-alive connection (the default read
    timeout) and more requests than the hand-off queue holds: the accept
    loop blocks on the queue, and the stop still ends within seconds."""
    monkeypatch.setenv("KA_DAEMON_HTTP_WORKERS", "1")
    snap = write(tmp_path, "cluster.json", PACK_SNAP)
    d = AssignerDaemon(snap, solver="greedy", device="cpu", err=io.StringIO())
    d.start()
    pending = []
    try:
        idle = _keep_alive(d.http_port)
        for _ in range(12):  # the queue holds 8
            s = socket.create_connection(("127.0.0.1", d.http_port), timeout=10)
            s.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
            pending.append(s)
        assert _await(lambda: d.httpd._work.full(), timeout=10)
    finally:
        stop = threading.Thread(target=d.shutdown, daemon=True)
        stop.start()
        stop.join(10)
        for s in pending:
            s.close()
    idle.close()
    assert not stop.is_alive(), "the stop hung on the hand-off queue"


# --- ka-daemon in a process (scripts/dispatch_smoke.py's checks) ------------------------


def _daemon_process(clusters, env):
    proc = subprocess.Popen(
        [sys.executable, "-m", "kafka_assigner_tpu_torch.daemon", "--clusters", clusters,
         "--solver", "greedy", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True).start()
    assert _await(lambda: any("listening on http://" in ln for ln in lines), timeout=90)
    banner = next(ln for ln in lines if "listening on http://" in ln)
    return proc, int(banner.split("http://127.0.0.1:")[1].split()[0]), lines


def test_the_daemon_process_packs_and_drains(tmp_path):
    snap = write(tmp_path, "cluster.json", PACK_SNAP)
    base_plan = both_clis(snap, "--solver", "greedy")
    base_whatif = both_clis(snap, mode="RANK_DECOMMISSION")
    calls = [("POST", f"/clusters/{n}{p}", {}) for n in ("a", "b")
             for p in ("/plan", "/plan", "/whatif", "/whatif")]
    env = dict(os.environ, PYTHONPATH=str(ROOT), KA_DISPATCH_WINDOW_MS="300",
               KA_DAEMON_MAX_INFLIGHT="32")
    rounds = {}
    for regime in ("1", "0"):
        proc, port, lines = _daemon_process(f"a={snap};b={snap}",
                                            dict(env, KA_DISPATCH=regime))
        try:
            fams = []
            for _ in range(2 if regime == "1" else 1):
                for (_m, path, _p), (status, body, _h) in zip(
                        calls, barrier_round(port, calls)):
                    assert status == 200
                    assert body["result"]["stdout"] == (
                        base_plan if path.endswith("/plan") else base_whatif)
                fams.append(scrape(port))
            rounds[regime] = fams
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
        assert any("drained; exiting 0" in ln for ln in lines)
    warm, packed = rounds["1"]
    assert total(packed, "ka_dispatch_batches_total") >= 1
    assert total(packed, "ka_dispatch_jobs_total") >= 8
    assert total(packed, "ka_compile_store_misses_total") == total(
        warm, "ka_compile_store_misses_total")
    for fam in ("ka_dispatch_batch_size", "ka_daemon_solve_queue_ms",
                "ka_dispatch_queue_depth", "ka_dispatch_window_ms",
                "ka_dispatch_pad_waste_frac"):
        assert fam in packed, fam
    (off,) = rounds["0"]
    assert total(off, "ka_dispatch_jobs_total") == 0
