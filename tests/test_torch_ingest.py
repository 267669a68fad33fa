"""Mode 3's streamed ingest in the port (``kafka_assigner_tpu_torch/
generator.py:stream_initial_assignment``, ``models/problem.py:
GroupEncodeAccumulator``, the device solver's ``preencoded`` entry) against
the JAX package's, on the CPU; the twins of ``tests/test_zk_ingest_stream.py``.

- the chunked accumulator equals the port's one-shot ``encode_topic_group``
  and the JAX package's accumulator, array for array, at chunk sizes 1, 3,
  64 and all, under both codecs (``KA_HOSTCODEC``), and on the empty group;
- the stream equals ``partition_assignment`` and the JAX stream, preencode
  included; the overlap kill switch, a backend without ``fetch_topics``, a
  producer error re-raised on the consumer thread, duplicates per
  occurrence, and under best-effort a topic missing mid-scan skipped;
- the device solver consumes the preencode with the plan it would have
  produced by encoding, and rejects a stale one;
- over the jute server, the duplicate-occurrence edge (a name that both
  vanished and resolved in one scan) drops the preencode, with stdout and
  stderr equal to the reference's;
- on the card (``cuda``-marked), a streamed solve equals the CPU's.

Tolerance: exact (integer arrays and bytes).
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
from kafka_assigner_tpu.cli import run as jax_run
from kafka_assigner_tpu.generator import stream_initial_assignment as jax_stream
from kafka_assigner_tpu.io.snapshot import SnapshotBackend as JaxSnapshot
from kafka_assigner_tpu.models.problem import GroupEncodeAccumulator as JaxAccumulator
from kafka_assigner_tpu_torch import cli, generator
from kafka_assigner_tpu_torch import faults as torch_faults
from kafka_assigner_tpu_torch.assigner import TopicAssigner
from kafka_assigner_tpu_torch.generator import stream_initial_assignment
from kafka_assigner_tpu_torch.io.base import MetadataBackend
from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend
from kafka_assigner_tpu_torch.models import problem
from kafka_assigner_tpu_torch.models.problem import (
    GroupEncodeAccumulator,
    encode_topic_group,
)
from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver

from .jute_server import JuteZkServer, cluster_tree


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    for knob in ("KA_ZK_OVERLAP", "KA_ZK_INGEST_CHUNK", "KA_ZK_PIPELINE", "KA_HOSTCODEC",
                 "KA_FAULTS_SPEC", "KA_FAILURE_POLICY"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("KA_ZK_CLIENT", "wire")
    jax_faults.reset()
    torch_faults.reset()
    yield
    jax_faults.reset()
    torch_faults.reset()


def _cluster():
    """12 brokers in 3 racks and one rackless; 9 topics of mixed width and
    partition count, one with a broker outside the live set and one with
    ragged replica lists (both encode paths stream)."""
    brokers = set(range(100, 112))
    racks = {b: f"r{b % 3}" for b in sorted(brokers) if b != 111}
    topics = []
    for i in range(9):
        p = 1 + (i * 7) % 13
        topics.append((f"topic-{i}", {
            pid: [100 + (pid + r + i) % 12 for r in range(2 + i % 3)] for pid in range(p)
        }))
    topics.append(("dead-broker", {0: [100, 999], 1: [101, 102]}))
    topics.append(("ragged", {0: [100], 1: [101, 102, 103]}))
    return topics, racks, brokers


def _assert_same_group(got, ref):
    encs, cur, jh, pr = got
    r_encs, r_cur, r_jh, r_pr = ref
    assert np.array_equal(cur, r_cur) and cur.dtype == r_cur.dtype
    assert np.array_equal(jh, r_jh) and np.array_equal(pr, r_pr)
    assert len(encs) == len(r_encs)
    for e, r in zip(encs, r_encs):
        assert e.topic == r.topic
        assert (e.n, e.p, e.n_pad, e.p_pad, e.r_cap, e.jhash) \
            == (r.n, r.p, r.n_pad, r.p_pad, r.r_cap, r.jhash)
        assert np.array_equal(e.partition_ids, r.partition_ids)
        assert np.array_equal(e.current, r.current)
        assert np.array_equal(e.rack_idx, r.rack_idx)
        assert np.array_equal(e.broker_ids, r.broker_ids)


@pytest.mark.parametrize("codec", ["1", "0"])
@pytest.mark.parametrize("chunk", [1, 3, 64, 11])
def test_accumulator_matches_one_shot_and_the_reference(monkeypatch, chunk, codec):
    monkeypatch.setenv("KA_HOSTCODEC", codec)
    topics, racks, brokers = _cluster()
    one_shot = encode_topic_group(topics, racks, brokers, 0)
    acc, ref = GroupEncodeAccumulator(racks, brokers), JaxAccumulator(racks, brokers)
    for i in range(0, len(topics), chunk):
        acc.add(topics[i:i + chunk])
        ref.add(topics[i:i + chunk])
    assert acc.codecs == ["c" if codec == "1" else "numpy"] * (-(-len(topics) // chunk))
    got = acc.finish()
    _assert_same_group(got, one_shot)
    _assert_same_group(got, ref.finish())
    assert acc.encode_ms >= 0.0
    # Each encoding's current is its row of the final slab, not a chunk's.
    encs, cur, _, _ = got
    for i, e in enumerate(encs):
        assert e.current.base is cur
        assert np.array_equal(e.current, cur[i])


def test_accumulator_empty_group():
    _, racks, brokers = _cluster()
    got = GroupEncodeAccumulator(racks, brokers).finish()
    _assert_same_group(got, JaxAccumulator(racks, brokers).finish())
    assert got[0] == [] and got[1].shape == (1, 8, 2)


@pytest.fixture()
def snapshot(tmp_path):
    topics, racks, brokers = _cluster()
    cluster = {
        "brokers": [{"id": b, "host": f"h{b}", "port": 9092,
                     **({"rack": racks[b]} if b in racks else {})} for b in sorted(brokers)],
        "topics": {t: {str(p): r for p, r in parts.items()}
                   for t, parts in topics if t != "dead-broker"},
    }
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(cluster))
    return str(path)


def test_stream_matches_partition_assignment_and_the_reference(snapshot):
    backend, ref_backend = SnapshotBackend(snapshot), JaxSnapshot(snapshot)
    names = backend.all_topics()
    initial, pre = stream_initial_assignment(backend, names)
    assert initial == backend.partition_assignment(names) and pre is None
    _, racks, brokers = _cluster()
    initial, pre = stream_initial_assignment(backend, names, brokers, racks,
                                             want_encode=True)
    ref_initial, ref_pre = jax_stream(ref_backend, names, brokers, racks, want_encode=True)
    assert initial == ref_initial == backend.partition_assignment(names)
    _assert_same_group(pre, ref_pre)
    _assert_same_group(pre, encode_topic_group([(t, initial[t]) for t in names],
                                               racks, brokers, 0))
    assert generator.last_ingest["preencoded"] and generator.last_ingest["topics"] == len(names)


def test_stream_respects_overlap_kill_switch(snapshot, monkeypatch):
    monkeypatch.setenv("KA_ZK_OVERLAP", "0")
    backend = SnapshotBackend(snapshot)
    names = backend.all_topics()
    _, racks, brokers = _cluster()
    initial, pre = stream_initial_assignment(backend, names, brokers, racks,
                                             want_encode=True)
    assert initial == backend.partition_assignment(names) and pre is None


def test_stream_falls_back_without_fetch_topics(snapshot):
    backend = SnapshotBackend(snapshot)

    class Legacy:
        partition_assignment = backend.partition_assignment

    names = backend.all_topics()
    _, racks, brokers = _cluster()
    initial, pre = stream_initial_assignment(Legacy(), names, brokers, racks,
                                             want_encode=True)
    assert initial == backend.partition_assignment(names) and pre is None


def test_explicit_protocol_subclass_inherits_working_fetch_topics(snapshot, capsys):
    inner = SnapshotBackend(snapshot)

    class Subclassed(MetadataBackend):
        def brokers(self):
            return inner.brokers()

        def all_topics(self):
            return inner.all_topics()

        def partition_assignment(self, topics):
            return inner.partition_assignment(topics)

    backend = Subclassed()
    names = inner.all_topics()
    assert list(backend.fetch_topics(names)) == list(inner.fetch_topics(names))
    assert list(backend.fetch_topics(["ghost"] + names, missing="skip")) \
        == list(inner.fetch_topics(["ghost"] + names, missing="skip"))
    assert "treating as vanished" in capsys.readouterr().err
    with pytest.raises(KeyError):
        list(backend.fetch_topics(["ghost"], missing="skip"))  # nothing resolves


@pytest.mark.parametrize("want_encode", [False, True])
def test_producer_error_reraises_on_consumer_thread(snapshot, want_encode):
    """A failure on the producer thread is raised on the calling thread,
    as a serial read's would be."""
    _, racks, brokers = _cluster()
    with pytest.raises(KeyError, match="no_such_topic"):
        stream_initial_assignment(SnapshotBackend(snapshot), ["topic-1", "no_such_topic"],
                                  brokers, racks, want_encode=want_encode)

    class Failing:
        def fetch_topics(self, topics, missing="raise"):
            yield topics[0], {0: [100, 101]}
            failing_thread.append(threading.current_thread())
            raise ConnectionResetError("session dropped")

    failing_thread: list = []
    with pytest.raises(ConnectionResetError, match="session dropped"):
        stream_initial_assignment(Failing(), ["a", "b"], brokers, racks,
                                  want_encode=want_encode)
    assert failing_thread
    assert (failing_thread[0] is threading.current_thread()) is not want_encode


def test_stream_under_a_short_switch_interval_loses_nothing():
    """The producer thread and the encode share only the queue: with the
    interpreter switching threads every microsecond, 3,000 one-topic
    chunks stream into exactly the one-shot encode, in order."""
    import sys

    names = [f"t{i:04d}" for i in range(3000)]
    parts = {t: {p: [100 + (i + p + r) % 12 for r in range(3)] for p in range(1 + i % 5)}
             for i, t in enumerate(names)}

    class Slow:
        def fetch_topics(self, topics, missing="raise"):
            for t in topics:
                yield t, parts[t]

    _, racks, brokers = _cluster()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("KA_ZK_INGEST_CHUNK", "1")
            done = []
            t = threading.Thread(target=lambda: done.append(stream_initial_assignment(
                Slow(), names, brokers, racks, want_encode=True)))
            t.start()
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive() and done
    initial, pre = done[0]
    assert list(initial) == names and initial == parts
    assert generator.last_ingest["chunks"] == 3000
    _assert_same_group(pre, encode_topic_group([(t, parts[t]) for t in names],
                                               racks, brokers, 0))


def test_duplicate_topics_stream_per_occurrence(snapshot):
    backend = SnapshotBackend(snapshot)
    names = backend.all_topics()[:1] * 3
    _, racks, brokers = _cluster()
    initial, pre = stream_initial_assignment(backend, names, brokers, racks,
                                             want_encode=True)
    _, ref_pre = jax_stream(JaxSnapshot(snapshot), names, brokers, racks, want_encode=True)
    assert list(initial) == names[:1]
    assert [e.topic for e in pre[0]] == names
    _assert_same_group(pre, ref_pre)


@pytest.mark.parametrize("overlap", ["1", "0"])
def test_best_effort_skips_a_topic_missing_mid_scan(snapshot, monkeypatch, overlap):
    monkeypatch.setenv("KA_ZK_OVERLAP", overlap)
    topics = ["topic-1", "ghost", "topic-2", "ghost"]
    _, racks, brokers = _cluster()
    runs = []
    for fn, backend in ((stream_initial_assignment, SnapshotBackend(snapshot)),
                        (jax_stream, JaxSnapshot(snapshot))):
        skipped: list = []
        with contextlib.redirect_stderr(io.StringIO()) as err:
            initial, pre = fn(backend, topics, brokers, racks, want_encode=True,
                              failure_policy="best-effort", skipped=skipped)
        runs.append((initial, pre, skipped, err.getvalue()))
    (got, got_pre, got_skipped, got_err), (ref, ref_pre, ref_skipped, ref_err) = runs
    assert got == ref and list(got) == ["topic-1", "topic-2"]
    assert got_skipped == ref_skipped == ["ghost", "ghost"]
    assert got_err == ref_err
    if overlap == "1":
        assert [e.topic for e in got_pre[0]] == ["topic-1", "topic-2"]
        _assert_same_group(got_pre, ref_pre)
    else:
        assert got_pre is None and ref_pre is None


def _rfs(topics):
    return [len(next(iter(c.values()))) for _, c in topics]


def test_solver_consumes_the_preencode():
    """The device solver on a preencode gives the plan it gives by
    encoding, and says it took the preencode."""
    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster

    topics = []
    for rf in (3, 2):
        tm, _, racks = rack_striped_cluster(16, 5, 4 + rf, rf, 4, name_fmt=f"rf{rf}-{{}}",
                                            extra_brokers=2)
        topics += list(tm.items())
    brokers = set(range(2, 18))  # brokers 0 and 1 replaced by 16 and 17
    racks = {b: racks[b] for b in brokers}
    acc = GroupEncodeAccumulator(racks, brokers)
    for i in range(0, len(topics), 4):
        acc.add(topics[i:i + 4])
    pre = acc.finish()
    solver = TorchSolver("cpu")
    plain = solver.assign_many(topics, racks, brokers, _rfs(topics))
    assert solver.last_codec["encode"] in ("c", "numpy")
    took = solver.assign_many(topics, racks, brokers, _rfs(topics), preencoded=pre)
    assert took == plain
    assert solver.last_codec["encode"] == "preencoded"
    assigner = TopicAssigner(device="cpu")
    assert assigner.generate_assignments(topics, brokers, racks, preencoded=pre) == plain
    assert assigner.solver.last_codec["encode"] == "preencoded"


@pytest.mark.parametrize("stale", ["broker removed", "rack moved", "topic order"])
def test_stale_preencode_is_rejected(stale):
    topics = [("t", {0: [1, 2], 1: [2, 3]}), ("u", {0: [3, 4]})]
    racks = {1: "a", 2: "b", 3: "c", 4: "a"}
    acc = GroupEncodeAccumulator(racks, {1, 2, 3, 4})
    acc.add(topics)
    pre = acc.finish()
    nodes, batch = {1, 2, 3, 4}, topics
    if stale == "broker removed":
        nodes = {1, 2, 3}
    elif stale == "rack moved":
        racks = {**racks, 4: "b"}
    else:
        batch = topics[::-1]
    match = "does not match the topic batch" if stale == "topic order" \
        else "different broker set"
    with pytest.raises(ValueError, match=match):
        TorchSolver("cpu").assign_many(batch, racks, nodes, 2, preencoded=pre)


def _run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def test_duplicate_occurrence_edge_drops_the_preencode(request, monkeypatch):
    """``--topics events,events`` under best-effort with the first read of
    ``events`` answered NoNode: the name both vanished and resolved in one
    scan, so the preencode no longer matches the plan's topic list; the
    solve encodes instead. Exit code, stdout and the skip lines equal the
    reference's."""
    monkeypatch.setenv("KA_FAULTS_SPEC", "reply:5=nonode")
    results = []
    for fn, extra in ((jax_run, ["--solver", "tpu"]), (cli.run, ["--device", "cpu"])):
        server = JuteZkServer(cluster_tree())
        server.start()
        request.addfinalizer(server.shutdown)
        jax_faults.reset()
        torch_faults.reset()
        results.append(_run(fn, ["--zk_string", f"127.0.0.1:{server.port}", "--mode",
                                 "PRINT_REASSIGNMENT", "--topics", "events,events",
                                 "--failure-policy", "best-effort"] + extra))
    ref, got = results
    assert got[0] == ref[0] == 0  # the plan lost no topic
    assert got[1] == ref[1] and '"topic":"events"' in got[1]
    skip = lambda err: [ln for ln in err.splitlines() if "vanished" in ln]  # noqa: E731
    assert skip(got[2]) == skip(ref[2]) and skip(got[2])
    assert generator.last_ingest["preencoded"]  # one was built, then dropped
    assert generator.last_ingest["solve_encode"] == problem.last_codec["encode"] == "c"


def test_mode3_over_zookeeper_streams_into_the_solve(request):
    """Mode 3 on the device lane over the socket: the accumulator's encode
    took the C codec and the solve took its preencode."""
    server = JuteZkServer(cluster_tree())
    server.start()
    request.addfinalizer(server.shutdown)
    rc, out, _ = _run(cli.run, ["--zk_string", f"127.0.0.1:{server.port}", "--mode",
                                "PRINT_REASSIGNMENT", "--device", "cpu"])
    assert rc == 0 and "NEW ASSIGNMENT:" in out
    assert generator.last_ingest["codecs"] == ["c"]
    assert generator.last_ingest["solve_encode"] == "preencoded"
    assert generator.last_ingest["topics"] == 2


@pytest.mark.cuda
def test_streamed_solve_on_the_card_equals_cpu(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster
    from kafka_assigner_tpu_torch.ops import leadership as lead

    topic_map, _, racks = rack_striped_cluster(40, 24, 12, 3, 5, extra_brokers=2)
    tree = {f"/brokers/ids/{b}": json.dumps({"host": f"h{b}", "port": 9092,
                                             "rack": racks[b]}).encode() for b in racks}
    for t, parts in topic_map.items():
        tree[f"/brokers/topics/{t}"] = json.dumps(
            {"partitions": {str(p): r for p, r in parts.items()}}).encode()
    server = JuteZkServer(tree)
    server.start()
    request.addfinalizer(server.shutdown)
    argv = ["--zk_string", f"127.0.0.1:{server.port}", "--mode", "PRINT_REASSIGNMENT",
            "--broker_hosts_to_remove", "h0,h1"]
    before = lead.launches["leadership"]
    on_card = _run(cli.run, argv + ["--device", "cuda"])
    assert lead.launches["leadership"] == before + 1
    assert generator.last_ingest["solve_encode"] == "preencoded"
    on_cpu = _run(cli.run, argv + ["--device", "cpu"])
    assert on_card[0] == on_cpu[0] == 0 and on_card[1] == on_cpu[1]
