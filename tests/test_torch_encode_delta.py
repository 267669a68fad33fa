"""The port's delta encode (``GroupEncodeAccumulator.update_topics``,
``delete_topic``, ``merge``) against the JAX package's, on the CPU: the seven
cases of ``tests/test_encode_delta.py`` on the port's accumulator, and
randomized churn on seeds under both ``KA_HOSTCODEC`` settings, where the
port's ``merge`` equals the JAX package's field by field and equals a
from-scratch port ``encode_topic_group`` of the final state. Every
comparison is exact: encodes are integer arrays."""
from __future__ import annotations

import random

import numpy as np
import pytest

from kafka_assigner_tpu.models import problem as jax_problem
from kafka_assigner_tpu_torch.models import problem
from kafka_assigner_tpu_torch.models.problem import (
    GroupEncodeAccumulator,
    encode_topic_group,
)
from kafka_assigner_tpu_torch.native import build as nbuild

BROKERS = set(range(1, 10))
RACKS = {b: f"r{(b - 1) % 3}" for b in BROKERS}


@pytest.fixture(scope="module", autouse=True)
def built():
    """The port's codec built, as its entry points build it."""
    nbuild.build_hostcodec()


@pytest.fixture(params=["1", "0"], ids=["c-codec", "numpy"])
def codec(request, monkeypatch):
    monkeypatch.setenv("KA_HOSTCODEC", request.param)
    return "c" if request.param == "1" else "numpy"


def _random_topic(rng, name):
    p = rng.randint(1, 30)
    rf = rng.randint(1, 3)
    return name, {pid: rng.sample(sorted(BROKERS), rf) for pid in range(p)}


def _assert_fields_equal(a, b):
    """Two ``(encs, currents, jhashes, p_reals)`` results, array by array and
    encoding by encoding, dtypes included."""
    encs_a, *arrays_a = a
    encs_b, *arrays_b = b
    for x, y in zip(arrays_a, arrays_b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert [e.topic for e in encs_a] == [e.topic for e in encs_b]
    for ea, eb in zip(encs_a, encs_b):
        assert (ea.p, ea.p_pad, ea.n, ea.n_pad, ea.jhash, ea.rf, ea.r_cap) == (
            eb.p, eb.p_pad, eb.n, eb.n_pad, eb.jhash, eb.rf, eb.r_cap)
        for field in ("partition_ids", "broker_ids", "rack_idx", "current"):
            np.testing.assert_array_equal(getattr(ea, field), getattr(eb, field))


def _assert_merge_equals_scratch(acc, topics):
    order = sorted(topics)
    _assert_fields_equal(
        acc.merge(order),
        encode_topic_group([(t, topics[t]) for t in order], RACKS, BROKERS,
                           [0] * len(order)),
    )


def _churn(seed, *accs):
    """One randomized churn sequence (adds, deletes, grows and reassigns in
    place) applied to every accumulator; returns the final topic map."""
    rng = random.Random(seed)
    topics = {}
    next_id = 0

    def add():
        nonlocal next_id
        name, cur = _random_topic(rng, f"t{next_id}")
        next_id += 1
        topics[name] = cur
        for acc in accs:
            acc.update_topics([(name, cur)])

    for _ in range(rng.randint(1, 6)):
        add()
    for _step in range(25):
        op = rng.random()
        if op < 0.35 or not topics:
            add()
        elif op < 0.55:
            name = rng.choice(sorted(topics))
            del topics[name]
            for acc in accs:
                assert acc.delete_topic(name)
        else:
            name = rng.choice(sorted(topics))
            _, cur = _random_topic(rng, name)
            topics[name] = cur
            for acc in accs:
                acc.update_topics([(name, cur)])
    return topics


@pytest.mark.parametrize("seed", range(8))
def test_randomized_churn_matches_from_scratch(seed):
    acc = GroupEncodeAccumulator(RACKS, BROKERS)
    topics = _churn(seed, acc)
    _assert_merge_equals_scratch(acc, topics)


@pytest.mark.parametrize("seed", range(6))
def test_randomized_churn_matches_the_jax_merge(seed, codec):
    """The port's merge equals the JAX package's, field by field, and a
    from-scratch port encode of the final state, through the codec the knob
    names; chunked updates (the resync's seeding) merge the same."""
    port = GroupEncodeAccumulator(RACKS, BROKERS)
    jax = jax_problem.GroupEncodeAccumulator(RACKS, BROKERS)
    topics = _churn(100 + seed, port, jax)
    assert problem.last_codec["encode"] == codec
    rng = random.Random(seed)
    order = sorted(topics)
    rng.shuffle(order)
    merged = port.merge(order)
    _assert_fields_equal(merged, jax.merge(order))
    _assert_fields_equal(
        merged,
        encode_topic_group([(t, topics[t]) for t in order], RACKS, BROKERS,
                           [0] * len(order)),
    )
    chunked = GroupEncodeAccumulator(RACKS, BROKERS)
    items = list(topics.items())
    for i in range(0, len(items), 3):
        assert chunked.update_topics(items[i:i + 3]) == len(items[i:i + 3])
    _assert_fields_equal(chunked.merge(order), merged)
    assert port.delta_shape() == jax.delta_shape()
    assert port.delta_topics() == jax.delta_topics()


def test_merge_is_non_destructive_and_order_sensitive():
    acc = GroupEncodeAccumulator(RACKS, BROKERS)
    a = {0: [1, 2], 1: [2, 3]}
    b = {0: [4, 5, 6]}
    acc.update_topics([("a", a), ("b", b)])
    first = acc.merge(["a", "b"])
    again = acc.merge(["a", "b"])
    np.testing.assert_array_equal(first[1], again[1])
    swapped = acc.merge(["b", "a"])
    _, cur_s, jh_s, _ = encode_topic_group([("b", b), ("a", a)], RACKS, BROKERS, [0, 0])
    np.testing.assert_array_equal(swapped[1], cur_s)
    np.testing.assert_array_equal(swapped[2], jh_s)


def test_shrink_after_giant_topic_shrinks_buckets(codec):
    """A deleted giant topic does not inflate later merges: each entry is
    trimmed to its own buckets, also when it shared a chunk with the giant."""
    acc = GroupEncodeAccumulator(RACKS, BROKERS)
    jax = jax_problem.GroupEncodeAccumulator(RACKS, BROKERS)
    giant = {p: [1, 2, 3] for p in range(200)}
    small = {0: [1, 2]}
    for a in (acc, jax):
        a.update_topics([("giant", giant), ("small", small)])
    assert acc.delta_shape() == jax.delta_shape() == (200, 3)
    for a in (acc, jax):
        a.delete_topic("giant")
    merged = acc.merge(["small"])
    scratch = encode_topic_group([("small", small)], RACKS, BROKERS, [0])
    assert merged[1].shape == scratch[1].shape == (1, 8, 2)
    _assert_fields_equal(merged, scratch)
    _assert_fields_equal(merged, jax.merge(["small"]))
    assert acc.delta_shape() == (8, 2)


def test_merge_unknown_topic_raises():
    acc = GroupEncodeAccumulator(RACKS, BROKERS)
    acc.update_topics([("known", {0: [1, 2]})])
    with pytest.raises(KeyError, match="ghost"):
        acc.merge(["known", "ghost"])


def test_duplicate_topic_occurrences_in_order():
    acc = GroupEncodeAccumulator(RACKS, BROKERS)
    cur = {0: [1, 2], 1: [3, 4]}
    acc.update_topics([("dup", cur)])
    _assert_fields_equal(
        acc.merge(["dup", "dup"]),
        encode_topic_group([("dup", cur), ("dup", cur)], RACKS, BROKERS, [0, 0]),
    )


def test_empty_merge_matches_empty_finish_shape():
    acc = GroupEncodeAccumulator(RACKS, BROKERS)
    encs, cur, jh, pr = acc.merge([])
    assert encs == [] and cur.shape == (1, 8, 2)
    assert acc.delta_shape() is None
    _assert_fields_equal((encs, cur, jh, pr), GroupEncodeAccumulator(RACKS, BROKERS).finish())


def test_delta_and_streaming_chunks_coexist():
    """The streamed ``add``/``finish`` path and the delta store are
    independent: using one never corrupts the other."""
    acc = GroupEncodeAccumulator(RACKS, BROKERS)
    stream = [(f"s{i}", {0: [1, 2], 1: [2, 3]}) for i in range(3)]
    acc.add(stream)
    acc.update_topics([("d0", {0: [4, 5]})])
    _assert_fields_equal(acc.finish(), encode_topic_group(stream, RACKS, BROKERS, [0] * 3))
    _assert_fields_equal(
        acc.merge(["d0"]),
        encode_topic_group([("d0", {0: [4, 5]})], RACKS, BROKERS, [0]),
    )


def test_merged_encodings_own_their_partition_ids(codec):
    """A stored entry keeps no view into its chunk's slab, and a merge's
    encodings view the merge's own ``currents``."""
    acc = GroupEncodeAccumulator(RACKS, BROKERS)
    acc.update_topics([(f"t{i}", {p: [1 + (i + p) % 9, 1 + (i + p + 1) % 9]
                                  for p in range(5 + i)}) for i in range(4)])
    for enc, cur, _, _ in acc._delta.values():
        assert enc.partition_ids.base is None and cur.base is None
    encs, currents, _, _ = acc.merge(["t3", "t0"])
    assert all(np.shares_memory(e.current, currents) for e in encs)
