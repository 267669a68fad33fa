"""The port's batched placement (``kafka_assigner_tpu_torch/ops/
assignment.py``) against the JAX package's ``sticky_fill``,
``cluster_segments`` and ``place_scan`` for each leg of the chain.

Both sides get identical encoded inputs (the JAX package's own
``encode_topic_group``, handed to the port through ``carry.py``). Integers
everywhere: exact equality.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kafka_assigner_tpu.models.problem import encode_topic_group
from kafka_assigner_tpu.models.synthetic import rack_striped_cluster
from kafka_assigner_tpu.ops import assignment as jops
from kafka_assigner_tpu_torch.carry import encoded_to_torch, to_numpy, to_tensor
from kafka_assigner_tpu_torch.ops import assignment as tops


def _instance(kind):
    if kind == "expansion":  # fast-leg solvable: replace 4 of 60 brokers
        tm, _, racks = rack_striped_cluster(
            60, 6, 24, 3, 5, name_fmt="tp-{:03d}", extra_brokers=4
        )
        live = set(range(4, 64))
    elif kind == "saturated":  # strands fast, dense; balance rescues
        tm, _, racks = rack_striped_cluster(
            50, 3, 250, 3, 5, name_fmt="tpsat-{:02d}", extra_brokers=10
        )
        live = set(range(10, 60))
    else:  # decommission: brokers leave, nobody joins
        tm, _, racks = rack_striped_cluster(40, 5, 30, 3, 4, name_fmt="tpd-{:02d}")
        live = set(range(4, 40))
    return list(tm.items()), live, {b: racks[b] for b in live}


def _encode(topics, live, rack_map, rfs):
    encs, currents, jhashes, p_reals = encode_topic_group(
        topics, rack_map, live, rfs
    )
    return encs, currents, jhashes, p_reals


def _jax_place(encs, currents, jhashes, p_reals, rf, mode, rfs=None):
    out = jax.device_get(jops.place_scan_jit(
        jnp.asarray(currents), jnp.asarray(encs[0].rack_idx),
        jnp.asarray(jhashes), jnp.asarray(p_reals), n=encs[0].n, rf=rf,
        wave_mode=mode, rfs=None if rfs is None else jnp.asarray(rfs),
        r_cap=encs[0].r_cap,
    ))
    return [np.asarray(o) for o in out[:4]]


def _port_place(encs, currents, jhashes, p_reals, rf, mode, rfs=None):
    cur, rack, jh, pr = encoded_to_torch(currents, encs[0].rack_idx, jhashes, p_reals)
    res = tops.place_batched(
        cur, rack, jh, pr, encs[0].n, rf, mode,
        None if rfs is None else to_tensor(rfs), r_cap=encs[0].r_cap,
    )
    outs = [to_numpy(t) for t in (res.acc_nodes, res.acc_count,
                                  res.infeasible, res.deficit)]
    return outs, res.waves


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_sticky_fill_matches_jax_per_topic():
    topics, live, rack_map = _instance("decommission")
    encs, currents, jhashes, p_reals = _encode(topics, live, rack_map, 3)
    n, rf = encs[0].n, 3
    b = len(encs)
    cap = (p_reals[:b] * rf + n - 1) // n
    alive = np.arange(encs[0].n_pad) < n
    cur, rack, _, pr = encoded_to_torch(
        currents[:b], encs[0].rack_idx, jhashes[:b], p_reals[:b]
    )
    got = tops.sticky_fill(
        cur, rack, rf, to_tensor(cap), n, pr, tops.default_alive(rack, n),
        to_tensor(np.full(b, rf)),
    )
    for t in range(b):
        ref = jops.sticky_fill(
            jnp.asarray(currents[t]), jnp.asarray(encs[0].rack_idx), rf,
            jnp.int32(cap[t]), n, jnp.int32(p_reals[t]), jnp.asarray(alive),
        )
        np.testing.assert_array_equal(to_numpy(got.acc_nodes[t]), np.asarray(ref.acc_nodes))
        np.testing.assert_array_equal(to_numpy(got.acc_count[t]), np.asarray(ref.acc_count))
        np.testing.assert_array_equal(to_numpy(got.node_load[t]), np.asarray(ref.node_load))
        np.testing.assert_array_equal(to_numpy(got.deficit[t]), np.asarray(ref.deficit))


def test_cluster_segments_matches_jax():
    topics, live, rack_map = _instance("expansion")
    encs, *_ = _encode(topics, live, rack_map, 3)
    n, r_cap = encs[0].n, encs[0].r_cap
    alive = np.arange(encs[0].n_pad) < n
    ref = jops.cluster_segments(jnp.asarray(encs[0].rack_idx), n, jnp.asarray(alive), r_cap)
    rack = to_tensor(encs[0].rack_idx)
    got = tops.cluster_segments(rack, n, tops.default_alive(rack, n), r_cap)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(r))


@pytest.mark.parametrize(
    "kind,mode",
    [
        ("expansion", "auto"),
        ("expansion", "fast"),
        ("expansion", "dense"),
        ("expansion", "balance"),
        ("expansion", "seq"),
        ("decommission", "auto"),
        ("saturated", "auto"),
        ("saturated", "fast"),
        ("saturated", "seq"),
    ],
)
def test_each_leg_matches_place_scan(kind, mode):
    topics, live, rack_map = _instance(kind)
    enc = _encode(topics, live, rack_map, 3)
    ref = _jax_place(*enc, 3, mode)
    got, waves = _port_place(*enc, 3, mode)
    _assert_same(got, ref)
    assert set(waves) <= set(tops.WAVE_MODES[mode])


def test_saturated_chain_really_runs_every_rescue_leg():
    # The saturated instance strands the fast and dense legs, so the
    # batched chain must hand those topics on and balance must solve them.
    topics, live, rack_map = _instance("saturated")
    enc = _encode(topics, live, rack_map, 3)
    got, waves = _port_place(*enc, 3, "auto")
    assert waves.get("dense", 0) > 0 and waves.get("balance", 0) > 0
    assert not got[2][: len(topics)].any()


def test_seq_rescues_auction_strand():
    # tests/test_tpu_parity.py::test_seq_leg_rescues_auction_strand_byte_equal:
    # cap == 1 with an exactly-tight orphan matching — every auction leg
    # strands and only the seq leg threads through.
    inter = list(range(100, 115))
    racks = {100 + i: f"r{i % 5}" for i in range(15)}
    racks[115] = "r0"
    live = set(range(101, 116))
    rack_map = {b: racks[b] for b in live}
    current = {p: [inter[(5 + p + i) % 15] for i in range(3)] for p in range(5)}
    enc = _encode([("__consumer_offsets", current)], live, rack_map, 3)
    ref = _jax_place(*enc, 3, "auto")
    got, waves = _port_place(*enc, 3, "auto")
    _assert_same(got, ref)
    assert "seq" in waves and not got[2][0]


def test_mixed_rf_batch_matches_place_scan():
    tm, _, racks = rack_striped_cluster(30, 6, 16, 3, 5, name_fmt="tprf-{:02d}")
    live = set(range(2, 30))
    rack_map = {b: racks[b] for b in live}
    rfs = [3, 2, 3, 1, 2, 3]
    enc = _encode(list(tm.items()), live, rack_map, rfs)
    rfs_arr = np.full(enc[1].shape[0], 3, np.int32)
    rfs_arr[: len(rfs)] = rfs
    _assert_same(
        _port_place(*enc, 3, "auto", rfs_arr)[0],
        _jax_place(*enc, 3, "auto", rfs_arr),
    )


def test_infeasible_topic_flags_and_deficit_match():
    # Three brokers on one rack cannot hold RF 2: every leg strands.
    current = {0: [10, 11], 1: [11, 10]}
    rack_map = {10: "a", 11: "a", 12: "a"}
    enc = _encode([("t", current)], {10, 11, 12}, rack_map, 2)
    ref = _jax_place(*enc, 2, "auto")
    got, _ = _port_place(*enc, 2, "auto")
    _assert_same(got, ref)
    assert got[2][0]


def test_requests_rank_counts_earlier_same_key_rows():
    pick = to_tensor([[2, 1, 2, 0, 2, 1], [0, 0, 0, 0, 0, 0]])
    valid = to_tensor([[1, 1, 1, 1, 0, 1], [1, 0, 1, 1, 1, 1]]).bool()
    rank = to_numpy(tops._requests_rank(pick, valid, 3))
    np.testing.assert_array_equal(rank[0][valid[0].numpy()], [0, 0, 1, 0, 1])
    np.testing.assert_array_equal(rank[1][valid[1].numpy()], [0, 1, 2, 3, 4])
