"""The port's consumer-group family against the JAX package, on the CPU:

- ``encode_group`` / ``decode_plan`` field by field;
- ``pack_group`` and ``group_pack_sweep`` (the sticky pass, then the orphan
  scan's plain version) against ``pack_group_jit`` / ``group_pack_sweep_jit``
  and the host oracle ``greedypack.pack_consumers``, on the randomized
  instances of ``tests/test_groups.py`` and on the KG1 stress cases of
  ``ops/group_pack_cases.py``;
- the kernel's pick rule (first argmax of headroom, overflow when it is
  below the weight), emulated lane by lane, against ``pack_scan_plain``;
- the envelopes, the snapshot's ``groups`` and ``traffic`` sections, the
  synthetic family, and the ``ka-groups`` CLI byte for byte.

Inputs come from seeds; every output is an integer or a string, compared
exactly. The ``cuda``-marked tests hold the kernel against the plain version
on the card and skip without one.
"""
from __future__ import annotations

import contextlib
import io
import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kafka_assigner_tpu.groups.encode as jenc
import kafka_assigner_tpu.groups.solve as jsolve
import kafka_assigner_tpu_torch.groups.encode as tenc
import kafka_assigner_tpu_torch.groups.solve as tsolve
from kafka_assigner_tpu import faults
from kafka_assigner_tpu.cli import run_groups as jax_run_groups
from kafka_assigner_tpu.io.base import ConsumerGroupState as JState
from kafka_assigner_tpu.io.base import GroupMember as JMember
from kafka_assigner_tpu.io.snapshot import SnapshotBackend as JSnapshot
from kafka_assigner_tpu.obs.health import synthetic_partition_traffic as jax_traffic
from kafka_assigner_tpu.ops import assignment as jops
from kafka_assigner_tpu.solvers.greedypack import pack_consumers as jax_oracle
from kafka_assigner_tpu_torch import cli
from kafka_assigner_tpu_torch.errors import IngestError, SolveError
from kafka_assigner_tpu_torch.io.base import ConsumerGroupState, GroupMember
from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend
from kafka_assigner_tpu_torch.obs.health import synthetic_partition_traffic
from kafka_assigner_tpu_torch.ops import group_pack as gp
from kafka_assigner_tpu_torch.ops import group_pack_cases as gcases
from kafka_assigner_tpu_torch.ops.assignment import group_pack_sweep, pack_group
from kafka_assigner_tpu_torch.parallel import whatif as tw
from kafka_assigner_tpu_torch.solvers.greedypack import pack_consumers, scale_weights

from .test_groups import _state

CASES = {case[0]: case for case in gcases.stress_cases()}


@pytest.fixture(autouse=True)
def _fresh_injector():
    faults.reset()
    yield
    faults.reset()


def _port_state(st: JState) -> ConsumerGroupState:
    return ConsumerGroupState(
        st.group, tuple(GroupMember(m.member_id, m.capacity) for m in st.members),
        st.assignment, st.lags,
    )


def _encodings(st, **kw):
    return jenc.encode_group(st, **kw), tenc.encode_group(_port_state(st), **kw)


def _assert_same_encoding(a, b):
    for field in ("group", "rows", "members", "real_members", "p", "c", "p_pad",
                  "c_pad", "weight_kind", "shift", "total_weight"):
        assert getattr(a, field) == getattr(b, field), field
    for field in ("weights", "capacities", "current", "proc_order"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field


# --- encode -----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_encode_and_decode_match(seed):
    rng = random.Random(seed)
    n = rng.choice([1, 3, 7])
    st = _state(rng, n_topics=rng.randint(1, 3), max_parts=rng.choice([3, 11]),
                n_members=n)
    universe = {t: list(range(12)) for t in list(st.lags)[:1]}
    for kw in ({}, dict(max_consumers=2 * n + 3, max_scale_pct=300),
               dict(partitions=universe, capacity_headroom=2.0)):
        a, b = _encodings(st, **kw)
        _assert_same_encoding(a, b)
        cols = np.random.default_rng(seed).integers(-1, a.c_pad + 1, a.p_pad)
        assert jenc.decode_plan(a, cols) == tenc.decode_plan(b, cols)


def test_encode_overflow_shift_capacity_default_and_throughput_match():
    big = JState("big", (JMember("m0", 0.0), JMember("m1", 0.0)),
                 {"t": {0: "m0", 1: "m1"}}, {"t": {0: 2**30, 1: 2**29}})
    a, b = _encodings(big, max_scale_pct=800)
    assert a.shift > 0
    _assert_same_encoding(a, b)
    mixed = JState("g", (JMember("c-0", 400.0), JMember("c-1", 400.0), JMember("c-2", 0.0)),
                   {"t": {p: None for p in range(3)}}, {"t": {p: 99 for p in range(3)}})
    for headroom in (1.0, 2.0):
        a, b = _encodings(mixed, capacity_headroom=headroom)
        _assert_same_encoding(a, b)
    values = {("t", p): 1000.7 * (p + 1) for p in range(3)}
    a, b = _encodings(mixed, weight="throughput", weight_values=values)
    _assert_same_encoding(a, b)
    st = _port_state(mixed)
    with pytest.raises(ValueError, match="weight column"):
        tenc.encode_group(st, weight="entropy")
    with pytest.raises(ValueError, match="weight_values"):
        tenc.encode_group(st, weight="throughput")


# --- packing: the port's CPU path, the JAX package, the oracle ---------------

def _jax_pack(w, cap, cur, order, alive, p_real):
    out = jops.pack_group_jit(jnp.asarray(w), jnp.asarray(cap), jnp.asarray(cur),
                              jnp.asarray(order), jnp.asarray(alive), jnp.int32(p_real))
    return [np.asarray(x) for x in out]


def _assert_pack_matches(w, cap, cur, order, alive, p_real, oracle_rows=8):
    """Port pack_group (CPU) == pack_group_jit per candidate == the oracle."""
    t = [torch.as_tensor(np.ascontiguousarray(x)) for x in (w, cap, cur, order, alive)]
    got = [x.numpy() for x in pack_group(*t, p_real)]
    for s in range(w.shape[0]):
        ref = _jax_pack(w[s], cap, cur, order, alive[s], p_real)
        for g, r in zip(got, ref):
            assert np.array_equal(g[s], r), s
        if s < oracle_rows:
            host = pack_consumers([int(x) for x in w[s]], [int(x) for x in cap],
                                  [int(x) for x in cur], [int(x) for x in order],
                                  [bool(x) for x in alive[s]], p_real)
            assert host.assigned == got[0][s].tolist()
            assert host.load == got[1][s].tolist()
            assert (host.moved, host.overflowed) == (got[2][s], got[3][s])
    return got


@pytest.mark.parametrize("seed", range(8))
def test_pack_group_matches_jax_and_oracle_randomized(seed):
    rng = random.Random(seed)
    n_members = rng.choice([1, 2, 5, 12])
    st = _state(rng, n_topics=rng.randint(1, 3), max_parts=rng.choice([2, 9]),
                n_members=n_members, owned=rng.choice([0.3, 0.95]))
    enc = tenc.encode_group(_port_state(st), max_consumers=2 * n_members,
                            max_scale_pct=300)
    alive = enc.alive(enc.real_members)
    got = tw.pack_group_on_device(enc.weights, enc.capacities, enc.current,
                                  enc.proc_order, alive, enc.p, device="cpu")
    ref = _jax_pack(enc.weights, enc.capacities, enc.current, enc.proc_order, alive, enc.p)
    for g, r in zip(got, ref):
        assert np.array_equal(np.asarray(g), r)
    host = jax_oracle(scale_weights([int(x) for x in enc.weights], 100, enc.p),
                      [int(x) for x in enc.capacities], [int(x) for x in enc.current],
                      [int(x) for x in enc.proc_order], [bool(x) for x in alive], enc.p)
    assert host.assigned == got[0].tolist() and host.load == got[1].tolist()
    assert (host.moved, host.overflowed, not host.feasible) == got[2:]
    assert tw.last_groups["kind"] == "plan" and tw.last_groups["s"] == 1


@pytest.mark.parametrize("seed", range(4))
def test_group_pack_sweep_matches_jax_and_oracle(seed):
    rng = random.Random(100 + seed)
    st = _state(rng, n_members=rng.choice([2, 4]))
    enc = tenc.encode_group(_port_state(st), max_consumers=8, max_scale_pct=300)
    cand = [(s, k) for s in (100, 150, 300) for k in (1, 2, 4, 8)]
    alive = np.zeros((len(cand), enc.c_pad), dtype=bool)
    for i, (_s, k) in enumerate(cand):
        alive[i, :k] = True
    scales = np.array([s for s, _k in cand], np.int32)
    got = tw.evaluate_group_candidates(enc.weights, enc.capacities, enc.current,
                                       enc.proc_order, alive, scales, enc.p, device="cpu")
    ref = jops.group_pack_sweep_jit(
        *(jnp.asarray(x) for x in (enc.weights, enc.capacities, enc.current,
                                   enc.proc_order, alive, scales)), jnp.int32(enc.p))
    for g, r in zip(got, ref):
        assert np.array_equal(g, np.asarray(r))
    for i, (s, _k) in enumerate(cand):
        host = pack_consumers(scale_weights([int(x) for x in enc.weights], s, enc.p),
                              [int(x) for x in enc.capacities],
                              [int(x) for x in enc.current],
                              [int(x) for x in enc.proc_order],
                              [bool(x) for x in alive[i]], enc.p)
        assert (host.moved, host.overflowed) == (got[0][i], got[1][i])
        assert host.load == got[3][i].tolist()
    rec = tw.last_groups
    assert (rec["kind"], rec["s"], rec["c_pad"]) == ("sweep", len(cand), enc.c_pad)
    assert rec["steps_max"] <= enc.p and rec["steps_sum"] <= len(cand) * enc.p


def test_group_pack_sweep_scales_weights_as_the_reference():
    # Sub-100% scales floor real rows at 1 and keep pad rows at 0.
    w = torch.tensor([7, 1, 3, 0, 0, 0, 0, 0], dtype=torch.int32)
    cap = torch.tensor([4, 4, 0, 0, 0, 0, 0, 0], dtype=torch.int32)
    cur = torch.tensor([0, 1, -1, 0, 0, -1, -1, -1], dtype=torch.int32)
    order = torch.tensor([0, 2, 1, 3, 4, 5, 6, 7], dtype=torch.int32)
    alive = torch.zeros((3, 8), dtype=torch.bool)
    alive[:, :2] = True
    scales = torch.tensor([10, 50, 250], dtype=torch.int32)
    got = group_pack_sweep(w, cap, cur, order, alive, scales, 3)
    ref = jops.group_pack_sweep_jit(*(jnp.asarray(x.numpy()) for x in
                                      (w, cap, cur, order, alive, scales)), jnp.int32(3))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("name", sorted(CASES))
def test_stress_cases_match_jax_and_oracle(name):
    _, w, cap, cur, order, alive, p_real, _ = CASES[name]
    got = _assert_pack_matches(w, cap, cur, order, alive, p_real)
    if name == "no-consumer-alive":
        assert (got[0][:, :p_real] == 0).all() and (got[3] == p_real).all()
    if name == "every-row-overflows":
        assert (got[3] == p_real).all()
    if name == "need-none":
        assert (got[2] == 0).all() and (got[3] == 0).all()


# --- the kernel's pick rule, emulated lane by lane ----------------------------

def _kernel_rule(weights, capacities, proc_order, alive, need, assigned, load):
    """``csrc/group_pack.cu``'s loop in Python for one candidate: lane l owns
    columns l, l + 32, ...; a step takes the largest lane maximum and the
    lowest first index holding it; the row overflows when that maximum is
    below its weight; only a live pick's headroom moves."""
    c = len(capacities)
    hr = [capacities[j] - load[j] if alive[j] else -gp.BIG for j in range(c)]

    def lane_max(lane):
        best = (-(2**31), 2**31 - 1)
        for j in range(lane, c, 32):
            if hr[j] > best[0]:
                best = (hr[j], j)
        return best

    lanes = [lane_max(lane) for lane in range(32)]
    over = 0
    for base in range(0, len(proc_order), 32):
        for row in proc_order[base:base + 32]:
            if not need[row]:
                continue
            v = max(m for m, _ in lanes)
            i = min(j for m, j in lanes if m == v)
            over += v < weights[row]
            assigned[row] = i
            load[i] += weights[row]
            if alive[i]:
                hr[i] -= weights[row]
            lanes[i % 32] = lane_max(i % 32)
    return over


@pytest.mark.parametrize("name", sorted(n for n in CASES if "32768" not in n))
def test_kernel_rule_equals_the_plain_scan(name):
    inputs = gcases.scan_inputs(CASES[name])
    plain_in = [x.clone() for x in inputs]
    over = gp.pack_scan_plain(*plain_in)
    w, cap, order, alive, need, assigned, load = (x.tolist() for x in inputs)
    for s in range(len(w)):
        o = _kernel_rule(w[s], cap, order, alive[s], need[s], assigned[s], load[s])
        assert o == int(over[s])
    assert assigned == plain_in[5].tolist() and load == plain_in[6].tolist()


def test_pack_scan_takes_the_plain_version_only_on_the_cpu():
    inputs = gcases.scan_inputs(CASES["s1"])
    before = gp.launches["group_pack"]
    gp.pack_scan(*inputs)
    assert gp.launches["group_pack"] == before  # CPU tensors launch nothing
    with pytest.raises(TypeError, match="int32"):
        gp.pack_scan(inputs[0].long(), *inputs[1:])
    with pytest.raises(ValueError, match="need"):
        gp.pack_scan(*inputs[:4], inputs[4][:, :-1], *inputs[5:])
    with pytest.raises(ValueError, match="cpu or cuda"):
        gp.pack_scan(*(x.to("meta") for x in inputs))


# --- envelopes and the pipeline helpers ---------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_envelopes_match(seed):
    st = _state(random.Random(seed + 5), n_members=3)
    a, b = _encodings(st)
    ref, _ = jsolve.group_plan_envelope(a, groups_real=True, fallback="raise")
    assert tsolve.group_plan_envelope(b, True, device="cpu") == ref
    assert tsolve.group_plan_envelope(b, True, solver="greedy")["plan"] == ref["plan"]
    a, b = _encodings(st, max_consumers=6, max_scale_pct=200)
    counts, scales = [1, 2, 3, 6, 6, 0], [200, 100, 150]
    ref, _ = jsolve.group_sweep_envelope(a, counts, scales, True, fallback="raise")
    assert tsolve.group_sweep_envelope(b, counts, scales, True, device="cpu") == ref
    with pytest.raises(ValueError, match="usable consumer columns"):
        tsolve.group_sweep_envelope(b, [b.c + 1], [100], True, device="cpu")
    with pytest.raises(ValueError, match="at least one count"):
        tsolve.group_sweep_envelope(b, [0], [100], True, device="cpu")


def test_helpers_match():
    for args in ((10, 3, 12), (0, 1, 256), (40, 3, 256), (5, 4, 3)):
        assert tsolve.default_counts(*args) == jsolve.default_counts(*args)
    for value, default in (("100,150,", None), (None, "1,2"), (None, None),
                           ([3, "4"], None), (" 7 , 8", None)):
        assert tsolve.parse_int_list(value, default) == jsolve.parse_int_list(value, default)
    for junk in (True, "x,y"):
        with pytest.raises(ValueError):
            tsolve.parse_int_list(junk)
    st = _state(random.Random(9))
    part_map = {"t0": list(range(9)), "t1": [0, 1], "zz": [0]}
    assert tsolve.group_partition_universe(_port_state(st), part_map) \
        == jsolve.group_partition_universe(st, part_map)
    assert tsolve.subscribed_partitions({"g": _port_state(st)}, part_map) \
        == jsolve.subscribed_partitions({"g": st}, part_map)


def test_device_failure_is_a_solve_error():
    st = _state(random.Random(2))
    enc = tenc.encode_group(_port_state(st))
    if torch.cuda.is_available():
        assert tsolve.group_plan_envelope(enc, True, device="cuda") \
            == tsolve.group_plan_envelope(enc, True, device="cpu")
    else:
        with pytest.raises(SolveError, match="no CUDA device"):
            tsolve.group_plan_envelope(enc, True, device="cuda")


# --- backend hooks ------------------------------------------------------------

def _snapshot(tmp_path, groups=True, traffic=False, name="cluster.json"):
    snap = {
        "brokers": [{"id": i, "host": f"b{i}", "port": 9092} for i in range(3)],
        "topics": {"events": {str(p): [0, 1] for p in range(6)},
                   "logs": {str(p): [1, 2] for p in range(3)},
                   "other": {"0": [0]}},
    }
    if groups:
        snap["groups"] = {
            "g": {"members": {"c-0": 90.0, "c-1": None, "c-2": 25.0},
                  "assignment": {"events": {"0": "c-0", "1": "c-1", "4": "c-9"}},
                  "lag": {"events": {str(p): 10 * (p + 1) for p in range(4)}}},
            "h": {"members": {"x-0": None, "x-1": None},
                  "assignment": {"logs": {"0": "x-1", "2": None}},
                  "lag": {"logs": {"1": 7}}},
        }
    if traffic:
        snap["traffic"] = {"events": {"2": {"in_bytes": 5e4, "out_bytes": 1e5, "lag": 3}}}
    path = tmp_path / name
    path.write_text(json.dumps(snap), encoding="utf-8")
    return str(path)


def test_snapshot_sections_parse_equal(tmp_path):
    path = _snapshot(tmp_path, traffic=True)
    a, b = JSnapshot(path), SnapshotBackend(path)
    assert (a.supports_groups(), a.supports_traffic()) == (b.supports_groups(),
                                                           b.supports_traffic())
    assert {g: tuple(st) for g, st in a.fetch_consumer_groups().items()} \
        == {g: tuple(st) for g, st in b.fetch_consumer_groups().items()}
    assert [tuple(x) for x in a.fetch_consumer_groups(["h", "h"]).values()] \
        == [tuple(x) for x in b.fetch_consumer_groups(["h", "h"]).values()]
    with pytest.raises(KeyError, match="not in snapshot"):
        b.fetch_consumer_groups(["nope"])
    parts = {"events": range(6), "logs": [0, 1, 2]}
    assert a.fetch_partition_traffic(parts) == b.fetch_partition_traffic(parts)
    bare = SnapshotBackend(_snapshot(tmp_path, groups=False, name="bare.json"))
    assert not bare.supports_groups() and not bare.supports_traffic()
    with pytest.raises(IngestError, match="groups"):
        bare.fetch_consumer_groups()


def test_synthetic_family_matches(tmp_path):
    parts = {f"topic-{t}": list(range(37)) for t in range(5)}
    parts["x"] = [3, 9]
    assert synthetic_partition_traffic(parts) == jax_traffic(parts)
    bare = _snapshot(tmp_path, groups=False)
    with pytest.raises(IngestError):
        tsolve.load_group_states(SnapshotBackend(bare), parts)
    for groups in (None, ["a", "b"]):
        got = tsolve.load_group_states(SnapshotBackend(bare), parts, groups, synthetic=True)
        ref = jsolve.load_group_states(JSnapshot(bare), parts, groups, synthetic=True)
        assert got[1] is ref[1] is False
        assert {g: tuple(s) for g, s in got[0].items()} \
            == {g: tuple(s) for g, s in ref[0].items()}


# --- the CLI --------------------------------------------------------------------

def _run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


CLI_CASES = {
    "plan-two-groups": ["--mode", "plan"],
    "plan-one-group": ["--mode", "plan", "--group", "g"],
    "plan-throughput": ["--mode", "plan", "--weight", "throughput", "--group", "h"],
    "plan-greedy": ["--mode", "plan", "--solver", "greedy"],
    "sweep-default": ["--mode", "sweep", "--group", "g"],
    "sweep-counts-scales": ["--mode", "sweep", "--counts", "1,2,4,", "--scales",
                            "100,150,300,"],
    "sweep-throughput": ["--mode", "sweep", "--weight", "throughput", "--counts", "2,3"],
    "synthetic-plan": ["--mode", "plan", "--synthetic"],
    "synthetic-sweep-throughput": ["--mode", "sweep", "--synthetic", "--weight",
                                   "throughput", "--group", "s1,s2", "--scales", "100,"],
}


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_cli_stdout_is_byte_identical(tmp_path, name):
    argv = ["--zk_string", _snapshot(tmp_path, traffic=True)] + CLI_CASES[name]
    ref = _run(jax_run_groups, argv)
    got = _run(cli.run_groups, argv + ["--device", "cpu"])
    assert ref[0] == got[0] == 0
    assert got[1] == ref[1]


def test_cli_refusal_and_errors_match(tmp_path):
    bare = _snapshot(tmp_path, groups=False, name="bare.json")
    for argv in (["--zk_string", bare, "--mode", "plan"], ["--mode", "plan"]):
        ref = _run(jax_run_groups, argv)
        got = _run(cli.run_groups, argv + ["--device", "cpu"])
        assert got[0] == ref[0] == 1 and got[1] == ref[1] == ""
        assert got[2].splitlines()[0] == ref[2].splitlines()[0]
    argv = ["--zk_string", _snapshot(tmp_path), "--mode", "sweep", "--counts",
            ",".join(map(str, range(1, 100))), "--device", "cpu"]
    with pytest.raises(ValueError, match="KA_GROUPS_MAX_CANDIDATES"):
        cli.run_groups(argv)


@pytest.mark.parametrize("argv, code", [
    (["--mode", "plan", "--group", "nope"], cli.EXIT_VALIDATION),
    (["--mode", "plan", "--synthetic", "--counts", "x"], cli.EXIT_VALIDATION),
])
def test_groups_main_exit_codes(tmp_path, monkeypatch, argv, code):
    path = _snapshot(tmp_path)
    monkeypatch.setattr("sys.argv", ["ka-groups", "--zk_string", path, "--device", "cpu",
                                     *argv])
    with pytest.raises(SystemExit) as e:
        cli.groups_main()
    assert e.value.code == code


def test_groups_main_maps_ingest_and_solve_errors(tmp_path, monkeypatch):
    monkeypatch.setattr("sys.argv", ["ka-groups", "--zk_string",
                                     str(tmp_path / "missing.json")])
    with pytest.raises(SystemExit) as e:
        cli.groups_main()
    assert e.value.code == cli.EXIT_INGEST

    def crash(*_a, **_k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(tw, "pack_group_on_device", crash)
    monkeypatch.setattr("sys.argv", ["ka-groups", "--zk_string", _snapshot(tmp_path),
                                     "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        cli.groups_main()
    assert e.value.code == cli.EXIT_SOLVE


# --- on the card ------------------------------------------------------------------

def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_plain_on_stress_cases(name):
    cuda_device()
    assert gcases.check_case(CASES[name]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plan", "sweep"])
def test_cli_on_card_equals_cpu(tmp_path, mode):
    cuda_device()
    argv = ["--zk_string", _snapshot(tmp_path, traffic=True), "--mode", mode]
    before = gp.launches["group_pack"]
    on_card = _run(cli.run_groups, argv + ["--device", "cuda"])
    assert gp.launches["group_pack"] > before
    assert on_card == _run(cli.run_groups, argv + ["--device", "cpu"])
