"""The port's what-if layer against the JAX package, on the CPU:

- ``place_batched`` with per-row liveness (several masks in one batch,
  rows shuffled) against ``place_scan(alive=...)`` run once per mask, on
  every wave mode and on the giant-shape chain past a lowered
  ``KA_DENSE_MASK_BUDGET``;
- ``whatif_sweep`` and ``whatif_subset_sweep`` against the JAX package's
  jitted sweeps, chunked or not;
- ``evaluate_removal_scenarios`` and ``rank_decommission_candidates`` on the
  cases of ``tests/test_whatif.py`` and ``tests/test_whatif_incremental.py``,
  on the incremental and the dense path, with the same "incremental ran"
  probe on both packages; the rescue of stranded scenarios; BASELINE
  config 5.

Inputs come from seeds; results are integers, compared exactly
(``dataclasses.astuple`` of each ``ScenarioResult``).
"""
from __future__ import annotations

import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kafka_assigner_tpu.parallel.whatif as jw
import kafka_assigner_tpu_torch.parallel.whatif as tw
from kafka_assigner_tpu.models.synthetic import build_config5, rack_striped_cluster
from kafka_assigner_tpu.ops import assignment as jops
from kafka_assigner_tpu_torch.carry import encoded_to_torch, to_numpy, to_tensor
from kafka_assigner_tpu_torch.ops import assignment as tops

from .test_invariants import make_cluster
from .test_torch_giant import budget_flip  # noqa: F401  (fixture)
from .test_torch_placement import _encode
from .test_whatif_incremental import _clean_topic, _dirty_row, _rack_groups


# --- per-row liveness in place_batched ------------------------------------

def _instance(kind):
    if kind == "saturated":  # strands fast and dense; balance rescues
        tm, _, racks = rack_striped_cluster(
            50, 3, 250, 3, 5, name_fmt="wsat-{:02d}", extra_brokers=10
        )
        live = set(range(10, 60))
    elif kind == "giant":  # one 1,000-partition topic, exactly saturated
        tm, _, racks = rack_striped_cluster(
            50, 1, 1000, 3, 5, name_fmt="wgiant-{:02d}", extra_brokers=10
        )
        live = set(range(10, 60))
    else:  # decommission: 40 brokers in 4 racks, mixed RF 1-3
        tm, _, racks = rack_striped_cluster(40, 6, 30, 3, 4, name_fmt="wdec-{:02d}")
        rng = random.Random(3)
        tm = {t: {p: r[:rf] for p, r in cur.items()}
              for (t, cur), rf in zip(tm.items(), [rng.randint(1, 3) for _ in tm])}
        live = set(range(40))
    return list(tm.items()), live, {b: racks[b] for b in live}


def _rows_and_masks(kind, seed=0):
    """Every topic of the instance under each of three masks (all alive, two
    brokers gone, five random brokers gone), rows shuffled."""
    topics, live, rack_map = _instance(kind)
    rfs = [len(next(iter(cur.values()))) for _, cur in topics]
    encs, cur, jh, pr = _encode(topics, live, rack_map, rfs)
    n, n_pad = encs[0].n, encs[0].n_pad
    rng = np.random.default_rng(seed)
    masks = np.zeros((3, n_pad), bool)
    masks[:, :n] = True
    masks[1, [0, 7]] = False
    masks[2, rng.choice(n, 5, replace=False)] = False
    b = cur.shape[0]
    rf_arr = np.full(b, max(rfs), np.int32)
    rf_arr[: len(rfs)] = rfs
    row = np.repeat(np.arange(3), b)
    perm = rng.permutation(len(row))
    rows = tuple(np.concatenate([a] * 3)[perm] for a in (cur, jh, pr, rf_arr))
    return encs, rows, masks, row[perm], max(rfs)


def _jax_place_masked(encs, rows, mask, rf, mode):
    cur, jh, pr, rfs = rows
    out = jax.device_get(jops.place_scan_jit(
        jnp.asarray(cur), jnp.asarray(encs[0].rack_idx), jnp.asarray(jh),
        jnp.asarray(pr), n=encs[0].n, rf=rf, wave_mode=mode,
        rfs=jnp.asarray(rfs), r_cap=encs[0].r_cap, alive=jnp.asarray(mask),
    ))
    return [np.asarray(o) for o in out[:4]]


def _port_place_rows(encs, rows, masks, row, rf, mode, device="cpu"):
    cur, jh, pr, rfs = rows
    c, rack, j, p = encoded_to_torch(cur, encs[0].rack_idx, jh, pr, device)
    res = tops.place_batched(
        c, rack, j, p, encs[0].n, rf, mode, to_tensor(rfs, device),
        r_cap=encs[0].r_cap, alive=torch.as_tensor(masks).to(device),
        alive_row=torch.as_tensor(row).to(device),
    )
    return [to_numpy(t) for t in (res.acc_nodes, res.acc_count, res.infeasible,
                                  res.deficit)], res.waves


def _check_per_mask(encs, rows, masks, row, rf, mode, got):
    for m in range(len(masks)):
        sel = np.where(row == m)[0]
        ref = _jax_place_masked(encs, tuple(a[sel] for a in rows), masks[m], rf, mode)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[sel], r)


@pytest.mark.parametrize("mode", ["fast", "auto", "dense", "balance", "seq",
                                  "balance_quota"])
@pytest.mark.parametrize("kind", ["saturated", "decommission"])
def test_per_row_masks_match_place_scan(kind, mode):
    encs, rows, masks, row, rf = _rows_and_masks(kind)
    got, waves = _port_place_rows(encs, rows, masks, row, rf, mode)
    _check_per_mask(encs, rows, masks, row, rf, mode, got)
    assert set(waves) <= set(tops.WAVE_MODES[mode])


def test_saturated_masks_run_the_rescue_legs():
    # The saturated instance under three masks strands fast and dense, so
    # the per-row masks must travel with the stranded rows into each leg.
    encs, rows, masks, row, rf = _rows_and_masks("saturated")
    _, waves = _port_place_rows(encs, rows, masks, row, rf, "auto")
    assert waves.get("dense", 0) > 0 and waves.get("balance", 0) > 0


@pytest.mark.parametrize("mode", ["auto", "fast", "balance_quota", "fresh", "seq"])
def test_per_row_masks_on_the_giant_chain(budget_flip, mode):  # noqa: F811
    encs, rows, masks, row, rf = _rows_and_masks("giant")
    budget_flip(50_000)
    assert tops.resolve_chain(mode, rows[0].shape[1], encs[0].n_pad)[2]
    got, _ = _port_place_rows(encs, rows, masks, row, rf, mode)
    _check_per_mask(encs, rows, masks, row, rf, mode, got)


@pytest.mark.parametrize("shape", ["none", "shared", "per_row", "indexed"])
def test_default_liveness_forms_agree(shape):
    # No mask, one shared (1, N_pad) mask, one mask per row and one mask
    # indexed by every row place identically.
    topics, live, rack_map = _instance("saturated")
    encs, cur, jh, pr = _encode(topics, live, rack_map, 3)
    c, rack, j, p = encoded_to_torch(cur, encs[0].rack_idx, jh, pr)
    base = tops.place_batched(c, rack, j, p, encs[0].n, 3, "auto", r_cap=encs[0].r_cap)
    default = tops.default_alive(rack, encs[0].n)[None]
    kw = {"none": {}, "shared": {"alive": default},
          "per_row": {"alive": default.expand(len(cur), -1)},
          "indexed": {"alive": default, "alive_row": torch.zeros(len(cur), dtype=torch.long)}}
    res = tops.place_batched(c, rack, j, p, encs[0].n, 3, "auto", r_cap=encs[0].r_cap,
                             **kw[shape])
    for a, b in zip(res[:4], base[:4]):
        assert torch.equal(a, b)
    assert res.waves == base.waves


def test_batched_segments_match_jax_per_mask():
    encs, _, masks, _, _ = _rows_and_masks("saturated")
    rack = to_tensor(encs[0].rack_idx)
    got = tops.cluster_segments(rack, encs[0].n, torch.as_tensor(masks), encs[0].r_cap)
    for m in range(len(masks)):
        ref = jops.cluster_segments(jnp.asarray(encs[0].rack_idx), encs[0].n,
                                    jnp.asarray(masks[m]), encs[0].r_cap)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(to_numpy(g[m]), np.asarray(r))


# --- the device sweeps -----------------------------------------------------

def _sweep_inputs(kind="decommission"):
    topics, live, rack_map = _instance(kind)
    rfs = [len(next(iter(cur.values()))) for _, cur in topics]
    encs, cur, jh, pr = _encode(topics, live, rack_map, rfs)
    rf_arr = np.zeros(cur.shape[0], np.int32)
    rf_arr[: len(rfs)] = rfs
    n, n_pad = encs[0].n, encs[0].n_pad
    alive = np.zeros((9, n_pad), bool)
    alive[:, :n] = True
    for s in range(1, 9):
        alive[s, [(3 * s) % n, (5 * s + 1) % n][: 1 + s % 2]] = False
    return encs, cur, jh, pr, rf_arr, alive, max(rfs)


@pytest.mark.parametrize("chunk", [None, 1])
@pytest.mark.parametrize("mode", ["fast", "auto"])
def test_whatif_sweep_matches_jax(monkeypatch, mode, chunk):
    encs, cur, jh, pr, rfs, alive, rf = _sweep_inputs()
    if chunk:  # one scenario per placement call
        monkeypatch.setattr(tops, "SWEEP_CHUNK_ELEMS", chunk)
    ref = jax.device_get(jops.whatif_sweep_jit(
        jnp.asarray(cur), jnp.asarray(encs[0].rack_idx), jnp.asarray(jh),
        jnp.asarray(pr), jnp.asarray(alive), n=encs[0].n, rf=rf, wave_mode=mode,
        rfs=jnp.asarray(rfs), r_cap=encs[0].r_cap,
    ))
    c, rack, j, p = encoded_to_torch(cur, encs[0].rack_idx, jh, pr)
    got = tops.whatif_sweep(c, rack, j, p, torch.as_tensor(alive), encs[0].n, rf,
                            mode, to_tensor(rfs), encs[0].r_cap)
    for g, r in zip(got[:3], ref):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(r))
    assert got.rows == len(alive) * len(cur)
    assert got.chunks == (len(alive) if chunk else 1)


def _subset_case():
    """The subset sweep's inputs on the port and the JAX package's answer:
    each scenario a random subset of the topics, -1 padded to 8."""
    encs, cur, jh, pr, rfs, alive, rf = _sweep_inputs()
    s, t_pad = len(alive), 8
    rng = np.random.default_rng(1)
    b_real = len(_instance("decommission")[0])
    topics = np.full((s, t_pad), -1, np.int32)
    sc = np.full((s, t_pad) + cur.shape[1:], -1, np.int32)
    sj, sp = np.zeros((s, t_pad), np.int32), np.zeros((s, t_pad), np.int32)
    srf = np.full((s, t_pad), rf, np.int32)
    for i in range(s):
        tops_i = np.sort(rng.choice(b_real, rng.integers(0, b_real + 1), replace=False))
        k = len(tops_i)
        topics[i, :k] = tops_i
        sc[i, :k], sj[i, :k], sp[i, :k], srf[i, :k] = (
            cur[tops_i], jh[tops_i], pr[tops_i], rfs[tops_i])
    ref = jax.device_get(jops.whatif_subset_sweep_jit(
        jnp.asarray(sc), jnp.asarray(encs[0].rack_idx), jnp.asarray(sj),
        jnp.asarray(sp), jnp.asarray(alive), n=encs[0].n, rf=rf,
        rfs=jnp.asarray(srf), r_cap=encs[0].r_cap,
    ))
    c, rack, j, p = encoded_to_torch(cur, encs[0].rack_idx, jh, pr)
    args = (c, rack, j, p, to_tensor(topics), torch.as_tensor(alive), encs[0].n, rf,
            to_tensor(rfs), encs[0].r_cap)
    return args, ref


def test_whatif_subset_sweep_matches_jax():
    args, ref = _subset_case()
    got = tops.whatif_subset_sweep(*args)
    for g, r in zip(got[:3], ref):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(r))


# --- the sweep's call size ---------------------------------------------------

#: A quarter of an 80 GB card: what ``sweep_budget`` grants one call on an
#: H100, which at these shapes holds every scenario.
CARD_QUARTER = 80 * 10**9 // 4


@functools.lru_cache(maxsize=None)
def _jax_rescue():
    tm, live, racks, scenarios = rescue_cluster()
    return _astuples(jw.evaluate_removal_scenarios(tm, live, racks, scenarios, 3))


@pytest.mark.parametrize("kind", ["sweep", "subset", "rescue"])
@pytest.mark.parametrize("size", ["one", "sized", "whole"])
def test_results_do_not_depend_on_the_call_size(monkeypatch, size, kind):
    """One scenario a call, two (the sizing function under a budget that
    holds two) and the whole request in one call (a card's quarter) each
    give the JAX package's answer bit for bit: the dense sweep on ``fast``,
    the subset sweep, and a request whose stranded scenarios the ``auto``
    rescue places. The record names the scenarios a call held."""
    if kind == "rescue":
        tm, live, racks, scenarios = rescue_cluster()
        encs, cur, _, _ = _encode(list(tm.items()), live, racks, [3] * len(tm))
        t, s = len(cur), len(scenarios)
    else:
        encs, cur, jh, pr, rfs, alive, rf = _sweep_inputs()
        t, s = (len(cur) if kind == "sweep" else 8), len(alive)
    shapes = (t, cur.shape[1], max(3, cur.shape[2]), encs[0].n_pad)
    budget = {"one": 0, "sized": 2 * t * tops.sweep_row_bytes(*shapes[1:]),
              "whole": CARD_QUARTER}[size]
    per = {"one": 1, "sized": 2, "whole": s}[size]
    assert min(tops.sweep_scenarios_per_call(budget, *shapes), s) == per
    monkeypatch.setattr(tops, "sweep_budget", lambda dev: budget)
    if kind == "rescue":
        monkeypatch.setenv("KA_WHATIF_INCREMENTAL", "0")
        got = tw.evaluate_removal_scenarios(tm, live, racks, scenarios, 3, device="cpu")
        assert _astuples(got) == _jax_rescue()
        rec = tw.last_sweep
        assert rec["path"] == "dense" and rec["rescued"] >= 1 and rec["rescue_waves"]
        assert (rec["per_call"], rec["chunks"]) == (per, -(-s // per))
        return
    if kind == "sweep":
        ref = jax.device_get(jops.whatif_sweep_jit(
            jnp.asarray(cur), jnp.asarray(encs[0].rack_idx), jnp.asarray(jh),
            jnp.asarray(pr), jnp.asarray(alive), n=encs[0].n, rf=rf, wave_mode="fast",
            rfs=jnp.asarray(rfs), r_cap=encs[0].r_cap,
        ))
        c, rack, j, p = encoded_to_torch(cur, encs[0].rack_idx, jh, pr)
        got = tops.whatif_sweep(c, rack, j, p, torch.as_tensor(alive), encs[0].n, rf,
                                "fast", to_tensor(rfs), encs[0].r_cap)
    else:
        args, ref = _subset_case()
        got = tops.whatif_subset_sweep(*args)
    for g, r in zip(got[:3], ref):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(r))
    assert (got.per_call, got.chunks, got.rows) == (per, -(-s // per), s * t)


@pytest.mark.parametrize("shape", [
    (2048, 104, 3, 5000),     # config 4: 2,000 topics bucketed, 5,000 brokers
    (512, 104, 3, 40),        # 400 topics on a few dozen brokers
    (1, 200_000, 3, 5_104),   # one giant topic
    (8, 16, 3, 8),
])
def test_sweep_call_size_from_the_budget(shape):
    """At least one whole scenario; never more as the budget shrinks; past
    one scenario no more bytes than the budget and no tensor of the call
    past 2^31 elements; off a CUDA device the element rule of old."""
    t, p_pad, width, n_pad = shape
    row = tops.sweep_row_bytes(p_pad, width, n_pad)
    assert tops.sweep_budget(torch.device("cpu")) is None
    assert tops.sweep_scenarios_per_call(None, t, p_pad, width, n_pad) == max(
        1, tops.SWEEP_CHUNK_ELEMS // (t * n_pad))
    last = None
    for budget in (1 << 50, 1 << 40, CARD_QUARTER, 1 << 32, 1 << 30, 1 << 26, 1 << 20,
                   row, 0):
        per = tops.sweep_scenarios_per_call(budget, t, p_pad, width, n_pad)
        assert isinstance(per, int) and per >= 1
        assert last is None or per <= last
        last = per
        if per > 1:
            rows = per * t
            assert rows * row <= budget
            assert rows * (n_pad + 1) < 2**31 and rows * p_pad * width * 16 < 2**31
    assert last == 1


def test_sweep_budget_is_a_share_of_the_card_split_among_its_sweeps(monkeypatch):
    """A quarter of the card's total memory, split among the sweeps that
    share it; the free memory is never asked."""
    class Props:
        total_memory = 85_000_000_000

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props)
    monkeypatch.setattr(torch.cuda, "mem_get_info", None)
    card = torch.device("cuda", 0)
    quarter = Props.total_memory // tops.SWEEP_MEMORY_SHARE
    assert tops.sweep_budget(card) == quarter
    with tops.sharing_device(8):
        assert tops.sweep_budget(card) == quarter // 8
        with tops.sharing_device(2):
            assert tops.sweep_budget(card) == quarter // 2
        assert tops.sweep_budget(card) == quarter // 8
    assert tops.sweep_budget(card) == quarter


# --- the host layer ----------------------------------------------------------

def _astuples(results):
    return [dataclasses.astuple(r) for r in results]


def _evaluate_both(monkeypatch, fn_name, *args, expect_incremental=None):
    """The JAX package's and the port's ``fn_name`` on the same arguments,
    with the "incremental ran" probe on both; returns the port's results
    (equal to JAX's) and whether the incremental path ran."""
    taken = {}

    def probe(mod, key):
        orig = mod._evaluate_incremental

        def run(*a, **k):
            r = orig(*a, **k)
            taken[key] = r is not None
            return r
        monkeypatch.setattr(mod, "_evaluate_incremental", run)

    probe(jw, "jax")
    probe(tw, "port")
    ref = getattr(jw, fn_name)(*args)
    got = getattr(tw, fn_name)(*args, device="cpu")
    assert _astuples(got) == _astuples(ref)
    assert taken.get("port") == taken.get("jax"), taken
    if expect_incremental is not None:
        assert bool(taken.get("port")) == expect_incremental, taken
    return got, taken.get("port", False)


def _both_paths(monkeypatch, *args, fn_name="evaluate_removal_scenarios",
                expect_incremental=True):
    """Incremental (the default) and dense (KA_WHATIF_INCREMENTAL=0), each
    against JAX; the port's two paths must agree too."""
    monkeypatch.delenv("KA_WHATIF_INCREMENTAL", raising=False)
    inc, ran = _evaluate_both(monkeypatch, fn_name, *args,
                              expect_incremental=expect_incremental)
    assert tw.last_sweep.get("path", "dense") == ("incremental" if ran else "dense")
    monkeypatch.setenv("KA_WHATIF_INCREMENTAL", "0")
    full, _ = _evaluate_both(monkeypatch, fn_name, *args, expect_incremental=False)
    monkeypatch.delenv("KA_WHATIF_INCREMENTAL")
    assert _astuples(inc) == _astuples(full)
    return inc


@pytest.fixture(scope="module")
def cluster():
    current, live, rack_map = make_cluster(0, 16, 32, 3, 4)
    topics = {f"t{i}": current for i in range(3)}
    return topics, live, rack_map


def test_matches_jax_on_individual_solve_scenarios(monkeypatch, cluster):
    topics, live, rack_map = cluster
    res = _both_paths(monkeypatch, topics, live, rack_map,
                      [[], [100], [101], [100, 104]], 3, expect_incremental=None)
    assert len(res) == 4 and res[0].moved_replicas == 0


def test_empty_scenario_moves_nothing(monkeypatch, cluster):
    topics, live, rack_map = cluster
    (res,) = _both_paths(monkeypatch, topics, live, rack_map, [[]], 3,
                         expect_incremental=None)
    assert res.feasible and res.moved_replicas == 0


def test_rank_decommission_candidates_matches(monkeypatch, cluster):
    topics, live, rack_map = cluster
    ranked = _both_paths(monkeypatch, topics, live, rack_map, None, 3,
                         fn_name="rank_decommission_candidates",
                         expect_incremental=None)
    assert len(ranked) == len(live)


@pytest.mark.parametrize("scenarios,rf,match", [
    ([[999999]], 3, "unknown broker"),
    ([[]], -1, "unexpected replication factor"),
])
def test_errors_match(cluster, scenarios, rf, match):
    topics, live, rack_map = cluster
    if rf < 0:
        topics = dict(topics, ragged={0: [100, 101, 102], 1: [100, 101]})
    with pytest.raises(ValueError, match=match) as ref:
        jw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, rf)
    with pytest.raises(ValueError, match=match) as got:
        tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, rf,
                                      device="cpu")
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("incremental", ["1", "0"])
def test_membudget_chunking_matches_unchunked(monkeypatch, cluster, incremental):
    topics, live, rack_map = cluster
    scenarios = [[b] for b in sorted(live)[:12]]
    monkeypatch.setenv("KA_WHATIF_INCREMENTAL", incremental)
    expected = tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                             device="cpu")
    monkeypatch.setenv("KA_WHATIF_MEMBUDGET", "1")  # 1 scenario per block
    ref = jw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3)
    got = tw.evaluate_removal_scenarios(topics, live, rack_map, scenarios, 3,
                                        device="cpu")
    assert _astuples(got) == _astuples(expected) == _astuples(ref)
    if tw.last_sweep["path"] == "dense":
        assert tw.last_sweep["chunks"] == len(scenarios)


def test_sweep_defaults_to_cuda(cluster):
    topics, live, rack_map = cluster
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.evaluate_removal_scenarios(topics, live, rack_map, [[]], 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.rank_decommission_candidates(topics, live, rack_map, [100], 3)


# The cases of tests/test_whatif_incremental.py.

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_clusters(monkeypatch, seed):
    rng = random.Random(seed)
    brokers = set(range(1, 97))
    racks = {b: f"r{b % 6}" for b in brokers}
    groups = _rack_groups(brokers, racks)
    topics = {}
    for i in range(160):
        p = rng.randint(1, 3)
        cur = _clean_topic(groups, i, p, 3)
        if rng.random() < 0.06:
            cur[rng.randrange(p)] = _dirty_row(rng, brokers, racks)
        topics[f"t{i:03d}"] = cur
    scenarios = [rng.sample(sorted(brokers), rng.randint(0, 2)) for _ in range(12)]
    _both_paths(monkeypatch, topics, brokers, racks, scenarios, 3)


def test_over_capacity_topic_not_skipped(monkeypatch):
    brokers = set(range(1, 31))
    racks = {b: f"r{b % 5}" for b in brokers}
    groups = _rack_groups(brokers, racks)
    topics = {f"bg{i:02d}": _clean_topic(groups, i, 2, 2) for i in range(64)}
    topics["hot"] = {p: [1 + p % 2, 3 + p % 6] for p in range(8)}
    res = _both_paths(monkeypatch, topics, brokers, racks,
                      [[b] for b in sorted(brokers)[:10]], -1)
    assert all(r.moved_replicas > 0 for r in res)


def test_mixed_rf(monkeypatch):
    brokers = set(range(1, 49))
    racks = {b: f"r{b % 4}" for b in brokers}
    groups = _rack_groups(brokers, racks)
    topics = {f"rf2-{i}": _clean_topic(groups, i, 2, 2) for i in range(64)}
    topics.update({f"rf3-{i}": _clean_topic(groups, i + 7, 2, 3) for i in range(64)})
    _both_paths(monkeypatch, topics, brokers, racks, [[b] for b in sorted(brokers)[:8]], -1)


def test_rank_decommission_incremental(monkeypatch):
    brokers = set(range(1, 33))
    racks = {b: f"r{b % 4}" for b in brokers}
    groups = _rack_groups(brokers, racks)
    topics = {f"t{i:02d}": _clean_topic(groups, i, 3, 2) for i in range(48)}
    _both_paths(monkeypatch, topics, brokers, racks, None, -1,
                fn_name="rank_decommission_candidates")


def test_small_cluster_declines_to_dense(monkeypatch):
    brokers = set(range(1, 9))
    racks = {b: f"r{b % 4}" for b in brokers}
    topics = {"t": {p: [1 + p % 8, 1 + (p + 3) % 8] for p in range(5)}}
    _both_paths(monkeypatch, topics, brokers, racks, [[1], [2]], -1,
                expect_incremental=False)


def rescue_cluster():
    """100 brokers in 5 racks, one 2,000-partition RF-3 topic; each
    scenario removes 4 brokers of every rack, so cap ceil(6,000 / 80) = 75
    leaves no slack and the fast leg strands; plus one broker and none."""
    tm, live, racks = rack_striped_cluster(100, 1, 2000, 3, 5, name_fmt="rescue-{:02d}")
    rng = np.random.default_rng(0)
    by_rack = {}
    for b in sorted(live):
        by_rack.setdefault(racks[b], []).append(b)
    scenarios = [sorted(int(x) for r in sorted(by_rack)
                        for x in rng.choice(by_rack[r], 4, replace=False))
                 for _ in range(4)]
    return tm, live, racks, scenarios + [[0], []]


def test_rescue_of_stranded_scenarios_matches(monkeypatch):
    tm, live, racks, scenarios = rescue_cluster()
    rescued = {}
    for key, mod in (("jax", jw), ("port", tw)):
        orig = mod._rescue_flagged

        def run(flagged, *a, _orig=orig, _key=key):
            rescued[_key] = len(flagged)
            return _orig(flagged, *a)
        monkeypatch.setattr(mod, "_rescue_flagged", run)
    res = _evaluate_both(monkeypatch, "evaluate_removal_scenarios", tm, live, racks,
                         scenarios, 3)[0]
    assert rescued["port"] == rescued["jax"] == tw.last_sweep["rescued"] >= 1
    assert res[-1].moved_replicas == 0 and res[-1].feasible


def test_config5_full_size(monkeypatch):
    # BASELINE config 5 at full size: 256 singleton removals of a 1k-broker
    # cluster, 100 topics x 50 partitions at RF 3.
    topics, live, rack_map = build_config5()
    scenarios = [[b] for b in range(256)]
    held = {b: 0 for b in live}
    for cur in topics.values():
        for reps in cur.values():
            for b in reps:
                held[b] += 1
    res = _both_paths(monkeypatch, topics, live, rack_map, scenarios, 3)
    # Cap stays ceil(150 / 999) = 1 per topic: exactly the removed broker's
    # replicas move.
    assert all(r.feasible and r.moved_replicas == held[r.removed[0]] for r in res)
    assert {held[b] for b in range(256)} <= set(range(14, 18))


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_rescue_on_card_equals_cpu():
    dev = cuda_device()
    tm, live, racks, scenarios = rescue_cluster()
    on_card = tw.evaluate_removal_scenarios(tm, live, racks, scenarios, 3, device=dev)
    on_cpu = tw.evaluate_removal_scenarios(tm, live, racks, scenarios, 3, device="cpu")
    assert on_card == on_cpu


@pytest.mark.cuda
def test_per_row_masks_on_card_equal_cpu():
    dev = cuda_device()
    encs, rows, masks, row, rf = _rows_and_masks("saturated")
    got, _ = _port_place_rows(encs, rows, masks, row, rf, "auto", dev)
    ref, _ = _port_place_rows(encs, rows, masks, row, rf, "auto")
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)

