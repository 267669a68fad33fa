"""The port's leadership ordering (``kafka_assigner_tpu_torch/ops/
leadership.py``) against the JAX package's ``leadership_order``, its Pallas
kernel in interpret mode, ``order_batched`` and the host C++ ``order_many``.

Integers everywhere: the tolerance is exact equality. Inputs are made with
numpy from a seed and fed to both sides through ``carry.py``. On the CPU the
port's wrapper runs its plain version; the tests marked ``cuda`` hold the
hand-written kernel against that plain version on a card.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_assigner_tpu.ops.assignment import leadership_order as jax_order
from kafka_assigner_tpu.ops.assignment import order_batched
from kafka_assigner_tpu.ops.pallas_leadership import leadership_order_pallas
from kafka_assigner_tpu_torch.carry import counters_to_torch, to_numpy, to_tensor
from kafka_assigner_tpu_torch.ops import leadership as port
from kafka_assigner_tpu_torch.ops.leadership_cases import (
    chain_step_ns, check_case, stress_cases,
)


def _rows(rng, b, p, n, rf, partial=True):
    """(B, P, RF) candidate rows with counts in 0..RF (partial/empty rows)
    or all RF."""
    acc = np.full((b, p, rf), -1, np.int32)
    cnt = np.zeros((b, p), np.int32)
    for t in range(b):
        for i in range(p):
            c = int(rng.integers(0, rf + 1)) if partial else rf
            cnt[t, i] = c
            if c:
                acc[t, i, :c] = rng.choice(n, c, replace=False)
    return acc, cnt


def _port(acc, cnt, counters, jh, **kw):
    o, c = port.leadership_order(
        to_tensor(acc), to_tensor(cnt), counters_to_torch(counters),
        to_tensor(np.asarray(jh, np.int32).reshape(-1)), **kw,
    )
    return to_numpy(o), to_numpy(c)


def _jax_one(acc, cnt, counters, jh, rf):
    o, c = jax_order(
        jnp.asarray(acc), jnp.asarray(cnt), jnp.asarray(counters),
        jnp.int32(jh), rf,
    )
    return np.asarray(o), np.asarray(c)


@pytest.mark.parametrize("seed,rf", [(0, 1), (0, 2), (0, 3), (1, 3), (0, 4)])
def test_plain_matches_jax_scan_and_pallas_interpret(seed, rf):
    rng = np.random.default_rng(seed)
    p, n = 40, 32
    acc, cnt = _rows(rng, 1, p, n, rf)
    counters = rng.integers(0, 7, (n, rf)).astype(np.int32)
    jh = int(rng.integers(0, 2**30))

    o_port, c_port = _port(acc, cnt, counters, [jh])
    o_jax, c_jax = _jax_one(acc[0], cnt[0], counters, jh, rf)
    o_pl, c_pl = leadership_order_pallas(
        jnp.asarray(acc[0]), jnp.asarray(cnt[0]), jnp.asarray(counters),
        jnp.int32(jh), rf, interpret=True,
    )
    np.testing.assert_array_equal(o_port[0], o_jax)
    np.testing.assert_array_equal(c_port, c_jax)
    np.testing.assert_array_equal(o_port[0], np.asarray(o_pl))
    np.testing.assert_array_equal(c_port, np.asarray(c_pl))


@pytest.mark.parametrize("p", [520, 8, 1000])
def test_plain_non_block_multiple_p_matches_jax(p):
    # P not a multiple of the Pallas BLOCK_P (512) nor of 8-row chunks.
    rng = np.random.default_rng(11)
    n, rf = 32, 3
    acc, cnt = _rows(rng, 1, p, n, rf, partial=False)
    counters = rng.integers(0, 5, (n, rf)).astype(np.int32)
    jh = int(rng.integers(0, 2**30))
    o_port, c_port = _port(acc, cnt, counters, [jh])
    o_jax, c_jax = _jax_one(acc[0], cnt[0], counters, jh, rf)
    np.testing.assert_array_equal(o_port[0], o_jax)
    np.testing.assert_array_equal(c_port, c_jax)


@pytest.mark.parametrize("rf", [2, 3])
def test_multi_topic_batch_carries_counters_like_order_batched(rf):
    rng = np.random.default_rng(5 + rf)
    b, p, n = 4, 24, 20
    acc, cnt = _rows(rng, b, p, n, rf)
    counters = rng.integers(0, 4, (n, rf)).astype(np.int32)
    jhs = rng.integers(0, 2**30, b).astype(np.int32)
    o_port, c_port = _port(acc, cnt, counters, jhs)
    o_jax, c_jax = order_batched(
        jnp.asarray(acc), jnp.asarray(cnt), jnp.asarray(counters),
        jnp.asarray(jhs), rf,
    )
    np.testing.assert_array_equal(o_port, np.asarray(o_jax))
    np.testing.assert_array_equal(c_port, np.asarray(c_jax))


def test_matches_native_order_many():
    from kafka_assigner_tpu.native.build import load_native_library
    from kafka_assigner_tpu.native.leadership import order_many

    load_native_library()  # the suite's conftest prebuilds it
    rng = np.random.default_rng(3)
    b, p, n, rf = 3, 16, 24, 3
    acc, cnt = _rows(rng, b, p, n, rf)
    counters = rng.integers(0, 6, (n, rf)).astype(np.int32)
    jhs = rng.integers(0, 2**30, b).astype(np.int32)
    o_nat, c_nat = order_many(
        acc, cnt, jhs.astype(np.int64), np.full(b, p, np.int32), counters
    )
    o_port, c_port = _port(acc, cnt, counters, jhs)
    np.testing.assert_array_equal(o_port, o_nat)
    np.testing.assert_array_equal(c_port, c_nat)


def test_out_of_range_candidates_follow_xla_clamp_and_drop():
    # A candidate index >= N_pad: XLA clamps the counter gather into the
    # slab and drops the out-of-range update; the port does the same.
    rng = np.random.default_rng(9)
    n, rf = 8, 3
    acc = np.array([[[2, 9, 5]], [[11, 1, 0]]], np.int32).reshape(1, 2, 3)
    cnt = np.array([[3, 3]], np.int32)
    counters = rng.integers(0, 3, (n, rf)).astype(np.int32)
    o_port, c_port = _port(acc, cnt, counters, [12345])
    o_jax, c_jax = _jax_one(acc[0], cnt[0], counters, 12345, rf)
    np.testing.assert_array_equal(o_port[0], o_jax)
    np.testing.assert_array_equal(c_port, c_jax)


@pytest.mark.parametrize("chunk", [1, 3, 8, 64])
def test_plain_row_block_is_semantics_invariant(chunk):
    rng = np.random.default_rng(21)
    acc, cnt = _rows(rng, 2, 20, 16, 3)
    counters = rng.integers(0, 4, (16, 3)).astype(np.int32)
    jhs = rng.integers(0, 2**30, 2).astype(np.int32)
    base = _port(acc, cnt, counters, jhs, chunk=8)
    got = _port(acc, cnt, counters, jhs, chunk=chunk)
    np.testing.assert_array_equal(base[0], got[0])
    np.testing.assert_array_equal(base[1], got[1])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(2)
    acc, cnt = _rows(rng, 1, 8, 10, 2)
    counters = np.zeros((10, 2), np.int32)
    before = port.launches["leadership"]
    o, c = _port(acc, cnt, counters, [7])
    assert port.launches["leadership"] == before
    o2, c2 = port.leadership_order_plain(
        to_tensor(acc), to_tensor(cnt), counters_to_torch(counters),
        to_tensor([7]),
    )
    np.testing.assert_array_equal(o, to_numpy(o2))
    np.testing.assert_array_equal(c, to_numpy(c2))
    assert (counters == 0).all()  # the caller's slab is not mutated


def test_chain_probe_takes_only_a_slot_on_the_card():
    # The probe launches a CUDA kernel: it has no plain version to fall
    # back to, so a CPU tensor (or a slot of the wrong size) is refused.
    with pytest.raises(ValueError):
        port.chain_probe(3, torch.zeros(17, dtype=torch.int32), 16)


@pytest.mark.parametrize("bad", ["dtype", "shape", "rf"])
def test_wrapper_rejects_bad_inputs(bad):
    acc = torch.zeros((1, 4, 3), dtype=torch.int32)
    cnt = torch.zeros((1, 4), dtype=torch.int32)
    counters = torch.zeros((8, 3), dtype=torch.int32)
    jh = torch.zeros(1, dtype=torch.int32)
    if bad == "dtype":
        with pytest.raises(TypeError):
            port.leadership_order(acc.long(), cnt, counters, jh)
    elif bad == "shape":
        with pytest.raises(ValueError):
            port.leadership_order(acc, cnt[:, :2], counters, jh)
    else:
        with pytest.raises(ValueError):
            port.leadership_order(
                torch.zeros((1, 4, 33), dtype=torch.int32), cnt,
                torch.zeros((8, 33), dtype=torch.int32), jh,
            )


# --- the column decoupling the kernel's pipeline relies on -----------------


def _column_major_order(acc, cnt, counters, jhs):
    """Leadership ordering evaluated column by column: slot 0 of every row
    (topics, then partitions, in order), then slot 1 of every row, and so
    on. This is the order the CUDA kernel's pipeline relies on: slot r reads
    and writes only column r of the slab, and meets the other slots only
    through its own row's remaining set. Plain Python integers; the inputs'
    counters stay far from int32 overflow."""
    b, p, rf = acc.shape
    n_pad = counters.shape[0]
    cand = acc.reshape(-1, rf).tolist()
    count = cnt.reshape(-1).tolist()
    jh = np.repeat(np.asarray(jhs, np.int64), p).tolist()
    slab = counters.astype(np.int64).tolist()
    remaining = [[j < c for j in range(rf)] for c in count]
    out = [[-1] * rf for _ in count]
    for r in range(rf):
        for i, (row, c) in enumerate(zip(cand, count)):
            m = max(c - r, 1)
            start = jh[i] % m  # floor modulo, as torch and XLA take it
            rem = remaining[i]
            best_key, choice = None, 0
            for j in range(rf):
                key = port.BIG
                if rem[j]:
                    rank = sum(rem[q] and row[q] < row[j] for q in range(rf))
                    gather = min(max(row[j], 0), n_pad - 1)
                    key = slab[gather][r] * m + (rank + start) % m
                if best_key is None or key < best_key:
                    best_key, choice = key, j
            rem[choice] = False
            if r < c:
                out[i][r] = row[choice]
                if row[choice] < n_pad:
                    slab[max(row[choice], 0)][r] += 1
    return np.array(out, np.int32).reshape(b, p, rf), np.array(slab, np.int32)


def _native_takes(acc, cnt, n_pad):
    """Whether the host C++ ``order_many`` takes the input: counts in
    0..RF, and distinct in-range candidates in each row's first ``count``
    slots."""
    rf = acc.shape[-1]
    if cnt.min() < 0 or cnt.max() > rf:
        return False
    for row, c in zip(acc.reshape(-1, rf), cnt.reshape(-1)):
        cands = row[:c]
        if len(set(cands.tolist())) != c or (cands < 0).any() or (cands >= n_pad).any():
            return False
    return True


STRESS = {case[0]: case for case in stress_cases()}


@pytest.mark.parametrize("name", list(STRESS))
def test_column_major_order_matches_jax_and_native(name):
    # The card's stress cases (chip_smoke.py phase 3), column by column,
    # against the JAX package's scan and, where it takes them, order_many.
    from kafka_assigner_tpu.native.build import load_native_library
    from kafka_assigner_tpu.native.leadership import order_many

    _, acc, cnt, counters, jhs, _ = STRESS[name]
    b, p, rf = acc.shape
    o_col, c_col = _column_major_order(acc, cnt, counters, jhs)
    o_jax, c_jax = order_batched(
        jnp.asarray(acc), jnp.asarray(cnt), jnp.asarray(counters),
        jnp.asarray(jhs), rf, leader_chunk=1 if rf > 4 else None,
    )
    np.testing.assert_array_equal(o_col, np.asarray(o_jax))
    np.testing.assert_array_equal(c_col, np.asarray(c_jax))
    if _native_takes(acc, cnt, counters.shape[0]):
        load_native_library()  # the suite's conftest prebuilds it
        o_nat, c_nat = order_many(
            acc, cnt, jhs.astype(np.int64), np.full(b, p, np.int32), counters
        )
        np.testing.assert_array_equal(o_col, o_nat)
        np.testing.assert_array_equal(c_col, c_nat)
    if b * p <= 1000:  # the plain version walks rows one by one
        o_port, c_port = _port(acc, cnt, counters, jhs)
        np.testing.assert_array_equal(o_port, o_col)
        np.testing.assert_array_equal(c_port, c_col)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_column_major_order_equals_row_major_plain(seed):
    rng = np.random.default_rng(100 + seed)
    acc, cnt = _rows(rng, 3, 30, 9, 4)
    counters = rng.integers(0, 3, (9, 4)).astype(np.int32)
    jhs = rng.integers(0, 2**30, 3).astype(np.int32)
    o_col, c_col = _column_major_order(acc, cnt, counters, jhs)
    o_port, c_port = _port(acc, cnt, counters, jhs)
    np.testing.assert_array_equal(o_port, o_col)
    np.testing.assert_array_equal(c_port, c_col)


# --- on the card ----------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rf,force_global", [
    (1, False), (3, False), (4, True), (3, True), (5, False), (12, True),
    (32, False), (32, True),
])
def test_kernel_matches_plain_on_card(cuda_device, rf, force_global):
    rng = np.random.default_rng(rf)
    b, p, n = 3, 45, 50  # P not a multiple of 8; partial and empty rows
    acc, cnt = _rows(rng, b, p, n, rf)
    counters = rng.integers(0, 5, (n + 6, rf)).astype(np.int32)
    jhs = rng.integers(0, 2**30, b).astype(np.int32)
    args = [to_tensor(x, cuda_device) for x in (acc, cnt, counters, jhs)]
    before = port.launches["leadership"]
    o_k, c_k = port.leadership_order(*args, force_global_slab=force_global)
    torch.cuda.synchronize()
    assert port.launches["leadership"] == before + 1
    o_p, c_p = port.leadership_order_plain(*args)
    assert torch.equal(o_k, o_p) and torch.equal(c_k, c_p)


@pytest.mark.cuda
def test_kernel_large_slab_takes_global_variant_on_card(cuda_device):
    rng = np.random.default_rng(4)
    n, rf = 20000, 4  # 320 KB slab: above the shared-memory opt-in limit
    acc, cnt = _rows(rng, 2, 16, n, rf)
    counters = rng.integers(0, 3, (n, rf)).astype(np.int32)
    jhs = rng.integers(0, 2**30, 2).astype(np.int32)
    args = [to_tensor(x, cuda_device) for x in (acc, cnt, counters, jhs)]
    o_k, c_k = port.leadership_order(*args)
    o_p, c_p = port.leadership_order_plain(*args)
    assert torch.equal(o_k, o_p) and torch.equal(c_k, c_p)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STRESS))
def test_kernel_stress_cases_match_plain_on_card(cuda_device, name):
    assert check_case(STRESS[name], str(cuda_device)) == 0


@pytest.mark.cuda
def test_mid_event_splits_prologue_from_chain_on_card(cuda_device):
    _, acc, cnt, counters, jhs, _ = STRESS["rf3-smem"]
    args = [to_tensor(x, cuda_device) for x in (acc, cnt, counters, jhs)]
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    start.record()
    o_k, c_k = port.leadership_order(*args, mid_event=mid)
    end.record()
    end.synchronize()
    assert start.elapsed_time(mid) >= 0 and mid.elapsed_time(end) >= 0
    o_p, c_p = port.leadership_order_plain(*args)
    assert torch.equal(o_k, o_p) and torch.equal(c_k, c_p)


@pytest.mark.cuda
@pytest.mark.parametrize("rf", [1, 3, 32])
def test_chain_probe_walks_the_chain_on_card(cuda_device, rf):
    before = port.launches["leadership"]
    ns, cycles = chain_step_ns(rf, steps=1 << 12, reps=2)
    assert ns > 0 and cycles > 0
    assert port.launches["leadership"] == before  # a measurement, not a launch
