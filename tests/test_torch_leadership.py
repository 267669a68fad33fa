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


# --- on the card ----------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rf,force_global", [(1, False), (3, False), (4, True), (3, True)])
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
