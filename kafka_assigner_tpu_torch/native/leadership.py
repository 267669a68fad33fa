"""The host leadership lane: ``ka_order_many`` (``greedy.cpp``) over
device-placed batches, the counterpart of
``kafka_assigner_tpu/native/leadership.py``.

Leadership ordering (``computePreferenceLists``,
``KafkaAssignmentStrategy.java:202-302``) is a sequential chain: each
partition reads the counters the previous one wrote, across topics through
the shared Context. The reference runs it as host C++ by default; the port
runs it in the leadership kernel (``csrc/leadership.cu``) unless
``KA_LEADERSHIP=native`` asks for this lane, which copies the placement to
the host first. Both give the same bytes.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..utils.env import env_choice
from .build import load_native_library

#: ``KA_LEADERSHIP``'s values, as the reference's.
LEADERSHIP_CHOICES = ("auto", "native", "device")


def leadership_backend() -> str:
    """Resolve ``KA_LEADERSHIP`` to ``native`` or ``device``.

    ``auto`` (the default) and ``device`` take the device lane: the kernel
    on ``cuda``, its plain version on ``cpu``. (The reference's ``auto``
    takes the host lane when its library loads; the port keeps the device
    lane until card numbers of both lanes decide otherwise.) ``native``
    takes the host lane and raises ``NativeBuildError`` when the library
    is not built: it never falls back to the device lane."""
    if env_choice("KA_LEADERSHIP", LEADERSHIP_CHOICES, "auto") != "native":
        return "device"
    load_native_library()
    return "native"


def order_many(
    acc_nodes: np.ndarray,   # (B, P_pad, RF) int32, node index or -1
    acc_count: np.ndarray,   # (B, P_pad) int32
    jhashes: np.ndarray,     # (B,) abs java hash
    p_reals: np.ndarray,     # (B,) int32
    counters: np.ndarray,    # (N_pad, RF) int32 Context slab, not mutated
) -> tuple[np.ndarray, np.ndarray]:
    """Leadership-order every partition of every topic in sequence.

    Returns ``(ordered (B, P_pad, RF), counters_after)``, byte-identical to
    ``ops/leadership.py:leadership_order`` on the same batch. Rows past a
    topic's ``p_reals`` come out -1 and bump nothing."""
    lib = load_native_library()
    b, p_pad, rf = acc_nodes.shape
    acc_nodes = np.ascontiguousarray(acc_nodes, dtype=np.int32)
    acc_count = np.ascontiguousarray(acc_count, dtype=np.int32)
    jh = np.ascontiguousarray(jhashes, dtype=np.int64)
    pr = np.ascontiguousarray(p_reals, dtype=np.int32)
    if acc_count.shape != (b, p_pad) or jh.shape != (b,) or pr.shape != (b,):
        raise ValueError(
            f"order_many: acc_count {acc_count.shape}, jhashes {jh.shape} and "
            f"p_reals {pr.shape} do not fit acc_nodes {acc_nodes.shape}"
        )
    if counters.ndim != 2 or counters.shape[1] != rf:
        raise ValueError(f"order_many: counters must be (N_pad, {rf}), got {counters.shape}")
    counters_after = np.array(counters, dtype=np.int32)  # private copy
    ordered = np.empty((b, p_pad, rf), dtype=np.int32)

    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ka_order_many(
        b, p_pad, rf,
        acc_nodes.ctypes.data_as(i32p),
        acc_count.ctypes.data_as(i32p),
        jh.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pr.ctypes.data_as(i32p),
        counters_after.ctypes.data_as(i32p),
        ordered.ctypes.data_as(i32p),
    )
    return ordered, counters_after
