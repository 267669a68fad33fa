"""Java ``String.hashCode`` semantics, needed for output parity with the reference.

The reference rotates its node-processing order by ``Math.abs(topic.hashCode()) %
nodes`` (``KafkaAssignmentStrategy.java:188-200``) both when spreading orphaned
replicas and when breaking ties in leadership ordering. To reproduce the
reference's placement decisions bit-for-bit, we reproduce the JVM hash exactly,
including 32-bit overflow over UTF-16 code units.
"""
from __future__ import annotations

import struct

_INT32_MIN = -(2**31)


def java_string_hash(s: str) -> int:
    """Java ``String.hashCode()``: ``sum(u[i] * 31^(n-1-i))`` wrapped to int32.

    Operates on UTF-16 code units (Java ``char``), so supplementary-plane
    characters contribute two units, exactly as on the JVM.
    """
    data = s.encode("utf-16-be")
    units = struct.unpack(f">{len(data) // 2}H", data)
    h = 0
    for u in units:
        h = (31 * h + u) & 0xFFFFFFFF
    return h - 0x100000000 if h >= 0x80000000 else h


def topic_start_index(topic: str, n: int) -> int:
    """``Math.abs(topic.hashCode()) % n`` (``KafkaAssignmentStrategy.java:190``).

    Java's ``Math.abs(Integer.MIN_VALUE)`` is still negative; the reference
    would then index an array with a negative value and crash with
    ``ArrayIndexOutOfBoundsException``. We surface that pathological case as a
    clear error instead of reproducing the crash.
    """
    if n <= 0:
        raise ValueError("node count must be positive")
    h = java_string_hash(topic)
    if h == _INT32_MIN:
        raise ValueError(
            f"topic {topic!r} hashes to Integer.MIN_VALUE; the reference tool "
            "crashes on this input (negative array index)"
        )
    return abs(h) % n
