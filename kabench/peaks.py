"""The yardstick's table of peaks and the byte counts of the work a kernel
must do, from shapes alone.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W limit; a
card set below it reads lower shares, so a run reports the card's name and
the caller keeps its power limit beside every share.
"""
from __future__ import annotations

#: HBM3 bandwidth of one H100 SXM, bytes per second.
HBM_BYTES_PER_S = 3.35e12

INT32 = 4


def leadership_bytes(topics: int, partitions: int, rf: int, brokers: int) -> int:
    """Bytes the leadership ordering of one plan must move, each input read
    once and each output written once: every partition's placed replicas
    (topics x partitions x rf) and replica count (topics x partitions), each
    topic's hash, and the per-broker, per-slot counters read and written
    (brokers x rf, twice) in, the ordered replicas (topics x partitions x
    rf) out. All int32, real rows only: padding is the program's choice."""
    return INT32 * (2 * topics * partitions * rf + topics * partitions
                    + 2 * brokers * rf + topics)


def least_seconds(nbytes: int) -> float:
    """The least time the card's memory allows for ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S
