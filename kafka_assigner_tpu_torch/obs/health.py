"""The deterministic synthetic traffic series, a copy of
``synthetic_partition_traffic`` from the reference's
``kafka_assigner_tpu/obs/health.py:242-270``. The consumer-group family's
synthetic members and its throughput weight column read it; the rest of
the reference's health scoring is not part of this package.
"""
from __future__ import annotations

import zlib
from typing import Dict, Iterable, Mapping

from ..io.base import PartitionTraffic


def synthetic_partition_traffic(
    partitions: Mapping[str, Iterable[int]],
) -> Dict[str, Dict[int, PartitionTraffic]]:
    """Per partition, a stable ``PartitionTraffic`` derived from a CRC of
    ``topic/partition``: identical across calls, processes and machines,
    and skewed over orders of magnitude like a real cluster's."""
    out: Dict[str, Dict[int, PartitionTraffic]] = {}
    for topic, parts in partitions.items():
        per: Dict[int, PartitionTraffic] = {}
        for p in parts:
            h = zlib.crc32(f"{topic}/{int(p)}".encode("utf-8"))
            # 2^(h mod 11) scales 1x..1024x over a 100 B/s base; lag
            # correlates loosely with traffic.
            scale = float(2 ** (h % 11))
            per[int(p)] = PartitionTraffic(
                in_bytes=round(100.0 * scale, 3),
                out_bytes=round(250.0 * scale, 3),
                lag=int((h >> 8) % 1000),
            )
        out[topic] = per
    return out
