"""The data types the consumer-group family reads from a backend: copies of
``PartitionTraffic``, ``GroupMember`` and ``ConsumerGroupState`` from the
reference's ``kafka_assigner_tpu/io/base.py:38-78``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple


class PartitionTraffic(NamedTuple):
    """One partition's traffic and lag: produce and consume byte rates and
    the worst consumer-group lag. Backends without real meters serve the
    deterministic synthetic series (``obs/health.py:
    synthetic_partition_traffic``); ``supports_traffic()`` says which."""

    in_bytes: float   # produced bytes/s into this partition
    out_bytes: float  # consumed bytes/s out of this partition
    lag: int          # worst consumer-group lag, in messages


class GroupMember(NamedTuple):
    """One consumer-group member: a stable id and a capacity estimate in
    the weight column's units. ``capacity <= 0`` means unknown, and the
    encoder substitutes the fair-share default (``groups/encode.py``)."""

    member_id: str
    capacity: float = 0.0


class ConsumerGroupState(NamedTuple):
    """One consumer group's packing problem: members, the current
    ``topic -> partition -> member_id`` ownership (``None`` = unowned) and
    ``topic -> partition -> messages`` lag. Partitions may appear in
    ``lags`` without an owner and the other way round; the encoder
    reconciles both against the caller's partition universe."""

    group: str
    members: Tuple[GroupMember, ...]
    assignment: Dict[str, Dict[int, Optional[str]]]
    lags: Dict[str, Dict[int, int]]
