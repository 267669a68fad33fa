"""Dense problem encoding: the bridge between ``{partition: [broker_id]}``
maps and the index-space tensors the solver works on, a copy of
``kafka_assigner_tpu/models/problem.py``. The batched encode and decode go
through the C boundary codec (``native/hostcodec.c``) when ``KA_HOSTCODEC``
is on (the default) and the codec is built, as the reference's do; the numpy
bodies here are its twin, and give the same arrays and lists.

Everything downstream works on int32 arrays over *index* space (broker row
0..N-1, rack 0..R-1, partition row 0..P-1); ids appear only here. Shapes are
bucketed like the reference's: multiples of 8 on the partition and node axes
(``_pad8``), exact replica width (min 2), powers of two on the batch axis.

:class:`GroupEncodeAccumulator` builds the batched group encode chunk by
chunk while mode 3's metadata still streams in (``generator.py:
stream_initial_assignment``), with the arrays of the one-shot encode.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Set

import numpy as np

from ..solvers.base import Context
from ..utils.env import env_bool
from ..utils.javahash import java_string_hash

#: Which codec the latest encode and decode of this process took: ``"c"``
#: (the native codec) or ``"numpy"``. The solver copies it after each solve.
last_codec: Dict[str, str] = {"encode": "", "decode": ""}


def _checked_jhash(topic: str) -> int:
    """abs(Java String.hashCode), rejecting Integer.MIN_VALUE (the reference
    crashes on it with a negative array index)."""
    h = java_string_hash(topic)
    if h == -(2**31):
        raise ValueError(
            f"topic {topic!r} hashes to Integer.MIN_VALUE; the reference "
            "tool crashes on this input (negative array index)"
        )
    return abs(h)


def _hostcodec():
    """The built C boundary codec, or None when ``KA_HOSTCODEC=0`` or it is
    not built (``native/build.py:prebuild_native_libraries`` warns at
    startup when it cannot be built); the numpy paths then run."""
    if not env_bool("KA_HOSTCODEC"):
        return None
    from ..native.build import NativeBuildError, load_hostcodec

    try:
        return load_hostcodec()
    except NativeBuildError:
        return None


def _next_bucket(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _pad8(n: int, floor: int = 8) -> int:
    """Round up to a multiple of 8 (min ``floor``)."""
    return max(floor, (n + 7) // 8 * 8)


def group_pads(currents: Sequence[Mapping[int, Sequence[int]]]) -> tuple:
    """``(p_pad, width)`` bucket covering a whole topic group, by the
    group encode's rules (the reference's ``group_pads``)."""
    p_pad = max((_pad8(len(cur)) for cur in currents), default=8)
    width = max(
        (max((len(r) for r in cur.values()), default=1) for cur in currents),
        default=2,
    )
    return p_pad, max(width, 2)


def batch_bucket(b: int) -> int:
    """Power-of-two bucket for the batch (topic-count) axis; padding topics
    are inert (p_real == 0)."""
    return _next_bucket(b, floor=1)


@dataclass
class ClusterEncoding:
    """Broker/rack canonicalization shared by every topic in a run."""

    broker_ids: np.ndarray      # (N,) int64 ascending
    rack_idx: np.ndarray        # (N_pad,) int32
    broker_to_idx: Dict[int, int]
    n: int
    n_pad: int
    n_racks: int                # distinct racks among the real brokers


def encode_cluster(
    rack_assignment: Mapping[int, str], nodes: Set[int]
) -> ClusterEncoding:
    """Factorize the broker set + rack map once for a whole run."""
    broker_ids = np.array(sorted(nodes), dtype=np.int64)
    n = len(broker_ids)
    n_pad = _pad8(n)
    uniq: Dict[str, int] = {}
    rack_idx = np.empty(n_pad, dtype=np.int32)
    for i, b in enumerate(broker_ids):
        name = rack_assignment.get(int(b))
        if name is None:
            # A rackless node's rack id is its id string
            # (KafkaAssignmentStrategy.java:82-86), collisions included.
            name = str(int(b))
        rack_idx[i] = uniq.setdefault(name, len(uniq))
    for i in range(n, n_pad):
        rack_idx[i] = len(uniq) + (i - n)
    return ClusterEncoding(
        broker_ids=broker_ids,
        rack_idx=rack_idx,
        broker_to_idx={int(b): i for i, b in enumerate(broker_ids)},
        n=n,
        n_pad=n_pad,
        n_racks=len(uniq),
    )


def rack_cap(n_racks: int) -> int:
    """Static rack-id bound for the wave bodies' per-rack tensors."""
    return _next_bucket(n_racks + 1, floor=16)


@dataclass
class ProblemEncoding:
    """One topic's assignment problem, canonicalized to dense index space."""

    topic: str
    broker_ids: np.ndarray      # (N,) int64, ascending — index -> broker id
    partition_ids: np.ndarray   # (P,) int64, ascending — row -> partition id
    rack_idx: np.ndarray        # (N_pad,) int32
    current: np.ndarray         # (P_pad, L) int32 broker index or -1; from
                                # encode_topic_group a VIEW into the batch array
    rf: int                     # replication factor to assign
    jhash: int                  # abs(java hash of the topic)
    n: int                      # real node count
    p: int                      # real partition count
    n_pad: int
    p_pad: int
    r_cap: int | None = None    # static rack-id bound (rack_cap)


def encode_problem(
    topic: str,
    current_assignment: Mapping[int, Sequence[int]],
    rack_assignment: Mapping[int, str],
    nodes: Set[int],
    partitions: Set[int],
    replication_factor: int,
    cluster: ClusterEncoding | None = None,
) -> ProblemEncoding:
    """Canonicalize one topic; ``partitions`` ids missing from
    ``current_assignment`` become empty (-1) rows."""
    if cluster is None:
        cluster = encode_cluster(rack_assignment, nodes)
    last_codec["encode"] = "numpy"
    broker_ids = cluster.broker_ids
    n = cluster.n
    spids = sorted(partitions)
    partition_ids = np.array(spids, dtype=np.int64)
    p = len(partition_ids)
    p_pad = _pad8(p)
    lengths = {len(r) for r in current_assignment.values()}
    width = max(max(lengths, default=0), 2)
    current = np.full((p_pad, width), -1, dtype=np.int32)
    uniform = (
        n > 0
        and len(lengths) == 1
        and next(iter(lengths)) > 0
        and (
            partitions == current_assignment.keys()
            or all(pid in current_assignment for pid in spids)
        )
    )
    if uniform and p > 0:
        # Vectorized id -> index mapping; ids outside the live set map to -1.
        length = next(iter(lengths))
        ids = np.array([current_assignment[pid] for pid in spids], dtype=np.int64)
        idx = np.searchsorted(broker_ids, ids).clip(0, max(n - 1, 0))
        found = broker_ids[idx] == ids
        current[:p, :length] = np.where(found, idx, -1).astype(np.int32)
    else:
        part_to_row = {int(pid): i for i, pid in enumerate(partition_ids)}
        for pid, replicas in current_assignment.items():
            row = part_to_row.get(int(pid))
            if row is None:
                continue
            for s, b in enumerate(replicas):
                current[row, s] = cluster.broker_to_idx.get(int(b), -1)

    return ProblemEncoding(
        topic=topic,
        broker_ids=broker_ids,
        partition_ids=partition_ids,
        rack_idx=cluster.rack_idx,
        current=current,
        rf=replication_factor,
        jhash=_checked_jhash(topic),
        n=n,
        p=p,
        n_pad=cluster.n_pad,
        p_pad=p_pad,
        r_cap=rack_cap(cluster.n_racks),
    )


def encode_topic_group(
    named_currents: Sequence[tuple],  # [(topic, {pid: [broker_id, ...]}), ...]
    rack_assignment: Mapping[int, str],
    nodes: Set[int],
    rfs: int | Sequence[int],
    cluster: ClusterEncoding | None = None,
) -> tuple:
    """One-pass batched encode of a topic group. Returns ``(encs, currents
    (B_pad, P_pad, W) int32, jhashes (B_pad,) int32, p_reals (B_pad,) int32)``
    with the batch axis bucketed (padding topics inert). Every uniform
    topic's id -> index mapping is one ``searchsorted`` over the
    concatenation; ragged replica lists take the general fill. With the C
    codec on and every mapping a real ``dict``, the codec does the same in
    one pass (:func:`_encode_topic_group_codec`)."""
    if cluster is None:
        cluster = encode_cluster(rack_assignment, nodes)
    broker_ids = cluster.broker_ids
    n = cluster.n
    if isinstance(rfs, int):
        rfs = [rfs] * len(named_currents)
    elif len(rfs := list(rfs)) != len(named_currents):
        raise ValueError(
            f"rfs has {len(rfs)} entries for {len(named_currents)} topics"
        )

    codec = _hostcodec()
    if codec is not None and all(isinstance(c, dict) for _, c in named_currents):
        # The codec walks real dicts (the PyDict API); other Mappings
        # (MappingProxyType, ChainMap, ...) take the numpy path, so the
        # accepted inputs do not depend on the codec being built.
        last_codec["encode"] = "c"
        return _encode_topic_group_codec(codec, named_currents, rfs, cluster)
    last_codec["encode"] = "numpy"

    per = []  # (topic, spids, ids(ndarray)|None, cur, jhash)
    max_p, max_w = 0, 1
    for topic, cur in named_currents:
        jh_abs = _checked_jhash(topic)
        spids = sorted(cur)
        ids = None
        width = 0
        if spids and n > 0:
            try:
                ids = np.asarray([cur[p] for p in spids], dtype=np.int64)
                if ids.ndim != 2:
                    ids = None
            except (ValueError, TypeError):
                ids = None  # ragged replica lists: general fill below
        if ids is not None:
            width = ids.shape[1]
        elif spids:
            width = max((len(cur[p]) for p in spids), default=0)
        max_p = max(max_p, len(spids))
        max_w = max(max_w, width)
        per.append((topic, spids, ids, cur, jh_abs))

    p_pad = _pad8(max_p)
    width = max(max_w, 2)
    b_pad = batch_bucket(len(per))
    currents = np.full((b_pad, p_pad, width), -1, dtype=np.int32)
    jhashes = np.zeros(b_pad, dtype=np.int32)
    p_reals = np.zeros(b_pad, dtype=np.int32)

    flats = [ids.ravel() for _, _, ids, _, _ in per if ids is not None]
    if flats:
        all_ids = np.concatenate(flats) if len(flats) > 1 else flats[0]
        idx = np.searchsorted(broker_ids, all_ids).clip(0, max(n - 1, 0))
        mapped = np.where(broker_ids[idx] == all_ids, idx, -1).astype(np.int32)
    off = 0
    encs = []
    for i, ((topic, spids, ids, cur, jh), rf) in enumerate(zip(per, rfs)):
        p = len(spids)
        if ids is not None:
            size = ids.size
            currents[i, :p, : ids.shape[1]] = mapped[off : off + size].reshape(
                ids.shape
            )
            off += size
        elif p:
            b2i = cluster.broker_to_idx
            for row, pid in enumerate(spids):
                for s, b in enumerate(cur[pid]):
                    currents[i, row, s] = b2i.get(int(b), -1)
        jhashes[i] = jh
        p_reals[i] = p
        encs.append(
            ProblemEncoding(
                topic=topic,
                broker_ids=broker_ids,
                partition_ids=np.asarray(spids, dtype=np.int64),
                rack_idx=cluster.rack_idx,
                current=currents[i],
                rf=rf,
                jhash=jh,
                n=n,
                p=p,
                n_pad=cluster.n_pad,
                p_pad=p_pad,
                r_cap=rack_cap(cluster.n_racks),
            )
        )
    return encs, currents, jhashes, p_reals


def _encode_topic_group_codec(codec, named_currents, rfs, cluster):
    """The C codec's encode: the same outputs as the numpy body of
    :func:`encode_topic_group`, the dict walk, key sort, id -> index mapping
    and row fills done in one C pass."""
    n = cluster.n
    jh_list = [_checked_jhash(topic) for topic, _ in named_currents]
    curs = [cur for _, cur in named_currents]
    max_p, max_w = codec.scan_dims(curs)
    p_pad = _pad8(max_p)
    width = max(max_w, 2)
    b_pad = batch_bucket(len(curs))
    currents = np.full((b_pad, p_pad, width), -1, dtype=np.int32)
    jhashes = np.zeros(b_pad, dtype=np.int32)
    p_reals = np.zeros(b_pad, dtype=np.int32)
    part_ids = np.full((b_pad, p_pad), -1, dtype=np.int64)
    codec.encode_rows(
        curs, np.ascontiguousarray(cluster.broker_ids, dtype=np.int64),
        currents, p_reals, part_ids,
    )
    jhashes[: len(jh_list)] = jh_list
    encs = []
    for i, ((topic, _), rf) in enumerate(zip(named_currents, rfs)):
        p = int(p_reals[i])
        encs.append(
            ProblemEncoding(
                topic=topic,
                broker_ids=cluster.broker_ids,
                partition_ids=part_ids[i, :p],
                rack_idx=cluster.rack_idx,
                current=currents[i],
                rf=rf,
                jhash=jh_list[i],
                n=n,
                p=p,
                n_pad=cluster.n_pad,
                p_pad=p_pad,
                r_cap=rack_cap(cluster.n_racks),
            )
        )
    return encs, currents, jhashes, p_reals


class GroupEncodeAccumulator:
    """Incremental :func:`encode_topic_group`, the reference's
    (``kafka_assigner_tpu/models/problem.py:384``): feed topic chunks as the
    streamed ingest delivers them (:meth:`add`), then :meth:`finish` into
    the arrays the one-shot group encode would have produced.

    Chunking is safe because the group buckets are maxima of per-topic
    shapes (``p_pad = _pad8(max p)``, ``width = max(w, 2)``, ``b_pad =
    batch_bucket(B)``) and the encoded values (id -> index mapping,
    jhashes, p_reals) never depend on which topics share a batch. Each
    chunk encodes against the shared cluster encoding with its own smaller
    buckets (the expensive dict walk, through the C codec when it is on);
    ``finish`` block-copies the chunk slabs into the group-bucketed arrays
    and rebinds every encoding's ``current`` to its row of the final slab.

    Replication factors are not known until the whole topic list is in
    (RF inference runs after ingest): chunks encode with a placeholder
    ``rf``, and the solver stamps the real values (``rf`` is carried
    metadata, not an input to the array encode).

    ``codecs`` records the codec each chunk's encode took (``"c"`` or
    ``"numpy"``, from :data:`last_codec`); ``encode_ms`` the host time spent
    in :meth:`add` and :meth:`update_topics`.

    The delta store (:meth:`update_topics`, :meth:`delete_topic`,
    :meth:`merge`; the reference's ``models/problem.py:482-574``) is the
    resident daemon's incremental re-encode: one entry per live topic, each
    trimmed to the topic's own buckets, so a merge computes the group
    buckets from the live topics alone, as a from-scratch encode does.
    """

    def __init__(
        self, rack_assignment: Mapping[int, str], nodes: Set[int]
    ) -> None:
        self.cluster = encode_cluster(rack_assignment, nodes)
        self._chunks: List[tuple] = []  # (encs, currents, jhashes, p_reals)
        self._total = 0
        self.encode_ms = 0.0
        self.codecs: List[str] = []
        self._delta: Dict[str, tuple] = {}  # topic -> (enc, cur2d, jh, p)

    def add(self, named_currents: Sequence[tuple], rfs: int = 0) -> None:
        """Encode one chunk of ``(topic, current_assignment)`` pairs, in
        stream order, against the shared cluster encoding."""
        if not named_currents:
            return
        t0 = time.perf_counter()
        out = encode_topic_group(
            named_currents, {}, set(), [rfs] * len(named_currents),
            cluster=self.cluster,
        )
        self._chunks.append(out)
        self._total += len(named_currents)
        self.codecs.append(last_codec["encode"])
        self.encode_ms += (time.perf_counter() - t0) * 1000.0

    def peek_shape(self) -> tuple | None:
        """``(p_pad, width)`` bucket maxima over the chunks encoded so far,
        or None before any chunk arrived: the partial-metadata signal the
        ingest warm-up predicts the solve's signature from
        (``solvers/warmup.py``). Later chunks can only grow these maxima."""
        if not self._chunks:
            return None
        return (
            max(c[1].shape[1] for c in self._chunks),
            max(c[1].shape[2] for c in self._chunks),
        )

    def finish(self) -> tuple:
        """Merge the chunk slabs into group-wide buckets: the same ``(encs,
        currents, jhashes, p_reals)`` as one-shot :func:`encode_topic_group`
        over the concatenated chunks."""
        if not self._chunks:
            return (
                [],
                np.full((1, 8, 2), -1, dtype=np.int32),
                np.zeros(1, dtype=np.int32),
                np.zeros(1, dtype=np.int32),
            )
        p_pad = max(c[1].shape[1] for c in self._chunks)
        width = max(c[1].shape[2] for c in self._chunks)
        b_pad = batch_bucket(self._total)
        currents = np.full((b_pad, p_pad, width), -1, dtype=np.int32)
        jhashes = np.zeros(b_pad, dtype=np.int32)
        p_reals = np.zeros(b_pad, dtype=np.int32)
        encs: List[ProblemEncoding] = []
        i = 0
        for cencs, ccur, cjh, cpr in self._chunks:
            b = len(cencs)
            currents[i:i + b, : ccur.shape[1], : ccur.shape[2]] = ccur[:b]
            jhashes[i:i + b] = cjh[:b]
            p_reals[i:i + b] = cpr[:b]
            for k, e in enumerate(cencs):
                # `current` was a view into the chunk's slab: rebind it to
                # the final slab's row. `partition_ids` keeps its own array
                # (a view holds its base alive).
                encs.append(
                    dataclasses.replace(
                        e, current=currents[i + k], p_pad=p_pad
                    )
                )
            i += b
        self._chunks = []
        return encs, currents, jhashes, p_reals

    # -- delta API (the resident daemon's incremental re-encode) -------------

    def update_topics(
        self, named_currents: Sequence[tuple], rfs: int = 0
    ) -> int:
        """(Re-)encode the given topics into the delta store, batched
        through :func:`encode_topic_group` (the C codec or its numpy twin,
        as any encode). Each topic's slab is trimmed to its own buckets,
        ``_pad8(p)`` x ``max(width, 2)``, so :meth:`merge` recovers the
        group buckets a from-scratch encode of the final state computes,
        whichever topics shared a chunk or have since been deleted. A prior
        entry of a topic is replaced. Returns the topics (re-)encoded."""
        if not named_currents:
            return 0
        t0 = time.perf_counter()
        encs, currents, _jh, _pr = encode_topic_group(
            named_currents, {}, set(), [rfs] * len(named_currents),
            cluster=self.cluster,
        )
        for i, (topic, cur) in enumerate(named_currents):
            enc = encs[i]
            own_p_pad = _pad8(enc.p)
            own_width = max(max((len(r) for r in cur.values()), default=0), 2)
            trimmed = np.array(currents[i][:own_p_pad, :own_width], copy=True)
            self._delta[topic] = (
                # Own copies: a view would keep the whole chunk's slab alive.
                dataclasses.replace(
                    enc, current=trimmed, p_pad=own_p_pad,
                    partition_ids=np.array(enc.partition_ids, copy=True),
                ),
                trimmed,
                enc.jhash,
                enc.p,
            )
        self.encode_ms += (time.perf_counter() - t0) * 1000.0
        return len(named_currents)

    def delete_topic(self, topic: str) -> bool:
        """Drop one topic from the delta store; returns whether it was
        there."""
        return self._delta.pop(topic, None) is not None

    def delta_topics(self) -> List[str]:
        """The delta store's topics, in insertion order."""
        return list(self._delta)

    def delta_shape(self) -> tuple | None:
        """``(p_pad, width)`` bucket maxima over the delta store's live
        topics (what a merge of all of them buckets to), or None when the
        store is empty: the daemon's warm-up signature input."""
        if not self._delta:
            return None
        shapes = [cur.shape for _, cur, _, _ in self._delta.values()]
        return (max(s[0] for s in shapes), max(s[1] for s in shapes))

    def merge(self, topic_order: Sequence[str]) -> tuple:
        """The delta store assembled for ``topic_order``: the same
        ``(encs, currents, jhashes, p_reals)`` bytes as a one-shot
        :func:`encode_topic_group` of the final state in that order. The
        store keeps serving later merges. An unknown topic raises
        ``KeyError``."""
        entries = []
        for t in topic_order:
            try:
                entries.append(self._delta[t])
            except KeyError:
                raise KeyError(
                    f"topic {t!r} is not in the delta encode store"
                ) from None
        if not entries:
            return (
                [],
                np.full((1, 8, 2), -1, dtype=np.int32),
                np.zeros(1, dtype=np.int32),
                np.zeros(1, dtype=np.int32),
            )
        p_pad = max(cur.shape[0] for _, cur, _, _ in entries)
        width = max(cur.shape[1] for _, cur, _, _ in entries)
        b_pad = batch_bucket(len(entries))
        currents = np.full((b_pad, p_pad, width), -1, dtype=np.int32)
        jhashes = np.zeros(b_pad, dtype=np.int32)
        p_reals = np.zeros(b_pad, dtype=np.int32)
        encs: List[ProblemEncoding] = []
        for i, (enc, cur, jh, p) in enumerate(entries):
            currents[i, : cur.shape[0], : cur.shape[1]] = cur
            jhashes[i] = jh
            p_reals[i] = p
            encs.append(dataclasses.replace(enc, current=currents[i], p_pad=p_pad))
        return encs, currents, jhashes, p_reals


def decode_assignment(
    enc: ProblemEncoding, ordered: np.ndarray
) -> Dict[int, List[int]]:
    """(P_pad, RF) broker-index matrix -> {partition_id: [broker_id, ...]}."""
    rows = np.asarray(ordered[: enc.p])
    if rows.size and (rows >= 0).all():
        ids = enc.broker_ids[rows].tolist()
        return dict(zip(enc.partition_ids.tolist(), ids))
    out: Dict[int, List[int]] = {}
    for row in range(enc.p):
        out[int(enc.partition_ids[row])] = [
            int(enc.broker_ids[i]) for i in rows[row] if i >= 0
        ]
    return out


def decode_assignments_batched(
    encs: Sequence[ProblemEncoding], ordered: np.ndarray
) -> List[Dict[int, List[int]]]:
    """Batched :func:`decode_assignment`: through the C codec when it is on
    and built, else one gather + one bulk int conversion per distinct RF
    over the whole (B, P_pad, RF) result. Both skip -1 slots, so a narrower
    topic of a mixed-RF batch, and a compat row shorter than the slot
    width, come out as short as they are."""
    if not encs:
        return []
    ordered = np.ascontiguousarray(ordered, dtype=np.int32)
    broker_ids = encs[0].broker_ids
    codec = _hostcodec()
    if codec is not None:
        last_codec["decode"] = "c"
        part_ids = np.full((len(encs), ordered.shape[1]), -1, dtype=np.int64)
        for i, e in enumerate(encs):
            part_ids[i, : e.p] = e.partition_ids
        p_reals32 = np.fromiter((e.p for e in encs), dtype=np.int32, count=len(encs))
        return codec.decode_rows(
            ordered[: len(encs)],
            np.ascontiguousarray(broker_ids, dtype=np.int64),
            part_ids, p_reals32, len(encs),
        )
    last_codec["decode"] = "numpy"
    p_reals = np.fromiter((e.p for e in encs), dtype=np.int64, count=len(encs))
    rfs = np.fromiter((e.rf for e in encs), dtype=np.int64, count=len(encs))
    # Completeness over real rows and each topic's own slots (a narrower
    # topic's trailing slots in a mixed-RF batch are legitimately -1).
    valid = np.arange(ordered.shape[1])[None, :] < p_reals[:, None]
    slot_ok = np.arange(ordered.shape[2])[None, None, :] < rfs[:, None, None]
    incomplete = ((ordered < 0) & valid[:, :, None] & slot_ok).any(axis=(1, 2))
    lists_by_topic: Dict[int, list] = {}
    for r in np.unique(rfs):
        idx = np.where(rfs == r)[0]
        sub = broker_ids[np.maximum(ordered[idx][:, :, :r], 0)].tolist()
        for k, i in enumerate(idx):
            lists_by_topic[int(i)] = sub[k]
    out: List[Dict[int, List[int]]] = []
    for i, enc in enumerate(encs):
        if not incomplete[i] and enc.p:
            out.append(
                dict(zip(enc.partition_ids.tolist(), lists_by_topic[i][: enc.p]))
            )
        else:
            out.append(decode_assignment(enc, ordered[i]))
    return out


def context_to_array(ctx: Context, enc: ProblemEncoding) -> np.ndarray:
    """The cross-topic leadership counters as a dense (N_pad, RF) int32 slab.

    The leadership key ``count * m + rotated_pos`` (m <= RF) shares int32
    space with the BIG sentinel, so a persisted context grown past the key
    space (with 2^24 placements of headroom) is refused here."""
    limit = (0x3FFFFFFF - enc.rf) // max(enc.rf, 1) - (1 << 24)
    counters = np.zeros((enc.n_pad, enc.rf), dtype=np.int32)
    for i, b in enumerate(enc.broker_ids):
        per_node = ctx.counter.get(int(b))
        if per_node:
            for slot in range(enc.rf):
                c = per_node.get(slot, 0)
                if c > limit:
                    raise ValueError(
                        f"leadership counter for broker {int(b)} slot {slot} "
                        f"({c}) exceeds the solver's key space ({limit}); the "
                        "persisted --leadership_context has grown too large — "
                        "start from a fresh context"
                    )
                counters[i, slot] = c
    return counters


def apply_counter_updates(
    ctx: Context, enc: ProblemEncoding, before: np.ndarray, after: np.ndarray
) -> None:
    """Fold the solve's counter increments back into the shared Context."""
    delta = np.asarray(after, dtype=np.int64) - np.asarray(before, dtype=np.int64)
    for i, b in enumerate(enc.broker_ids):
        for slot in range(enc.rf):
            d = int(delta[i, slot])
            if d:
                node = ctx.counter.setdefault(int(b), {})
                node[slot] = node.get(slot, 0) + d
