"""The flight recorder: a bounded in-memory ring of lifecycle events — the
port of the reference's ``kafka_assigner_tpu/obs/flight.py``. Every event
carries a monotonic ``seq``, a wall-clock ``t``, its ``kind`` and
``cluster`` when cluster-scoped; overflow drops the oldest and is counted,
never silent. ``faults/inject.py`` records each fired fault here (kind
``fault``).

Activation as the rest of ``obs/``: nothing records until :func:`enable`
runs (``KA_OBS_FLIGHT_EVENTS`` entries; the one-shot CLI never enables it),
and :func:`record` without a live recorder is one global read and a
``None`` check. :func:`flush_to_dump` writes the ring as NDJSON to
``KA_OBS_FLIGHT_DUMP``.
"""
from __future__ import annotations

import collections
import sys
import threading
import time
from typing import List, Optional


class FlightRecorder:
    """One bounded event ring. Thread-safe: the watch loops, request
    threads, and the breaker all record concurrently."""

    def __init__(self, capacity: int) -> None:
        self.capacity = max(1, int(capacity))
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=self.capacity
        )
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0
        self.started_at = time.time()

    def record(self, kind: str, cluster: Optional[str] = None,
               **fields) -> int:
        """Append one event; returns its sequence number. Overflow evicts
        the oldest event and bumps ``dropped`` (counted, never silent)."""
        with self._lock:
            self._seq += 1
            if len(self._events) == self.capacity:
                self.dropped += 1
            ev = {"seq": self._seq, "t": round(time.time(), 3),
                  "kind": kind}
            if cluster is not None:
                ev["cluster"] = cluster
            ev.update(fields)
            self._events.append(ev)
            return self._seq

    def snapshot(self, cluster: Optional[str] = None,
                 since: int = 0) -> List[dict]:
        """The retained events, oldest first; ``cluster`` filters to one
        cluster's events (clusterless events are kept — they describe the
        whole process), ``since`` to events after that sequence number."""
        with self._lock:
            events = [dict(e) for e in self._events]
        # Pin the dump order to the sequence numbers rather than inheriting
        # it from ring insertion: ``oldest first`` is a documented contract
        # of the view and the NDJSON flush, not an accident of deque layout.
        events.sort(key=lambda e: e["seq"])
        return [
            e for e in events
            if e["seq"] > since
            and (cluster is None or e.get("cluster", cluster) == cluster)
        ]

    def stats(self) -> dict:
        """Ring accounting without copying the events (the /metrics
        gauges): total recorded and overflow-dropped counts."""
        with self._lock:
            return {"recorded": self._seq, "dropped": self.dropped}

    def view(self, cluster: Optional[str] = None) -> dict:
        """The ring with its accounting, as one JSON-ready object."""
        events = self.snapshot(cluster)
        stats = self.stats()
        return {
            "capacity": self.capacity,
            "recorded": stats["recorded"],
            "dropped": stats["dropped"],
            "started_at": round(self.started_at, 3),
            "events": events,
        }

    def flush(self, path: str, err=None) -> Optional[str]:
        """Write the ring as NDJSON (one event per line, oldest first).
        Returns the path written, or None. A failing write is reported on
        stderr and swallowed — a flight dump must never mask the exit it
        is documenting (same contract as the run-report emitter)."""
        import json

        err = err if err is not None else sys.stderr
        try:
            with open(path, "w", encoding="utf-8") as f:
                for ev in self.snapshot():
                    f.write(json.dumps(ev, sort_keys=True) + "\n")
            return path
        except OSError as e:
            print(f"obs: could not write flight dump {path!r}: {e}",
                  file=err)
            return None


#: The live recorder, or None (the CLI's state — zero overhead). One global
#: read per record call, same activation model as trace._ACTIVE.
_RECORDER: Optional[FlightRecorder] = None


def enable(capacity: Optional[int] = None) -> Optional[FlightRecorder]:
    """Install a fresh recorder. ``capacity`` defaults to the
    ``KA_OBS_FLIGHT_EVENTS`` knob; 0 disables recording entirely."""
    global _RECORDER
    if capacity is None:
        from ..utils.env import env_int

        capacity = env_int("KA_OBS_FLIGHT_EVENTS")
    _RECORDER = FlightRecorder(capacity) if capacity > 0 else None
    return _RECORDER


def disable() -> None:
    global _RECORDER
    _RECORDER = None


def recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def record(kind: str, cluster: Optional[str] = None, **fields) -> None:
    """Record one event on the live recorder; a cheap no-op when none."""
    rec = _RECORDER
    if rec is not None:
        rec.record(kind, cluster, **fields)


def flush_to_dump(err=None) -> Optional[str]:
    """Flush the live recorder to the ``KA_OBS_FLIGHT_DUMP`` path (no-op
    when either is unset), so the last ``KA_OBS_FLIGHT_EVENTS`` transitions
    survive the process."""
    rec = _RECORDER
    if rec is None:
        return None
    from ..utils.env import env_str

    path = env_str("KA_OBS_FLIGHT_DUMP")
    if not path:
        return None
    return rec.flush(path, err=err)
