"""``SolveDispatcher``: the daemon's dispatch plane, the port of the
reference's ``kafka_assigner_tpu/daemon/dispatch.py``.

Under ``KA_DISPATCH=0`` every solve-bearing request of the daemon takes one
shared solve lock. By default the daemon builds one dispatcher instead,
shared by every cluster. Request handlers then run their host halves
concurrently, and their device halves become typed jobs on one queue:

========================== ===============================================
job                        coalescing
========================== ===============================================
what-if scenario rows      rows whose batch key matches (the sweep entry,
(``/whatif``: the dense    the bytes of every shared operand and the
and incremental sweeps,    static arguments) concatenate along the row
the rescue, the budgeted   axis into one ``whatif_sweep`` or
blocks)                    ``whatif_subset_sweep`` call; each budgeted
                           block of a large sweep is a job of its own that
                           packs with nothing
placement rows (``/plan``, distinct plans whose encodings agree in shape,
the recommendation's       statics and rack bytes concatenate their topic
candidate plan)            rows into one ``place_batched`` call; each
                           plan orders its own leaders afterwards
group candidate rows       the same through ``group_pack_sweep``: one KG1
(``/groups/sweep``)        launch for the candidates of several requests
identical request bodies   concurrent requests with equal (cluster, cache
(``/plan``, ``/whatif``,   version, params) keys run once; the leader's
the recommendation)        stdout serves every waiter. The entry is
                           stamped with the cache version at the leader's
                           admission, so an arrival after a resync starts
                           a fresh entry
========================== ===============================================

One dispatcher thread gathers jobs for a window (``KA_DISPATCH_WINDOW_MS``
times the queue depth, capped at ``KA_DISPATCH_WINDOW_MAX_MS`` and never
below the base) or until ``KA_DISPATCH_MAX_BATCH`` jobs wait, groups them by
key and runs one device call per group, then hands each job its rows of the
outputs. Placement is independent per row, so a row's outputs are the same
whatever rides beside it, and the bytes of every response are those of a
solo run.

The port has no compiled shapes, so a packed call is not padded to a power
of two: ``dispatch.pad_waste_frac`` reads 0 where the reference's reads the
padded share.

A crash inside a packed call (the ``dispatch`` fault seam fires once per
call, on the dispatcher thread, before the device work) fails that group's
jobs only; each re-runs its own rows solo on its request thread
(:func:`submit_routed`). A sticky CUDA error poisons the
context for every job: the solo re-run covers a Python-level crash, not
that. Queue wait counts against the request's watchdog and is recorded
apart from solve time (``daemon.solve.queue_ms`` against the ``dispatch``
span). ``close()`` dispatches every queued job at once, refuses new ones
(their callers take the direct path) and joins the thread.

Request captures are thread-local: a request's stdout, its request ID and
its queue wait land in its own capture. Work on the dispatcher thread (the
packed device call, the ``dispatch`` span, the batch counters) records into
the cumulative registry, and into a process-wide capture when one is open.
"""
from __future__ import annotations

import hashlib
import io
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..faults.inject import fault_point
from ..obs import flight
from ..obs.metrics import counter_add, gauge_set, hist_observe
from ..obs.trace import record_span

#: The dispatcher installed for a thread (a request body's scope), so the
#: sweep and solve entries find it without a process global: an in-process
#: CLI run on another thread never routes through a daemon's queue.
_tls = threading.local()


def active_broker() -> Optional["SolveDispatcher"]:
    """The dispatcher installed for the calling thread, or None (the CLI,
    the ``KA_DISPATCH=0`` lock regime, threads outside a request)."""
    return getattr(_tls, "broker", None)


class dispatch_scope:
    """Install ``broker`` as the calling thread's dispatcher for a request
    body; nested scopes restore the previous one."""

    def __init__(self, broker: Optional["SolveDispatcher"]) -> None:
        self._broker = broker
        self._prev: Optional["SolveDispatcher"] = None

    def __enter__(self) -> Optional["SolveDispatcher"]:
        self._prev = getattr(_tls, "broker", None)
        _tls.broker = self._broker
        return self._broker

    def __exit__(self, *exc) -> None:
        _tls.broker = self._prev
        return None


def batch_key(entry: str, shared_arrays, statics: tuple) -> str:
    """A row job's compatibility class: the entry, a digest of every shared
    (not row-indexed) operand's dtype, shape and bytes, and the static
    arguments. Jobs with equal keys would make the same call on the same
    shared operands, so concatenating their rows is the widening a sweep
    already does within one request; two clusters whose encodings agree
    get the same key. The operands are host arrays: no key reads a card
    tensor back."""
    h = hashlib.blake2b(digest_size=16)
    h.update(entry.encode("utf-8"))
    h.update(repr(statics).encode("utf-8"))
    for a in shared_arrays:
        arr = np.ascontiguousarray(a)
        h.update(str(arr.dtype).encode("utf-8"))
        h.update(str(arr.shape).encode("utf-8"))
        h.update(arr.tobytes())
    return f"{entry}:{h.hexdigest()}"


def submit_routed(entry: str, shared, statics: tuple, rows, n_rows: int,
                  call: Callable, cluster: Optional[str] = None):
    """Route a device call's rows through the calling thread's dispatcher
    (the reference's ``parallel/whatif.py:_submit_coalesced``). ``shared``
    (host arrays) and ``statics`` make the :func:`batch_key`; neither is
    hashed when no dispatcher routes. Returns the call's outputs cut to
    these rows, or None when no dispatcher routes (the caller calls
    directly). A packed call that crashed (another request's rows may have
    shared it) is re-run once on these rows alone, on this thread; a second
    failure goes to the caller's own fallback."""
    broker = active_broker()
    if broker is None:
        return None
    key = batch_key(entry, shared, statics)
    try:
        return broker.submit_rows(entry, key, rows, n_rows, call, cluster=cluster)
    except Exception as e:
        counter_add("dispatch.solo_fallbacks")
        print(f"kafka-assigner: coalesced {entry} batch failed "
              f"({type(e).__name__}: {e}); re-running this request's "
              f"{n_rows} row(s) solo", file=sys.stderr)
        return call(rows)


def _rows_of(out, lo: int, hi: int):
    """A job's rows of one output of a packed call (an array or a tensor);
    an output without rows (a record of the call) passes whole."""
    return out[lo:hi] if hasattr(out, "shape") else out


class _RowJob:
    """One row job: ``rows`` (each array's axis 0 is the packable axis,
    ``n_rows`` long) and the ``call`` that runs the device work on rows."""

    __slots__ = (
        "entry", "key", "rows", "n_rows", "call", "cluster",
        "done", "result", "error", "t_submit", "t_start",
    )

    def __init__(self, entry, key, rows, n_rows, call, cluster):
        self.entry = entry
        self.key = key
        self.rows = rows
        self.n_rows = n_rows
        self.call = call
        self.cluster = cluster
        self.done = threading.Event()
        self.result: Optional[tuple] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.t_start: float = 0.0


class _PlanEntry:
    """One request body in flight: the leader runs it, the followers wait.
    ``version`` is the cache version at the leader's admission."""

    __slots__ = ("done", "stdout", "degraded", "error", "followers", "version")

    def __init__(self, version: object = None) -> None:
        self.done = threading.Event()
        self.stdout: Optional[str] = None
        self.degraded = False
        self.error: Optional[BaseException] = None
        self.followers = 0
        self.version = version


class SolveDispatcher:
    """The gather queue and its one dispatcher thread (module doc)."""

    def __init__(self, err=None) -> None:
        self.err = err if err is not None else sys.stderr
        self._cv = threading.Condition()
        self._queue: List[_RowJob] = []
        self._closed = False
        #: Identical-body dedup, one entry per body key in flight.
        self._plan_mu = threading.Lock()
        self._plan_entries: Dict[str, _PlanEntry] = {}
        self._thread = threading.Thread(target=self._loop, name="ka-dispatch",
                                        daemon=True)
        self._thread.start()

    # -- live knobs -------------------------------------------------------------

    @staticmethod
    def _window_s(depth: int = 1) -> float:
        """The gather window of a cycle that finds ``depth`` jobs queued:
        the base window times the depth, capped at
        ``KA_DISPATCH_WINDOW_MAX_MS``, never below the base."""
        from ..utils.env import env_float

        base = env_float("KA_DISPATCH_WINDOW_MS")
        cap = env_float("KA_DISPATCH_WINDOW_MAX_MS")
        return min(base * max(1, depth), max(cap, base)) / 1000.0

    @staticmethod
    def _max_batch() -> int:
        from ..utils.env import env_int

        return env_int("KA_DISPATCH_MAX_BATCH")

    # -- row jobs ------------------------------------------------------------------

    def submit_rows(
        self,
        entry: str,
        key: str,
        rows: Dict[str, np.ndarray],
        n_rows: int,
        call: Callable[[Dict[str, np.ndarray]], tuple],
        cluster: Optional[str] = None,
    ) -> Optional[tuple]:
        """Queue one row job and wait for its rows of a packed call: the
        outputs, each cut to this job's ``n_rows`` on axis 0 (an output
        without rows whole), or None when the dispatcher is closed (the
        caller takes its direct path). Raises the group's error when the
        packed call failed (the caller re-runs its rows solo)."""
        job = _RowJob(entry, key, rows, n_rows, call, cluster)
        with self._cv:
            if self._closed:
                return None
            self._queue.append(job)
            self._cv.notify_all()
        counter_add("dispatch.jobs")
        job.done.wait()
        # Recorded on the request thread, so it lands in the request's
        # capture, apart from the solve's time.
        hist_observe("daemon.solve.queue_ms", (job.t_start - job.t_submit) * 1000.0)
        if job.error is not None:
            raise job.error
        return job.result

    # -- body jobs (identical-request dedup) ----------------------------------

    def run_job(
        self,
        key: str,
        fn: Callable[[io.StringIO], bool],
        out: io.StringIO,
        version: Optional[Callable[[], object]] = None,
    ) -> Optional[Tuple[bool, bool]]:
        """Run one whole request body (``fn(stdout) -> degraded``) with
        identical concurrent bodies (equal ``key``) coalesced into one run,
        whose stdout serves every waiter. Distinct bodies run concurrently
        on their request threads; their device rows meet in the row queue.

        ``version`` reads the caller's live cache version. An arrival whose
        version differs from the in-flight entry's waits that entry out and
        is admitted afresh, so no follower gets another epoch's bytes.

        Returns ``(degraded, coalesced)``, ``coalesced`` true for a follower
        served the leader's bytes, or None when the dispatcher is closed
        (the caller takes the lock). The leader's exception is the leader's;
        its followers re-run solo."""
        with self._cv:
            if self._closed:
                return None
        counter_add("dispatch.jobs")
        t0 = time.perf_counter()
        while True:
            live = version() if version is not None else None
            with self._plan_mu:
                entry = self._plan_entries.get(key)
                if entry is None:
                    leader = True
                    entry = _PlanEntry(live)
                    self._plan_entries[key] = entry
                    break
                if version is None or entry.version == live:
                    leader = False
                    entry.followers += 1
                    break
                stale = entry
            # The leader in flight was admitted under another version: wait
            # it out (it drops its entry when done) and be admitted again.
            stale.done.wait()
        if leader:
            try:
                hist_observe("daemon.solve.queue_ms",
                             (time.perf_counter() - t0) * 1000.0)
                local = io.StringIO()
                try:
                    entry.degraded = fn(local)
                    entry.stdout = local.getvalue()
                except BaseException as e:
                    entry.error = e
            finally:
                with self._plan_mu:
                    self._plan_entries.pop(key, None)
                    followers = entry.followers
                entry.done.set()
            if followers:
                counter_add("dispatch.batches")
                hist_observe("dispatch.batch_size", 1 + followers)
                flight.record("dispatch", None, entry="body", jobs=1 + followers,
                              coalesced=True)
            else:
                counter_add("dispatch.solo_fallbacks")
            if entry.error is not None:
                raise entry.error
            out.write(entry.stdout)
            return entry.degraded, False
        entry.done.wait()
        hist_observe("daemon.solve.queue_ms", (time.perf_counter() - t0) * 1000.0)
        if entry.error is not None:
            # The leader's crash is the leader's: this follower runs its own
            # body, with its own fallbacks.
            counter_add("dispatch.solo_fallbacks")
            return fn(out), False
        out.write(entry.stdout)
        return entry.degraded, True

    # -- lifecycle ---------------------------------------------------------------

    def close(self) -> None:
        """Refuse new jobs, dispatch every queued one now (a draining
        daemon's requests wait on them), then join the thread."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=30.0)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- the dispatcher thread -------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait(0.1)
                if not self._queue and self._closed:
                    return
                # Gather from the first job's submit time: wait out the
                # window (recomputed on every wake from the live depth)
                # unless the size trigger fires or the daemon drains.
                gauge_set("dispatch.queue_depth", len(self._queue))
                t_first = self._queue[0].t_submit
                max_batch = self._max_batch()
                eff_s = self._window_s(len(self._queue))
                while not self._closed and len(self._queue) < max_batch:
                    eff_s = self._window_s(len(self._queue))
                    left = t_first + eff_s - time.perf_counter()
                    if left <= 0:
                        break
                    self._cv.wait(left)
                gauge_set("dispatch.window_ms", eff_s * 1000.0)
                # The size trigger caps the cycle too: the jobs past it are
                # already past their window, and the next cycle takes them.
                batch = self._queue[:max_batch]
                del self._queue[:max_batch]
            groups: Dict[str, List[_RowJob]] = {}
            for job in batch:
                groups.setdefault(job.key, []).append(job)
            for jobs in groups.values():
                self._run_group(jobs)

    def _run_group(self, jobs: List[_RowJob]) -> None:
        """One packed device call: the group's rows concatenated, the first
        job's call (equal keys, equal shared operands) on them, each job's
        rows of the outputs handed back. An escape fails this group only."""
        t0 = time.perf_counter()
        for job in jobs:
            job.t_start = t0
        ok = False
        total = sum(j.n_rows for j in jobs)
        try:
            fault_point("dispatch", cluster=jobs[0].cluster)
            if len(jobs) == 1:
                rows = jobs[0].rows
            else:
                rows = {name: np.concatenate([j.rows[name] for j in jobs], axis=0)
                        for name in jobs[0].rows}
            outs = jobs[0].call(rows)
            off = 0
            for job in jobs:
                job.result = tuple(_rows_of(a, off, off + job.n_rows) for a in outs)
                off += job.n_rows
            ok = True
        except BaseException as e:
            for job in jobs:
                job.error = e
            print(f"ka-dispatch: coalesced {jobs[0].entry} dispatch failed "
                  f"({type(e).__name__}: {e}); {len(jobs)} job(s) degrade per-job",
                  file=self.err)
        finally:
            ms = (time.perf_counter() - t0) * 1000.0
            record_span("dispatch", ms, ok)
            if ok:
                # A failed call's jobs re-run solo and count there.
                hist_observe("dispatch.batch_size", len(jobs))
                hist_observe("dispatch.pad_waste_frac", 0.0)
                counter_add("dispatch.batches" if len(jobs) > 1
                            else "dispatch.solo_fallbacks")
            flight.record("dispatch", jobs[0].cluster if len(jobs) == 1 else None,
                          entry=jobs[0].entry, jobs=len(jobs), rows=total,
                          coalesced=len(jobs) > 1, ok=ok, ms=round(ms, 3))
            for job in jobs:
                job.done.set()
