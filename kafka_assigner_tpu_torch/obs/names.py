"""The declared metric and span names this package writes, a subset of the
reference's registry (``kafka_assigner_tpu/obs/names.py``), each with the
reference's meaning, so a port report reads like the reference's.

Every metric and span name the package writes with a literal first
argument is declared here, in the change that adds the write
(``tests/test_torch_obs.py`` sweeps the package's sources and fails on an
undeclared literal). Dynamic names compose on declared bases: the CLI's
``mode/<MODE>`` span, the per-kind fault counters
``faults.injected.<kind>`` and the warm-up's per-outcome counters
``warmup.<outcome>``. The daemon's counters and spans are written through
its supervisor (``daemon/supervisor.py``), not with literal names, and are
declared here all the same; for a daemon of many clusters they take an
``@cluster`` suffix, which the cumulative registry turns into a label. So
are the controller's (``daemon/controller.py``), which it writes through
its cluster's supervisor. The fleet scheduler's (``daemon/fleet.py``) are
daemon-wide and carry no cluster label.

:data:`FLIGHT_KINDS` lists the flight recorder's event kinds
(``obs/flight.py``), each with the reference's fields.
"""
from __future__ import annotations

#: Counter / gauge / histogram names (the write API's first argument).
METRIC_NAMES: frozenset = frozenset({
    # zk.* — metadata reads and reassignment writes (every backend counts
    # here), the wire client's frames, serial-op latency, session
    # re-establishments, writes a read-back found landed, watch
    # notifications received, and its pipelined window
    "zk.reads", "zk.writes", "zk.bytes", "zk.op_ms", "zk.topics_missing",
    "zk.watch_events",
    "zk.session.reestablished", "zk.write_readback_confirmed",
    "zk.wire_frames_in", "zk.wire_frames_out",
    "zk.wire_bytes_in", "zk.wire_bytes_out",
    "zk.pipeline.batches", "zk.pipeline.rtts_saved",
    "zk.pipeline.in_flight", "zk.pipeline.batch_ms",
    # ingest.* — topics read, skipped under best-effort, and the streamed
    # encode's host time and the share of it overlapped with the fetch
    "ingest.topics", "ingest.topics_skipped",
    "ingest.encode_ms", "ingest.overlap_ms",
    # encode.* — the batched host encode
    "encode.topics", "encode.p_pad", "encode.pad_waste_frac",
    # plan.* — lifted into the report's plan section
    "plan.moves", "plan.leader_churn", "plan.topics", "plan.partitions",
    "plan.waves", "plan.moves_submitted", "plan.noops",
    "plan.skipped_moves", "plan.verify_mismatches", "plan.unplanned_topics",
    # whatif.* — scenario-sweep fan-out
    "whatif.scenarios", "whatif.fanout", "whatif.dispatch_ms",
    "whatif.incremental_sweeps", "whatif.rescued",
    # per-lane solve counters and the best-effort fallbacks
    "greedy.assigns", "greedy.partitions",
    "native.assigns", "native.partitions",
    "solver.assign_calls", "solver.fresh_calls", "solve.fallbacks",
    # compile.store.* — the library store (utils/programstore.py): a library
    # loaded from the store or built now, the wall of each, and a stored
    # library that failed to load; unbucketed never counts (no entry is
    # per shape)
    "compile.store.hits", "compile.store.misses",
    "compile.store.exec_fallbacks", "compile.store.unbucketed",
    "compile.store.loads_ms", "compile.store.compiles_ms",
    # warmup.* — the ingest-overlapped warm-up ("warmup.<outcome>" composes
    # on this base)
    "warmup.failures",
    # faults.* — injection accounting ("faults.injected.<kind>" composes)
    "faults.injected",
    # exec.* — plan execution (ka-execute): waves, moves submitted,
    # convergence re-polls, write read-backs, skipped moves, verify passes,
    # and each wave's wall
    "exec.waves", "exec.moves", "exec.retries", "exec.write_retries",
    "exec.skipped", "exec.verify", "exec.wave_ms",
    # groups.* — consumer-group plans, sweeps, dispatches, fallbacks and
    # the refusal of a backend without groups
    "groups.plans", "groups.sweeps", "groups.moves",
    "groups.candidates", "groups.dispatches", "groups.fanout",
    "groups.solve_fallbacks", "groups.refusals",
    # daemon.* — the resident daemon (daemon/): requests served, degraded,
    # shed by the inflight gate, failed by a bug, re-run after a churn race
    # or on the greedy lane after a solve crash, over the watchdog's budget;
    # topics re-encoded by a watch event, full resyncs and their failures,
    # session losses, watch events received, dropped by the fault seam and
    # watch-loop errors; post-resync warm-ups and their failures; the
    # session breaker's transitions and probes
    "daemon.requests", "daemon.requests_degraded", "daemon.requests_shed",
    "daemon.request_errors",
    "daemon.churn_retries", "daemon.solve_fallbacks",
    "daemon.watchdog_exceeded", "daemon.reencode.topics",
    "daemon.resyncs", "daemon.resync_failures", "daemon.session_lost",
    "daemon.watch_events", "daemon.watch_dropped", "daemon.watch_errors",
    "daemon.warmups", "daemon.warmup_failures",
    "daemon.breaker_opened", "daemon.breaker_probes",
    "daemon.breaker_closed",
    # ... requests refused before a cluster's first sync; /execute runs,
    # their 409s, halts, errors, kills and broken progress streams; and
    # /recommendations evaluated
    "daemon.requests_unsynced",
    "daemon.executes", "daemon.execute_conflicts", "daemon.execute_halts",
    "daemon.execute_errors", "daemon.execute_interrupted",
    "daemon.execute_stream_broken", "daemon.recommendations",
    # daemon.http.* — the routing layer's requests and latency by endpoint,
    # cluster and code (cumulative only, written with labels)
    "daemon.http.requests", "daemon.http.request_ms",
    # health.* — the cached assignment's scores on every resync and delta
    # re-encode, the scoring's wall, and the last recommendation's moves
    "health.replica_spread", "health.replica_stddev",
    "health.leader_spread", "health.leader_stddev",
    "health.rack_violations", "health.score", "health.score_ms",
    "health.movement_debt",
    # traffic.* — per-partition traffic and lag series (cumulative only),
    # the series over KA_OBS_TRAFFIC_SERIES_MAX, and failed fetches
    "traffic.in_bytes", "traffic.out_bytes", "traffic.lag",
    "traffic.series_dropped", "traffic.fetch_failures",
    # a served ranking's wall over its scenarios, and a served groups
    # sweep's wall
    "whatif.scenario_ms", "groups.sweep_ms",
    # dispatch.* — the coalescing dispatcher (daemon/dispatch.py): packed
    # device calls, jobs routed through it, jobs that ran alone or re-ran
    # solo, jobs per packed call, a job's queue wait (apart from its solve
    # time), the queue depth at a gather cycle's start, the window it used,
    # and the padded share of a packed call's rows
    "dispatch.batches", "dispatch.jobs", "dispatch.solo_fallbacks",
    "dispatch.batch_size", "daemon.solve.queue_ms",
    "dispatch.queue_depth", "dispatch.window_ms", "dispatch.pad_waste_frac",
    # controller.* — the closed-loop rebalance controller
    # (daemon/controller.py): evaluations and holds, actions and the
    # replica moves they executed, truncations, rollbacks, regressions,
    # failed executions, the controller breaker's transitions, and the live
    # hysteresis streak and window-budget gauges
    "controller.evaluations", "controller.holds", "controller.actions",
    "controller.truncations", "controller.rollbacks",
    "controller.regressions", "controller.exec_failures",
    "controller.breaker_opened", "controller.breaker_closed",
    "controller.moves", "controller.window_moves", "controller.streak",
    # fleet.* — the daemon-wide fleet scheduler (daemon/fleet.py):
    # admission grants and denials, the live-lease and window-move gauges,
    # expired leases, the boot-time recovery scan's resumed and failed
    # journals, and a verdict memory reset by the controller
    "fleet.grants", "fleet.deferrals", "fleet.preemptions",
    "fleet.leases", "fleet.window_moves", "fleet.lease_expired",
    "fleet.recoveries", "fleet.recovery_failures",
    "fleet.memory_resets",
})

#: Span names (``span(...)`` first argument). Paths derive from nesting at
#: run time; "mode/<MODE>" composes from the CLI mode.
SPAN_NAMES: frozenset = frozenset({
    "metadata/assignment", "ingest/stream", "feasibility",
    "zk/brokers", "zk/partition_assignment",
    "plan/solve", "plan/fresh", "plan/emit",
    "encode", "solve", "decode",
    "whatif/rank", "whatif/incremental", "whatif/dispatch",
    "whatif/rescue",
    "native/assign_many",
    "warmup",
    "exec/wave", "exec/submit", "exec/poll", "exec/verify",
    "groups/plan", "groups/sweep", "groups/dispatch",
    "daemon/request", "daemon/resync", "daemon/recommend", "daemon/groups",
    # one packed device call of the dispatcher, on its own thread (outside
    # every request's capture)
    "dispatch",
    # the rebalance controller: one evaluation of the recommendation
    # pipeline, and one supervised action (the forward run, the post-move
    # re-score and any rollback)
    "controller/evaluate", "controller/act",
})

#: Both namespaces.
ALL_NAMES: frozenset = METRIC_NAMES | SPAN_NAMES

#: The flight recorder's event kinds (``flight.record``'s first argument),
#: the reference's taxonomy (``kafka_assigner_tpu/obs/flight.py``).
FLIGHT_KINDS: frozenset = frozenset({
    "daemon", "lifecycle", "breaker", "session", "resync", "watch",
    "watchdog", "request", "execute", "fault", "profile", "recommendation",
    "groups", "dispatch", "controller",
    # one decision of the fleet scheduler: granted / deferred / budget-hold
    # / preempted / released / lease-expired / recovered / recovery-failed
    # / recovery-done (+ ``cluster``, ``sha``, ``moves``, ``lease_kind``,
    # ``reason``, ...)
    "fleet",
})
