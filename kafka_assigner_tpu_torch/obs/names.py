"""The declared metric and span names this package writes, a subset of the
reference's registry (``kafka_assigner_tpu/obs/names.py``), each with the
reference's meaning, so a port report reads like the reference's.

Every metric and span name the package writes with a literal first
argument is declared here, in the change that adds the write
(``tests/test_torch_obs.py`` sweeps the package's sources and fails on an
undeclared literal). Dynamic names compose on declared bases: the CLI's
``mode/<MODE>`` span, the per-kind fault counters
``faults.injected.<kind>`` and the warm-up's per-outcome counters
``warmup.<outcome>``.
"""
from __future__ import annotations

#: Counter / gauge / histogram names (the write API's first argument).
METRIC_NAMES: frozenset = frozenset({
    # zk.* — metadata reads and reassignment writes (every backend counts
    # here), the wire client's frames, serial-op latency, session
    # re-establishments and writes a read-back found landed, and its
    # pipelined window
    "zk.reads", "zk.writes", "zk.bytes", "zk.op_ms", "zk.topics_missing",
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
})

#: Both namespaces.
ALL_NAMES: frozenset = METRIC_NAMES | SPAN_NAMES
