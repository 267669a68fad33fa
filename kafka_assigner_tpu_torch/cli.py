"""The port's CLI, every mode of the reference CLI::

    python -m kafka_assigner_tpu_torch.cli --zk_string file://cluster.json \
        --mode PRINT_REASSIGNMENT [--topics a,b] [--integer_broker_ids 1,2 |
        --broker_hosts h1,h2] [--broker_hosts_to_remove h3]
        [--desired_replication_factor N] [--disable_rack_awareness]
        [--leadership_context PATH] [--solver {device,native,greedy}]
        [--failure-policy {strict,best-effort}] [--report-json PATH]
        [--device {cuda,cpu}]

    python -m kafka_assigner_tpu_torch.cli --zk_string file://cluster.json \
        --mode PRINT_FRESH_ASSIGNMENT --topics a,b --partition_count P \
        --desired_replication_factor N [broker selection as above]
        [--device {cuda,cpu}]

    python -m kafka_assigner_tpu_torch.cli --zk_string file://cluster.json \
        --mode RANK_DECOMMISSION [--integer_broker_ids 1,2 | --broker_hosts
        h1,h2 | --scenario_file PATH] [--broker_hosts_to_remove h3]
        [--topics a,b] [--desired_replication_factor N] [--device {cuda,cpu}]

    python -m kafka_assigner_tpu_torch.cli --zk_string file://cluster.json \
        --mode {PRINT_CURRENT_ASSIGNMENT [--topics a,b] | PRINT_CURRENT_BROKERS}

``--zk_string`` takes what the reference CLI takes (``io/base.py:
open_backend``): a ZooKeeper quorum ``host:port,...[/chroot]`` (the
reference tool's only mode; the in-tree wire client unless ``kazoo`` is
installed, ``KA_ZK_CLIENT`` picks), ``kafka://host:port,...`` for the Kafka
AdminClient bridge, or a ``file://cluster.json`` snapshot. A rack-blind
backend (confluent-kafka's AdminClient) is refused by the plan modes unless
``--disable_rack_awareness`` opts out explicitly (exit 1). The flags are
the reference CLI's flags for these modes
(``kafka_assigner_tpu/cli.py:83-118``). ``--solver`` picks mode 3's solver:
``device`` (the default; the PyTorch/CUDA solver, in the place of the
reference's ``tpu``), ``native`` (the C++ greedy) or ``greedy`` (the Python
oracle); the other modes always run on the device and note a ``--solver``
other than ``device`` on stderr, as the reference does. ``--device`` says
where the device solver runs. RANK_DECOMMISSION ranks each candidate
broker's removal (all live brokers by default), or each removal set of a
``--scenario_file``, in one sweep; the two current-state modes run on the
host. Stdout is byte-identical to ``kafka_assigner_tpu.cli`` (with
``--solver tpu`` in the place of ``device``). Every entry first builds the
native host libraries (``native/build.py``) when they are not built.

Every mode takes the reference's ``--report-json PATH`` (default: the
``KA_OBS_REPORT`` knob; ``KA_OBS_ENABLE=1`` collects without a file): the
schema-v1 run report of ``obs/report.py`` with its spans, counters, gauges
and ``plan`` section, and a summary on stderr. ``--failure-policy`` (default:
the ``KA_FAILURE_POLICY`` knob, ``strict``) is mode 3's: ``best-effort``
skips topics that vanish mid-scan and re-runs a crashed device
solve on the greedy lane, and the run exits 6 (degraded success).

Exit codes follow the reference's documented ones: 1 usage, 3 metadata
ingest (an unreachable quorum, a session lost past its retries, a topic
missing under ``strict`` in mode 3), 4 solve (a device crash under
``strict``), 5 validation (RF bounds, unknown hosts or scenario entries,
infeasible plan), 6 degraded success.

Warm start, ``ka-warm`` (:func:`run_warm`, ``python -m
kafka_assigner_tpu_torch.warm``)::

    python -m kafka_assigner_tpu_torch.warm (--zk_string file://cluster.json
        [--topics a,b] [--desired_replication_factor N] |
        --buckets TOPICS,PARTITIONS,RF,BROKERS[,RACKS]) [--device {cuda,cpu}]

seeds the library store (``utils/programstore.py``, ``KA_PROGRAM_STORE*``)
for a cluster's signature or a synthetic one, with the reference's flags,
stderr lines and exit codes (0 seeded; 1 usage, incomplete, or nothing
persisted under ``KA_PROGRAM_STORE=0``; 3 ingest; 5 validation). Mode 3's
device lane also warms by itself: its streamed ingest starts a warm-up
thread after the first encoded chunk (``KA_WARMUP``).

The consumer-group tool ``ka-groups`` (:func:`run_groups`,
``python -m kafka_assigner_tpu_torch.groups``)::

    python -m kafka_assigner_tpu_torch.groups --zk_string file://cluster.json \
        [--mode {plan,sweep}] [--group g1,g2] [--synthetic]
        [--weight {lag,throughput}] [--counts 1,2,4] [--scales 100,150]
        [--solver {device,greedy}] [--failure-policy {strict,best-effort}]
        [--report-json PATH] [--device {cuda,cpu}]

takes the reference's flags (``kafka_assigner_tpu/cli.py:661-721``) and
prints the reference's JSON envelope byte for byte. Under ``best-effort`` a
crashed device solve re-runs on the host packing oracle (the same plan,
marked ``"solver": "greedy-fallback"``) and the run exits 6. Exit codes: 1
usage (and the refusal of a backend without groups), 3 ingest, 4 solve, 5
validation, 6 degraded success.

Plan execution, ``ka-execute`` (:func:`execute`, ``python -m
kafka_assigner_tpu_torch.exec``)::

    python -m kafka_assigner_tpu_torch.exec --zk_string file://cluster.json \
        --plan PLAN [--journal PATH] [--resume] [--rollback]
        [--wave-size N] [--throttle S] [--failure-policy {strict,best-effort}]
        [--report-json PATH]

drives a saved mode-3 stdout (its NEW ASSIGNMENT, or with ``--rollback``
its CURRENT ASSIGNMENT) or a bare plan to convergence in throttled,
journaled waves and verifies the cluster against it byte for byte
(``exec/engine.py``), with the reference's flags, stderr lines, journal
and exit codes (``kafka_assigner_tpu/cli.py:901-1116``): 0 verified, 1
usage, 3 ingest, 5 validation (a read-only backend, a plan the cluster
does not match, a journal of another plan or cluster), 6 moves skipped
under ``best-effort``, 7 verify mismatch, 8 halted mid-plan (resume with
``--resume``). It does no device work and takes no ``--device``.

The resident daemon for one cluster, ``ka-daemon`` (:func:`daemon_main`,
``python -m kafka_assigner_tpu_torch.daemon``)::

    python -m kafka_assigner_tpu_torch.daemon --zk_string host:2181 \
        [--solver {device,native,greedy}] [--failure-policy {strict,best-effort}]
        [--bind ADDR] [--port N] [--device {cuda,cpu}]

serves ``/plan``, ``/whatif``, ``/healthz``, ``/readyz`` and ``/state``
(``daemon/service.py``), with the reference's flags of the single-cluster
daemon (``kafka_assigner_tpu/cli.py:497-648``) and ``--device``; a served
``/plan``'s ``result.stdout`` is byte-identical to this CLI's mode 3 on the
same metadata. It announces ``ka-daemon: listening on http://ADDR:PORT`` on
stderr and exits 0 after a SIGTERM drain; 1 on a usage error or ``--device
cuda`` without a card (it never falls back to the CPU); 3 when the first
sync fails; 5 on validation.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .solvers.base import SOLVER_NAMES

EXIT_OK = 0
EXIT_USAGE = 1
EXIT_INGEST = 3
EXIT_SOLVE = 4
EXIT_VALIDATION = 5
EXIT_DEGRADED = 6
EXIT_VERIFY = 7     # ka-execute: the cluster after the moves differs from the plan
EXIT_EXECUTE = 8    # ka-execute: halted mid-plan, resumable with --resume

#: The reference CLI's modes (``kafka_assigner_tpu/cli.py:67-73``).
MODES = (
    "PRINT_CURRENT_ASSIGNMENT",
    "PRINT_CURRENT_BROKERS",
    "PRINT_REASSIGNMENT",
    "RANK_DECOMMISSION",
    "PRINT_FRESH_ASSIGNMENT",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kafka-assignment-generator-torch",
        description="Prints a least-disruptive reassignment of topic "
        "partition replicas to brokers in Kafka-parseable JSON.",
    )
    p.add_argument("--zk_string", default=None,
                   help="ZK quorum as comma-separated host:port pairs "
                        "(optionally /chroot), kafka://host:port for the "
                        "Kafka AdminClient bridge, or a file://cluster.json "
                        "snapshot")
    p.add_argument("--mode", default=None, choices=MODES,
                   help="the mode to run")
    p.add_argument("--integer_broker_ids", default=None,
                   help="comma-separated list of Kafka broker IDs (integers)")
    p.add_argument("--broker_hosts", default=None,
                   help="comma-separated list of broker hostnames (instead of broker IDs)")
    p.add_argument("--broker_hosts_to_remove", default=None,
                   help="comma-separated list of broker hostnames to exclude")
    p.add_argument("--topics", default=None,
                   help="comma-separated list of topics")
    p.add_argument("--desired_replication_factor", type=int, default=-1,
                   help="used for changing replication factor for topics; "
                        "if not present it will use the existing number")
    p.add_argument("--disable_rack_awareness", action="store_true",
                   help="set to true to ignore rack configurations")
    p.add_argument("--partition_count", type=int, default=None,
                   help="PRINT_FRESH_ASSIGNMENT: number of partitions to "
                        "place for each --topics entry")
    p.add_argument("--scenario_file", default=None, metavar="PATH",
                   help="RANK_DECOMMISSION: JSON array of removal scenarios "
                        "(arrays of broker ids and/or hostnames, e.g. "
                        '[[1,2],["host7"]]) ranked in one batched sweep '
                        "instead of the default per-broker singleton sweep")
    p.add_argument("--leadership_context", default=None, metavar="PATH",
                   help="persist cross-run leadership counters to PATH "
                        "(loaded if present, saved after the plan)")
    p.add_argument("--solver", default="device", choices=SOLVER_NAMES,
                   help="PRINT_REASSIGNMENT's solver: the PyTorch/CUDA solver "
                        "(device, the default), the C++ greedy (native) or "
                        "the Python greedy oracle (greedy)")
    p.add_argument("--failure-policy", dest="failure_policy", default=None,
                   choices=("strict", "best-effort"),
                   help="strict (default): abort on the first unrecoverable "
                        "failure. best-effort: skip topics that vanish "
                        "mid-scan and fall back to the greedy solver when the device "
                        "solve crashes, reported on stderr and in the run "
                        "report, exiting 6 (default: the KA_FAILURE_POLICY "
                        "knob)")
    _add_report_flag(p)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the device solver runs (default: cuda)")
    return p


def _add_report_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--report-json", dest="report_json", default=None,
                   metavar="PATH",
                   help="emit the schema-versioned run report (spans, "
                        "metrics, plan stats) to PATH, plus a summary on "
                        "stderr (default: the KA_OBS_REPORT knob)")


def _captured(mode: str, report_json: Optional[str], argv, dispatch) -> int:
    """Run ``dispatch()`` (returning an exit code) under an obs capture when
    a report is asked for (``--report-json``, ``KA_OBS_REPORT``) or
    ``KA_OBS_ENABLE=1``, inside a ``mode/<mode>`` span, and emit the report
    (``kafka_assigner_tpu/cli.py:182-237``). Its status is ``ok`` on exit 0,
    ``degraded`` on exit 6, else ``error`` (with the exception's type and
    message when one escaped). A report that cannot be built or written is
    reported on stderr and never masks the run's own outcome. Without
    collection the dispatch runs with the obs no-ops: byte-identical output,
    no files. Either way the run's warm-up thread is joined before it
    returns."""
    from . import obs
    from .utils.env import env_bool, env_str

    report_path = report_json or env_str("KA_OBS_REPORT")
    if report_path is None and not env_bool("KA_OBS_ENABLE"):
        try:
            return dispatch()
        finally:
            _join_warmup_threads()  # a warm-up never outlives its run
    with obs.run_capture() as run:
        status, error, rc = "error", None, EXIT_USAGE
        try:
            with obs.span(f"mode/{mode}") as sp:
                rc = dispatch()
                if rc not in (EXIT_OK, EXIT_DEGRADED):
                    # A failure signaled by return code: the span agrees
                    # with the report's status. Degraded success is not a
                    # span failure: the plan was emitted.
                    sp.fail()
            status = (
                "ok" if rc == EXIT_OK
                else "degraded" if rc == EXIT_DEGRADED
                else "error"
            )
            return rc
        except BaseException as e:
            # A run that raises still flushes its spans (marked error) and
            # emits its report.
            error = e
            raise
        finally:
            try:
                # The warm-up thread records its span and counters from the
                # background: drain it so the report carries its outcome.
                _join_warmup_threads()
                report = obs.build_report(
                    run, status=status, mode=mode,
                    argv=list(argv) if argv is not None else sys.argv[1:],
                    error=error,
                )
                obs.emit_report(report, report_path)
            except Exception as e:
                print(f"obs: could not emit run report: {e}", file=sys.stderr)


def _join_warmup_threads() -> None:
    """Join the run's warm-up threads. Only the solver's modules start one,
    so a run that never imported them (``ka-execute``) has none to join and
    does not import them here."""
    generator = sys.modules.get(f"{__package__}.generator")
    if generator is not None:
        generator.join_warmup_threads()


def _prebuild_native() -> None:
    """Build the native host libraries unless they are built: entry points
    compile, the solve path only loads (``native/build.py``). A codec that
    cannot be built warns once and the numpy codec stands in."""
    from .native.build import prebuild_native_libraries

    prebuild_native_libraries(err=sys.stderr)


def _note_solver_ignored(args, why: str) -> None:
    """The reference's stderr note for a mode that ignores ``--solver``
    (``kafka_assigner_tpu/cli.py:299-322``)."""
    if args.solver != "device":
        print(f"note: --solver {args.solver} is ignored by {args.mode} ({why})",
              file=sys.stderr)


def run_tool(argv: Optional[List[str]] = None, out=None) -> int:
    """Parse, validate, open the backend, run the mode. Raises the typed
    errors (``ValueError``, ``KeyError``, ``OSError``, ``ZkWireError``,
    ``IngestError``, ``SolveError``); :func:`run` maps them to exit
    codes."""
    _prebuild_native()
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        if args.zk_string is None:
            raise ValueError("--zk_string is required")
        if args.mode is None:
            raise ValueError("--mode is required")
        if args.integer_broker_ids is not None and args.broker_hosts is not None:
            raise ValueError(
                "--integer_broker_ids and --broker_hosts cannot be used together!"
            )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        parser.print_usage(sys.stderr)
        return EXIT_USAGE

    topics = args.topics.split(",") if args.topics is not None else None
    return _captured(args.mode, args.report_json, argv,
                     lambda: _dispatch_mode(args, topics, out))


def _dispatch_mode(args, topics, out) -> int:
    """Backend open, the mode, backend close."""
    from .io.base import open_backend

    backend = open_backend(args.zk_string)
    try:
        return _run_mode(args, topics, out, backend)
    finally:
        backend.close()


#: The modes that emit a plan, refused on a rack-blind backend.
PLAN_MODES = ("PRINT_REASSIGNMENT", "RANK_DECOMMISSION", "PRINT_FRESH_ASSIGNMENT")


def _run_mode(args, topics, out, backend) -> int:
    from .generator import (
        Degradation,
        build_rack_assignment,
        print_current_assignment,
        print_current_brokers,
        print_decommission_ranking,
        print_fresh_assignment,
        print_least_disruptive_reassignment,
        resolve_broker_ids,
        resolve_excluded_broker_ids,
    )
    from .utils.env import env_choice

    live_brokers = backend.brokers()
    broker_ids = resolve_broker_ids(
        live_brokers, args.integer_broker_ids, args.broker_hosts
    )
    excluded = resolve_excluded_broker_ids(live_brokers, args.broker_hosts_to_remove)
    rack_assignment = build_rack_assignment(live_brokers, args.disable_rack_awareness)
    if (args.mode in PLAN_MODES and getattr(backend, "rack_blind", False)
            and not args.disable_rack_awareness):
        # A backend that cannot report racks must not silently produce a
        # rack-unsafe plan (kafka_assigner_tpu/cli.py:262-279).
        print(
            "error: this metadata backend cannot supply broker rack info "
            "(confluent-kafka's AdminClient is rack-blind), so a "
            "rack-aware assignment cannot be guaranteed. Re-run with "
            "--disable_rack_awareness to explicitly opt out of rack "
            "diversity, or use the zk:// or file:// backend (or install "
            "kafka-python, whose AdminClient carries racks).",
            file=sys.stderr,
        )
        return EXIT_USAGE
    if args.mode == "PRINT_CURRENT_ASSIGNMENT":
        print_current_assignment(backend, topics, out=out)
        return EXIT_OK
    if args.mode == "PRINT_CURRENT_BROKERS":
        print_current_brokers(backend, out=out, live_brokers=live_brokers)
        return EXIT_OK
    if args.mode == "RANK_DECOMMISSION":
        _note_solver_ignored(args, "always the batched device sweep")
        # --broker_hosts_to_remove narrows the cluster first (rank the
        # remaining removals given those already gone); the selected
        # brokers are the candidates (kafka_assigner_tpu/cli.py:323-331).
        live = [b for b in live_brokers if b.id not in excluded]
        print_decommission_ranking(
            backend, topics, (broker_ids - excluded) or None,
            {k: v for k, v in rack_assignment.items() if k not in excluded},
            args.desired_replication_factor, device=args.device, out=out,
            live_brokers=live, scenario_file=args.scenario_file,
        )
        return EXIT_OK
    if args.mode == "PRINT_FRESH_ASSIGNMENT":
        if not topics or args.partition_count is None \
                or args.partition_count <= 0 \
                or args.desired_replication_factor <= 0:
            print(
                "error: PRINT_FRESH_ASSIGNMENT requires --topics, a "
                "positive --partition_count and a positive "
                "--desired_replication_factor",
                file=sys.stderr,
            )
            return EXIT_USAGE
        _note_solver_ignored(args, "always the device solver")
        # Target set: the selected brokers (or all live ones) minus the
        # excluded, as the reference's cli.py:305-313.
        target = (broker_ids or {b.id for b in live_brokers}) - excluded
        print_fresh_assignment(
            topics, args.partition_count, args.desired_replication_factor,
            [b for b in live_brokers if b.id in target],
            {k: v for k, v in rack_assignment.items() if k in target},
            device=args.device,
            out=out,
        )
        return EXIT_OK
    degradation = Degradation()
    print_least_disruptive_reassignment(
        backend,
        topics,
        broker_ids,
        excluded,
        rack_assignment,
        args.desired_replication_factor,
        device=args.device,
        out=out,
        live_brokers=live_brokers,
        context_file=args.leadership_context,
        solver=args.solver,
        failure_policy=args.failure_policy or env_choice("KA_FAILURE_POLICY"),
        degradation=degradation,
    )
    if degradation.any():
        # The plan on stdout is complete for what it covers; the exit code
        # tells this run from a clean one without parsing stderr.
        print(
            f"kafka-assigner: degraded success: "
            f"{len(degradation.topics_skipped)} topic(s) skipped, "
            f"{degradation.solve_fallbacks} solver fallback(s); "
            f"exiting {EXIT_DEGRADED}",
            file=sys.stderr,
        )
        return EXIT_DEGRADED
    return EXIT_OK


def run(argv: Optional[List[str]] = None, out=None) -> int:
    """:func:`run_tool` with the documented exit-code mapping."""
    from .errors import IngestError, SolveError
    from .io.zkwire import ZkWireError

    try:
        return run_tool(argv, out=out)
    except IngestError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_INGEST
    except SolveError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_SOLVE
    except BrokenPipeError:
        raise
    except (ZkWireError, OSError) as e:
        # Connect and read failures before mode 3 tags them (backend open,
        # the broker listing, the other modes' reads).
        print(f"error: metadata ingest failed: {e}", file=sys.stderr)
        return EXIT_INGEST
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_VALIDATION


def main() -> None:
    sys.exit(run())


def build_warm_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ka-warm-torch",
        description="Seed the port's library store (utils/programstore.py) "
        "so later processes start load-bound instead of build-bound: make "
        "the batched solve resident for a cluster snapshot's exact "
        "signature, or for an explicit synthetic bucket set.",
    )
    p.add_argument("--zk_string", default=None,
                   help="cluster to warm for: ZK quorum host:port pairs, "
                        "kafka://host:port or a file://cluster.json snapshot "
                        "(the store is seeded for this cluster's exact "
                        "signature)")
    p.add_argument("--topics", default=None,
                   help="comma-separated topic subset (default: all topics)")
    p.add_argument("--desired_replication_factor", type=int, default=-1,
                   help="RF override, like the generator flag; default "
                        "infers from the current assignment")
    p.add_argument("--buckets", default=None,
                   metavar="TOPICS,PARTITIONS,RF,BROKERS[,RACKS]",
                   help="warm a synthetic bucket set instead of a cluster, "
                        "e.g. 2048,128,3,5120,8; no metadata backend needed")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the device solver runs (default: cuda)")
    return p


def run_warm(argv: Optional[List[str]] = None) -> int:
    """``ka-warm``: build or load the libraries of the batched solve for a
    cluster (or an explicit bucket set) and make it resident once, so the
    next process finds the store seeded (the reference's
    ``kafka_assigner_tpu/cli.py:run_warm``). Exit 0 on success, 1 on a
    usage error or when nothing persisted; :func:`warm_main` maps ingest
    and validation errors."""
    from .models.problem import _pad8, encode_cluster, group_pads
    from .obs.trace import span
    from .solvers.warmup import warm_solver_programs

    parser = build_warm_parser()
    args = parser.parse_args(argv)
    _prebuild_native()

    if (args.buckets is None) == (args.zk_string is None):
        print("error: pass exactly one of --zk_string or --buckets",
              file=sys.stderr)
        parser.print_usage(sys.stderr)
        return EXIT_USAGE

    if args.buckets is not None:
        try:
            parts = [int(tok) for tok in args.buckets.split(",")]
            if len(parts) == 4:
                parts.append(8)
            n_topics, partitions, rf, brokers, racks = parts
            if min(n_topics, partitions, rf, brokers, racks) < 1:
                raise ValueError("all bucket fields must be positive")
        except ValueError as e:
            print(f"error: bad --buckets value {args.buckets!r}: {e}",
                  file=sys.stderr)
            return EXIT_USAGE
        rack_assignment = {i: f"r{i % racks}" for i in range(brokers)}
        cluster = encode_cluster(rack_assignment, set(range(brokers)))
        p_pad, width = _pad8(partitions), max(rf, 2)
    else:
        from .assigner import infer_topic_rf
        from .io.base import open_backend

        backend = open_backend(args.zk_string)
        try:
            live = backend.brokers()
            topic_list = (
                args.topics.split(",") if args.topics is not None
                else backend.all_topics()
            )
            initial = backend.partition_assignment(topic_list)
        finally:
            backend.close()
        rack_assignment = {b.id: b.rack for b in live if b.rack is not None}
        rfs = [
            infer_topic_rf(t, initial[t], args.desired_replication_factor)
            for t in topic_list
        ]
        rf = max((r for r in rfs if r > 0), default=2)
        n_topics = len(topic_list)
        cluster = encode_cluster(rack_assignment, {b.id for b in live})
        p_pad, width = group_pads([initial[t] for t in topic_list])

    with span("warmup"):
        outcomes = warm_solver_programs(
            cluster, n_topics, p_pad, width, rf, device=args.device
        )
    for name, outcome in sorted(outcomes.items()):
        print(f"ka-warm: {name}: {outcome}", file=sys.stderr)
    if not outcomes or "error" in outcomes.values():
        print("ka-warm: warm-up incomplete (see warnings above)",
              file=sys.stderr)
        return EXIT_USAGE
    if all(o == "jit" for o in outcomes.values()):
        # Built in this process only (the store is off): the next process
        # would still start cold, which defeats this tool.
        print(
            "ka-warm: programs compiled but NOTHING persisted — the store "
            "is disabled (KA_PROGRAM_STORE=0?) or the signature was "
            "rejected; the next process will still pay the cold compile",
            file=sys.stderr,
        )
        return EXIT_USAGE
    print(
        f"ka-warm: store seeded for {n_topics} topic(s), "
        f"p_pad={p_pad}, width={width}, rf={rf}, "
        f"n={cluster.n}", file=sys.stderr,
    )
    return EXIT_OK


def warm_main() -> None:
    """:func:`run_warm` with the documented exit codes
    (``python -m kafka_assigner_tpu_torch.warm``)."""
    from .io.zkwire import ZkWireError

    try:
        sys.exit(run_warm())
    except (ZkWireError, OSError) as e:
        print(f"error: metadata ingest failed: {e}", file=sys.stderr)
        sys.exit(EXIT_INGEST)
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(EXIT_VALIDATION)


def build_groups_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ka-groups-torch",
        description="Consumer-group packing: a sticky, movement-minimizing "
        "rebalance plan per group (plan), or the autoscale cost curve over "
        "every (consumer count x lag scale) candidate in one batched "
        "device call (sweep). Prints a schema-versioned JSON envelope, "
        "byte-stable across identical runs.",
    )
    p.add_argument("--zk_string", default=None,
                   help="ZK quorum host:port pairs, kafka://host:port or a "
                        "file://cluster.json snapshot (group state needs a "
                        "snapshot \"groups\" section or an AdminClient with "
                        "consumer-group offsets, else --synthetic)")
    p.add_argument("--mode", default="plan", choices=("plan", "sweep"),
                   help="plan: per-group packing plan; sweep: the batched "
                        "autoscale cost curve")
    p.add_argument("--group", default=None,
                   help="comma-separated group names (default: every group "
                        "the snapshot records)")
    p.add_argument("--synthetic", action="store_true",
                   help="explicit opt-in to the deterministic synthetic "
                        "group family (envelopes carry groups_real=false)")
    p.add_argument("--weight", default="lag", choices=("lag", "throughput"),
                   help="packing weight column: per-partition lag, or "
                        "produced-byte rate from the traffic section (the "
                        "synthetic series where it has none)")
    p.add_argument("--counts", default=None,
                   help="sweep candidate consumer counts, comma-separated "
                        "(default: 1..2x the current membership, capped by "
                        "KA_GROUPS_MAX_CANDIDATES)")
    p.add_argument("--scales", default=None,
                   help="sweep weight scales in percent, comma-separated "
                        "(default: the KA_GROUPS_DEFAULT_SCALES knob)")
    p.add_argument("--solver", default="device", choices=("device", "greedy"),
                   help="device: the packing program on --device; greedy: "
                        "the host packing oracle (the same plans)")
    p.add_argument("--failure-policy", dest="failure_policy", default=None,
                   choices=("strict", "best-effort"),
                   help="strict (default): a crashed device solve exits "
                        "with the solve code. best-effort: it falls back "
                        "to the host packing oracle (the same plan bytes) "
                        "and the run exits 6 (default: the "
                        "KA_FAILURE_POLICY knob)")
    _add_report_flag(p)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the device solver runs (default: cuda)")
    return p


def run_groups(argv: Optional[List[str]] = None) -> int:
    """``ka-groups``: open the backend, refuse one without groups
    unless ``--synthetic``, encode, pack, print the envelope. Raises the
    typed errors; :func:`groups_main` maps them to exit codes."""
    _prebuild_native()
    parser = build_groups_parser()
    args = parser.parse_args(argv)
    if args.zk_string is None:
        print("error: --zk_string is required", file=sys.stderr)
        parser.print_usage(sys.stderr)
        return EXIT_USAGE
    mode = "GROUPS_PLAN" if args.mode == "plan" else "GROUPS_SWEEP"
    return _captured(mode, args.report_json, argv, lambda: _dispatch_groups(args))


def _dispatch_groups(args) -> int:
    """Backend open, group ingest (or the loud refusal), backend close,
    encode, solve, the envelope and the ``groups.*`` counters."""
    import json

    from .groups.model import GROUPS_SCHEMA_VERSION
    from .groups.solve import (
        build_group_bodies,
        load_group_states,
        parse_int_list,
        subscribed_partitions,
        throughput_weights,
    )
    from .io.base import open_backend
    from .obs.metrics import counter_add
    from .utils.env import env_choice, env_float, env_int, env_str

    policy = args.failure_policy or env_choice("KA_FAILURE_POLICY")
    group_names = args.group.split(",") if args.group else None
    scales = parse_int_list(args.scales, env_str("KA_GROUPS_DEFAULT_SCALES"))
    counts = parse_int_list(args.counts)
    headroom = env_float("KA_GROUPS_CAPACITY_HEADROOM")
    max_cand = env_int("KA_GROUPS_MAX_CANDIDATES")

    backend = open_backend(args.zk_string)
    try:
        if not args.synthetic and not getattr(backend, "supports_groups",
                                              lambda: False)():
            # The loud refusal: synthetic inputs never pass for cluster
            # truth.
            counter_add("groups.refusals")
            print(
                "error: this metadata backend cannot read consumer "
                "groups (no group membership/offset surface), so a "
                "packing plan would be built on invented inputs. Re-run "
                "with --synthetic to explicitly opt into the "
                "deterministic synthetic family (marked "
                "groups_real=false), or use a snapshot with a \"groups\" "
                "section / an AdminClient with consumer-group offset "
                "support.",
                file=sys.stderr,
            )
            return EXIT_USAGE
        partitions = backend.partition_assignment(backend.all_topics())
        part_map = {t: sorted(per) for t, per in partitions.items()}
        states, groups_real = load_group_states(
            backend, part_map, groups=group_names, synthetic=args.synthetic,
        )
        if not states:
            raise ValueError("the backend reports no consumer groups")
        weight_values = (
            throughput_weights(backend, subscribed_partitions(states, part_map))
            if args.weight == "throughput" else None
        )
    finally:
        backend.close()
    bodies = build_group_bodies(
        states, groups_real, part_map, args.mode, args.weight,
        weight_values, scales, headroom, max_cand, counts=counts,
        solver=args.solver, device=args.device,
        fallback="greedy" if policy == "best-effort" else "raise",
    )
    degraded_any = False
    for body in bodies.values():
        if args.mode == "sweep":
            counter_add("groups.sweeps")
        else:
            counter_add("groups.plans")
            counter_add("groups.moves", body["moves"])
        if body["solver"] == "greedy-fallback":
            counter_add("groups.solve_fallbacks")
            degraded_any = True
    if len(bodies) == 1:
        payload = next(iter(bodies.values()))
    else:
        payload = {
            "schema_version": GROUPS_SCHEMA_VERSION,
            "kind": "groups-plan-set" if args.mode == "plan" else "groups-sweep-set",
            "groups_real": groups_real,
            "groups": bodies,
        }
    print(json.dumps(payload, indent=1, sort_keys=True))
    if degraded_any:
        print(
            "ka-groups: degraded success: device solve fell back to the "
            f"greedy packing oracle; exiting {EXIT_DEGRADED}",
            file=sys.stderr,
        )
        return EXIT_DEGRADED
    return EXIT_OK


def groups_main() -> None:
    """:func:`run_groups` with the documented exit codes."""
    from .errors import IngestError, SolveError
    from .io.zkwire import ZkWireError

    try:
        sys.exit(run_groups())
    except IngestError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(EXIT_INGEST)
    except SolveError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(EXIT_SOLVE)
    except (ZkWireError, OSError) as e:
        print(f"error: metadata ingest failed: {e}", file=sys.stderr)
        sys.exit(EXIT_INGEST)
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(EXIT_VALIDATION)


def build_execute_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ka-execute",
        description="Execute an emitted reassignment plan against the "
        "cluster: throttled waves, ISR-convergence polling between waves, "
        "a crash-safe journal (resume with --resume after a kill), and a "
        "byte-identical verify-after-move pass (exec/engine.py).",
    )
    p.add_argument("--zk_string", default=None,
                   help="cluster to execute against: ZK quorum host:port "
                        "pairs, or a file://cluster.json snapshot (hermetic "
                        "simulated-convergence mode)")
    p.add_argument("--plan", default=None, metavar="PATH",
                   help="plan JSON to execute — the NEW ASSIGNMENT payload "
                        "(a saved mode-3 stdout is accepted; the rollback "
                        "snapshot section is ignored)")
    p.add_argument("--journal", default=None, metavar="PATH",
                   help="crash-safe journal path (default: the "
                        "KA_EXEC_JOURNAL knob, else <plan>.journal)")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run from its journal's "
                        "last committed wave (refused when the journal "
                        "belongs to a different plan)")
    p.add_argument("--rollback", action="store_true",
                   help="execute the plan file's saved CURRENT ASSIGNMENT "
                        "snapshot instead of the NEW ASSIGNMENT payload — "
                        "drives the cluster BACK to its pre-reassignment "
                        "state through the same wave engine (throttled, "
                        "journaled at <plan>.rollback.journal by default, "
                        "verified after the moves)")
    p.add_argument("--wave-size", dest="wave_size", type=int, default=None,
                   help="partition moves per wave (default: the "
                        "KA_EXEC_WAVE_SIZE knob)")
    p.add_argument("--throttle", type=float, default=None,
                   help="seconds to pause between converged waves "
                        "(default: the KA_EXEC_THROTTLE knob)")
    p.add_argument("--failure-policy", dest="failure_policy", default=None,
                   choices=("strict", "best-effort"),
                   help="strict (default): halt resumably on the first "
                        "wave that fails to converge (exit 8). "
                        "best-effort: record unconverged moves as skipped "
                        "and keep going — the run exits with the "
                        "degraded-success code and the skips are listed in "
                        "the run report's plan section")
    p.add_argument("--report-json", dest="report_json", default=None,
                   metavar="PATH",
                   help="emit the schema-versioned run report (exec span "
                        "family, exec.* counters, wave-latency histogram) "
                        "to PATH")
    return p


def run_execute(argv: Optional[List[str]] = None) -> int:
    """``ka-execute``: drive a plan to convergence. Raises the typed errors;
    :func:`execute` maps them to exit codes. Returns 0, 6 (moves skipped
    under best-effort) or 7 (the cluster after the moves differs from the
    plan). The report's mode is ``EXECUTE_REASSIGNMENT`` or
    ``ROLLBACK_REASSIGNMENT``."""
    parser = build_execute_parser()
    args = parser.parse_args(argv)
    if args.zk_string is None or args.plan is None:
        print("error: --zk_string and --plan are required", file=sys.stderr)
        parser.print_usage(sys.stderr)
        return EXIT_USAGE
    mode = (
        "ROLLBACK_REASSIGNMENT" if args.rollback else "EXECUTE_REASSIGNMENT"
    )
    return _captured(mode, args.report_json, argv,
                     lambda: _dispatch_execute(args))


def _dispatch_execute(args) -> int:
    """Plan load, backend open, the engine's run, the exit code."""
    from .exec.engine import PlanExecutor, load_plan_file
    from .io.base import open_backend
    from .utils.env import env_choice, env_str

    plan, topic_order = load_plan_file(
        args.plan, section="current" if args.rollback else "new"
    )
    # A rollback is another plan (other canonical bytes, another journal
    # identity): every default journal source, the plan-derived path and
    # the KA_EXEC_JOURNAL knob, gets a rollback name, so a forward run's
    # journal is never refused or overwritten. Only --journal is taken as
    # given.
    if args.journal:
        journal_path = args.journal
    else:
        env_journal = env_str("KA_EXEC_JOURNAL")
        if env_journal:
            journal_path = env_journal + (
                ".rollback" if args.rollback else ""
            )
        else:
            journal_path = args.plan + (
                ".rollback.journal" if args.rollback else ".journal"
            )
    policy = args.failure_policy or env_choice("KA_FAILURE_POLICY")
    backend = open_backend(args.zk_string)
    try:
        executor = PlanExecutor(
            backend, plan, topic_order, journal_path,
            failure_policy=policy, resume=args.resume,
            wave_size=args.wave_size, throttle=args.throttle,
            # The journal's identity is (cluster, plan sha): the same plan
            # bytes on another cluster never cross-resume.
            cluster=args.zk_string,
        )
        outcome = executor.execute()
    finally:
        backend.close()
    n_moves = outcome.moves_submitted
    print(
        f"ka-execute: {outcome.waves_run}/{outcome.waves_total} wave(s) "
        f"run ({n_moves} move(s) submitted, {outcome.noops} already in "
        f"place{', resumed' if outcome.resumed else ''})",
        file=sys.stderr,
    )
    if outcome.mismatches:
        for m in outcome.mismatches[:10]:
            print(
                f"ka-execute: VERIFY MISMATCH [{m['kind']}] "
                f"{m['topic']!r}/{m['partition']}: expected "
                f"{m['expected']}, observed {m['observed']}",
                file=sys.stderr,
            )
        extra = len(outcome.mismatches) - 10
        if extra > 0:
            print(f"ka-execute: ... and {extra} more mismatch(es)",
                  file=sys.stderr)
        print(
            f"ka-execute: verify-after-move FAILED "
            f"({len(outcome.mismatches)} mismatch(es)); exiting "
            f"{EXIT_VERIFY}",
            file=sys.stderr,
        )
        return EXIT_VERIFY
    if outcome.skipped:
        print(
            f"ka-execute: degraded success: {len(set(outcome.skipped))} "
            f"move(s) skipped under best-effort; exiting {EXIT_DEGRADED}",
            file=sys.stderr,
        )
        return EXIT_DEGRADED
    print("ka-execute: verify-after-move OK: cluster state is "
          "byte-identical to the plan", file=sys.stderr)
    return EXIT_OK


def execute(argv: Optional[List[str]] = None) -> int:
    """:func:`run_execute` with the exit-code mapping. Anything else,
    the injected wave-boundary kill included, propagates with its
    traceback."""
    from .errors import ExecuteError, IngestError
    from .io.zkwire import ZkWireError

    try:
        return run_execute(argv)
    except ExecuteError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_EXECUTE
    except IngestError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_INGEST
    except BrokenPipeError:
        raise
    except (ZkWireError, OSError) as e:
        print(f"error: metadata ingest failed: {e}", file=sys.stderr)
        return EXIT_INGEST
    except (ValueError, KeyError) as e:
        # JournalError (a corrupt or mismatched journal) and plan-file
        # validation failures among them.
        print(f"error: {e}", file=sys.stderr)
        return EXIT_VALIDATION


def execute_main() -> None:
    """``python -m kafka_assigner_tpu_torch.exec``: :func:`execute`."""
    sys.exit(execute())


def build_daemon_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ka-daemon-torch",
        description="Resident assigner daemon (daemon/): keeps the ZooKeeper "
        "sessions, the loaded libraries and the CUDA context, and the encoded "
        "cluster state in memory, keeps them fresh through ZooKeeper watches "
        "with incremental re-encode, and serves /plan, /whatif, /execute, "
        "/recommendations, /groups/plan, /groups/sweep, /healthz, /readyz, "
        "/state, /controller, /metrics and /debug/flight over HTTP, for one "
        "cluster (--zk_string) or many (--clusters, routed by "
        "/clusters/<name>/...), with an optional closed-loop rebalance "
        "controller per cluster. SIGTERM drains and exits 0.",
    )
    p.add_argument("--zk_string", default=None,
                   help="the cluster to serve: ZooKeeper host:port pairs, or a "
                        "file://cluster.json snapshot (watchless; interval "
                        "resyncs only)")
    p.add_argument("--clusters", default=None, metavar="SPEC",
                   help="serve several clusters from one daemon: "
                        "semicolon-separated name=connect pairs (connect "
                        "strings may hold commas), e.g. "
                        "'west=zk1:2181,zk2:2181;east=file://east.json', or "
                        "a path to a JSON file mapping names to connect "
                        "strings. Append '#controller=off|observe|auto' to an "
                        "entry (or use the object form {\"connect\": ..., "
                        "\"controller\": ...}) to override the KA_CONTROLLER "
                        "policy of that cluster. "
                        "Each cluster has its own session, watch loop, cache, "
                        "inflight gate, watchdog and breaker. Exclusive with "
                        "--zk_string")
    p.add_argument("--solver", default="device", choices=SOLVER_NAMES,
                   help="default solver of served /plan requests (a request's "
                        "'solver' overrides)")
    p.add_argument("--failure-policy", dest="failure_policy", default=None,
                   choices=("strict", "best-effort"),
                   help="default failure policy of served requests (default: "
                        "the KA_FAILURE_POLICY knob)")
    p.add_argument("--bind", default=None,
                   help="bind address (default: the KA_DAEMON_BIND knob, "
                        "loopback)")
    p.add_argument("--port", type=int, default=None,
                   help="listen port (default: the KA_DAEMON_PORT knob; 0 = "
                        "ephemeral, announced on stderr)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the device solver, the what-if sweep and the "
                        "group packing run (default: cuda)")
    p.add_argument("--access-log", dest="access_log", default=None,
                   metavar="PATH",
                   help="NDJSON access log: one line a served request with its "
                        "request id, path, cluster, HTTP code, status, latency "
                        "and stale/degraded markers (default: the "
                        "KA_OBS_ACCESS_LOG knob, else stderr)")
    return p


def parse_clusters_spec(spec: str) -> dict:
    """The ``--clusters`` value: a ``*.json`` or ``file://`` path to a
    ``{name: connect}`` object (a value may be ``{"connect": ...,
    "controller": ...}``), or inline semicolon-separated ``name=connect``
    pairs (connect strings keep their commas)."""
    import json as json_mod

    # Inline entries always hold '='; a bare path never does.
    if "=" not in spec and (spec.startswith("file://") or spec.endswith(".json")):
        path = spec[len("file://"):] if spec.startswith("file://") else spec
        with open(path, "r", encoding="utf-8") as f:
            raw = json_mod.load(f)
        if not isinstance(raw, dict) or not raw or not all(
            isinstance(k, str) and isinstance(v, (str, dict))
            for k, v in raw.items()
        ):
            raise ValueError(
                f"--clusters file {path!r} must be a non-empty JSON "
                "object mapping cluster names to connect strings (or "
                "{\"connect\": ..., \"controller\": ...} objects)"
            )
        return dict(raw)
    clusters = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, eq, connect = entry.partition("=")
        name, connect = name.strip(), connect.strip()
        if not eq or not name or not connect:
            raise ValueError(
                f"--clusters entry {entry!r} is not of the form name=connect"
            )
        if name in clusters:
            raise ValueError(f"--clusters names {name!r} twice")
        clusters[name] = connect
    if not clusters:
        raise ValueError("--clusters names no clusters")
    return clusters


def run_daemon(argv: Optional[List[str]] = None) -> int:
    """``ka-daemon``: start the resident daemon and serve until signaled.
    Exit 0 after a clean SIGTERM or SIGINT drain; 1 on a usage error or a
    ``cuda`` daemon without a card; a failed initial sync of a single-cluster
    daemon maps to the ingest code, and a refused cluster spec to the
    validation code, through :func:`daemon_main`. The device check, the library build
    and the solver's fail-fast are the daemon's own
    (:class:`~.daemon.service.AssignerDaemon`)."""
    from .daemon.service import AssignerDaemon, run_daemon_process

    parser = build_daemon_parser()
    args = parser.parse_args(argv)
    if (args.zk_string is None) == (args.clusters is None):
        print("error: pass exactly one of --zk_string or --clusters",
              file=sys.stderr)
        parser.print_usage(sys.stderr)
        return EXIT_USAGE
    clusters = None
    if args.clusters is not None:
        try:
            clusters = parse_clusters_spec(args.clusters)
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            parser.print_usage(sys.stderr)
            return EXIT_USAGE
    try:
        daemon = AssignerDaemon(
            args.zk_string,
            clusters=clusters,
            solver=args.solver,
            device=args.device,
            failure_policy=args.failure_policy,
            bind=args.bind,
            port=args.port,
            access_log=args.access_log,
        )
    except RuntimeError as e:  # a cuda daemon without a card
        print(f"error: {e}", file=sys.stderr)
        return EXIT_USAGE
    return run_daemon_process(daemon)


def daemon_main() -> None:
    """``python -m kafka_assigner_tpu_torch.daemon``: :func:`run_daemon`
    with the exit-code mapping."""
    from .errors import IngestError
    from .io.zkwire import ZkWireError

    try:
        sys.exit(run_daemon())
    except IngestError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(EXIT_INGEST)
    except (ZkWireError, OSError) as e:
        print(f"error: metadata ingest failed: {e}", file=sys.stderr)
        sys.exit(EXIT_INGEST)
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(EXIT_VALIDATION)


if __name__ == "__main__":
    main()
