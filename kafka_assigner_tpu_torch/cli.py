"""The port's CLI, every mode of the reference CLI::

    python -m kafka_assigner_tpu_torch.cli --zk_string file://cluster.json \
        --mode PRINT_REASSIGNMENT [--topics a,b] [--integer_broker_ids 1,2 |
        --broker_hosts h1,h2] [--broker_hosts_to_remove h3]
        [--desired_replication_factor N] [--disable_rack_awareness]
        [--leadership_context PATH] [--device {cuda,cpu}]

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

The flags are the reference CLI's flags for these modes
(``kafka_assigner_tpu/cli.py:83-118``); ``--device`` takes the place of
``--solver``. RANK_DECOMMISSION ranks each candidate broker's removal (all
live brokers by default), or each removal set of a ``--scenario_file``, in
one sweep; the two current-state modes run on the host. Stdout is
byte-identical to ``kafka_assigner_tpu.cli`` (``--solver tpu`` for the plan
modes). Exit codes follow the reference's documented ones: 1 usage, 3
metadata ingest, 5 validation (RF bounds, unknown hosts or scenario
entries, infeasible plan).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

EXIT_OK = 0
EXIT_USAGE = 1
EXIT_INGEST = 3
EXIT_VALIDATION = 5

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
                   help="a file://cluster.json snapshot")
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
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the solve runs (default: cuda)")
    return p


def run_tool(argv: Optional[List[str]] = None, out=None) -> int:
    """Parse, validate, load the snapshot, run the mode. Raises the typed
    errors (``ValueError``, ``KeyError``, ``OSError``); :func:`run` maps
    them to exit codes."""
    from .generator import (
        build_rack_assignment,
        print_current_assignment,
        print_current_brokers,
        print_decommission_ranking,
        print_fresh_assignment,
        print_least_disruptive_reassignment,
        resolve_broker_ids,
        resolve_excluded_broker_ids,
    )
    from .io.snapshot import open_snapshot

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
    backend = open_snapshot(args.zk_string)
    live_brokers = backend.brokers()
    broker_ids = resolve_broker_ids(
        live_brokers, args.integer_broker_ids, args.broker_hosts
    )
    excluded = resolve_excluded_broker_ids(live_brokers, args.broker_hosts_to_remove)
    rack_assignment = build_rack_assignment(live_brokers, args.disable_rack_awareness)
    if args.mode == "PRINT_CURRENT_ASSIGNMENT":
        print_current_assignment(backend, topics, out=out)
        return EXIT_OK
    if args.mode == "PRINT_CURRENT_BROKERS":
        print_current_brokers(backend, out=out, live_brokers=live_brokers)
        return EXIT_OK
    if args.mode == "RANK_DECOMMISSION":
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
    )
    return EXIT_OK


def run(argv: Optional[List[str]] = None) -> int:
    """:func:`run_tool` with the documented exit-code mapping."""
    try:
        return run_tool(argv)
    except BrokenPipeError:
        raise
    except OSError as e:
        print(f"error: metadata ingest failed: {e}", file=sys.stderr)
        return EXIT_INGEST
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_VALIDATION


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
