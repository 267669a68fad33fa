"""The machine-readable run report: one stable, versioned JSON artifact —
the port of the reference's ``kafka_assigner_tpu/obs/report.py``. The
schema version and the tool name are the reference's, so the reference's
checked-in fixture (``tests/golden/run_report_v1.json``) validates here
too, and a port report can be read by whatever reads the reference's.

Schema v1 (all keys always present)::

    {
      "schema_version": 1,
      "tool": "kafka-assignment-generator",
      "status": "ok" | "degraded" | "error",   # degraded: best-effort run
                                               # that skipped/fell back
      "mode": "<CLI mode or null>",
      "argv": [...],                  # CLI argv (no env values: no secrets)
      "spans": [{"name","path","parent","depth","ms","status"}, ...],
      "metrics": {"counters": {...}, "gauges": {...}, "histograms": {...}},
      "plan": {"moves": n, "leader_churn": n, ...}   # plan.* gauges lifted
    }

Optional keys: ``error`` ({"type","message"}, only when status is error),
``spans_dropped`` (only when the span cap overflowed). A span's ``status``
is ``ok``, ``error`` (an exception unwound through it), or ``open`` (the
process died before the span exited).

The emitter also prints a short human summary on stderr; stdout stays
reserved for payload JSON. ``python -m kafka_assigner_tpu_torch.obs.report
--check-fixture PATH`` validates a report file.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import List, Optional, Sequence

from .trace import RunCollector

REPORT_SCHEMA_VERSION = 1

TOOL_NAME = "kafka-assignment-generator"

#: Top-level keys every report carries, in every version-1 emission.
REQUIRED_KEYS = (
    "schema_version", "tool", "status", "mode", "argv", "spans", "metrics",
    "plan",
)
SPAN_KEYS = ("name", "path", "parent", "depth", "ms", "status")
METRIC_KEYS = ("counters", "gauges", "histograms")


def build_report(
    run: RunCollector,
    *,
    status: str = "ok",
    mode: Optional[str] = None,
    argv: Optional[Sequence[str]] = None,
    error: Optional[BaseException] = None,
) -> dict:
    """Assemble the schema-v1 report dict from a finished (or failed)
    capture. ``plan`` is the ``plan.*`` gauge namespace lifted to a section
    of its own, so consumers read ``.plan.moves`` without knowing the
    metric registry's naming."""
    gauges = dict(run.gauges)
    plan = {
        k.split(".", 1)[1]: v for k, v in gauges.items()
        if k.startswith("plan.")
    }
    report = {
        "schema_version": REPORT_SCHEMA_VERSION,
        "tool": TOOL_NAME,
        "status": status,
        "mode": mode,
        "argv": list(argv) if argv is not None else [],
        "spans": [dict(rec) for rec in run.spans],
        "metrics": {
            "counters": dict(run.counters),
            "gauges": gauges,
            "histograms": {k: dict(v) for k, v in run.hists.items()},
        },
        "plan": plan,
    }
    if run.spans_dropped:
        report["spans_dropped"] = run.spans_dropped
    if error is not None:
        report["error"] = {
            "type": type(error).__name__,
            "message": str(error),
        }
    return report


def _summary_lines(report: dict) -> List[str]:
    """The stderr human summary: status, top-level span timings, headline
    plan/metric facts. Short and stable — the JSON is the real artifact."""
    spans = report["spans"]
    top = [i for i, s in enumerate(spans) if s["depth"] == 0]
    lines = [
        f"obs: run {report['status']}"
        + (f" mode={report['mode']}" if report["mode"] else "")
        + f" spans={len(spans)}"
        + (f" (+{report['spans_dropped']} dropped)"
           if report.get("spans_dropped") else "")
    ]
    if report.get("error"):
        err = report["error"]
        lines.append(f"obs: error {err['type']}: {err['message']}")
    for i in top:
        s = spans[i]
        kids = [c for c in spans if c["parent"] == i]
        detail = " ".join(f"{c['name']}={c['ms']}ms" for c in kids[:6])
        lines.append(
            f"obs:   {s['path']} {s['ms']}ms [{s['status']}]"
            + (f" ({detail})" if detail else "")
        )
    plan = report["plan"]
    if plan:
        facts = " ".join(f"{k}={plan[k]}" for k in sorted(plan))
        lines.append(f"obs:   plan {facts}")
    return lines


def emit_report(
    report: dict, path: Optional[str] = None, err=None
) -> Optional[str]:
    """Write the JSON artifact (when ``path`` is given) and print the human
    summary on stderr. Returns the path written, or None.

    Emission must never mask the run's own outcome: a failing write (bad
    directory, full disk) is reported on stderr and swallowed — the solve's
    stdout payload and exit status always win.
    """
    err = err if err is not None else sys.stderr
    text = json.dumps(report, indent=2, sort_keys=True)
    written = None
    if path:
        try:
            with open(path, "w", encoding="utf-8") as f:
                f.write(text + "\n")
            written = path
        except OSError as e:
            print(f"obs: could not write report {path!r}: {e}", file=err)
    for line in _summary_lines(report):
        print(line, file=err)
    if written:
        print(f"obs: report written: {written}", file=err)
    return written


class AccessLog:
    """A structured NDJSON access log: exactly one JSON line per served
    request, to ``path`` (append mode — restarts extend, never clobber) or
    stderr when unset.

    Line schema (sorted keys; consumers should tolerate additions)::

        {"ts": epoch_s, "request_id": "...", "method": "POST",
         "path": "/plan", "cluster": "west" | null, "code": 200,
         "status": "ok" | "degraded" | "error" | null,
         "ms": 12.3, "inflight": 1, "stale": false, "degraded": false}

    ``status`` is the request's run-report status (null for GET probes),
    ``inflight`` the owning cluster's admitted-request depth at completion,
    ``stale``/``degraded`` the staleness/degradation markers a dashboards
    alert on without parsing the envelope. Thread-safe (one lock, one
    line-buffered stream); a failing write is reported once on stderr and
    the log disables itself — telemetry must never take down the serving
    path it is describing.
    """

    def __init__(self, path: Optional[str] = None, err=None) -> None:
        self._err = err if err is not None else sys.stderr
        self._lock = threading.Lock()
        self._path = path
        self._fh = None
        self._size = 0
        self._dead = False
        self._rollover_dead = False
        if path:
            try:
                self._fh = open(path, "a", encoding="utf-8")
                self._size = self._fh.tell()  # restart: resume the cap count
            except OSError as e:
                print(
                    f"obs: could not open access log {path!r}: {e}; "
                    "falling back to stderr",
                    file=self._err,
                )

    def log(self, **fields) -> None:
        if self._dead:
            return
        fields.setdefault("ts", round(time.time(), 3))
        line = json.dumps(fields, sort_keys=True, default=str)
        with self._lock:
            try:
                stream = self._fh if self._fh is not None else self._err
                stream.write(line + "\n")
                stream.flush()
            except (OSError, ValueError) as e:
                self._dead = True
                print(
                    f"obs: access log write failed ({e}); access logging "
                    "disabled for this process",
                    file=self._err,
                )
                return
            if self._fh is not None:
                self._size += len(line.encode("utf-8")) + 1
                self._maybe_rollover()

    def _maybe_rollover(self) -> None:
        """Size-capped rollover, under the log lock:
        once the file reaches ``KA_OBS_ACCESS_LOG_MAX_MB`` (live-read per
        write; 0 = unbounded, the historical behavior) the current file is
        renamed to ``<path>.1`` — atomically replacing any previous ``.1``,
        so disk stays bounded at ~2x the cap — and a fresh file reopened.
        The rename happens FIRST, with the handle still open (the open fd
        follows the inode), so a failing rename leaves appending fully
        intact with no close/reopen churn; that failure is reported ONCE
        and disables further rollover attempts for this process — a
        persistently unwritable ``.1`` must not cost a stderr line and two
        syscalls per served request forever."""
        import os

        from ..utils.env import env_int

        if self._rollover_dead:
            return
        cap_mb = env_int("KA_OBS_ACCESS_LOG_MAX_MB")
        if not cap_mb or self._size < cap_mb * 1024 * 1024:
            return
        try:
            os.replace(self._path, self._path + ".1")
        except OSError as e:
            self._rollover_dead = True
            print(
                f"obs: access log rollover failed for {self._path!r} "
                f"({e}); rollover disabled for this process, continuing "
                "to append",
                file=self._err,
            )
            return
        try:
            fresh = open(self._path, "a", encoding="utf-8")
        except OSError as e:
            # The old handle still points at the renamed .1 file: keep
            # appending there (no line is ever lost), loudly, once.
            self._rollover_dead = True
            print(
                f"obs: could not reopen access log {self._path!r} after "
                f"rollover ({e}); rollover disabled, appending to the "
                "rolled file",
                file=self._err,
            )
            return
        try:
            self._fh.close()
        except OSError as e:
            print(f"obs: access log close failed ({e})", file=self._err)
        self._fh = fresh
        self._size = fresh.tell()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError as e:
                    print(
                        f"obs: access log close failed ({e})",
                        file=self._err,
                    )
                self._fh = None


def validate_report(obj) -> List[str]:
    """Structural schema check; the empty list means valid. Used by the lint
    gate on the checked-in fixture and by tests on live emissions."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return ["report is not a JSON object"]
    for key in REQUIRED_KEYS:
        if key not in obj:
            problems.append(f"missing required key {key!r}")
    if obj.get("schema_version") != REPORT_SCHEMA_VERSION:
        problems.append(
            f"schema_version {obj.get('schema_version')!r} != emitter's "
            f"{REPORT_SCHEMA_VERSION} (bump = regenerate the fixture)"
        )
    if obj.get("status") not in ("ok", "degraded", "error"):
        problems.append(
            f"status {obj.get('status')!r} not in (ok, degraded, error)"
        )
    spans = obj.get("spans")
    if not isinstance(spans, list):
        problems.append("spans is not a list")
    else:
        for i, s in enumerate(spans):
            for key in SPAN_KEYS:
                if not isinstance(s, dict) or key not in s:
                    problems.append(f"span[{i}] missing key {key!r}")
                    break
    metrics = obj.get("metrics")
    if not isinstance(metrics, dict):
        problems.append("metrics is not an object")
    else:
        for key in METRIC_KEYS:
            if not isinstance(metrics.get(key), dict):
                problems.append(f"metrics.{key} missing or not an object")
    if obj.get("status") == "error" and "error" in obj:
        e = obj["error"]
        if not (isinstance(e, dict) and "type" in e and "message" in e):
            problems.append("error section must carry type and message")
    return problems


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="obs.report",
        description="validate run-report artifacts against the emitter's "
        "declared schema version",
    )
    parser.add_argument(
        "--check-fixture", metavar="PATH", required=True,
        help="report JSON to validate (exit 1 on schema drift)",
    )
    args = parser.parse_args(argv)
    try:
        with open(args.check_fixture, "r", encoding="utf-8") as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        print(f"obs.report: cannot load {args.check_fixture}: {e}",
              file=sys.stderr)
        return 1
    problems = validate_report(obj)
    for p in problems:
        print(f"obs.report: {args.check_fixture}: {p}", file=sys.stderr)
    if not problems:
        print(
            f"obs.report: {args.check_fixture} valid "
            f"(schema v{REPORT_SCHEMA_VERSION})",
            file=sys.stderr,
        )
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
