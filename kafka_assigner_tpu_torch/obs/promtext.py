"""Prometheus text exposition (version 0.0.4) of the cumulative registry,
the port of the reference's ``kafka_assigner_tpu/obs/promtext.py`` with the
same family names, escaping and ``ka_`` prefix.

The daemon's ``/metrics`` endpoint renders the process-lifetime registry
(``obs/metrics.py:CumulativeMetrics``) through :func:`render`: dotted
registry names become ``ka_``-prefixed snake_case families (counters gain
the conventional ``_total`` suffix), the ``@cluster`` suffix of the
multi-cluster daemon's metric names becomes a ``cluster`` label, and each
histogram renders as the standard cumulative ``_bucket{le=...}`` series
plus ``_sum``/``_count``. The ``KA_OBS_HIST_EDGES`` bucket edges are the
``le`` thresholds, so one knob shapes the run report and the scrape.

:func:`parse` is the matching reader: it decodes an exposition back into
``{family: {"type": ..., "samples": [(name, labels, value), ...]}}``, and
:func:`check_histogram` checks one histogram family's buckets, sum and
count. Pure text in, text out: no sockets, no globals.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

#: Every family this module emits carries this prefix: one namespace for
#: the whole tool, so a shared Prometheus never collides with other jobs.
PREFIX = "ka_"

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def family_name(name: str) -> str:
    """Registry name → Prometheus family name: dots (and anything else
    outside the legal charset) become underscores, under the shared
    :data:`PREFIX`. ``daemon.reencode.topics`` → ``ka_daemon_reencode_topics``."""
    return PREFIX + _SANITIZE.sub("_", name)


def _escape(value: str) -> str:
    return (
        str(value).replace("\\", "\\\\").replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _labels_text(labels: Tuple[Tuple[str, str], ...],
                 extra: Optional[List[Tuple[str, str]]] = None) -> str:
    pairs = list(labels) + list(extra or [])
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(pairs))
    return "{" + body + "}"


def _fmt(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render(snapshot: dict, *, extra_gauges: Optional[dict] = None,
           info: Optional[dict] = None) -> str:
    """The full exposition for one registry snapshot
    (``CumulativeMetrics.snapshot()``): counters, gauges, histograms, plus
    ``extra_gauges`` (``{name: value}`` process gauges the service layer
    computes, e.g. uptime) and an ``info`` dict rendered as the
    conventional ``ka_build_info{...} 1`` gauge."""
    lines: List[str] = []

    def family(name: str, ftype: str, help_text: str) -> str:
        fam = family_name(name)
        lines.append(f"# HELP {fam} {help_text}")
        lines.append(f"# TYPE {fam} {ftype}")
        return fam

    if info is not None:
        fam = PREFIX + "build_info"
        lines.append(
            f"# HELP {fam} Build/process identity of this ka-daemon."
        )
        lines.append(f"# TYPE {fam} gauge")
        labels = tuple((k, str(v)) for k, v in sorted(info.items()))
        lines.append(f"{fam}{_labels_text(labels)} 1")
    for name, value in sorted((extra_gauges or {}).items()):
        fam = family(name, "gauge", f"Process gauge {name}.")
        lines.append(f"{fam} {_fmt(value)}")
    for name in sorted(snapshot["counters"]):
        fam = family(
            name + "_total", "counter",
            f"Cumulative daemon-lifetime total of {name}.",
        )
        for labels, value in sorted(snapshot["counters"][name].items()):
            lines.append(f"{fam}{_labels_text(labels)} {_fmt(value)}")
    for name in sorted(snapshot["gauges"]):
        fam = family(name, "gauge", f"Last observed value of {name}.")
        for labels, value in sorted(snapshot["gauges"][name].items()):
            lines.append(f"{fam}{_labels_text(labels)} {_fmt(value)}")
    for name in sorted(snapshot["hists"]):
        fam = family(
            name, "histogram",
            f"Daemon-lifetime distribution of {name} "
            "(KA_OBS_HIST_EDGES buckets).",
        )
        for labels, h in sorted(snapshot["hists"][name].items()):
            cum = 0
            for edge, count in zip(h["edges"], h["counts"]):
                cum += count
                lines.append(
                    f"{fam}_bucket"
                    f"{_labels_text(labels, [('le', _fmt(edge))])} {cum}"
                )
            lines.append(
                f"{fam}_bucket{_labels_text(labels, [('le', '+Inf')])} "
                f"{h['count']}"
            )
            lines.append(
                f"{fam}_sum{_labels_text(labels)} {_fmt(h['sum'])}"
            )
            lines.append(
                f"{fam}_count{_labels_text(labels)} {h['count']}"
            )
    return "\n".join(lines) + "\n"


class PromParseError(ValueError):
    """The exposition text does not parse."""


def _unescape(value: str) -> str:
    """Left-to-right escape decoding. A chained ``str.replace`` is WRONG
    here: for a literal backslash followed by ``n`` the renderer emits
    ``\\\\n`` (escaped backslash, then a real ``n``), and replacing
    ``\\n`` first would eat the second backslash and fabricate a newline
    Unknown escapes pass through verbatim, matching Prometheus's reader."""
    if "\\" not in value:
        return value
    out: List[str] = []
    i = 0
    n = len(value)
    while i < n:
        c = value[i]
        if c == "\\" and i + 1 < n:
            nxt = value[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ("\\", '"'):
                out.append(nxt)
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def parse(text: str) -> Dict[str, dict]:
    """Decode an exposition into ``{family: {"type": str, "samples":
    [({label: value}, float), ...]}}``. Strict about what :func:`render`
    promises: legal names, parsable label bodies, float values, and no
    sample before its family's ``# TYPE`` line (an untyped sample fails)."""
    families: Dict[str, dict] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                fam, ftype = parts[2], parts[3] if len(parts) > 3 else ""
                if not _NAME_OK.match(fam):
                    raise PromParseError(
                        f"line {lineno}: illegal family name {fam!r}"
                    )
                if ftype not in ("counter", "gauge", "histogram",
                                 "summary", "untyped"):
                    raise PromParseError(
                        f"line {lineno}: unknown type {ftype!r}"
                    )
                families.setdefault(fam, {"type": ftype, "samples": []})
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise PromParseError(f"line {lineno}: unparsable sample {line!r}")
        name, label_body, value_s = m.groups()
        labels: Dict[str, str] = {}
        if label_body:
            # Strict sequential walk: every label must match AT the cursor
            # and be comma-separated — junk between labels or a dropped
            # comma is a parse error, exactly as Prometheus treats it.
            pos = 0
            body = label_body.strip()
            while pos < len(body):
                lm = _LABEL_RE.match(body, pos)
                if not lm:
                    raise PromParseError(
                        f"line {lineno}: unparsable label body "
                        f"{label_body!r}"
                    )
                labels[lm.group(1)] = _unescape(lm.group(2))
                pos = lm.end()
                if pos < len(body):
                    if body[pos] != ",":
                        raise PromParseError(
                            f"line {lineno}: labels not comma-separated "
                            f"in {label_body!r}"
                        )
                    pos += 1  # past the comma (a trailing one is legal)
        try:
            value = (
                math.inf if value_s == "+Inf"
                else -math.inf if value_s == "-Inf"
                else float(value_s)
            )
        except ValueError:
            raise PromParseError(
                f"line {lineno}: unparsable value {value_s!r}"
            ) from None
        # A histogram's _bucket/_sum/_count samples belong to the family
        # that declared the TYPE; everything else must be declared too.
        owner = None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in families:
                owner = name[: -len(suffix)]
                break
        if owner is None:
            if name not in families:
                raise PromParseError(
                    f"line {lineno}: sample {name!r} before any # TYPE "
                    "declaration"
                )
            owner = name
        families[owner]["samples"].append((name, labels, value))
    return families


def check_histogram(family: dict) -> List[str]:
    """Consistency findings for one parsed histogram family (empty =
    consistent): bucket counts must be monotone nondecreasing in ``le``,
    the ``+Inf`` bucket must equal ``_count``, and ``_sum`` must be a
    finite number (0 observations ⇒ 0 sum)."""
    problems: List[str] = []
    series: Dict[Tuple[Tuple[str, str], ...], dict] = {}
    for name, labels, value in family["samples"]:
        key = tuple(sorted(
            (k, v) for k, v in labels.items() if k != "le"
        ))
        slot = series.setdefault(key, {"buckets": [], "sum": None,
                                       "count": None})
        if name.endswith("_bucket"):
            le = labels.get("le")
            if le is None:
                slot["buckets"].append((None, value))  # flagged below
                continue
            try:
                slot["buckets"].append(
                    (math.inf if le == "+Inf" else float(le), value)
                )
            except ValueError:
                slot["buckets"].append((None, value))
        elif name.endswith("_sum"):
            slot["sum"] = value
        elif name.endswith("_count"):
            slot["count"] = value
    for key, slot in series.items():
        tag = dict(key) or "(no labels)"
        bad_le = [c for le, c in slot["buckets"] if le is None]
        if bad_le:
            problems.append(
                f"{tag}: bucket sample(s) with missing/unparsable le label"
            )
        buckets = sorted(
            (le, c) for le, c in slot["buckets"] if le is not None
        )
        counts = [c for _, c in buckets]
        if counts != sorted(counts):
            problems.append(f"{tag}: bucket counts not monotone: {buckets}")
        if not buckets or buckets[-1][0] != math.inf:
            problems.append(f"{tag}: missing +Inf bucket")
        elif slot["count"] is None or buckets[-1][1] != slot["count"]:
            problems.append(
                f"{tag}: +Inf bucket {buckets[-1][1]} != _count "
                f"{slot['count']}"
            )
        if slot["sum"] is None or not math.isfinite(slot["sum"]):
            problems.append(f"{tag}: missing or non-finite _sum")
        if slot["count"] == 0 and slot["sum"] not in (0, 0.0):
            problems.append(f"{tag}: zero observations but sum {slot['sum']}")
    return problems
