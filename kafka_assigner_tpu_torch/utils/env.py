"""The ``KA_*`` knobs this package reads, with the reference's names,
defaults and house rule (``kafka_assigner_tpu/utils/env.py``): a mis-set
knob never silently changes the configuration — an unparsable or unknown
value is ignored LOUDLY on stderr and the declared default is used.

Only the knobs of the ported placement, solver and what-if paths are
declared, each with the reference's default and floor. ``KA_QUOTA_WAVE_TARGET``
and ``KA_QUOTA_ENDGAME`` tune the giant-shape quota leg
(``ops/assignment.py:_hybrid_quota_body``); ``KA_WHATIF_INCREMENTAL`` and
``KA_WHATIF_MEMBUDGET`` steer the what-if sweep (``parallel/whatif.py``); the
three ``KA_GROUPS_*`` knobs set the consumer-group sweep's default scales,
its fan-out cap and the capacity default (``groups/``); ``KA_HOSTCODEC`` and
``KA_LEADERSHIP`` pick the boundary codec and the leadership lane
(``native/``). The run report, the device profiler hook and the failure
policy read the reference's ``KA_OBS_*``, ``KA_PROFILE``, ``KA_LOG``,
``KA_FAILURE_POLICY`` and ``KA_FAULTS_*`` knobs (``obs/``, ``faults/``,
``utils/logging.py``). The six ``KA_ZK_*`` knobs pick the live-ZooKeeper
client and tune its pipelined reads, its retries and mode 3's streamed
ingest (``io/zkwire.py``, ``io/zk.py``, ``generator.py``). The three
``KA_PROGRAM_STORE*`` knobs and ``KA_WARMUP`` steer warm start: the library
store (``utils/programstore.py``) and mode 3's ingest-overlapped warm-up
(``solvers/warmup.py``). The seven ``KA_EXEC_*`` knobs size, pace and poll
``ka-execute``'s waves (``exec/engine.py``) and set the snapshot backend's
simulated convergence and the default journal path. The twelve ``KA_DAEMON_*``
knobs bind, gate, time and resync ``ka-daemon``, size its HTTP worker pool
and place its ``/execute`` journals (``daemon/``); the four ``KA_DISPATCH*``
knobs turn on and tune its coalescing dispatcher (``daemon/dispatch.py``);
``KA_HEALTH_MOVE_COST`` prices a moved replica for
``/recommendations`` and the controller, the seven ``KA_CONTROLLER*`` knobs
set the closed-loop controller's policy and its safety rails
(``daemon/controller.py``), the four ``KA_FLEET_*`` knobs the fleet
scheduler's move budget, concurrency cap and lease life
(``daemon/fleet.py``), ``KA_OBS_ACCESS_LOG`` and ``KA_OBS_TRAFFIC_SERIES_MAX``
route its access log and cap its traffic series. The port reads every
knob per call, where the
reference reads some at trace time.
"""
from __future__ import annotations

import os
import sys
from typing import Any, NamedTuple


class Knob(NamedTuple):
    default: Any
    floor: Any = None  # numeric clamp (min), None = unclamped
    choices: Any = None  # the accepted values of a choice knob


KNOBS = {
    # Orphan-spread leg chain, validated against ops/assignment.py:
    # WAVE_MODES at the call site. None = "auto" ("seq" under compat).
    "KA_WAVE_MODE": Knob(None),
    # Leadership rows per plain-version step; semantics-invariant.
    "KA_LEADER_CHUNK": Knob(None, floor=1),
    "KA_RF_DECREASE_COMPAT": Knob(False),
    # P_pad x N_pad gate past which the chain switches to its giant-shape
    # legs.
    "KA_DENSE_MASK_BUDGET": Knob(1 << 27, floor=1),
    "KA_QUOTA_WAVE_TARGET": Knob(4, floor=1),
    "KA_QUOTA_ENDGAME": Knob(32, floor=1),
    # The incremental what-if sweep (only the topics a scenario can change
    # are re-solved); 0 forces the dense sweep, the differential oracle.
    "KA_WHATIF_INCREMENTAL": Knob(True),
    # Dense what-if sweep: scenarios per dispatch keep the (S, B, P_pad, RF)
    # state under this many int32 elements.
    "KA_WHATIF_MEMBUDGET": Knob(1 << 28, floor=1),
    # Consumer-group packing (``ka-groups``): the sweep's default weight
    # scales in percent, its (counts x scales) fan-out cap, and the factor
    # on the fair share that members without a declared capacity get.
    "KA_GROUPS_DEFAULT_SCALES": Knob("100,150,200"),
    "KA_GROUPS_MAX_CANDIDATES": Knob(256, floor=1),
    "KA_GROUPS_CAPACITY_HEADROOM": Knob(1.25, floor=1.0),
    # The C dict <-> tensor boundary codec (native/hostcodec.c); 0 selects
    # the numpy encode and decode, which give the same arrays and lists.
    "KA_HOSTCODEC": Knob(True),
    # Where leadership ordering runs: auto | native | device
    # (native/leadership.py:LEADERSHIP_CHOICES). auto and device take the
    # device lane, the kernel on cuda and its plain version on cpu, as the
    # port has since its first slice; native takes the host C++ pass after a
    # copy of the placement to the host, and raises when its library is not
    # built. The reference's auto takes the host lane; the port keeps the
    # device lane until card numbers of both lanes (chip_smoke.py phase 17)
    # decide.
    "KA_LEADERSHIP": Knob("auto"),
    # Failure policy (cli.py): strict aborts on the first unrecoverable
    # failure; best-effort skips vanished topics and re-runs a crashed
    # device solve on the greedy lane, exiting 6.
    "KA_FAILURE_POLICY": Knob("strict", choices=("strict", "best-effort")),
    # Fault injection (faults/inject.py): the spec, and the seed and rate
    # of a `random` schedule.
    "KA_FAULTS_SPEC": Knob(None),
    "KA_FAULTS_SEED": Knob(0),
    "KA_FAULTS_RATE": Knob(0.05, floor=0.0),
    # Live ZooKeeper (io/zk.py, io/zkwire.py, generator.py): the client
    # (kazoo when installed, else the in-tree wire client), the pipelined
    # read window, connect passes over the endpoint list, in-session
    # re-establishments, topics per streamed encode chunk, and the
    # ingest/encode overlap's kill switch.
    "KA_ZK_CLIENT": Knob("auto", choices=("auto", "kazoo", "wire")),
    "KA_ZK_PIPELINE": Knob(32, floor=1),
    "KA_ZK_CONNECT_RETRIES": Knob(3, floor=1),
    "KA_ZK_SESSION_RETRIES": Knob(2, floor=0),
    "KA_ZK_INGEST_CHUNK": Knob(64, floor=1),
    "KA_ZK_OVERLAP": Knob(True),
    # Warm start: the persistent library store (utils/programstore.py; 0
    # builds into a per-process temporary directory), its root (default:
    # build/ at the repository root) and its size cap in MB, and mode 3's
    # ingest-overlapped warm-up (solvers/warmup.py). Plans are the same
    # bytes with any of them off.
    "KA_PROGRAM_STORE": Knob(True),
    "KA_PROGRAM_STORE_DIR": Knob(None),
    "KA_PROGRAM_STORE_MAX_MB": Knob(512, floor=1),
    "KA_WARMUP": Knob(True),
    # Plan execution (exec/engine.py, ka-execute): moves per wave, seconds
    # between converged waves, the first convergence-poll interval (backing
    # off 1.5x with jitter) and a wave's poll budget, resubmissions of a
    # wave write after a read-back, polls a snapshot move takes to become
    # visible, and the default journal path (else <plan>.journal).
    "KA_EXEC_WAVE_SIZE": Knob(8, floor=1),
    "KA_EXEC_THROTTLE": Knob(0.0, floor=0.0),
    "KA_EXEC_POLL_INTERVAL": Knob(0.5, floor=0.001),
    "KA_EXEC_POLL_TIMEOUT": Knob(600.0, floor=0.1),
    "KA_EXEC_WRITE_RETRIES": Knob(2, floor=0),
    "KA_EXEC_SIM_POLLS": Knob(1, floor=0),
    "KA_EXEC_JOURNAL": Knob(None),
    # The resident daemon (daemon/, ka-daemon): the HTTP bind address and
    # port (0 = ephemeral, announced on stderr), the inflight gate (read per
    # request), the watchdog's budget, the interval of full resyncs and the
    # prompt attempts after a failure, SIGTERM's drain window, the session
    # breaker's threshold and first cooldown, and the watch-fed re-encode
    # (0: interval resyncs only).
    "KA_DAEMON_BIND": Knob("127.0.0.1"),
    "KA_DAEMON_PORT": Knob(0, floor=0),
    "KA_DAEMON_MAX_INFLIGHT": Knob(8, floor=1),
    "KA_DAEMON_REQUEST_TIMEOUT": Knob(30.0, floor=0.1),
    "KA_DAEMON_RESYNC_INTERVAL": Knob(30.0, floor=0.05),
    "KA_DAEMON_RESYNC_RETRIES": Knob(3, floor=1),
    "KA_DAEMON_DRAIN_TIMEOUT": Knob(10.0, floor=0.0),
    "KA_DAEMON_BREAKER_THRESHOLD": Knob(3, floor=1),
    "KA_DAEMON_BREAKER_COOLDOWN": Knob(1.0, floor=0.05),
    "KA_DAEMON_WATCH": Knob(True),
    # The dispatch plane (daemon/dispatch.py): the coalescing dispatcher on
    # or off (0: the one solve lock; read once at daemon startup), its
    # gather window, the size trigger and the adaptive window's cap (read
    # live per gather cycle), and the HTTP server's worker threads (read
    # once at daemon startup).
    "KA_DISPATCH": Knob(True),
    "KA_DISPATCH_WINDOW_MS": Knob(3.0, floor=0.0),
    "KA_DISPATCH_MAX_BATCH": Knob(64, floor=1),
    "KA_DISPATCH_WINDOW_MAX_MS": Knob(25.0, floor=0.0),
    "KA_DAEMON_HTTP_WORKERS": Knob(64, floor=1),
    # The daemon's /execute journals when a request names none (None: the
    # working directory), and /recommendations' cost of one moved replica.
    "KA_DAEMON_JOURNAL_DIR": Knob(None),
    "KA_HEALTH_MOVE_COST": Knob(1.0, floor=0.0),
    # The closed-loop rebalance controller (daemon/controller.py): its
    # policy (a cluster's --clusters override wins), the evaluation cadence,
    # the hysteresis streak, the blast-radius cap per action and per rolling
    # window, the jittered cooldown between actions and the post-move
    # regression tolerance. Each is read live where it is used.
    "KA_CONTROLLER": Knob("off", choices=("off", "observe", "auto")),
    "KA_CONTROLLER_INTERVAL": Knob(30.0, floor=0.05),
    "KA_CONTROLLER_CONFIRMATIONS": Knob(3, floor=1),
    "KA_CONTROLLER_MAX_MOVES": Knob(16, floor=1),
    "KA_CONTROLLER_WINDOW": Knob(3600.0, floor=1.0),
    "KA_CONTROLLER_COOLDOWN": Knob(300.0, floor=0.0),
    "KA_CONTROLLER_REGRESSION_TOL": Knob(0.0, floor=0.0),
    # The fleet scheduler (daemon/fleet.py): the daemon-wide rolling move
    # budget and its window, how many clusters may hold an action lease at
    # once, and a lease's life without a heartbeat. Each is read live per
    # admission request.
    "KA_FLEET_MAX_MOVES": Knob(64, floor=1),
    "KA_FLEET_WINDOW": Knob(3600.0, floor=1.0),
    "KA_FLEET_MAX_CONCURRENT": Knob(1, floor=1),
    "KA_FLEET_LEASE_TTL": Knob(300.0, floor=0.1),
    # stderr diagnostics level (utils/logging.py).
    "KA_LOG": Knob("ERROR", choices=("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL")),
    # Observability (obs/): collect spans and metrics, the default report
    # path, the histogram edges, the daemon's access log (None: stderr) and
    # its rollover cap, the daemon's cap on traffic series a cluster, the
    # flight ring and its dump, and the device profiler's trace directory
    # (KA_PROFILE is its older name).
    "KA_OBS_ENABLE": Knob(False),
    "KA_OBS_REPORT": Knob(None),
    "KA_OBS_HIST_EDGES": Knob(None),
    "KA_OBS_ACCESS_LOG": Knob(None),
    "KA_OBS_ACCESS_LOG_MAX_MB": Knob(0, floor=0),
    "KA_OBS_TRAFFIC_SERIES_MAX": Knob(512, floor=0),
    "KA_OBS_FLIGHT_EVENTS": Knob(512, floor=0),
    "KA_OBS_FLIGHT_DUMP": Knob(None),
    "KA_OBS_PROFILE_DIR": Knob(None),
    "KA_PROFILE": Knob(None),
}

_TRUE = frozenset({"1", "true", "yes", "on"})
_FALSE = frozenset({"0", "false", "no", "off"})


def _lookup(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(f"{name!r} is not a knob of this package") from None


def _warn(msg: str) -> None:
    print(f"kafka-assigner: {msg}", file=sys.stderr)


def env_int(name: str):
    """``int(os.environ[name])`` clamped to the knob's floor; the declared
    default when unset/empty or non-integer (the latter with a warning)."""
    k = _lookup(name)
    raw = os.environ.get(name)
    if not raw:
        return k.default
    try:
        val = int(raw)
    except ValueError:
        _warn(f"ignoring non-integer {name}={raw!r}")
        return k.default
    return val if k.floor is None else max(k.floor, val)


def env_float(name: str):
    """``float(os.environ[name])`` clamped to the knob's floor; the declared
    default when unset/empty or non-numeric (the latter with a warning)."""
    k = _lookup(name)
    raw = os.environ.get(name)
    if not raw:
        return k.default
    try:
        val = float(raw)
    except ValueError:
        _warn(f"ignoring non-numeric {name}={raw!r}")
        return k.default
    return val if k.floor is None else max(k.floor, val)


def env_str(name: str):
    """Free-form string knob; unset/empty means the declared default."""
    k = _lookup(name)
    raw = os.environ.get(name)
    return raw if raw else k.default


def env_bool(name: str) -> bool:
    """Boolean knob (truthy 1/true/yes/on, falsy 0/false/no/off); anything
    else warns and defaults."""
    default = bool(_lookup(name).default)
    raw = os.environ.get(name)
    if not raw:
        return default
    low = raw.strip().lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    _warn(
        f"ignoring non-boolean {name}={raw!r} "
        "(truthy: 1/true/yes/on, falsy: 0/false/no/off)"
    )
    return default


_UNSET = object()


def env_choice(name: str, choices=None, default=_UNSET):
    """Enumerated knob: the raw value must be one of ``choices`` (the
    knob's declared set when not given); case and surrounding whitespace
    are forgiven; unknown values warn and fall back to ``default`` (the
    knob's, or the call site's for knobs whose default is computed)."""
    k = _lookup(name)
    if choices is None:
        choices = k.choices
    if not choices:
        raise KeyError(f"{name} is a choice knob with no declared choice set; "
                       "pass choices= at the call site")
    if default is _UNSET:
        default = k.default
    raw = os.environ.get(name)
    if not raw or not raw.strip():
        return default
    raw = raw.strip()
    for cand in (raw, raw.upper(), raw.lower()):
        if cand in choices:
            return cand
    _warn(f"ignoring unknown {name}={raw!r} (expected one of {sorted(choices)})")
    return default
