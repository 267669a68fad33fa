"""``kafka_assigner_tpu_torch.daemon``: the resident assigner daemon for one
cluster or many, the port of the reference's ``kafka_assigner_tpu/daemon``.

:mod:`.service` holds the HTTP surface, its routing by
``/clusters/<name>/...``, the telemetry endpoints and the process entry;
:mod:`.supervisor` each cluster's session, watch loop, lifecycle, request
gate, circuit breaker, health plane, groups endpoints and ``/execute``;
:mod:`.state` the watch-fed metadata cache and its incremental group
encode; :mod:`.dispatch` the dispatch plane that packs concurrent
requests' device rows (``KA_DISPATCH=0``: one solve lock); :mod:`.controller`
each cluster's closed-loop rebalance controller and the daemon's shared
ticker; :mod:`.fleet` the daemon-wide fleet scheduler (the controllers'
admission leases and move budget, the boot-time journal recovery). The
command
line is ``python -m kafka_assigner_tpu_torch.daemon`` (``cli.daemon_main``).
"""
from .controller import RebalanceController
from .dispatch import SolveDispatcher
from .fleet import FleetScheduler
from .service import DEFAULT_CLUSTER, AssignerDaemon, run_daemon_process
from .state import CacheBackend, DaemonState
from .supervisor import CircuitBreaker, ClusterSupervisor

__all__ = [
    "AssignerDaemon",
    "CacheBackend",
    "CircuitBreaker",
    "ClusterSupervisor",
    "DEFAULT_CLUSTER",
    "DaemonState",
    "FleetScheduler",
    "RebalanceController",
    "SolveDispatcher",
    "run_daemon_process",
]
