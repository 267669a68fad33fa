"""Deterministic fault injection, the port of the reference's
``kafka_assigner_tpu/faults``: with no injector active every hook is a
single ``None`` check. See :mod:`kafka_assigner_tpu_torch.faults.inject`
for the fault taxonomy, the ``KA_FAULTS_*`` knobs and the spec grammar.
"""
from .inject import (  # noqa: F401
    FAULT_KINDS,
    FAULT_SCOPES,
    FaultEvent,
    FaultInjector,
    FaultSpecError,
    InjectedSolverCrash,
    active_injector,
    fault_point,
    fleet_fault,
    install,
    parse_spec,
    reset,
)
