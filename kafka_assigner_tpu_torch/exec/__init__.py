"""``kafka_assigner_tpu_torch.exec``: the plan execution engine of
``ka-execute``, the port of the reference's ``kafka_assigner_tpu/exec``.

:class:`~.engine.PlanExecutor` drives an emitted reassignment plan to
convergence in throttled, journaled waves and verifies the result;
:func:`~.engine.load_plan_file` reads a plan file (a saved mode-3 stdout or
a bare plan); :class:`~.journal.ExecutionJournal` is the crash-safe resume
record. The command line is ``python -m kafka_assigner_tpu_torch.exec``
(``cli.execute_main``).
"""
from .engine import ExecOutcome, PlanExecutor, load_plan_file
from .journal import ExecutionJournal, JournalError, plan_fingerprint

__all__ = [
    "ExecOutcome",
    "ExecutionJournal",
    "JournalError",
    "PlanExecutor",
    "load_plan_file",
    "plan_fingerprint",
]
