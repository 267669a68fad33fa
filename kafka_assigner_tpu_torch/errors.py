"""Phase-tagged failures the CLI maps to its documented exit codes, copies
of the reference's ``kafka_assigner_tpu/errors.py``: an
:class:`IngestError` exits 3, a :class:`SolveError` exits 4, an
:class:`ExecuteError` (``ka-execute``) exits 8. Input and
validation failures keep their stdlib types (``ValueError``, ``KeyError``)
and exit 5. Both types chain the original exception (``raise ... from e``),
so a library caller still reaches it via ``__cause__``.
"""
from __future__ import annotations


class KafkaAssignerError(RuntimeError):
    """Base for phase-tagged unrecoverable failures of a CLI run."""


class IngestError(KafkaAssignerError):
    """Cluster-metadata ingest failed (a snapshot without the section a mode
    needs)."""


class SolveError(KafkaAssignerError):
    """A solver backend crashed and no fallback produced a plan: under the
    default ``strict`` policy every device crash, under ``best-effort`` a
    crash of the greedy lane it fell back to."""


class ExecuteError(KafkaAssignerError):
    """The plan execution engine halted mid-plan: a wave did not converge
    within the poll budget under ``--failure-policy strict``, a
    reassignment write exhausted its read-back and resubmit budget, or
    another reassignment stayed in flight past the wait budget. The journal
    keeps every committed wave, and ``ka-execute --resume`` continues the
    run. Refusals before a journal exists (a read-only backend, a plan that
    does not match the cluster) raise ``ValueError``: there is nothing to
    resume."""
