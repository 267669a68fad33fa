"""Phase-tagged failures the CLI maps to its documented exit codes, copies
of the reference's ``kafka_assigner_tpu/errors.py:42-50``: an
:class:`IngestError` exits 3, a :class:`SolveError` exits 4. Input and
validation failures keep their stdlib types (``ValueError``, ``KeyError``)
and exit 5.
"""
from __future__ import annotations


class IngestError(RuntimeError):
    """Cluster-metadata ingest failed (a snapshot without the section a mode
    needs)."""


class SolveError(RuntimeError):
    """The device solve failed; the port has no fallback that hides it."""
