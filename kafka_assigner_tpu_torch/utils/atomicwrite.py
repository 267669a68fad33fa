"""One atomic-write discipline for every crash-safety-critical file, a copy
of the reference's ``kafka_assigner_tpu/utils/atomicwrite.py``.

The execution journal and the snapshot backend's persisted cluster state
depend on the same property: a reader never observes a torn file, only the
state before or after a write. The recipe is a same-directory ``mkstemp``
(so the final rename never crosses a filesystem), write, flush and
``fsync`` (the rename must not land before the bytes do), then
``os.replace``, with the temporary file unlinked on any failure.
"""
from __future__ import annotations

import os
import tempfile


def atomic_write_text(path: str, text: str, *, prefix: str = ".ka_") -> None:
    """Atomically replace ``path`` with ``text`` (UTF-8)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=prefix, suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:  # the temporary file may already be gone
            pass
        raise
