"""Jittered exponential backoff, a copy of the reference's
``kafka_assigner_tpu/utils/backoff.py:JitteredBackoff`` with its timing
contract unchanged: attempt ``k`` (1-based) draws ``min(base *
factor**(k-1), cap) * j`` with ``j`` uniform in ``[0.5, 1.5)``. Jitter is the
only randomness, so a seeded ``rng`` reproduces a schedule exactly.

The wire client's connect passes and its in-session re-establishment
(``io/zkwire.py``) read it. Callers own their retry counting and their
sleeps: this class only answers "how long is the next pause?".
"""
from __future__ import annotations

import random
import time
from typing import Optional


class JitteredBackoff:
    """Successive jittered delays: ``min(base * factor**k, cap) * jitter``.

    ``factor`` defaults to doubling; ``cap`` bounds the nominal delay (None
    = uncapped); ``rng`` defaults to the module-global ``random`` (pass a
    seeded ``random.Random`` for reproducible schedules).
    """

    def __init__(
        self,
        base: float,
        *,
        factor: float = 2.0,
        cap: Optional[float] = None,
        rng=None,
    ) -> None:
        if base < 0:
            raise ValueError(f"backoff base must be >= 0, got {base}")
        if factor < 1.0:
            raise ValueError(f"backoff factor must be >= 1, got {factor}")
        self.base = float(base)
        self.factor = float(factor)
        self.cap = None if cap is None else float(cap)
        self._rng = rng if rng is not None else random
        self._nominal = self.base

    def peek_nominal(self) -> float:
        """The next delay before jitter (capped)."""
        if self.cap is None:
            return self._nominal
        return min(self._nominal, self.cap)

    def next_delay(self) -> float:
        """Draw the next jittered delay and advance the progression."""
        nominal = self.peek_nominal()
        self._nominal *= self.factor
        if self.cap is not None:
            self._nominal = min(self._nominal, self.cap)
        return nominal * (0.5 + self._rng.random())

    def delay_for(self, attempt: int) -> float:
        """The jittered delay for 1-based ``attempt``, independent of the
        instance's own progression (for callers whose retry counter lives
        elsewhere)."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        nominal = self.base * (self.factor ** (attempt - 1))
        if self.cap is not None:
            nominal = min(nominal, self.cap)
        return nominal * (0.5 + self._rng.random())

    def sleep(self) -> float:
        """``time.sleep(next_delay())``; returns the slept delay."""
        delay = self.next_delay()
        time.sleep(delay)
        return delay
