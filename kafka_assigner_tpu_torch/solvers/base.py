"""Solver seam: the cross-topic ``Context``, the ``Solver`` protocol and
``get_solver``, a copy of ``kafka_assigner_tpu/solvers/base.py`` (the
reference's ``KafkaAssignmentStrategy.java:40-63, 360-369``), with the
``device`` solver in the place of ``tpu``.

The ``Context`` file format is the reference package's, so a file written by
either package loads in the other.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Protocol, Sequence, Set


class Context:
    """Cross-topic leadership-balancing state: ``counter[node_id][slot]`` is
    how often ``node_id`` has been placed at preference position ``slot``,
    accumulated across every topic solved through one assigner."""

    __slots__ = ("counter",)

    def __init__(self) -> None:
        self.counter: Dict[int, Dict[int, int]] = {}

    def get(self, node_id: int, slot: int) -> int:
        return self.counter.get(node_id, {}).get(slot, 0)

    def increment(self, node_id: int, slot: int) -> None:
        self.counter.setdefault(node_id, {})[slot] = self.get(node_id, slot) + 1

    def save(self, path: str) -> None:
        # Write-then-rename: an interrupted save never leaves a truncated file.
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(
                    {str(n): {str(s): c for s, c in slots.items()}
                     for n, slots in self.counter.items()},
                    f,
                )
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def load(cls, path: str) -> "Context":
        ctx = cls()
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        ctx.counter = {
            int(n): {int(s): int(c) for s, c in slots.items()}
            for n, slots in raw.items()
        }
        return ctx


class Solver(Protocol):
    """A pluggable assignment backend."""

    def assign(
        self,
        topic: str,
        current_assignment: Mapping[int, Sequence[int]],
        rack_assignment: Mapping[int, str],
        nodes: Set[int],
        partitions: Set[int],
        replication_factor: int,
        context: Context | None = None,
    ) -> Dict[int, List[int]]: ...


#: ``--solver``'s names: the PyTorch/CUDA solver, the C++ greedy and the
#: Python greedy oracle.
SOLVER_NAMES = ("device", "native", "greedy")


def get_solver(name: str, device: str = "cuda") -> Solver:
    """The solver named ``name``; ``device`` is where the ``device`` solver
    runs. Raises ``NotImplementedError`` when the ``native`` library is not
    built, and ``ValueError`` for an unknown name."""
    if name == "greedy":
        from .greedy import GreedySolver

        return GreedySolver()
    if name == "device":
        from .torch_solver import TorchSolver

        return TorchSolver(device)
    if name == "native":
        from ..native.build import NativeBuildError

        try:
            from .native import NativeGreedySolver

            return NativeGreedySolver()
        except (NativeBuildError, OSError) as e:
            # OSError: ctypes on a library built for another platform.
            raise NotImplementedError(
                f"the 'native' solver backend could not be built: {e}"
            ) from e
    raise ValueError(
        f"unknown solver {name!r}; expected one of {', '.join(SOLVER_NAMES)}"
    )
