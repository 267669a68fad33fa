"""Ingest-overlapped warm-up: make the solve resident on the device while
ZooKeeper replies are still streaming in. The counterpart of
``kafka_assigner_tpu/solvers/warmup.py``.

``generator.stream_initial_assignment`` learns most of the solve's
signature long before the solve runs: the broker set and rack map arrive
first (so N_pad and the rack cap are exact), the topic list is an input (so
the batch bucket is exact), and the first encoded chunk reveals the
partition and width buckets the group encode converges to.

The reference makes an XLA executable resident per signature. The port
has no compiled program per shape, so for one predicted signature
"resident" means: the libraries the resolved dispatch needs loaded through
the library store (``utils/programstore.py``: loaded, or built now), the
CUDA context created on the solver's device, the leadership kernel's
library loaded and its shared-memory opt-in read (no kernel launch), and
``place_batched`` run once on inert inputs of the predicted shapes
(currents all -1, ``p_real`` 0, as the reference's dummy arrays), which
loads torch's lazily loaded kernels for that path and leaves blocks of
those sizes in the caching allocator.

Prediction, not promise: a later topic can widen the partition bucket or
the replica width; the warm-up then prepared a shape the solve does not
use, which costs background work and changes no byte. The warm-up writes
no state a solve reads (no ``TorchSolver.last_*``, no
``models.problem.last_codec``, no kernel launch count, no ``plan/*`` span)
and no metric but ``warmup.*`` and ``compile.store.*``. A failure of any
kind degrades to the cold path; ``KA_WARMUP=0`` turns the feature off.

The same signature builder backs ``ka-warm`` (``cli.py:run_warm``).
"""
from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np

from ..models.problem import ClusterEncoding, batch_bucket


def predict_group_signature(
    cluster: ClusterEncoding,
    n_topics: int,
    p_pad: int,
    width: int,
    rf: int,
) -> Dict[str, int]:
    """The bucketed solve signature implied by what ingest knows so far:
    the exact batch bucket, node bucket and rack cap, and the partition and
    width buckets of the topics encoded so far."""
    return {
        "b_pad": batch_bucket(max(n_topics, 1)),
        "p_pad": int(p_pad),
        "width": max(int(width), 2),
        "rf": max(int(rf), 1),
        "n": cluster.n,
        "n_pad": cluster.n_pad,
    }


def warm_for_assignments(
    cluster: ClusterEncoding,
    topics,  # Mapping[str, Mapping[int, Sequence[int]]]
    desired_rf: int = -1,
    device: str = "cuda",
) -> Dict[str, str]:
    """Derive the signature from a full topic map and make it resident:
    the hook a resident service calls after a resync. The same outcome
    contract as :func:`warm_solver_programs`."""
    from ..assigner import infer_topic_rf
    from ..models.problem import group_pads

    if not topics:
        return {}
    p_pad, width = group_pads(list(topics.values()))
    rfs = []
    for t, cur in topics.items():
        try:
            rf = infer_topic_rf(t, cur, desired_rf)
        except ValueError:  # a non-uniform topic casts no vote; the solve raises
            continue
        if rf > 0:
            rfs.append(rf)
    rf = max(rfs, default=max(width, 2))
    return warm_solver_programs(cluster, len(topics), p_pad, width, rf, device=device)


def _signature(sig: Dict[str, int], r_cap: int, device) -> tuple:
    """The resolved dispatch, as ``TorchSolver._solve`` resolves it: the
    leadership lane, the wave mode, the rack cap, the compat width and the
    codec. Returns ``(program, key)``."""
    from ..native.leadership import leadership_backend
    from ..utils.env import env_bool
    from .torch_solver import rf_compat_enabled, wave_mode

    native_order = leadership_backend() == "native"
    # The reference's placement-only program under its default place mode
    # for the host lane; its batched solve for the device lane.
    program = "place_scan_narrow" if native_order else "solve_batched"
    width = sig["width"] if rf_compat_enabled() and sig["width"] > sig["rf"] else None
    key = (program, str(device), sig["b_pad"], sig["p_pad"], sig["width"], sig["rf"],
           sig["n"], sig["n_pad"], r_cap, wave_mode(), width,
           env_bool("KA_HOSTCODEC"))
    return program, key


def _load_libraries(program: str) -> None:
    """The host libraries of the dispatch, through the store: the boundary
    codec (None when off or not built) and, on the host lane, the greedy
    library's leadership pass."""
    from ..models.problem import _hostcodec

    _hostcodec()
    if program == "place_scan_narrow":
        from ..native.build import load_native_library

        load_native_library()


def _create_context(device) -> None:
    """The CUDA context on ``device``."""
    import torch

    torch.cuda.init()
    torch.cuda.synchronize(device)


def _load_kernel(device) -> None:
    """The leadership kernel's library, through the store (the kernel
    fingerprint's facts are read here the first time), and its
    shared-memory opt-in: no launch."""
    from ..ops import leadership

    leadership.prepare(device)


def _inert_pass(cluster: ClusterEncoding, key: tuple, device) -> None:
    """One ``place_batched`` on inert inputs of the predicted shapes:
    torch's lazily loaded kernels of that path, and blocks of those sizes
    in the caching allocator."""
    import torch

    from ..carry import to_tensor
    from ..ops.assignment import place_batched

    program, _, b_pad, p_pad, width, rf, n, n_pad, r_cap, mode, compat, _ = key
    currents = np.full((b_pad, p_pad, width), -1, dtype=np.int32)
    zeros = np.zeros(b_pad, dtype=np.int32)
    t = [to_tensor(a, device) for a in (currents, cluster.rack_idx, zeros, zeros)]
    if program == "solve_batched":
        to_tensor(np.zeros((n_pad, compat or rf), dtype=np.int32), device)
    placed = place_batched(*t, n, rf, mode, None, r_cap=r_cap, width=compat)
    placed.infeasible.cpu()
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _make_resident(cluster: ClusterEncoding, key: tuple, device) -> None:
    """Everything a solve of this signature loads or allocates first,
    without a kernel launch, in named steps (``scripts/
    torch_bench_warmstart.py`` times each in a fresh process)."""
    program = key[0]
    _load_libraries(program)
    if device.type == "cuda":
        _create_context(device)
        if program == "solve_batched":
            _load_kernel(device)
    _inert_pass(cluster, key, device)


def warm_solver_programs(
    cluster: ClusterEncoding,
    n_topics: int,
    p_pad: int,
    width: int,
    rf: int,
    r_cap: Optional[int] = None,
    device: str = "cuda",
) -> Dict[str, str]:
    """Make the solve of this signature resident. Returns ``{program:
    outcome}``, keyed by the reference's program name for the dispatch the
    port resolves (``solve_batched`` on the device lane,
    ``place_scan_narrow`` on the host lane), with the reference's outcomes:

    - ``hit``: this signature was already made resident in this process;
    - ``warmed``: made resident now (libraries loaded from the store or
      built into it, then the inert pass);
    - ``jit``: the same with the store off (libraries built into the
      process's temporary directory, nothing persisted);
    - ``error``: anything else, warned on stderr; never raised.
    """
    import torch

    from ..models.problem import rack_cap
    from ..utils import programstore

    sig = predict_group_signature(cluster, n_topics, p_pad, width, rf)
    if r_cap is None:
        r_cap = rack_cap(cluster.n_racks)
    program = "solve_batched"
    try:
        device = torch.device(device)
        program, key = _signature(sig, r_cap, device)
        if programstore.resident(key):
            return {program: "hit"}
        _make_resident(cluster, key, device)
        programstore.mark_resident(key)
        return {program: "warmed" if programstore.store_enabled() else "jit"}
    except Exception as e:
        print(
            f"kafka-assigner: program store: warm({program}) failed "
            f"({type(e).__name__}: {e}); cold path unaffected",
            file=sys.stderr,
        )
        return {program: "error"}
