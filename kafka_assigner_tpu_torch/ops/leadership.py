"""Leadership ordering: the port of ``kafka_assigner_tpu/ops/
pallas_leadership.py`` (the Pallas TPU kernel ``_kernel`` behind
``leadership_order_pallas``), which computes what the reference package's
``leadership_order`` / ``order_batched`` compute (``ops/assignment.py:886,
1364``), i.e. ``computePreferenceLists`` (``KafkaAssignmentStrategy.java:
202-302``) over a batch of topics.

- :func:`leadership_order` is the wrapper: on CUDA tensors it launches the
  hand-written Hopper kernel (``csrc/leadership.cu``) once for the whole
  batch, or raises; on CPU tensors, and only there, it runs the plain
  version.
- :func:`leadership_order_plain` is the plain PyTorch version of the same
  function, on any device: the CPU tests run it, and ``chip_smoke.py`` holds
  the kernel against it on the card.
- :data:`launches` counts kernel launches (the wrapper adds one where it
  launches, and nowhere else), so a run can show its main path went through
  the kernel.

The kernel's design and what bounds it are in the header of the ``.cu``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import build

BIG = 0x3FFFFFFF
I32 = torch.int32

#: Kernel launches per kernel name; reset by whoever reads it.
launches: Dict[str, int] = {"leadership": 0}


def _check(acc_nodes, acc_count, counters, jhashes) -> None:
    dev = acc_nodes.device
    for name, t in (("acc_nodes", acc_nodes), ("acc_count", acc_count),
                    ("counters", counters), ("jhashes", jhashes)):
        if t.dtype != I32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, acc_nodes on {dev}")
    if acc_nodes.dim() != 3:
        raise ValueError(f"acc_nodes must be (B, P, RF), got {tuple(acc_nodes.shape)}")
    b, p, rf = acc_nodes.shape
    if tuple(acc_count.shape) != (b, p):
        raise ValueError(f"acc_count must be {(b, p)}, got {tuple(acc_count.shape)}")
    if tuple(jhashes.shape) != (b,):
        raise ValueError(f"jhashes must be ({b},), got {tuple(jhashes.shape)}")
    if counters.dim() != 2 or counters.shape[1] != rf or counters.shape[0] < 1:
        raise ValueError(
            f"counters must be (N_pad, {rf}), got {tuple(counters.shape)}"
        )
    if not 1 <= rf <= 32:
        raise ValueError(f"RF {rf} outside the kernel's 1..32 lanes")


def leadership_order_plain(
    acc_nodes: torch.Tensor,  # (B, P, RF) int32 broker index or -1
    acc_count: torch.Tensor,  # (B, P) int32
    counters: torch.Tensor,   # (N_pad, RF) int32 Context slab (not mutated)
    jhashes: torch.Tensor,    # (B,) int32 abs java hash per topic
    chunk: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch leadership ordering: topics, then partitions, in order,
    each partition's slots as the reference package's ``order_one``
    (vectorized over the RF candidates); rows are read in blocks of
    ``chunk`` (semantics-invariant, like the reference's chunked scan).
    Returns ``(ordered (B, P, RF), counters_after)``. A gather index is
    clamped into the slab and an out-of-range counter update dropped, as
    under XLA."""
    _check(acc_nodes, acc_count, counters, jhashes)
    b, p, rf = acc_nodes.shape
    n_pad = counters.shape[0]
    dev = acc_nodes.device
    counters = counters.clone()
    ordered = torch.full_like(acc_nodes, -1)
    slots = torch.arange(rf, dtype=I32, device=dev)
    rows_of = [
        (t, i0, acc_nodes[t, i0:i0 + chunk], acc_count[t, i0:i0 + chunk])
        for t in range(b) for i0 in range(0, p, max(chunk, 1))
    ]
    for t, i0, cands, counts in rows_of:
        jh = jhashes[t]
        for c in range(cands.shape[0]):
            i = i0 + c
            cand = cands[c]
            count = counts[c]
            remaining = slots < count
            rows = cand.clamp(0, n_pad - 1).long()
            less = cand[None, :] < cand[:, None]
            for r in range(rf):
                m = (count - r).clamp(min=1)
                k = (less & remaining[None, :]).sum(1, dtype=I32)
                rot = (k + jh % m) % m
                key = torch.where(remaining, counters[rows, r] * m + rot, BIG)
                choice = torch.argmin(key)
                chosen = cand[choice]
                valid = count > r
                ordered[t, i, r] = torch.where(valid, chosen, -1)
                remaining = remaining & (slots != choice)
                bump = valid & (chosen < n_pad)
                counters[chosen.clamp(0, n_pad - 1), r] += bump.to(I32)
    return ordered, counters


def leadership_order(
    acc_nodes: torch.Tensor,
    acc_count: torch.Tensor,
    counters: torch.Tensor,
    jhashes: torch.Tensor,
    force_global_slab: bool = False,
    chunk: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leadership ordering of a batch of placed topics: ``(ordered (B, P,
    RF), counters_after)``; ``counters`` is not mutated.

    CPU tensors take :func:`leadership_order_plain` (``chunk`` is its row
    block). CUDA tensors take the kernel, in one launch on the current
    stream; it keeps the counter slab in shared memory unless the slab
    exceeds the device's opt-in limit or ``force_global_slab`` asks for the
    global-memory variant."""
    _check(acc_nodes, acc_count, counters, jhashes)
    dev = acc_nodes.device
    if dev.type == "cpu":
        return leadership_order_plain(
            acc_nodes, acc_count, counters, jhashes, chunk
        )
    if dev.type != "cuda":
        raise ValueError(f"leadership_order runs on cpu or cuda, not {dev}")
    acc_nodes = acc_nodes.contiguous()
    acc_count = acc_count.contiguous()
    jhashes = jhashes.contiguous()
    b, p, rf = acc_nodes.shape
    n_pad = counters.shape[0]
    lib = build.load("leadership")
    lib.ka_smem_optin_limit.restype = ctypes.c_int
    lib.ka_smem_optin_limit.argtypes = []
    lib.ka_leadership_order.restype = ctypes.c_int
    lib.ka_leadership_order.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    with torch.cuda.device(dev):
        limit = lib.ka_smem_optin_limit()
        if limit < 0:
            raise RuntimeError("could not read the device's shared-memory limit")
        use_global = force_global_slab or n_pad * rf * 4 > limit
        ordered = torch.empty_like(acc_nodes)
        counters_out = counters.contiguous().clone()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ka_leadership_order(
            acc_nodes.data_ptr(), acc_count.data_ptr(), jhashes.data_ptr(),
            counters_out.data_ptr(), ordered.data_ptr(),
            b, p, rf, n_pad, int(use_global), stream,
        )
    if err != 0:
        raise RuntimeError(f"leadership kernel launch failed: cudaError {err}")
    launches["leadership"] += 1
    return ordered, counters_out
