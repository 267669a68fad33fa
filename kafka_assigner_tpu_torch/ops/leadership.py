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
  the kernel. One launch is the kernel's two phases: the per-row prologue
  and the chain.

The kernel's design and what bounds it are in the header of the ``.cu``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import build

BIG = 0x3FFFFFFF
I32 = torch.int32

#: Kernel launches per kernel name; reset by whoever reads it.
launches: Dict[str, int] = {"leadership": 0}

_smem_limit: Dict[int, int] = {}


def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library (``ops/build.py`` declares its C
    signatures)."""
    return build.load("leadership")


def _optin_limit(lib: ctypes.CDLL, dev: torch.device) -> int:
    """The device's shared-memory opt-in limit, read once per device."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _smem_limit:
        with torch.cuda.device(idx):
            limit = lib.ka_smem_optin_limit()
        if limit < 0:
            raise RuntimeError("could not read the device's shared-memory limit")
        _smem_limit[idx] = limit
    return _smem_limit[idx]


def prepare(dev: torch.device) -> int:
    """Load the kernel's library and read the device's shared-memory opt-in
    limit, without a launch (the warm-up's share of a first solve). Returns
    the limit."""
    return _optin_limit(_kernel_lib(), torch.device(dev))


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
    mid_event: Optional[torch.cuda.Event] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leadership ordering of a batch of placed topics: ``(ordered (B, P,
    RF), counters_after)``; ``counters`` is not mutated.

    CPU tensors take :func:`leadership_order_plain` (``chunk`` is its row
    block). CUDA tensors take the kernel, in one launch (prologue and chain)
    on the current stream; it keeps the counter slab in shared memory unless
    slab and tile rings together exceed the device's opt-in limit or
    ``force_global_slab`` asks for the global-memory variant. ``mid_event``,
    when given, is recorded between the prologue and the chain, so events
    around the call time the two apart."""
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
    counters_out = counters.contiguous().clone()
    rows = b * p
    if rows == 0:
        return torch.empty_like(acc_nodes), counters_out
    lib = _kernel_lib()
    use_global = force_global_slab or (
        lib.ka_leadership_smem_bytes(rf, n_pad, 0) > _optin_limit(lib, dev)
    )
    tile = lib.ka_leadership_tile_rows(rf)
    rows_pad = -(-rows // tile) * tile
    with torch.cuda.device(dev):
        records = torch.empty(
            rows_pad * lib.ka_leadership_record_words(rf), dtype=I32, device=dev
        )
        ordered = torch.empty(rows_pad * rf, dtype=I32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        mid = None
        if mid_event is not None:
            mid_event.record()  # creates the event; the launch records it again
            mid = mid_event.cuda_event
        err = lib.ka_leadership_order(
            acc_nodes.data_ptr(), acc_count.data_ptr(), jhashes.data_ptr(),
            counters_out.data_ptr(), ordered.data_ptr(), records.data_ptr(),
            b, p, rf, n_pad, int(use_global), stream, mid,
        )
    if err != 0:
        raise RuntimeError(f"leadership kernel launch failed: cudaError {err}")
    launches["leadership"] += 1
    return ordered[: rows * rf].view(b, p, rf), counters_out


def chain_probe(rf: int, slot: torch.Tensor, steps: int) -> torch.Tensor:
    """Run the kernel's chain alone: one thread takes ``steps`` dependent
    steps (the first minimum over the keys, then the next bumped row) on one
    slot. ``slot`` is int32 on the card: key, hit key, gather row, candidate
    and counter, ``rf`` words each, then the slot flag and N_pad. Returns
    ``(last bumped row, clock64 cycles of the loop)`` as an int64 tensor on
    the card. Events around the call give the chain's time per step; this is
    a measurement, not a leadership launch, and counts none."""
    if slot.device.type != "cuda" or slot.dtype != I32 or slot.numel() != 5 * rf + 2:
        raise ValueError(f"slot must be {5 * rf + 2} int32 words on a CUDA device")
    lib = _kernel_lib()
    slot = slot.contiguous()
    out = torch.zeros(2, dtype=torch.int64, device=slot.device)
    with torch.cuda.device(slot.device):
        err = lib.ka_leadership_chain_probe(
            rf, slot.data_ptr(), out.data_ptr(), steps,
            torch.cuda.current_stream(slot.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"chain probe launch failed: cudaError {err}")
    return out
