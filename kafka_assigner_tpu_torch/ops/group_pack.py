"""The consumer-group orphan scan (KG1): the port of the ``lax.scan`` over
``proc_order`` in ``kafka_assigner_tpu/ops/assignment.py:1599-1621``, the
loop of K14 ``pack_group`` and, through K15's vmap, ``group_pack_sweep``.

- :func:`pack_scan` is the wrapper: on CUDA tensors it launches the
  hand-written Hopper kernel (``csrc/group_pack.cu``) once for every
  candidate, or raises; on CPU tensors, and only there, it runs the plain
  version. :func:`variant_of` picks the kernel's variant from C_pad and the
  device's shared-memory limit alone; :data:`last_variant` says which one
  the last launch took.
- :func:`pack_scan_plain` is the plain PyTorch version on any device: the
  reference's step, vectorized over the candidates, walking ``proc_order``
  on the host. The CPU path and the tests run it; ``chip_smoke.py`` holds
  the kernel against it on the card.
- :data:`launches` counts kernel launches (the wrapper adds one where it
  launches, and nowhere else).
- :func:`step_probe` runs a step of two warp reductions and a bump alone
  as a dependent chain on one warp: the chain's yardstick, a measurement
  that counts no launch; with ``ballot`` the step is the register
  variant's, one reduction and a ballot.

The kernel's design, the rule it picks by and what bounds it are in the
header of the ``.cu``.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from . import build

BIG = 0x3FFFFFFF
I32 = torch.int32

#: Kernel launches per kernel name; reset by whoever reads it. Requests of
#: the daemon launch from several threads, so the count is taken under a lock.
launches: Dict[str, int] = {"group_pack": 0}
_launches_lock = threading.Lock()

#: The kernel's variants, by their code in ``ka_group_pack_scan``.
VARIANTS = ("registers", "shared", "global")
#: The register variant's most consumers a lane (``kMaxSlots``): it runs
#: at C_pad <= 32 x this.
MAX_SLOTS = 32
#: Shared-memory bytes a consumer of the shared variant: headroom, load
#: (int32 each) and liveness (``csrc/group_pack.cu:smem_bytes``).
SMEM_BYTES_PER_CONSUMER = 9

#: The variant of the last launch; None before the first.
last_variant: Optional[str] = None

_smem_limit: Dict[int, int] = {}


def _kernel_lib() -> ctypes.CDLL:
    return build.load("group_pack")


def _optin_limit(lib: ctypes.CDLL, dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _smem_limit:
        with torch.cuda.device(idx):
            limit = lib.ka_group_pack_smem_limit()
        if limit < 0:
            raise RuntimeError("could not read the device's shared-memory limit")
        _smem_limit[idx] = limit
    return _smem_limit[idx]


def variant_of(c_pad: int, smem_limit: int, force_global: bool = False) -> str:
    """The kernel's variant at ``c_pad`` consumers on a device whose
    shared-memory opt-in limit is ``smem_limit`` bytes: ``"registers"``
    up to 32 x :data:`MAX_SLOTS`; past it ``"shared"`` while the state fits
    the limit; else, or when ``force_global``, ``"global"``."""
    if not force_global:
        if c_pad <= 32 * MAX_SLOTS:
            return "registers"
        if c_pad * SMEM_BYTES_PER_CONSUMER <= smem_limit:
            return "shared"
    return "global"


def span_slots(alive_row) -> int:
    """Consumers a lane that the register variant gives one candidate
    (``alive_row``: its liveness over C_pad): the smallest of 1, 2, 4, ...,
    :data:`MAX_SLOTS` whose 32 lanes hold every column up to its last live
    consumer (``csrc/group_pack.cu:scan_span``)."""
    span = max((j + 1 for j, a in enumerate(alive_row) if a), default=1)
    slots = MAX_SLOTS
    while slots > 1 and span <= 32 * (slots // 2):
        slots //= 2
    return slots


def _check(weights, capacities, proc_order, alive, need, assigned, load) -> None:
    dev = weights.device
    named = (("weights", weights, I32), ("capacities", capacities, I32),
             ("proc_order", proc_order, I32), ("alive", alive, torch.bool),
             ("need", need, torch.bool), ("assigned", assigned, I32),
             ("load", load, I32))
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, weights on {dev}")
    if weights.dim() != 2 or capacities.dim() != 1:
        raise ValueError("weights must be (S, P_pad) and capacities (C_pad,)")
    s, p = weights.shape
    c = capacities.shape[0]
    if p < 1 or c < 1:
        raise ValueError(f"P_pad {p} and C_pad {c} must be positive")
    for name, t, shape in (("proc_order", proc_order, (p,)), ("alive", alive, (s, c)),
                           ("need", need, (s, p)), ("assigned", assigned, (s, p)),
                           ("load", load, (s, c))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def _first_max(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(S, C) -> (S,) the first index of each row's maximum, written out
    (the max, then the lowest index equal to it)."""
    m = x.amax(1, keepdim=True)
    return torch.where(x == m, cols, cols.shape[0]).amin(1)


def pack_scan_plain(
    weights: torch.Tensor,     # (S, P_pad) int32 scaled weights
    capacities: torch.Tensor,  # (C_pad,) int32
    proc_order: torch.Tensor,  # (P_pad,) int32, a permutation of the rows
    alive: torch.Tensor,       # (S, C_pad) bool
    need: torch.Tensor,        # (S, P_pad) bool: real rows the sticky pass left
    assigned: torch.Tensor,    # (S, P_pad) int32, updated in place
    load: torch.Tensor,        # (S, C_pad) int32, updated in place
) -> torch.Tensor:
    """The reference's scan step, vectorized over the candidates: per row
    in ``proc_order``, headroom ``where(alive, cap - load, -BIG)``, the
    first max-headroom consumer among those that fit, else the first
    max-headroom consumer and an overflow. Rows no candidate needs are
    skipped. Updates ``assigned`` and ``load``; returns ``overflowed (S,)``
    int32."""
    _check(weights, capacities, proc_order, alive, need, assigned, load)
    s = weights.shape[0]
    dev = weights.device
    cols = torch.arange(capacities.shape[0], dtype=I32, device=dev)
    cands = torch.arange(s, device=dev)
    cap = capacities[None, :]
    over = torch.zeros(s, dtype=I32, device=dev)
    needed = need.any(0).tolist()
    for row in proc_order.tolist():
        if not needed[row]:
            continue
        w = weights[:, row]
        nd = need[:, row]
        headroom = torch.where(alive, cap - load, -BIG)
        fits = alive & (headroom >= w[:, None])
        any_fit = fits.any(1)
        pick = torch.where(any_fit, _first_max(torch.where(fits, headroom, -BIG), cols),
                           _first_max(headroom, cols))
        assigned[:, row] = torch.where(nd, pick, assigned[:, row])
        load.index_put_((cands, pick), torch.where(nd, w, 0), accumulate=True)
        over += (nd & ~any_fit).to(I32)
    return over


def pack_scan(
    weights: torch.Tensor,
    capacities: torch.Tensor,
    proc_order: torch.Tensor,
    alive: torch.Tensor,
    need: torch.Tensor,
    assigned: torch.Tensor,
    load: torch.Tensor,
    force_global: bool = False,
) -> torch.Tensor:
    """The orphan scan of every candidate: updates ``assigned`` and
    ``load`` in place and returns ``overflowed (S,)`` int32.

    CPU tensors take :func:`pack_scan_plain`. CUDA tensors take the kernel,
    one launch on the current stream in the variant :func:`variant_of`
    gives (``force_global`` asks for the global-memory one); ``assigned``
    and ``load`` must be contiguous, since the kernel writes them in place.
    A launch that fails raises; no other variant stands in."""
    global last_variant
    _check(weights, capacities, proc_order, alive, need, assigned, load)
    dev = weights.device
    if dev.type == "cpu":
        return pack_scan_plain(weights, capacities, proc_order, alive, need,
                               assigned, load)
    if dev.type != "cuda":
        raise ValueError(f"pack_scan runs on cpu or cuda, not {dev}")
    if not (assigned.is_contiguous() and load.is_contiguous()):
        raise ValueError("assigned and load must be contiguous (updated in place)")
    weights, capacities, proc_order, alive, need = (
        t.contiguous() for t in (weights, capacities, proc_order, alive, need))
    s, p = weights.shape
    c = capacities.shape[0]
    lib = _kernel_lib()
    variant = variant_of(c, _optin_limit(lib, dev), force_global)
    with torch.cuda.device(dev):
        over = torch.empty(s, dtype=I32, device=dev)
        scratch = torch.empty((s, c) if variant == "global" else (1,), dtype=I32,
                              device=dev)
        err = lib.ka_group_pack_scan(
            weights.data_ptr(), capacities.data_ptr(), proc_order.data_ptr(),
            alive.data_ptr(), need.data_ptr(), assigned.data_ptr(), load.data_ptr(),
            over.data_ptr(), scratch.data_ptr(), s, p, c, VARIANTS.index(variant),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"group pack kernel launch failed ({variant} variant, C_pad {c}): "
            f"cudaError {err}")
    with _launches_lock:
        launches["group_pack"] += 1
    last_variant = variant
    return over


#: Words of the step probe's input: 32 headrooms, one a lane, and the weight.
PROBE_WORDS = 33


def step_probe(slot: torch.Tensor, steps: int, ballot: bool = False) -> torch.Tensor:
    """Run a step of the scan alone, ``steps`` times in a dependent chain
    on one warp with one consumer a lane (C_pad 32, all alive): two warp
    reductions (the max, then the lowest lane holding it) and the bump, the
    shared variant's step without its rescan; with ``ballot``, one warp
    reduction and a ballot of the lanes holding the max, then the bump, the
    register variant's step without its slice work. ``slot`` is
    :data:`PROBE_WORDS` int32 words on the card (the headrooms, then the
    weight). Returns ``(last pick, overflow count, clock64 cycles of the
    loop)`` as an int64 tensor on the card. Events around the call give the
    time a step; this is a measurement, not a group-pack launch, and counts
    none."""
    if slot.device.type != "cuda" or slot.dtype != I32 or slot.numel() != PROBE_WORDS:
        raise ValueError(f"slot must be {PROBE_WORDS} int32 words on a CUDA device")
    lib = _kernel_lib()
    slot = slot.contiguous()
    out = torch.zeros(3, dtype=torch.int64, device=slot.device)
    with torch.cuda.device(slot.device):
        err = lib.ka_group_pack_step_probe(
            slot.data_ptr(), out.data_ptr(), steps, int(ballot),
            torch.cuda.current_stream(slot.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"group-pack step probe launch failed: cudaError {err}")
    return out
