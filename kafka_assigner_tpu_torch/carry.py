"""The state carried across from the JAX package, given as numpy arrays,
into this package's tensors: the ``(N_pad, RF)`` leadership counter slab and
the encoded batch ``(currents, rack_idx, jhashes, p_reals)`` (the arrays the
reference's ``encode_topic_group`` and ``context_to_array`` produce, which
this package's copies produce too). Tests feed both packages identical
inputs through here. The ``Context`` needs no conversion: both packages
save and load the same JSON file.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def to_tensor(a, device="cpu") -> torch.Tensor:
    """An int32 tensor on ``device`` from any integer array (JAX arrays
    pass through ``np.asarray`` by the caller)."""
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def counters_to_torch(counters: np.ndarray, device="cpu") -> torch.Tensor:
    """The ``(N_pad, RF)`` counter slab as an int32 tensor."""
    counters = np.asarray(counters)
    if counters.ndim != 2:
        raise ValueError(f"counter slab must be (N_pad, RF), got {counters.shape}")
    return to_tensor(counters, device)


def encoded_to_torch(
    currents: np.ndarray,
    rack_idx: np.ndarray,
    jhashes: np.ndarray,
    p_reals: np.ndarray,
    device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(currents (B, P_pad, L), rack_idx (N_pad,), jhashes (B,), p_reals
    (B,))`` as int32 tensors (an int16-narrowed ``currents`` widens)."""
    currents = np.asarray(currents)
    if currents.ndim != 3:
        raise ValueError(f"currents must be (B, P_pad, L), got {currents.shape}")
    b = currents.shape[0]
    if np.shape(jhashes) != (b,) or np.shape(p_reals) != (b,):
        raise ValueError("jhashes and p_reals must have one entry per topic")
    return (
        to_tensor(currents, device), to_tensor(rack_idx, device),
        to_tensor(jhashes, device), to_tensor(p_reals, device),
    )


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
