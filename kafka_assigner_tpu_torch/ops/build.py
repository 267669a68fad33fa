"""Build the hand-written CUDA kernels of ``csrc/`` and load them with
``ctypes``, through the port's library store (``utils/programstore.py``).

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds into the store, one entry per (source, flags)
under a directory fingerprinted by the ``nvcc`` release and the device
(``build/torch-<fingerprint>/<name>-<hash>.so`` at the repository root by
default; ``build/`` is git-ignored): an edited source rebuilds and a stale
library is never loaded. Each library's C signatures are declared here,
once per load, and a library that lacks one is dropped and rebuilt.
``build_all`` starts one ``nvcc`` per source, all at once, and reports each
kernel's registers and shared memory from ``-Xptxas -v``.
"""
from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path
from typing import Dict

from ..utils import programstore

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_INT, _PTR, _LL = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong

#: The C functions each kernel library exports: ``(name, restype,
#: argtypes)``.
SIGNATURES = {
    "leadership": (
        ("ka_smem_optin_limit", _INT, []),
        ("ka_leadership_tile_rows", _INT, [_INT]),
        ("ka_leadership_record_words", _INT, [_INT]),
        ("ka_leadership_smem_bytes", _LL, [_INT] * 3),
        ("ka_leadership_order", _INT, [_PTR] * 6 + [_INT] * 5 + [_PTR] * 2),
        ("ka_leadership_chain_probe", _INT, [_INT, _PTR, _PTR, _LL, _PTR]),
    ),
    "group_pack": (
        ("ka_group_pack_smem_limit", _INT, []),
        ("ka_group_pack_scan", _INT, [_PTR] * 9 + [_INT] * 4 + [_PTR]),
        ("ka_group_pack_step_probe", _INT, [_PTR, _PTR, _LL, _INT, _PTR]),
    ),
}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = programstore.compiler_path("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


@functools.lru_cache(maxsize=None)
def spec(name: str) -> programstore.LibrarySpec:
    """The store's description of ``csrc/<name>.cu``'s library."""
    return programstore.LibrarySpec(
        name=name, kind="cuda", source=CSRC / f"{name}.cu", compiler="nvcc",
        flags=NVCC_FLAGS, symbols=SIGNATURES.get(name, ()), error=KernelBuildError,
    )


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: its store entry."""
    return programstore.entry_path(spec(name))


def build_all() -> Dict[str, object]:
    """Build every ``csrc/*.cu`` not yet in the store, in parallel, and load
    each. Returns ``{"seconds": float, "ptxas": {name: nvcc -Xptxas -v
    output}}`` (empty output for a library the store already held)."""
    import time

    t0 = time.perf_counter()
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    logs = programstore.build_many([spec(name) for name in names])
    return {"seconds": time.perf_counter() - t0,
            "ptxas": {name: log or "" for name, log in logs.items()}}


def _short_name(mangled: str) -> str:
    """``kernel<template arguments>`` of an Itanium-mangled kernel name whose
    template arguments are integer or bool literals; the name as given if it
    is not one."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = None
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if name is None:
        return mangled
    m = re.match(r"I((?:L[ib]\d+E)+)", mangled[i:])
    args = re.findall(r"\d+", m.group(1)) if m else []
    return name + (f"<{','.join(args)}>" if args else "")


def kernel_resources(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of one ``-Xptxas -v`` log: ``{name: {"registers",
    "stack", "spill_stores", "spill_loads"}}``, the name shortened to
    ``kernel<template arguments>`` (``pack_scan_kernel<1>``)."""
    out: Dict[str, Dict[str, int]] = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        stats = {}
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers")):
            found = re.search(pat, chunk)
            if found:
                stats[key] = int(found.group(1))
        out[_short_name(chunk.split("'", 1)[0])] = stats
    return out


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, its C signatures
    declared: from memory, else the store, else built now (a solve that
    reaches a library another thread is building waits for that build)."""
    return programstore.library(spec(name))
