"""Build the hand-written CUDA kernels of ``csrc/`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds into ``build/torch_kernels/lib<name>-<hash>.so``
at the repository root (``build/`` is git-ignored). The file name carries a
hash of the source and flags, so an edited source rebuilds and a stale
library is never loaded. ``build_all`` starts one ``nvcc`` per source, all
at once, and reports each kernel's registers and shared memory from
``-Xptxas -v``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built, named by a hash of source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one nvcc for ``csrc/<name>.cu``; None when already built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return log


def build_all() -> Dict[str, object]:
    """Build every ``csrc/*.cu`` in parallel. Returns ``{"seconds": float,
    "ptxas": {name: nvcc -Xptxas -v output}}`` (empty output for a source
    already built)."""
    t0 = time.perf_counter()
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {name: _start(name) for name in names}
    logs = {name: _finish(name, started[name]) for name in names}
    return {"seconds": time.perf_counter() - t0, "ptxas": logs}


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
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib
