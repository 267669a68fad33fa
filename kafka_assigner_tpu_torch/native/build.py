"""Build and load the port's native host libraries, the counterpart of
``kafka_assigner_tpu/native/build.py`` with its build/load split:

- ``greedy.cpp``: the C++ greedy oracle (``ka_solve_topic``,
  ``ka_solve_many``) and the host leadership pass (``ka_order_many``),
  built with ``g++`` and bound with ``ctypes``;
- ``hostcodec.c``: the dict <-> tensor boundary codec, a CPython extension
  (``ka_hostcodec_torch``) built with ``gcc``.

Both go through the port's library store (``utils/programstore.py``): one
entry per (source, compiler command, and for the extension the
interpreter's extension suffix) under a directory fingerprinted by the
compiler versions, ``build/torch-<fingerprint>/<name>-<hash>.so`` at the
repository root by default (``build/`` is git-ignored). An edited source
gets a new name and a stale library is never loaded; the compiler writes a
temporary file that ``os.replace`` moves into place, so concurrent
processes (test workers, the CLI beside a bench) never load a half-written
library; an entry that fails to load is dropped and rebuilt.

Only the ``build_*`` functions and :func:`prebuild_native_libraries` run a
compiler; callers are process entry points (the CLIs, ``chip_smoke.py``,
the tests). The ``load_*`` functions only load, and raise
:class:`NativeBuildError` when the library is not built.
"""
from __future__ import annotations

import ctypes
import functools
import os
import sys
import sysconfig
from pathlib import Path
from typing import Tuple

from ..utils import programstore

SRC_DIR = Path(__file__).resolve().parent
GREEDY_SRC = SRC_DIR / "greedy.cpp"
CODEC_SRC = SRC_DIR / "hostcodec.c"
CODEC_MODULE = "ka_hostcodec_torch"
GREEDY_CMD = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")
CODEC_CMD = ("gcc", "-O2", "-shared", "-fPIC")

_I32, _I32P = ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)
_I64, _I64P = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
GREEDY_SIGNATURES = (
    # n, rack_of, n_racks, p, current, width, rf, out_width, jhash_abs,
    # counters (in/out), out_ordered
    ("ka_solve_topic", _I32,
     [_I32, _I32P, _I32, _I32, _I32P, _I32, _I32, _I32, _I64, _I32P, _I32P]),
    # n, rack_of, n_racks, n_topics, p_counts, widths, jhashes,
    # currents_concat, current_offsets, rf, out_width, counters,
    # ordered_concat, ordered_offsets, fail_part
    ("ka_solve_many", _I32,
     [_I32, _I32P, _I32, _I32, _I32P, _I32P, _I64P, _I32P, _I64P, _I32, _I32,
      _I32P, _I32P, _I64P, _I32P]),
    # n_topics, p_pad, rf, acc_nodes, acc_count, jhashes, p_reals,
    # counters (in/out), out_ordered
    ("ka_order_many", None,
     [_I32, _I32, _I32, _I32P, _I32P, _I64P, _I32P, _I32P, _I32P]),
)
CODEC_FUNCTIONS = ("scan_dims", "encode_rows", "decode_rows")


class NativeBuildError(RuntimeError):
    pass


def _python_include() -> str:
    inc = sysconfig.get_paths().get("include")
    if not inc or not os.path.exists(os.path.join(inc, "Python.h")):
        raise NativeBuildError("Python.h not found; cannot build the codec")
    return inc


@functools.lru_cache(maxsize=None)
def _spec(name: str, src: Path, cmd: Tuple[str, ...], salt: str, module) \
        -> programstore.LibrarySpec:
    symbols = (tuple((f, None, None) for f in CODEC_FUNCTIONS) if module
               else GREEDY_SIGNATURES)
    return programstore.LibrarySpec(
        name=name, kind="host", source=src, compiler=cmd[0], flags=tuple(cmd[1:]),
        symbols=symbols, module=module, salt=salt, error=NativeBuildError,
    )


def greedy_spec() -> programstore.LibrarySpec:
    return _spec(GREEDY_SRC.stem, GREEDY_SRC, GREEDY_CMD, "", None)


def codec_spec() -> programstore.LibrarySpec:
    return _codec_spec(CODEC_SRC, CODEC_CMD)


@functools.lru_cache(maxsize=None)
def _codec_spec(src: Path, cmd: Tuple[str, ...]) -> programstore.LibrarySpec:
    return _spec(src.stem, src, cmd + (f"-I{_python_include()}",),
                 sysconfig.get_config_var("EXT_SUFFIX") or "", CODEC_MODULE)


def greedy_lib_path() -> Path:
    """Where ``greedy.cpp`` is built."""
    return programstore.entry_path(greedy_spec())


def codec_lib_path() -> Path:
    """Where ``hostcodec.c`` is built (for this interpreter)."""
    return programstore.entry_path(codec_spec())


def build_native_library() -> bool:
    """Build ``greedy.cpp`` unless the store holds it, and load it. Returns
    True when a compile ran; raises :class:`NativeBuildError` without a
    toolchain."""
    return programstore.ensure_built(greedy_spec())


def load_native_library() -> ctypes.CDLL:
    """The built greedy library, its C signatures declared; raises
    :class:`NativeBuildError` when it is not built."""
    return programstore.library(greedy_spec(), build=False)


def build_hostcodec() -> bool:
    """Build the ``ka_hostcodec_torch`` extension unless the store holds
    it, and load it. Returns True when a compile ran; raises
    :class:`NativeBuildError` when the toolchain or the Python headers are
    missing."""
    return programstore.ensure_built(codec_spec())


def prebuild_native_libraries(err=None) -> bool:
    """The startup build of both libraries, as the reference's: a greedy
    library that cannot be built is left unbuilt (``--solver native`` and
    ``KA_LEADERSHIP=native`` then raise where they are asked for), and
    under ``KA_HOSTCODEC`` (on by default) a codec that cannot be built
    warns once on ``err`` and the numpy paths stand in, byte-identically.
    Returns whether the codec is usable."""
    from ..utils.env import env_bool

    try:
        build_native_library()
    except NativeBuildError:
        pass
    if not env_bool("KA_HOSTCODEC"):
        return False
    try:
        build_hostcodec()
        return True
    except NativeBuildError as e:
        print(
            f"kafka-assigner: hostcodec unavailable ({e}); using the "
            "numpy boundary codec",
            file=err if err is not None else sys.stderr,
        )
        return False


def load_hostcodec():
    """The built ``ka_hostcodec_torch`` extension; raises
    :class:`NativeBuildError` when it is not built (a later
    :func:`build_hostcodec` unblocks the process)."""
    return programstore.library(codec_spec(), build=False)
