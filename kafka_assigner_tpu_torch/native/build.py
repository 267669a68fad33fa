"""Build and load the port's native host libraries, the counterpart of
``kafka_assigner_tpu/native/build.py`` with its build/load split:

- ``greedy.cpp``: the C++ greedy oracle (``ka_solve_topic``,
  ``ka_solve_many``) and the host leadership pass (``ka_order_many``),
  built with ``g++`` and bound with ``ctypes``;
- ``hostcodec.c``: the dict <-> tensor boundary codec, a CPython extension
  (``ka_hostcodec_torch``) built with ``gcc``.

Each source is built into ``build/torch_native/<name>-<hash>.so`` at the
repository root (``build/`` is git-ignored), the hash taken over the
source, the compiler command and, for the extension, the interpreter's
extension suffix: an edited source gets a new name and a stale library is
never loaded. The compiler writes a temporary file that ``os.replace``
moves into place, so concurrent processes (test workers, the CLI beside a
bench) never load a half-written library.

Only the ``build_*`` functions and :func:`prebuild_native_libraries` run a
compiler; callers are process entry points (the CLIs, ``chip_smoke.py``,
the tests). The ``load_*`` functions only load, and raise
:class:`NativeBuildError` when the library is not built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import List

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GREEDY_SRC = SRC_DIR / "greedy.cpp"
CODEC_SRC = SRC_DIR / "hostcodec.c"
CODEC_MODULE = "ka_hostcodec_torch"
GREEDY_CMD = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")
CODEC_CMD = ("gcc", "-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_cached: ctypes.CDLL | None = None
_codec_cached = None


class NativeBuildError(RuntimeError):
    pass


def _python_include() -> str:
    inc = sysconfig.get_paths().get("include")
    if not inc or not os.path.exists(os.path.join(inc, "Python.h")):
        raise NativeBuildError("Python.h not found; cannot build the codec")
    return inc


def _lib_path(src: Path, cmd: List[str], salt: str = "") -> Path:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(cmd).encode() + salt.encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def greedy_lib_path() -> Path:
    """Where ``greedy.cpp`` is built."""
    return _lib_path(GREEDY_SRC, list(GREEDY_CMD))


def codec_lib_path() -> Path:
    """Where ``hostcodec.c`` is built (for this interpreter)."""
    cmd = list(CODEC_CMD) + [f"-I{_python_include()}"]
    return _lib_path(CODEC_SRC, cmd, sysconfig.get_config_var("EXT_SUFFIX") or "")


def _compile(cmd: List[str], src: Path, out: Path) -> None:
    """``cmd src -o tmp``, then ``os.replace`` into ``out``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            cmd + [str(src), "-o", str(tmp)], capture_output=True, text=True,
            timeout=120,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"compiler unavailable or timed out: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"native build failed:\n{proc.stderr}")
    try:
        os.replace(tmp, out)
    except OSError as e:
        raise NativeBuildError(f"cannot install native library: {e}") from e


def build_native_library() -> bool:
    """Compile ``greedy.cpp`` unless it is built. Returns True when a
    compile ran; raises :class:`NativeBuildError` without a toolchain."""
    with _lock:
        out = greedy_lib_path()
        if out.exists():
            return False
        _compile(list(GREEDY_CMD), GREEDY_SRC, out)
        return True


def load_native_library() -> ctypes.CDLL:
    """The built greedy library, its C signatures declared once per
    process; raises :class:`NativeBuildError` when it is not built."""
    global _cached
    with _lock:
        if _cached is not None:
            return _cached
        path = greedy_lib_path()
        if not path.exists():
            raise NativeBuildError(
                "native greedy library not built; call "
                "native.build.build_native_library() at process startup "
                "(the solve path never compiles)"
            )
        lib = ctypes.CDLL(str(path))
        i32, i32p, i64, i64p = (ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
                                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64))
        for name, res, args in (
            # n, rack_of, n_racks, p, current, width, rf, out_width,
            # jhash_abs, counters (in/out), out_ordered
            ("ka_solve_topic", i32,
             [i32, i32p, i32, i32, i32p, i32, i32, i32, i64, i32p, i32p]),
            # n, rack_of, n_racks, n_topics, p_counts, widths, jhashes,
            # currents_concat, current_offsets, rf, out_width, counters,
            # ordered_concat, ordered_offsets, fail_part
            ("ka_solve_many", i32,
             [i32, i32p, i32, i32, i32p, i32p, i64p, i32p, i64p, i32, i32,
              i32p, i32p, i64p, i32p]),
            # n_topics, p_pad, rf, acc_nodes, acc_count, jhashes, p_reals,
            # counters (in/out), out_ordered
            ("ka_order_many", None,
             [i32, i32, i32, i32p, i32p, i64p, i32p, i32p, i32p]),
        ):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _cached = lib
        return lib


def build_hostcodec() -> bool:
    """Compile the ``ka_hostcodec_torch`` extension unless it is built.
    Returns True when a compile ran; raises :class:`NativeBuildError` when
    the toolchain or the Python headers are missing. A successful build
    clears a cached load failure."""
    global _codec_cached
    with _lock:
        out = codec_lib_path()
        if out.exists():
            return False
        _compile(list(CODEC_CMD) + [f"-I{_python_include()}"], CODEC_SRC, out)
        if isinstance(_codec_cached, NativeBuildError):
            _codec_cached = None
        return True


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
    """Import the built ``ka_hostcodec_torch`` extension. A library that is
    not built raises :class:`NativeBuildError` and is not remembered (a
    later :func:`build_hostcodec` unblocks the process); an unusable one
    (a missing symbol, a broken file) is remembered, so it costs one load
    attempt and not one per solve."""
    global _codec_cached
    with _lock:
        if isinstance(_codec_cached, NativeBuildError):
            raise _codec_cached
        if _codec_cached is not None:
            return _codec_cached
        path = codec_lib_path()
        if not path.exists():
            raise NativeBuildError(
                "hostcodec not built; call native.build.build_hostcodec() "
                "at process startup (the solve path never compiles)"
            )
        try:
            import importlib.machinery
            import importlib.util

            loader = importlib.machinery.ExtensionFileLoader(CODEC_MODULE, str(path))
            spec = importlib.util.spec_from_loader(CODEC_MODULE, loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
        except (ImportError, OSError) as e:
            _codec_cached = NativeBuildError(f"codec unusable: {e}")
            raise _codec_cached from e
        _codec_cached = mod
        return mod
