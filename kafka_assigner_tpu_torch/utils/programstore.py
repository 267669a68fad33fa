"""The persistent library store: every library the port builds, across
processes. The counterpart of ``kafka_assigner_tpu/utils/programstore.py``.

The reference stores one serialized XLA executable per bucketed call
signature. The port has no compiled program per shape: its hand kernels
take any shape. What a fresh process of the port compiles is its libraries
(the CUDA kernels of ``csrc/`` with ``nvcc``, ``native/greedy.cpp`` with
``g++``, ``native/hostcodec.c`` with ``gcc``), so a store entry here is one
built library per (source, compiler command), described by a
:class:`LibrarySpec`, and loading it is a ``dlopen`` instead of a compile.

Layout: ``<root>/torch-<fingerprint>/<name>-<keyhash>.so`` plus a
human-readable ``meta.json`` per fingerprint directory, and the compilers'
version lines under ``<root>/torch-tools/``. ``<root>`` is
``KA_PROGRAM_STORE_DIR`` or ``build/`` at the repository root.

The reference's safety contract, kept:

- **fingerprinted**: the directory is named by a hash of the store schema,
  the package and torch versions, torch's CUDA version, and the toolchain's
  own facts: for a kernel library the ``nvcc`` release and the device name,
  compute capability and count; for a host library the ``gcc`` and ``g++``
  versions and the interpreter's extension ABI. The kernel facts are read
  only when a kernel library is built or loaded, so a CPU-only process
  never creates a CUDA context for them. Any mismatch is a clean miss;
- **corruption-tolerant**: an entry that fails to load or lacks a symbol
  of its spec is warned about, unlinked and rebuilt
  (``compile.store.exec_fallbacks``);
- **atomic**: the compiler writes a temporary name unique to the process
  and the thread, and ``os.replace`` moves it into place, so concurrent
  writers (test workers, a warm-up thread beside the solve) never load a
  half-written library;
- **bounded**: after each write the store drops least-recently-used
  entries (mtime, refreshed on every load) until under
  ``KA_PROGRAM_STORE_MAX_MB``. The sweep counts the port's ``torch-*``
  directories only: a root shared with the reference never evicts its
  ``.exe`` entries, and the reference never counts these.

Within a process a library is resolved once: memory, then the store
(``compile.store.hits``, ``compile.store.loads_ms``), then a build
(``compile.store.misses``, ``compile.store.compiles_ms``), under a lock per
entry, so a solve that reaches a library the warm-up thread is building
waits for that build and never starts a second compiler.

``KA_PROGRAM_STORE=0`` turns the store off: libraries are built into a
per-process temporary directory that is removed at exit, and nothing is
counted or persisted. ``compile.store.unbucketed`` is declared with the
reference's names and never counts: no entry here is per shape.
"""
from __future__ import annotations

import atexit
import ctypes
import dataclasses
import functools
import hashlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .env import env_bool, env_int, env_str

#: Bump when the entry layout or the keying changes: old stores become
#: clean misses.
STORE_SCHEMA_VERSION = 1

#: The port's fingerprint directories and entries; the size cap counts
#: nothing else under the root.
DIR_PREFIX = "torch-"
ENTRY_SUFFIX = ".so"
#: The compilers' version lines, kept so a loading process runs none.
TOOLS_DIR = DIR_PREFIX + "tools"

#: Default root: ``build/`` at the repository root (git-ignored).
_DEFAULT_DIR = str(Path(__file__).resolve().parents[2] / "build")

_warned: set = set()
_tmp_seq = itertools.count()


def _tmp_name(path) -> str:
    """A temporary name beside ``path``, unique to the process and the
    thread: the warm-up thread and the solve may build the same entry."""
    return f"{path}.tmp.{os.getpid()}.{threading.get_ident()}.{next(_tmp_seq)}"


def _warn_once(msg: str) -> None:
    if msg not in _warned:
        print(f"kafka-assigner: {msg}", file=sys.stderr)
        _warned.add(msg)


# --- what a library is ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LibrarySpec:
    """One library the port builds.

    ``kind`` names the toolchain whose facts fingerprint it (``cuda`` or
    ``host``); ``compiler`` is resolved to an executable only when a build
    runs; the build is ``compiler *flags source -o <out>``. ``symbols`` maps
    each C function the library must export to ``(restype, argtypes)``:
    :meth:`open` declares them and treats a missing one as a broken
    library. ``module`` loads the library as a CPython extension of that
    name instead, and ``symbols`` then lists attributes it must have.
    ``salt`` joins the key (the extension ABI of the interpreter)."""

    name: str
    kind: str
    source: Path
    compiler: str
    flags: Tuple[str, ...]
    symbols: Tuple[Tuple[str, Any, Any], ...] = ()
    module: Optional[str] = None
    salt: str = ""
    error: type = RuntimeError

    @functools.cached_property
    def key(self) -> str:
        """The library's identity; raises ``error`` when the source cannot
        be read (an installation that did not ship it), so callers see
        the same failure as a build that cannot run."""
        try:
            source = Path(self.source).read_bytes()
        except OSError as e:
            raise self.error(f"cannot read the {self.name} source: {e}") from e
        digest = hashlib.sha256(source).hexdigest()
        return "|".join((self.name, digest, self.compiler, " ".join(self.flags),
                         self.salt))

    @property
    def filename(self) -> str:
        return f"{self.name}-{hashlib.sha256(self.key.encode()).hexdigest()[:16]}{ENTRY_SUFFIX}"

    def open(self, path: str):
        """Load the library at ``path`` and check it exports what it must;
        raises on a broken file or a missing symbol."""
        if self.module is not None:
            import importlib.machinery
            import importlib.util

            loader = importlib.machinery.ExtensionFileLoader(self.module, path)
            spec = importlib.util.spec_from_loader(self.module, loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            for name, _, _ in self.symbols:
                if not hasattr(mod, name):
                    raise AttributeError(f"{path} lacks {name}")
            return mod
        lib = ctypes.CDLL(path)
        for name, res, args in self.symbols:
            fn = getattr(lib, name)  # AttributeError: undefined symbol
            fn.restype, fn.argtypes = res, args
        return lib


def compiler_path(compiler: str) -> Optional[str]:
    """The executable of ``compiler``, or None. ``nvcc`` is looked for under
    ``CUDA_HOME``, then on ``PATH``, then under ``/usr/local/cuda``."""
    if compiler == "nvcc":
        home = os.environ.get("CUDA_HOME")
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
        found = shutil.which("nvcc")
        if found:
            return found
        default = Path("/usr/local/cuda/bin/nvcc")
        return str(default) if default.exists() else None
    return shutil.which(compiler)


# --- fingerprint ---------------------------------------------------------------

_FP_LOCK = threading.Lock()
_FP_CACHE: Dict[str, Tuple[str, Dict[str, Any]]] = {}


def _tool_version(compiler: str) -> str:
    """The version line of ``compiler --version`` (nvcc's ``release``
    line, the first line of the others), or ``unavailable``.

    With the store on, the line is kept under ``<root>/torch-tools/``,
    keyed by the executable's resolved path, size, mtime and inode, so a
    process that only loads libraries spawns no compiler: a replaced
    compiler has another key and is asked again."""
    exe = compiler_path(compiler)
    if exe is None:
        return "unavailable"
    real = os.path.realpath(exe)
    try:
        st = os.stat(real)
    except OSError:
        return "unavailable"
    cached = None
    if store_enabled():
        stamp = f"{compiler}|{real}|{st.st_size}|{st.st_mtime_ns}|{st.st_ino}"
        cached = Path(get_store().root) / TOOLS_DIR / (
            f"{compiler}-{hashlib.sha256(stamp.encode()).hexdigest()[:16]}.txt")
        try:
            return cached.read_text(encoding="utf-8").strip() or "unavailable"
        except OSError:
            pass
    try:
        out = subprocess.run([real, "--version"], capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "unavailable"
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if compiler == "nvcc":
        lines = [ln for ln in lines if "release" in ln] or lines
    version = lines[0] if lines else "unavailable"
    if cached is not None and version != "unavailable":
        try:
            cached.parent.mkdir(parents=True, exist_ok=True)
            tmp = _tmp_name(cached)
            Path(tmp).write_text(version + "\n", encoding="utf-8")
            os.replace(tmp, cached)
        except OSError as e:
            _warn_once(f"program store: could not keep the {compiler} version ({e})")
    return version


def _device_facts() -> Dict[str, Any]:
    import torch

    if not torch.cuda.is_available():
        return {"device_name": "none", "capability": "none", "device_count": 0}
    major, minor = torch.cuda.get_device_capability(0)
    return {
        "device_name": torch.cuda.get_device_name(0),
        "capability": f"{major}.{minor}",
        "device_count": torch.cuda.device_count(),
    }


def _fingerprint_facts(kind: str = "host") -> Dict[str, Any]:
    """The fingerprint inputs of one toolchain (also written to
    ``meta.json``, so a reader can see why an old entry stopped
    matching)."""
    import torch

    from .. import __version__ as pkg_version

    facts: Dict[str, Any] = {
        "store_schema": STORE_SCHEMA_VERSION,
        "package": pkg_version,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "toolchain": kind,
    }
    if kind == "cuda":
        facts["nvcc"] = _tool_version("nvcc")
        facts.update(_device_facts())
    else:
        facts["gcc"] = _tool_version("gcc")
        facts["g++"] = _tool_version("g++")
        facts["ext_suffix"] = sysconfig.get_config_var("EXT_SUFFIX") or ""
    return facts


def fingerprint(kind: str = "host") -> str:
    """Hex digest naming this process's compatibility class for one
    toolchain (cached: versions and devices do not change mid-process)."""
    with _FP_LOCK:
        if kind not in _FP_CACHE:
            facts = _fingerprint_facts(kind)
            digest = hashlib.sha256(
                json.dumps(facts, sort_keys=True).encode()
            ).hexdigest()[:24]
            _FP_CACHE[kind] = (digest, facts)
        return _FP_CACHE[kind][0]


def _reset_fingerprint_cache() -> None:
    """Test hook: forget the cached fingerprints."""
    with _FP_LOCK:
        _FP_CACHE.clear()


# --- the on-disk store ---------------------------------------------------------

class ProgramStore:
    """One on-disk library store rooted at ``root``."""

    def __init__(self, root: str) -> None:
        self.root = root

    def _dir(self, kind: str) -> str:
        return os.path.join(self.root, DIR_PREFIX + fingerprint(kind))

    def path(self, spec: LibrarySpec) -> Path:
        return Path(self._dir(spec.kind)) / spec.filename

    def load(self, spec: LibrarySpec):
        """The loaded library of ``spec``, or None: a clean miss, or an
        entry that failed to load (warned, counted, unlinked). Never
        raises."""
        from ..obs.metrics import counter_add

        path = self.path(spec)
        if not path.exists():
            return None
        try:
            lib = _open(spec, path)
        except Exception as e:
            if not isinstance(e, OSError):
                # The loader mapped the file before the check failed: this
                # process keeps it mapped under this path name.
                _SHADOWED.add(str(path))
            counter_add("compile.store.exec_fallbacks")
            _warn_once(
                f"program store: dropping corrupted entry {path} "
                f"({type(e).__name__}: {e}); rebuilding"
            )
            try:
                path.unlink()
            except OSError as ue:
                _warn_once(f"program store: could not unlink {path}: {ue}")
            return None
        try:
            os.utime(path, None)  # recency for the size cap
        except OSError:
            pass
        return lib

    def save(self, spec: LibrarySpec, built: str) -> bool:
        """Move the freshly built file ``built`` (a temporary name in the
        entry's directory) into place, write ``meta.json`` once, then
        enforce the size cap. Returns success; never raises."""
        try:
            d = self._dir(spec.kind)
            meta = os.path.join(d, "meta.json")
            if not os.path.exists(meta):
                tmp_meta = _tmp_name(meta)
                with open(tmp_meta, "w", encoding="utf-8") as f:
                    json.dump(_FP_CACHE[spec.kind][1], f, indent=2, default=str)
                os.replace(tmp_meta, meta)
            os.replace(built, self.path(spec))
        except Exception as e:
            _warn_once(
                f"program store: could not persist {spec.name} "
                f"({type(e).__name__}: {e})"
            )
            return False
        self._evict()
        return True

    def _evict(self) -> None:
        """LRU size cap over the port's entries of every fingerprint: drop
        oldest-mtime ``.so`` files of the ``torch-*`` directories until
        under ``KA_PROGRAM_STORE_MAX_MB``."""
        cap_bytes = env_int("KA_PROGRAM_STORE_MAX_MB") * (1 << 20)
        entries = []
        total = 0
        try:
            for sub in os.listdir(self.root):
                d = os.path.join(self.root, sub)
                if not sub.startswith(DIR_PREFIX) or not os.path.isdir(d):
                    continue
                for name in os.listdir(d):
                    if not name.endswith(ENTRY_SUFFIX):
                        continue
                    p = os.path.join(d, name)
                    try:
                        st = os.stat(p)
                    except OSError:  # raced away (a concurrent eviction)
                        continue
                    entries.append((st.st_mtime, st.st_size, p))
                    total += st.st_size
            if total <= cap_bytes:
                return
            evicted = 0
            for _mtime, size, p in sorted(entries):
                try:
                    os.unlink(p)
                except OSError:  # a concurrent evictor won the unlink
                    continue
                total -= size
                evicted += 1
                if total <= cap_bytes:
                    break
            if evicted:
                _warn_once(
                    "program store: size cap reached (KA_PROGRAM_STORE_MAX_MB); "
                    f"evicted {evicted} LRU entr(y/ies)"
                )
        except Exception as e:
            _warn_once(f"program store: eviction sweep failed ({e})")


_STORE_LOCK = threading.Lock()
_STORE: Optional[Tuple[str, ProgramStore]] = None


def store_enabled() -> bool:
    return env_bool("KA_PROGRAM_STORE")


def get_store() -> ProgramStore:
    """The process store (rebuilt when ``KA_PROGRAM_STORE_DIR`` changes)."""
    global _STORE
    root = env_str("KA_PROGRAM_STORE_DIR") or _DEFAULT_DIR
    with _STORE_LOCK:
        if _STORE is None or _STORE[0] != root:
            _STORE = (root, ProgramStore(root))
        return _STORE[1]


_JIT_DIR: Optional[str] = None
#: Entry paths whose broken library this process loaded and cannot unload:
#: the loader would hand back that library for the same path name.
_SHADOWED: set = set()


def _open(spec: LibrarySpec, path: Path):
    """``spec.open`` on ``path``; a path this process already holds a
    broken library under is opened through a fresh link name."""
    if str(path) not in _SHADOWED:
        return spec.open(str(path))
    link = _tmp_name(path)
    os.link(path, link)
    try:
        return spec.open(link)
    finally:
        os.unlink(link)


def _open_built(spec: LibrarySpec, path: Path):
    """``_open`` on a library this process built or placed (a fresh build,
    or the per-process directory with the store off). A failure is
    ``spec.error``, remembered for the load-only path, and the file goes,
    so a later build or process starts clean: a codec that compiles but
    does not import leaves its entry point on the numpy codec, as a codec
    that does not compile does."""
    try:
        return _open(spec, path)
    except Exception as e:
        if not isinstance(e, OSError):
            _SHADOWED.add(str(path))
        try:
            path.unlink()
        except OSError:
            pass
        err = spec.error(f"{spec.name} unusable ({type(e).__name__}: {e})")
        with _MEM_LOCK:
            _UNUSABLE[spec.key] = err
        raise err from e


def _jit_dir() -> str:
    """The per-process build directory of a process with the store off,
    removed at exit."""
    global _JIT_DIR
    with _STORE_LOCK:
        if _JIT_DIR is None:
            _JIT_DIR = tempfile.mkdtemp(prefix="ka-torch-libs-")
            atexit.register(shutil.rmtree, _JIT_DIR, True)
        return _JIT_DIR


def entry_path(spec: LibrarySpec) -> Path:
    """Where ``spec``'s library is (or would be) built: its store entry,
    or the per-process directory with the store off."""
    if store_enabled():
        return get_store().path(spec)
    return Path(_jit_dir()) / spec.filename


# --- resolution ----------------------------------------------------------------

_MEM: Dict[str, Any] = {}
_MEM_LOCK = threading.Lock()
#: Libraries this process built that failed to load: key -> the error the
#: load-only path raises while no usable build replaces them.
_UNUSABLE: Dict[str, Exception] = {}
_KEY_LOCKS: Dict[str, threading.RLock] = {}
#: Warm-up signatures made resident in this process (``solvers/warmup.py``).
_RESIDENT: set = set()


def _lock_for(key: str) -> threading.RLock:
    with _MEM_LOCK:
        lock = _KEY_LOCKS.get(key)
        if lock is None:
            lock = _KEY_LOCKS[key] = threading.RLock()
        return lock


def _start(spec: LibrarySpec, out: Path):
    exe = compiler_path(spec.compiler)
    if exe is None:
        raise spec.error(f"{spec.compiler} not found; cannot build {spec.name}")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = _tmp_name(out)
    cmd = [exe, *spec.flags, str(spec.source), "-o", tmp]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise spec.error(f"cannot run {spec.compiler}: {e}") from e
    return proc, tmp


def _finish(spec: LibrarySpec, started, timeout: float = 600.0) -> Tuple[str, str]:
    proc, tmp = started
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired as e:
        proc.kill()
        proc.communicate()
        Path(tmp).unlink(missing_ok=True)
        raise spec.error(f"{spec.compiler} timed out building {spec.name}") from e
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise spec.error(f"{spec.compiler} failed for {Path(spec.source).name}:\n{log}")
    return tmp, log


def build_many(specs: Sequence[LibrarySpec]) -> Dict[str, Optional[str]]:
    """Make every library of ``specs`` loaded and kept in memory, from the
    store where it holds the entry, else built with all compilers started
    together. Returns ``{name: compiler output}`` for the libraries built
    now and ``{name: None}`` for the others. Raises ``spec.error`` when a
    build fails."""
    return _build(specs)[0]


def _build(specs: Sequence[LibrarySpec]) -> Tuple[Dict[str, Optional[str]], Dict[str, Any]]:
    """:func:`build_many`, also returning ``{key: loaded library}``."""
    from ..obs.metrics import counter_add, hist_observe

    specs = sorted(specs, key=lambda s: s.key)
    locks = [_lock_for(s.key) for s in specs]
    for lock in locks:
        lock.acquire()
    try:
        logs: Dict[str, Optional[str]] = {}
        libs: Dict[str, Any] = {}
        todo: List[Tuple[LibrarySpec, Path]] = []
        enabled = store_enabled()
        store = get_store() if enabled else None
        for spec in specs:
            logs[spec.name] = None
            with _MEM_LOCK:
                lib = _MEM.get(spec.key)
            if lib is None:
                lib = _load_only(spec, missing_ok=True)
            libs[spec.key] = lib
            if lib is None:
                if enabled:
                    counter_add("compile.store.misses")
                todo.append((spec, entry_path(spec)))
        t0 = time.perf_counter()
        started = []
        try:
            for spec, out in todo:
                started.append((spec, out, _start(spec, out)))
        except BaseException:
            for _, _, (proc, tmp) in started:
                proc.kill()
                proc.communicate()
                Path(tmp).unlink(missing_ok=True)
            raise
        first_error = None
        for spec, out, st in started:
            try:
                tmp, logs[spec.name] = _finish(spec, st)
            except Exception as e:
                first_error = first_error or e
                continue
            if enabled:
                hist_observe("compile.store.compiles_ms", (time.perf_counter() - t0) * 1e3)
                if not store.save(spec, tmp):
                    Path(tmp).unlink(missing_ok=True)
                    first_error = first_error or spec.error(
                        f"could not install {spec.name} into the store")
                    continue
            else:
                os.replace(tmp, out)
            try:
                lib = libs[spec.key] = _open_built(spec, out)
            except Exception as e:
                first_error = first_error or e
                continue
            with _MEM_LOCK:
                _MEM[spec.key] = lib
        if first_error is not None:
            raise first_error
        return logs, libs
    finally:
        for lock in reversed(locks):
            lock.release()


def library(spec: LibrarySpec, build: bool = True):
    """The loaded library of ``spec``: from memory, else from the store,
    else built now (``build=False`` raises ``spec.error`` "not built"
    instead of compiling: the load-only path). Thread-safe per entry."""
    with _MEM_LOCK:
        lib = _MEM.get(spec.key)
    if lib is not None:
        return lib
    with _lock_for(spec.key):
        if build:
            return _build([spec])[1][spec.key]
        with _MEM_LOCK:
            lib = _MEM.get(spec.key)
        return lib if lib is not None else _load_only(spec)


def _load_only(spec: LibrarySpec, missing_ok: bool = False):
    """Load ``spec``'s built library into memory (a store hit, or the
    per-process directory with the store off). A library that is not built
    returns None under ``missing_ok``, else raises ``spec.error``."""
    from ..obs.metrics import counter_add, hist_observe

    t0 = time.perf_counter()
    if store_enabled():
        lib = get_store().load(spec)
        if lib is not None:
            counter_add("compile.store.hits")
            hist_observe("compile.store.loads_ms", (time.perf_counter() - t0) * 1e3)
    else:
        out = entry_path(spec)
        lib = _open_built(spec, out) if out.exists() else None
    if lib is None:
        if missing_ok:
            return None
        with _MEM_LOCK:
            unusable = _UNUSABLE.get(spec.key)
        raise unusable or spec.error(
            f"{spec.name} library not built; its entry point builds it at "
            "startup (the solve path never compiles)"
        )
    with _MEM_LOCK:
        _MEM[spec.key] = lib
        _UNUSABLE.pop(spec.key, None)
    return lib


def ensure_built(spec: LibrarySpec) -> bool:
    """Make ``spec``'s library loaded and kept in memory. Returns True when
    a compile ran."""
    return build_many([spec])[spec.name] is not None


def resident(sig: Any) -> bool:
    with _MEM_LOCK:
        return sig in _RESIDENT


def mark_resident(sig: Any) -> None:
    with _MEM_LOCK:
        _RESIDENT.add(sig)


def clear_memory() -> None:
    """Forget every library loaded and every signature warmed in this
    process (NOT the on-disk store): the next resolution goes to the store
    again. Tests use it as a fresh process's stand-in."""
    with _MEM_LOCK:
        _MEM.clear()
        _RESIDENT.clear()
        _UNUSABLE.clear()
