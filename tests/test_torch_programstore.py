"""The port's library store (``kafka_assigner_tpu_torch/utils/programstore.py``),
the cases of ``tests/test_programstore.py`` where they apply to a store of
built libraries instead of serialized executables, on libraries that
``gcc`` builds here: a one-function C source, and the port's own native
libraries. Round trip and hit, distinct entries, a fingerprint mismatch, a
source edit, a truncated library and one that lacks a symbol, concurrent
writers in threads and in processes, the one build a racing solve waits
for, the size cap beside the reference's entries, the store off, and the
CLI and solver through the store. ``cuda``-marked cases build, load and
launch the leadership kernel through the store on the card."""
from __future__ import annotations

import ctypes
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from kafka_assigner_tpu_torch import cli
from kafka_assigner_tpu_torch.generator import join_warmup_threads
from kafka_assigner_tpu_torch.obs import run_capture
from kafka_assigner_tpu_torch.solvers.base import Context
from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver
from kafka_assigner_tpu_torch.utils import programstore
from kafka_assigner_tpu_torch.utils.programstore import LibrarySpec

ROOT = Path(__file__).resolve().parent.parent
TOY_C = "int ka_toy(int x) { return x * %d + 1; }\n"
FLAGS = ("-O2", "-shared", "-fPIC")


@pytest.fixture(autouse=True)
def _fresh_store(tmp_path, monkeypatch):
    """Every test gets its own store directory, empty in-memory caches and
    no warm-up thread left over."""
    monkeypatch.setenv("KA_PROGRAM_STORE_DIR", str(tmp_path / "store"))
    monkeypatch.setenv("KA_PROGRAM_STORE", "1")
    monkeypatch.delenv("KA_PROGRAM_STORE_MAX_MB", raising=False)
    join_warmup_threads()
    programstore.clear_memory()
    programstore._reset_fingerprint_cache()
    yield
    join_warmup_threads()
    programstore.clear_memory()
    programstore._reset_fingerprint_cache()


_WRITER = r"""
import ctypes, os, sys
from pathlib import Path
os.environ["KA_PROGRAM_STORE_DIR"] = sys.argv[1]
from kafka_assigner_tpu_torch.utils import programstore
spec = programstore.LibrarySpec(
    name="toy", kind="host", source=Path(sys.argv[2]), compiler="gcc",
    flags=("-O2", "-shared", "-fPIC"),
    symbols=(("ka_toy", ctypes.c_int, [ctypes.c_int]),))
assert programstore.library(spec).ka_toy(4) == 13
print("loaded")
"""


def _toy(tmp_path, factor=3, name="toy", flags=FLAGS, symbols=None) -> LibrarySpec:
    src = tmp_path / f"{name}_{factor}.c"
    src.write_text(TOY_C % factor)
    return LibrarySpec(
        name=name, kind="host", source=src, compiler="gcc", flags=flags,
        symbols=symbols or (("ka_toy", ctypes.c_int, [ctypes.c_int]),),
    )


def _entries(tmp_path):
    root = tmp_path / "store"
    return sorted(root.rglob("*.so")) if root.exists() else []


# --- store lifecycle -----------------------------------------------------------

def test_round_trip_is_byte_identical_and_hits(tmp_path):
    spec = _toy(tmp_path)
    with run_capture() as cold:
        r1 = programstore.library(spec).ka_toy(7)
    assert cold.counters.get("compile.store.misses") == 1
    assert "compile.store.compiles_ms" in cold.hists
    (entry,) = _entries(tmp_path)
    assert entry.parent.name.startswith("torch-") and entry.name.startswith("toy-")
    assert json.loads((entry.parent / "meta.json").read_text())["toolchain"] == "host"

    programstore.clear_memory()  # a fresh process's view
    with run_capture() as warm:
        r2 = programstore.library(spec).ka_toy(7)
    assert warm.counters.get("compile.store.hits") == 1
    assert not warm.counters.get("compile.store.misses")
    assert "compile.store.loads_ms" in warm.hists
    assert r1 == r2 == 22
    with run_capture() as resident:
        programstore.library(spec)
    assert not resident.counters  # in memory: no store traffic


def test_distinct_sources_get_distinct_entries(tmp_path):
    programstore.library(_toy(tmp_path, 3))
    programstore.library(_toy(tmp_path, 4))                    # another source
    programstore.library(_toy(tmp_path, 3, flags=FLAGS + ("-g",)))  # another command
    assert len(_entries(tmp_path)) == 3
    assert programstore.library(_toy(tmp_path, 4)).ka_toy(2) == 9


def test_fingerprint_mismatch_is_a_clean_miss(tmp_path, monkeypatch):
    spec = _toy(tmp_path)
    programstore.library(spec)
    # Another compatibility class (a torch, compiler or device change): the
    # old entry must not load.
    monkeypatch.setattr(programstore, "STORE_SCHEMA_VERSION", 999)
    programstore._reset_fingerprint_cache()
    programstore.clear_memory()
    with run_capture() as run:
        assert programstore.library(spec).ka_toy(1) == 4
    assert run.counters.get("compile.store.misses") == 1
    assert not run.counters.get("compile.store.hits")
    fp_dirs = [p for p in (tmp_path / "store").iterdir()
               if p.is_dir() and p.name != programstore.TOOLS_DIR]
    assert len(fp_dirs) == 2


def test_source_edit_rekeys_immediately(tmp_path):
    """The port's counterpart of the reference's trace-time knob re-key:
    what keys an entry is read per resolution, so an edited source is a new
    entry in the same process and the old one is never loaded for it."""
    spec = _toy(tmp_path)
    programstore.library(spec)
    (tmp_path / "edited.c").write_text(TOY_C % 5)
    edited = dataclasses.replace(spec, source=tmp_path / "edited.c")
    with run_capture() as run:
        assert programstore.library(edited).ka_toy(1) == 6
    assert run.counters.get("compile.store.misses") == 1
    assert len(_entries(tmp_path)) == 2
    with run_capture() as run:
        assert programstore.library(spec).ka_toy(1) == 4  # original, in memory
    assert not run.counters


def _build_elsewhere(tmp_path, spec):
    """Build ``spec`` into the test's store from another process: a library
    this process has loaded stays mapped under its path, so a corruption on
    disk is only seen by a process that has not loaded it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _WRITER, str(tmp_path / "store"),
                           str(spec.source)], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (entry,) = _entries(tmp_path)
    return entry


def _replace_file(path: Path, data: bytes) -> None:
    """Write ``data`` at ``path`` as a new file (a new inode, as a copy or a
    rebuild from another process would leave it)."""
    tmp = path.with_name(path.name + ".new")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def test_truncated_library_is_dropped_and_rebuilt(tmp_path, capsys):
    spec = _toy(tmp_path)
    entry = _build_elsewhere(tmp_path, spec)
    _replace_file(entry, entry.read_bytes()[:100])
    with run_capture() as run:
        assert programstore.library(spec).ka_toy(2) == 7
    assert run.counters.get("compile.store.exec_fallbacks") == 1
    assert run.counters.get("compile.store.misses") == 1
    assert "dropping corrupted entry" in capsys.readouterr().err
    (rebuilt,) = _entries(tmp_path)
    assert rebuilt == entry and rebuilt.stat().st_size > 100


def test_library_lacking_a_symbol_is_dropped_and_rebuilt(tmp_path, capsys):
    spec = _toy(tmp_path)
    entry = _build_elsewhere(tmp_path, spec)
    other = tmp_path / "other.c"
    other.write_text("int ka_other(void) { return 0; }\n")
    subprocess.run(["gcc", *FLAGS, str(other), "-o", str(tmp_path / "other.so")],
                   check=True)
    _replace_file(entry, (tmp_path / "other.so").read_bytes())
    with run_capture() as run:
        assert programstore.library(spec).ka_toy(0) == 1
    assert run.counters.get("compile.store.exec_fallbacks") == 1
    assert "dropping corrupted entry" in capsys.readouterr().err


def test_concurrent_writers_never_torch_the_store(tmp_path):
    spec = _toy(tmp_path)
    built = programstore.library(spec)._name
    store = programstore.get_store()
    blob = Path(built).read_bytes()
    errs = []

    def _write():
        try:
            for _ in range(5):
                tmp = programstore._tmp_name(store.path(spec))
                Path(tmp).write_bytes(blob)
                assert store.save(spec, tmp)
        except Exception as e:  # save() must never raise, let alone corrupt
            errs.append(e)

    threads = [threading.Thread(target=_write) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errs == []
    programstore.clear_memory()
    assert programstore.library(spec, build=False).ka_toy(3) == 10
    assert len(_entries(tmp_path)) == 1
    assert not list((tmp_path / "store").rglob("*.tmp.*"))


def test_racing_resolutions_build_once(tmp_path):
    """The warm-up thread and the solve reaching one library at once: one
    compiler runs, the others wait for it and load the same library."""
    spec = _toy(tmp_path)
    got, barrier = [], threading.Barrier(6)

    def _resolve():
        barrier.wait()
        got.append(programstore.library(spec))

    with run_capture() as run:
        threads = [threading.Thread(target=_resolve) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert run.counters.get("compile.store.misses") == 1
    assert not run.counters.get("compile.store.hits")
    assert len(got) == 6 and all(lib is got[0] for lib in got)




def test_concurrent_processes_leave_one_loadable_library(tmp_path):
    spec = _toy(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen([sys.executable, "-c", _WRITER, str(tmp_path / "store"),
                          str(spec.source)], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len(_entries(tmp_path)) == 1
    assert not list((tmp_path / "store").rglob("*.tmp.*"))
    assert programstore.library(spec, build=False).ka_toy(4) == 13


def test_lru_cap_evicts_oldest_and_leaves_the_references_entries(tmp_path, monkeypatch):
    from kafka_assigner_tpu.utils import programstore as jax_store

    root = tmp_path / "store"
    port_dir, ref_dir = root / "torch-somefp", root / "refp"
    port_dir.mkdir(parents=True)
    ref_dir.mkdir()
    for i, name in enumerate(["old.so", "mid.so", "new.so"]):
        p = port_dir / name
        p.write_bytes(b"x" * 600_000)
        os.utime(p, (1_000_000 + i, 1_000_000 + i))
    ref = ref_dir / "ref.exe"
    ref.write_bytes(b"y" * 900_000)
    os.utime(ref, (1, 1))  # older than every library: the LRU's first pick
    monkeypatch.setenv("KA_PROGRAM_STORE_MAX_MB", "1")
    programstore.get_store()._evict()
    left = {p.name for p in port_dir.glob("*.so")}
    assert "new.so" in left and "old.so" not in left
    assert ref.exists()
    # The reference's sweep counts only its own entries: 0.9 MB is under
    # its cap, whatever the port's libraries weigh.
    jax_store.get_store()._evict()
    assert ref.exists() and (port_dir / "new.so").exists()


def test_store_off_builds_into_a_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("KA_PROGRAM_STORE", "0")
    spec = _toy(tmp_path)
    with run_capture() as run:
        assert programstore.library(spec).ka_toy(1) == 4
    assert not run.counters and not run.hists  # no store traffic at all
    assert _entries(tmp_path) == []
    path = programstore.entry_path(spec)
    assert path.exists() and path.parent == Path(programstore._jit_dir())
    assert not str(path).startswith(str(tmp_path))


class _ToyError(RuntimeError):
    pass


@pytest.mark.parametrize("store", ["on", "off"])
def test_a_build_that_does_not_load_raises_the_specs_error(tmp_path, monkeypatch, store):
    # The source compiles but lacks a symbol of the spec: the build raises
    # the spec's own error (which entry points catch), the file goes, and
    # the load-only path raises the same error instead of "not built".
    monkeypatch.setenv("KA_PROGRAM_STORE", "1" if store == "on" else "0")
    spec = dataclasses.replace(
        _toy(tmp_path, symbols=(("ka_missing", ctypes.c_int, [ctypes.c_int]),)),
        error=_ToyError)
    with pytest.raises(_ToyError, match="toy unusable"):
        programstore.library(spec)
    assert not programstore.entry_path(spec).exists()
    assert _entries(tmp_path) == []
    with pytest.raises(_ToyError, match="toy unusable"):
        programstore.library(spec, build=False)
    good = dataclasses.replace(spec, symbols=(("ka_toy", ctypes.c_int, [ctypes.c_int]),))
    assert programstore.library(good).ka_toy(1) == 4  # a usable build still works


def _count_probes(monkeypatch):
    calls = []
    real = programstore.subprocess.run

    def counting(cmd, *a, **k):
        calls.append(cmd)
        return real(cmd, *a, **k)

    monkeypatch.setattr(programstore.subprocess, "run", counting)
    return calls


def test_compiler_versions_are_kept_so_a_loading_process_runs_none(tmp_path, monkeypatch):
    calls = _count_probes(monkeypatch)
    first = programstore.fingerprint("host")
    assert len(calls) == 2  # gcc and g++, once
    kept = list((tmp_path / "store" / programstore.TOOLS_DIR).glob("*.txt"))
    assert sorted(p.name.split("-")[0] for p in kept) == ["g++", "gcc"]
    programstore._reset_fingerprint_cache()  # a fresh process's view
    assert programstore.fingerprint("host") == first
    assert len(calls) == 2  # read back, no compiler run
    # A replaced compiler (another size, mtime or inode) is asked again.
    fake = tmp_path / "bin" / "gcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'gcc (fake) 0.1'\n")
    fake.chmod(0o755)
    monkeypatch.setattr(programstore, "compiler_path",
                        lambda c: str(fake) if c == "gcc" else shutil.which(c))
    assert programstore._tool_version("gcc") == "gcc (fake) 0.1"
    assert len(calls) == 3
    # With the store off nothing is kept and every process asks.
    monkeypatch.setenv("KA_PROGRAM_STORE", "0")
    assert programstore._tool_version("gcc") == "gcc (fake) 0.1"
    assert len(calls) == 4


def test_unbucketed_is_declared_and_never_counts(tmp_path):
    """No entry of the port's store is per shape: the reference's
    ``compile.store.unbucketed`` stays declared and is never written."""
    from kafka_assigner_tpu_torch.obs import names

    assert "compile.store.unbucketed" in names.METRIC_NAMES
    pkg = ROOT / "kafka_assigner_tpu_torch"
    assert not any('"compile.store.unbucketed")' in p.read_text()
                   for p in pkg.rglob("*.py"))


# --- the port's own libraries and the solver through the store -------------------

def test_native_libraries_round_trip_through_the_store(tmp_path):
    from kafka_assigner_tpu_torch.native import build as nbuild

    with run_capture() as cold:
        assert nbuild.prebuild_native_libraries(err=io.StringIO()) is True
    assert cold.counters.get("compile.store.misses") == 2
    assert {p.name.split("-")[0] for p in _entries(tmp_path)} == {"greedy", "hostcodec"}
    programstore.clear_memory()
    with run_capture() as warm:
        assert nbuild.build_native_library() is False
        assert nbuild.build_hostcodec() is False
    assert warm.counters.get("compile.store.hits") == 2
    assert nbuild.load_hostcodec().scan_dims([{0: [1, 2]}]) == (1, 2)


def _cluster():
    racks = {100 + i: f"r{i % 3}" for i in range(6)}
    topics = [
        (f"t{i}", {p: [100 + (p + i + r) % 6 for r in range(3)] for p in range(8)})
        for i in range(4)
    ]
    return topics, racks, set(racks)


def test_solver_round_trip_through_the_store():
    from kafka_assigner_tpu_torch.native import build as nbuild

    nbuild.prebuild_native_libraries()
    topics, racks, nodes = _cluster()
    out1 = TorchSolver("cpu").assign_many(topics, racks, nodes, 3, Context())
    programstore.clear_memory()  # a fresh process's stand-in
    with run_capture() as warm:
        out2 = TorchSolver("cpu").assign_many(topics, racks, nodes, 3, Context())
    assert warm.counters.get("compile.store.hits") == 1  # the codec
    assert not warm.counters.get("compile.store.misses")
    assert out1 == out2


def test_solver_output_identical_with_store_off(monkeypatch):
    from kafka_assigner_tpu_torch.native import build as nbuild

    nbuild.prebuild_native_libraries()
    topics, racks, nodes = _cluster()
    out_on = TorchSolver("cpu").assign_many(topics, racks, nodes, 3, Context())
    monkeypatch.setenv("KA_PROGRAM_STORE", "0")
    programstore.clear_memory()
    nbuild.prebuild_native_libraries()
    out_off = TorchSolver("cpu").assign_many(topics, racks, nodes, 3, Context())
    assert out_on == out_off


@pytest.fixture()
def snapshot(tmp_path):
    cluster = {
        "brokers": [
            {"id": 100 + i, "host": f"h{i}", "port": 9092, "rack": f"r{i % 3}"}
            for i in range(6)
        ],
        "topics": {
            f"topic-{t}": {str(p): [100 + (p + t + r) % 6 for r in range(3)]
                           for p in range(8)}
            for t in range(5)
        },
    }
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(cluster))
    return str(path)


def _cli(snapshot, env=None):
    """Mode 3 of the port's CLI on the CPU in a fresh process."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), **(env or {}))
    proc = subprocess.run(
        [sys.executable, "-m", "kafka_assigner_tpu_torch.cli", "--zk_string",
         f"file://{snapshot}", "--mode", "PRINT_REASSIGNMENT", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    return proc.returncode, proc.stdout


@pytest.mark.parametrize("state", ["cold", "warm", "off", "corrupted"])
def test_plan_bytes_do_not_depend_on_the_store(snapshot, tmp_path, state):
    """Mode 3's plan, each run a fresh process, with the store cold, warm,
    off and holding truncated libraries, is the bytes of the in-process run
    on a store seeded beforehand."""
    out = io.StringIO()
    assert cli.run(["--zk_string", f"file://{snapshot}", "--mode", "PRINT_REASSIGNMENT",
                    "--device", "cpu"], out=out) == 0
    base = out.getvalue()
    assert "NEW ASSIGNMENT" in base
    env = {}
    if state == "cold":
        env["KA_PROGRAM_STORE_DIR"] = str(tmp_path / "cold")
    elif state == "off":
        env["KA_PROGRAM_STORE"] = "0"
    elif state == "corrupted":
        for entry in _entries(tmp_path):
            _replace_file(entry, entry.read_bytes()[:64])
    assert _cli(snapshot, env) == (0, base)
    if state == "corrupted":
        assert all(p.stat().st_size > 64 for p in _entries(tmp_path))
    if state == "cold":
        assert len(list((tmp_path / "cold").rglob("*.so"))) == 2


# --- on the card -----------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_leadership_kernel_builds_loads_and_launches_through_the_store(cuda_device,
                                                                        tmp_path):
    from kafka_assigner_tpu_torch.carry import to_tensor
    from kafka_assigner_tpu_torch.ops import build, leadership

    with run_capture() as cold:
        lib = build.load("leadership")
    assert cold.counters.get("compile.store.misses") == 1
    assert build.lib_path("leadership").exists()
    assert build.lib_path("leadership").parent.parent == tmp_path / "store"
    programstore.clear_memory()
    with run_capture() as warm:
        assert build.load("leadership") is not None
    assert warm.counters.get("compile.store.hits") == 1
    assert lib.ka_smem_optin_limit() > 0
    rng = np.random.default_rng(0)
    acc = rng.integers(0, 12, (2, 8, 3)).astype(np.int32)
    cnt = np.full((2, 8), 3, np.int32)
    counters = np.zeros((16, 3), np.int32)
    jhs = np.array([5, 9], np.int32)
    args = [to_tensor(x, cuda_device) for x in (acc, cnt, counters, jhs)]
    before = leadership.launches["leadership"]
    o_k, c_k = leadership.leadership_order(*args)
    torch.cuda.synchronize()
    assert leadership.launches["leadership"] == before + 1
    o_p, c_p = leadership.leadership_order_plain(*args)
    assert torch.equal(o_k, o_p) and torch.equal(c_k, c_p)
