"""The port's native host layer (``kafka_assigner_tpu_torch/native/``)
against the JAX package's and against its own twins, exactly:

- the C boundary codec against the port's numpy encode and decode and
  against the JAX package's ``encode_topic_group`` /
  ``decode_assignments_batched``, on ``tests/test_hostcodec.py``'s cases
  (its group generator, and the other files' helpers, imported as they
  are);
- the host leadership pass ``order_many`` against the JAX package's and the
  port's plain version, on ``tests/test_leadership_backends.py``'s seeds and
  the kernel's stress cases, and through the solver under
  ``KA_LEADERSHIP=native`` (compat width and mixed RF included);
- the C++ and Python greedy lanes against the JAX package's;
- ``get_solver``, the build/load split, and the host logic of KG1's step
  probe.

Integers everywhere: the tolerance is exact equality. The port's libraries
are built into the library store (``build/torch-<fingerprint>/``) by a
fixture (a test is a startup site, as the CLI is); the JAX package's by the
root conftest.
"""
from __future__ import annotations

import io
import operator
import os
import random
import subprocess
import sys
from pathlib import Path
from types import MappingProxyType

import numpy as np
import pytest
import torch

from kafka_assigner_tpu.assigner import TopicAssigner as JaxAssigner
from kafka_assigner_tpu.models import problem as jax_problem
from kafka_assigner_tpu.native.build import build_hostcodec as jax_build_codec
from kafka_assigner_tpu.native.build import build_native_library as jax_build_lib
from kafka_assigner_tpu.native.leadership import order_many as jax_order_many
from kafka_assigner_tpu_torch.assigner import TopicAssigner
from kafka_assigner_tpu_torch.carry import to_numpy, to_tensor
from kafka_assigner_tpu_torch.models import problem
from kafka_assigner_tpu_torch.native import build as nbuild
from kafka_assigner_tpu_torch.native import leadership as nlead
from kafka_assigner_tpu_torch.ops import group_pack as gp
from kafka_assigner_tpu_torch.ops import group_pack_cases as gcases
from kafka_assigner_tpu_torch.ops import leadership as lead
from kafka_assigner_tpu_torch.ops.leadership_cases import stress_cases
from kafka_assigner_tpu_torch.solvers import base as sbase
from kafka_assigner_tpu_torch.solvers import torch_solver as ts
from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver
from kafka_assigner_tpu_torch.utils import programstore

from .test_hostcodec import _random_group
from .test_leadership_backends import _random_batch
from .test_torch_compat import _random_decrease_case, _solve
from .test_torch_leadership import _native_takes

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def built():
    """Both packages' libraries built, as their entry points build them."""
    nbuild.build_native_library()
    nbuild.build_hostcodec()
    jax_build_lib()
    jax_build_codec()


@pytest.fixture()
def codec_on(monkeypatch):
    # An ambient KA_HOSTCODEC=0 would make these numpy-vs-numpy.
    monkeypatch.delenv("KA_HOSTCODEC", raising=False)
    assert problem._hostcodec() is not None


# --- the boundary codec ----------------------------------------------------


def _encode_three(monkeypatch, topics, racks, brokers, rf):
    """Port codec, port numpy and JAX (its default, the JAX codec)."""
    out_c = problem.encode_topic_group(topics, racks, brokers, rf)
    assert problem.last_codec["encode"] == "c"
    monkeypatch.setenv("KA_HOSTCODEC", "0")
    out_np = problem.encode_topic_group(topics, racks, brokers, rf)
    assert problem.last_codec["encode"] == "numpy"
    monkeypatch.delenv("KA_HOSTCODEC")
    out_jax = jax_problem.encode_topic_group(topics, racks, brokers, rf)
    return out_c, out_np, out_jax


def _assert_encodings_equal(a, b):
    encs_a, *arrays_a = a
    encs_b, *arrays_b = b
    for x, y in zip(arrays_a, arrays_b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    assert len(encs_a) == len(encs_b)
    for ea, eb in zip(encs_a, encs_b):
        for field in ("topic", "p", "jhash", "p_pad", "rf", "n", "n_pad", "r_cap"):
            assert getattr(ea, field) == getattr(eb, field), field
        for field in ("partition_ids", "current", "broker_ids", "rack_idx"):
            np.testing.assert_array_equal(getattr(ea, field), getattr(eb, field))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_encode_matches_numpy_and_jax(monkeypatch, codec_on, seed, ragged):
    rng = random.Random(seed)
    brokers = set(range(10, 40))
    racks = {b: f"r{b % 4}" for b in brokers}
    topics = _random_group(rng, 9, 12, brokers, ragged=ragged)
    out_c, out_np, out_jax = _encode_three(monkeypatch, topics, racks, brokers, 3)
    _assert_encodings_equal(out_c, out_np)
    _assert_encodings_equal(out_c, out_jax)


def test_codec_encode_mixed_rf_matches(monkeypatch, codec_on):
    rng = random.Random(7)
    brokers = set(range(1, 30))
    racks = {b: f"r{b % 5}" for b in brokers}
    topics = _random_group(rng, 5, 20, brokers)
    rfs = [3, 2, 3, 1, 2]
    out_c, out_np, out_jax = _encode_three(monkeypatch, topics, racks, brokers, rfs)
    _assert_encodings_equal(out_c, out_np)
    _assert_encodings_equal(out_c, out_jax)


def _ordered_with_holes(rng, encs, rf):
    """Complete, partial and empty rows, as ``tests/test_hostcodec.py``."""
    ordered = np.full((len(encs), encs[0].p_pad, rf), -1, dtype=np.int32)
    n = encs[0].n
    for i, e in enumerate(encs):
        for row in range(e.p):
            kind = rng.randint(0, 3)
            if kind == 0:
                continue
            picks = rng.sample(range(n), rf if kind > 1 else rf - 1)
            ordered[i, row, : len(picks)] = picks
    return ordered


@pytest.mark.parametrize("seed", [3, 4])
def test_codec_decode_matches_numpy_and_jax(monkeypatch, codec_on, seed):
    rng = random.Random(seed)
    brokers = set(range(1, 25))
    racks = {b: f"r{b % 5}" for b in brokers}
    topics = _random_group(rng, 7, 10, brokers)
    encs, _, _, _ = problem.encode_topic_group(topics, racks, brokers, 3)
    jencs, _, _, _ = jax_problem.encode_topic_group(topics, racks, brokers, 3)
    ordered = _ordered_with_holes(rng, encs, 3)
    out_c = problem.decode_assignments_batched(encs, ordered)
    assert problem.last_codec["decode"] == "c"
    out_jax = jax_problem.decode_assignments_batched(jencs, ordered)
    monkeypatch.setenv("KA_HOSTCODEC", "0")
    out_np = problem.decode_assignments_batched(encs, ordered)
    assert problem.last_codec["decode"] == "numpy"
    assert out_c == out_np == out_jax
    assert [list(d) for d in out_c] == [list(d) for d in out_np]  # key order


def test_codec_decode_compat_width_and_mixed_rf(monkeypatch, codec_on):
    # The solver's compat decode hands the encodings at rf = width; a
    # mixed-RF batch leaves a narrow topic's trailing slots -1. The codec
    # skips -1 slots where numpy slices by rf: the same lists either way.
    import dataclasses

    rng = random.Random(11)
    brokers = set(range(1, 40))
    racks = {b: f"r{b % 5}" for b in brokers}
    topics = _random_group(rng, 4, 16, brokers)
    encs, _, _, _ = problem.encode_topic_group(topics, racks, brokers, [4, 2, 3, 4])
    ordered = np.full((len(encs), encs[0].p_pad, 4), -1, np.int32)
    for i, e in enumerate(encs):
        for row in range(e.p):
            width = rng.randint(e.rf - 1, 4) if e.rf == 4 else e.rf
            ordered[i, row, :width] = rng.sample(range(encs[0].n), width)
    wide = [dataclasses.replace(e, rf=4) for e in encs]
    got = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("KA_HOSTCODEC", flag)
        got[flag] = (problem.decode_assignments_batched(wide, ordered),
                     problem.decode_assignments_batched(encs, ordered))
    assert got["1"] == got["0"]


def test_codec_numpy_int_keys_and_values(monkeypatch, codec_on):
    brokers = set(range(1, 9))
    racks = {b: "r1" for b in brokers}
    cur = {np.int64(3): [np.int64(1), np.int64(2)], np.int64(0): [3, 4]}
    out_c, out_np, out_jax = _encode_three(monkeypatch, [("t", cur)], racks, brokers, 2)
    _assert_encodings_equal(out_c, out_np)
    _assert_encodings_equal(out_c, out_jax)


def test_non_dict_mapping_takes_the_numpy_path(monkeypatch, codec_on):
    brokers = set(range(1, 9))
    racks = {b: f"r{b % 3}" for b in brokers}
    cur = MappingProxyType({0: [1, 2], 1: [2, 3]})
    out = problem.encode_topic_group([("t", cur)], racks, brokers, 2)
    assert problem.last_codec["encode"] == "numpy"
    ref = jax_problem.encode_topic_group([("t", dict(cur))], racks, brokers, 2)
    _assert_encodings_equal(out, ref)


def test_codec_error_paths_match_the_jax_codec():
    from kafka_assigner_tpu.native.build import load_hostcodec as jax_load

    codecs = (nbuild.load_hostcodec(), jax_load())
    assert codecs[0].__name__ == "ka_hostcodec_torch"
    brokers = np.arange(4, dtype=np.int64)
    calls = [
        ("scan_dims", ("not a list",)),
        ("scan_dims", ([1],)),
        # a replica list longer than the width; more partitions than p_pad
        # (a non-int replica entry: the next test)
        ("encode_rows", ([{0: [1, 2, 3]}],)),
        ("encode_rows", ([{0: [1], 1: [2], 2: [3]}],)),
        # p_reals out of range, either way; a broker index past the table
        ("decode_rows", (np.array([1000000], np.int32),)),
        ("decode_rows", (np.array([-1], np.int32),)),
        ("decode_rows", (np.array([2], np.int32), [0, 4])),
    ]
    for name, args in calls:
        raised = []
        for codec in codecs:
            if name == "encode_rows":
                cur = np.full((1, 2, 2), -1, np.int32)
                full = (args[0], brokers, cur, np.zeros(1, np.int32),
                        np.full((1, 2), -1, np.int64))
            elif name == "decode_rows":
                ordered = np.full((1, 2, 2), -1, np.int32) if len(args) > 1 \
                    else np.zeros((1, 2, 2), np.int32)
                if len(args) > 1:
                    ordered[0, 0] = args[1]
                full = (ordered, brokers, np.zeros((1, 2), np.int64), args[0], 1)
            else:
                full = args
            with pytest.raises((TypeError, ValueError)) as e:
                getattr(codec, name)(*full)
            raised.append((type(e.value), str(e.value)))
        assert raised[0] == raised[1], (name, raised)


@pytest.mark.parametrize("bad,exc", [("x", TypeError), (2**70, OverflowError)])
def test_codec_bad_replica_entry_raises_and_keeps_the_list(bad, exc):
    # A replica entry that is not an int64 raises Python's own conversion
    # error, and the caller's replica list keeps its references. (The JAX
    # package's codec releases the list twice on this path, so it is not
    # called here: ROADMAP.md section 3.)
    codec = nbuild.load_hostcodec()
    replicas = [1, bad]
    cur = {0: replicas}
    refs = sys.getrefcount(replicas)
    with pytest.raises(exc) as want:
        operator.index(bad) if exc is TypeError else np.int64(bad)
    for _ in range(3):
        with pytest.raises(exc) as got:
            codec.encode_rows([cur], np.arange(4, dtype=np.int64),
                              np.full((1, 2, 2), -1, np.int32), np.zeros(1, np.int32),
                              np.full((1, 2), -1, np.int64))
        if exc is TypeError:
            assert str(got.value) == str(want.value)
    assert sys.getrefcount(replicas) == refs
    assert cur[0] is replicas and replicas == [1, bad]


def test_codec_off_and_unbuilt_take_numpy(monkeypatch, tmp_path):
    monkeypatch.setenv("KA_HOSTCODEC", "0")
    assert problem._hostcodec() is None
    monkeypatch.delenv("KA_HOSTCODEC")
    # An empty store and nothing loaded in this process: the codec is not
    # built, and the load-only path never compiles it.
    monkeypatch.setenv("KA_PROGRAM_STORE_DIR", str(tmp_path / "empty"))
    programstore.clear_memory()
    try:
        assert problem._hostcodec() is None
        assert not nbuild.codec_lib_path().exists()
        problem.encode_topic_group([("t", {0: [1, 2]})], {}, {1, 2}, 2)
        assert problem.last_codec["encode"] == "numpy"
    finally:
        programstore.clear_memory()


def test_prebuild_warns_once_when_the_codec_cannot_build(monkeypatch, tmp_path):
    monkeypatch.delenv("KA_HOSTCODEC", raising=False)
    bad = tmp_path / "hostcodec.c"
    bad.write_text("#error no codec here\n")
    monkeypatch.setattr(nbuild, "CODEC_SRC", bad)
    monkeypatch.setenv("KA_PROGRAM_STORE_DIR", str(tmp_path / "out"))
    err = io.StringIO()
    assert nbuild.prebuild_native_libraries(err=err) is False
    assert err.getvalue().count("hostcodec unavailable") == 1
    assert "using the numpy boundary codec" in err.getvalue()
    monkeypatch.setenv("KA_HOSTCODEC", "0")
    assert nbuild.prebuild_native_libraries(err=err) is False  # no build tried


def _snapshot_json(tmp_path) -> str:
    import json

    cluster = {
        "brokers": [{"id": 10 + i, "host": f"h{i}", "port": 9092, "rack": f"r{i % 3}"}
                    for i in range(6)],
        "topics": {f"t{t}": {str(p): [10 + (p + t + r) % 6 for r in range(3)]
                             for p in range(5)} for t in range(4)},
    }
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(cluster))
    return f"file://{path}"


@pytest.mark.parametrize("store", ["on", "off"])
def test_a_codec_that_builds_but_does_not_import_leaves_numpy(monkeypatch, tmp_path,
                                                             capsys, store):
    # The codec compiles, but the file is no extension module: every entry
    # point warns and runs on the numpy codec, byte-identically.
    from kafka_assigner_tpu_torch import cli

    zk = _snapshot_json(tmp_path)
    argv = ["--zk_string", zk, "--mode", "PRINT_REASSIGNMENT", "--device", "cpu"]
    monkeypatch.setenv("KA_HOSTCODEC", "0")
    want = io.StringIO()
    assert cli.run(argv, out=want) == 0
    monkeypatch.delenv("KA_HOSTCODEC")
    monkeypatch.setenv("KA_PROGRAM_STORE", "1" if store == "on" else "0")
    bad = tmp_path / "hostcodec.c"
    bad.write_text("int ka_not_a_module(void) { return 0; }\n")
    monkeypatch.setattr(nbuild, "CODEC_SRC", bad)
    capsys.readouterr()
    try:
        err = io.StringIO()
        assert nbuild.prebuild_native_libraries(err=err) is False
        assert "hostcodec unavailable" in err.getvalue()
        assert "unusable" in err.getvalue()
        assert not nbuild.codec_lib_path().exists()  # the broken file went
        with pytest.raises(nbuild.NativeBuildError, match="unusable"):
            nbuild.load_hostcodec()
        assert problem._hostcodec() is None
        got = io.StringIO()
        assert cli.run(argv, out=got) == 0
        assert got.getvalue() == want.getvalue()
        assert problem.last_codec["encode"] == "numpy"
        assert "using the numpy boundary codec" in capsys.readouterr().err
    finally:
        programstore.clear_memory()


def test_a_greedy_library_without_its_symbols_fails_only_where_asked(monkeypatch,
                                                                    tmp_path):
    bad = tmp_path / "greedy.cpp"
    bad.write_text('extern "C" int ka_solve_topic() { return 0; }\n')
    monkeypatch.setattr(nbuild, "GREEDY_SRC", bad)
    try:
        nbuild.prebuild_native_libraries(err=io.StringIO())  # does not raise
        assert not nbuild.greedy_lib_path().exists()
        with pytest.raises(nbuild.NativeBuildError, match="unusable"):
            nbuild.load_native_library()
    finally:
        programstore.clear_memory()


def test_library_names_carry_a_content_hash(monkeypatch, tmp_path):
    # An edited source gets a new name: a stale library is never loaded.
    first = nbuild.greedy_lib_path()
    assert first.parent == Path(programstore.get_store()._dir("host")) and first.exists()
    src = tmp_path / "greedy.cpp"
    src.write_bytes(nbuild.GREEDY_SRC.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(nbuild, "GREEDY_SRC", src)
    assert nbuild.greedy_lib_path() != first
    assert nbuild.greedy_lib_path().stem.startswith("greedy-")


def test_every_library_source_ships_as_package_data():
    # An installed port builds its libraries from the sources the wheel
    # carries: each LibrarySpec's source must match a package-data glob of
    # its own package (pyproject.toml; no wheel is built here).
    import fnmatch
    import tomllib

    from kafka_assigner_tpu_torch.ops import build as obuild

    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    specs = [obuild.spec(n) for n in obuild.SIGNATURES]
    specs += [nbuild.greedy_spec(), nbuild.codec_spec()]
    assert {s.source.name for s in specs} == {
        "leadership.cu", "group_pack.cu", "greedy.cpp", "hostcodec.c"}
    for s in specs:
        rel = Path(s.source).resolve().relative_to(ROOT)
        assert (ROOT / rel).exists(), rel
        shipped = [
            pkg for pkg, globs in data.items()
            if rel.parts[:len(pkg.split("."))] == tuple(pkg.split("."))
            and any(fnmatch.fnmatch(Path(*rel.parts[len(pkg.split(".")):]).as_posix(), g)
                    for g in globs)
        ]
        assert shipped, f"{rel} matches no package-data glob"


def test_missing_native_sources_warn_and_leave_the_other_modes(monkeypatch, tmp_path,
                                                              capsys):
    # A port installed without its native sources: the codec warns the
    # reference's line and falls back to numpy, PRINT_CURRENT_BROKERS and
    # mode 3 on the device solver exit 0, and only --solver native fails.
    from kafka_assigner_tpu_torch import cli

    zk = _snapshot_json(tmp_path)
    mode3 = ["--zk_string", zk, "--mode", "PRINT_REASSIGNMENT", "--device", "cpu"]
    monkeypatch.setenv("KA_HOSTCODEC", "0")
    want = io.StringIO()
    assert cli.run(mode3, out=want) == 0
    monkeypatch.delenv("KA_HOSTCODEC")
    monkeypatch.setenv("KA_PROGRAM_STORE_DIR", str(tmp_path / "store"))
    monkeypatch.setattr(nbuild, "GREEDY_SRC", tmp_path / "gone" / "greedy.cpp")
    monkeypatch.setattr(nbuild, "CODEC_SRC", tmp_path / "gone" / "hostcodec.c")
    programstore.clear_memory()
    capsys.readouterr()
    try:
        err = io.StringIO()
        assert nbuild.prebuild_native_libraries(err=err) is False
        assert err.getvalue().startswith("kafka-assigner: hostcodec unavailable (cannot "
                                         "read the hostcodec source: ")
        assert err.getvalue().endswith("; using the numpy boundary codec\n")
        with pytest.raises(nbuild.NativeBuildError, match="cannot read the greedy source"):
            nbuild.load_native_library()
        brokers = io.StringIO()
        assert cli.run(["--zk_string", zk, "--mode", "PRINT_CURRENT_BROKERS"],
                       out=brokers) == 0
        assert brokers.getvalue().count("\n") >= 1
        got = io.StringIO()
        assert cli.run(mode3 + ["--solver", "device"], out=got) == 0
        assert got.getvalue() == want.getvalue()
        assert problem.last_codec["encode"] == "numpy"
        assert "using the numpy boundary codec" in capsys.readouterr().err
        with pytest.raises(NotImplementedError, match="cannot read the greedy source"):
            cli.run(mode3 + ["--solver", "native"], out=io.StringIO())
    finally:
        programstore.clear_memory()


_RACE = r"""
import os, sys
os.environ["KA_PROGRAM_STORE_DIR"] = sys.argv[1]
from kafka_assigner_tpu_torch.native import build
build.build_native_library()
build.build_hostcodec()
assert build.load_native_library() is not None
assert build.load_hostcodec().scan_dims([{0: [1, 2]}]) == (1, 2)
print("built")
"""


def test_concurrent_builds_never_load_a_partial_library(tmp_path):
    # More processes than cores race for one build directory, as the test
    # workers do: each compiles to its own temporary file and renames it
    # into place, so every one of them loads a whole library.
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen([sys.executable, "-c", _RACE, str(tmp_path)], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range((os.cpu_count() or 8) + 1)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all("built" in o for o in outs)
    tools = tmp_path / programstore.TOOLS_DIR
    (fp_dir,) = (p for p in tmp_path.iterdir() if p != tools)
    assert sorted(f.suffix for f in fp_dir.iterdir()) == [".json", ".so", ".so"]
    # The compilers' version lines, kept by the same racing writers.
    assert sorted(f.name.split("-")[0] for f in tools.iterdir()) == ["g++", "gcc"]


# --- the host leadership pass ------------------------------------------------


def _plain(acc, cnt, counters, jhashes):
    o, c = lead.leadership_order_plain(
        to_tensor(acc), to_tensor(cnt), to_tensor(counters),
        to_tensor(np.asarray(jhashes, np.int32)),
    )
    return to_numpy(o), to_numpy(c)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 9])
def test_order_many_matches_jax_and_plain(seed):
    rng = np.random.default_rng(seed)
    acc, cnt, jhashes, p_reals = _random_batch(rng, 7, 24, 16, 3)
    counters = rng.integers(0, 6, (16, 3)).astype(np.int32)
    before = counters.copy()
    got_o, got_c = nlead.order_many(acc, cnt, jhashes, p_reals, counters)
    np.testing.assert_array_equal(counters, before)  # not mutated
    ref_o, ref_c = jax_order_many(acc, cnt, jhashes, p_reals, counters)
    np.testing.assert_array_equal(got_o, ref_o)
    np.testing.assert_array_equal(got_c, ref_c)
    pl_o, pl_c = _plain(acc, cnt, counters, jhashes)
    np.testing.assert_array_equal(got_o, pl_o)
    np.testing.assert_array_equal(got_c, pl_c)


STRESS = {case[0]: case for case in stress_cases()
          if _native_takes(case[1], case[2], case[3].shape[0])}


@pytest.mark.parametrize("name", list(STRESS))
def test_order_many_on_the_kernel_stress_cases(name):
    # The kernel's stress cases (chip_smoke.py phase 3) the host pass takes:
    # RF 1-32 (the compat widths), same brokers, mixed RF, P=1, long topics.
    _, acc, cnt, counters, jhs, _ = STRESS[name]
    b, p, _ = acc.shape
    p_reals = np.full(b, p, np.int32)
    got_o, got_c = nlead.order_many(acc, cnt, jhs.astype(np.int64), p_reals, counters)
    ref_o, ref_c = jax_order_many(acc, cnt, jhs.astype(np.int64), p_reals, counters)
    np.testing.assert_array_equal(got_o, ref_o)
    np.testing.assert_array_equal(got_c, ref_c)
    if b * p <= 1000:  # the plain version walks rows one by one
        pl_o, pl_c = _plain(acc, cnt, counters, jhs)
        np.testing.assert_array_equal(got_o, pl_o)
        np.testing.assert_array_equal(got_c, pl_c)


def test_order_many_rejects_mismatched_shapes():
    acc = np.zeros((2, 8, 3), np.int32)
    with pytest.raises(ValueError, match="counters"):
        nlead.order_many(acc, np.zeros((2, 8), np.int32), np.zeros(2), np.zeros(2),
                         np.zeros((4, 2), np.int32))
    with pytest.raises(ValueError, match="p_reals"):
        nlead.order_many(acc, np.zeros((2, 8), np.int32), np.zeros(2), np.zeros(3),
                         np.zeros((4, 3), np.int32))


def _cluster(n_brokers=24, n_racks=4):
    live = set(range(1, n_brokers + 1))
    return live, {b: f"r{b % n_racks}" for b in live}


def _mixed_topics():
    return [
        (f"t{i}", {p: [1 + (p + i) % 8, 1 + (p + i + 3) % 8, 1 + (p + i + 5) % 8][:rf]
                   for p in range(6 + i)})
        for i, rf in enumerate((3, 2, 3, 1, 2))
    ]


@pytest.mark.parametrize("lane", ["native", "device", "auto"])
@pytest.mark.parametrize("codec", ["1", "0"])
def test_solver_lanes_match_jax_tpu(monkeypatch, lane, codec):
    # A mixed-RF batch with replaced brokers, through both lanes and both
    # codecs, against the JAX solver on its default lane.
    monkeypatch.setenv("KA_HOSTCODEC", codec)
    monkeypatch.setenv("KA_LEADERSHIP", lane)
    live, racks = _cluster()
    live -= {2, 5}
    topics = _mixed_topics()
    assigner = TopicAssigner(device="cpu")
    got = assigner.generate_assignments(topics, live, racks)
    monkeypatch.delenv("KA_LEADERSHIP")
    monkeypatch.delenv("KA_HOSTCODEC")
    ja = JaxAssigner("tpu")
    assert got == ja.generate_assignments(topics, live, racks)
    assert assigner.context.counter == ja.context.counter
    solver = assigner.solver
    assert solver.last_leadership == ("native" if lane == "native" else "plain")
    route = "c" if codec == "1" else "numpy"
    assert solver.last_codec == {"encode": route, "decode": route}


@pytest.mark.parametrize("lane", ["native", "device"])
@pytest.mark.parametrize("seed", range(4))
def test_lanes_at_the_compat_width_match_jax(monkeypatch, seed, lane):
    # An RF decrease under KA_RF_DECREASE_COMPAT: the counter slab and the
    # ordering run as wide as the current lists on either lane.
    monkeypatch.setenv("KA_RF_DECREASE_COMPAT", "1")
    case = _random_decrease_case(random.Random(100 + seed))
    ref = _solve(JaxAssigner("tpu"), *case)
    monkeypatch.setenv("KA_LEADERSHIP", lane)
    assigner = TopicAssigner(device="cpu")
    assert _solve(assigner, *case) == ref
    if ref[1] is None:
        assert assigner.solver.last_leadership == ("native" if lane == "native" else "plain")


def test_native_lane_fresh_and_single_topic_match_jax(monkeypatch):
    monkeypatch.setenv("KA_LEADERSHIP", "native")
    live, racks = _cluster(20, 5)
    solver = TorchSolver("cpu")
    got = solver.fresh_assignment("fresh", 60, live, racks, 3)
    assert solver.last_leadership == "native"
    assert solver.last_codec == {"encode": "numpy", "decode": "c"}
    from kafka_assigner_tpu.solvers.tpu import TpuSolver

    assert got == TpuSolver().fresh_assignment("fresh", 60, live, racks, 3)
    cur = {p: [1 + p % 20, 1 + (p + 7) % 20] for p in range(12)}
    one = TopicAssigner(device="cpu").generate_assignment("one", cur, live, racks)
    assert one == JaxAssigner("tpu").generate_assignment("one", cur, live, racks)


def test_native_lane_without_its_library_raises_and_never_orders(monkeypatch, tmp_path):
    monkeypatch.setenv("KA_LEADERSHIP", "native")
    # An empty store and nothing loaded in this process.
    monkeypatch.setenv("KA_PROGRAM_STORE_DIR", str(tmp_path / "empty"))
    programstore.clear_memory()
    calls = []
    monkeypatch.setattr(ts, "leadership_order", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(ts, "place_batched", lambda *a, **k: calls.append(a))
    live, racks = _cluster()
    with pytest.raises(nbuild.NativeBuildError, match="not built"):
        TorchSolver("cpu").assign_many([("t", {0: [1, 2, 3]})], racks, live, 3)
    assert calls == []
    with pytest.raises(NotImplementedError, match="could not be built"):
        sbase.get_solver("native")


def test_unknown_leadership_value_warns_and_takes_the_device_lane(monkeypatch, capsys):
    monkeypatch.setenv("KA_LEADERSHIP", "gpu")
    assert nlead.leadership_backend() == "device"
    assert "KA_LEADERSHIP" in capsys.readouterr().err
    for value, lane in (("auto", "device"), ("device", "device"), (" Native ", "native")):
        monkeypatch.setenv("KA_LEADERSHIP", value)
        assert nlead.leadership_backend() == lane


# --- the solver lanes ---------------------------------------------------------


def test_get_solver_names():
    from kafka_assigner_tpu_torch.solvers.greedy import GreedySolver
    from kafka_assigner_tpu_torch.solvers.native import NativeGreedySolver

    assert isinstance(sbase.get_solver("greedy"), GreedySolver)
    assert isinstance(sbase.get_solver("native"), NativeGreedySolver)
    assert sbase.get_solver("device", "cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unknown solver 'tpu'"):
        sbase.get_solver("tpu")


@pytest.mark.parametrize("compat", ["0", "1"])
@pytest.mark.parametrize("name", ["greedy", "native"])
def test_greedy_lanes_match_jax(monkeypatch, name, compat):
    # Replaced brokers, an RF decrease and mixed RF: the C++ lane batches
    # runs of one RF, the Python lane solves topic by topic, as the JAX
    # package's do.
    monkeypatch.setenv("KA_RF_DECREASE_COMPAT", compat)
    live, racks = _cluster(30, 5)
    live -= {3, 4}
    rng = np.random.default_rng(5)
    topics = [(f"g{i}", {p: [int(x) for x in rng.choice(np.arange(1, 31), 3, replace=False)]
                         for p in range(10)}) for i in range(4)]
    for desired in (-1, 2):
        ours, ref = TopicAssigner(name), JaxAssigner(name)
        assert ours.generate_assignments(topics, live, racks, desired) == \
            ref.generate_assignments(topics, live, racks, desired)
        assert ours.context.counter == ref.context.counter
    ours, ref = TopicAssigner(name), JaxAssigner(name)
    assert ours.generate_assignments(_mixed_topics(), live, racks) == \
        ref.generate_assignments(_mixed_topics(), live, racks)


@pytest.mark.parametrize("name", ["greedy", "native"])
def test_greedy_lanes_refuse_an_infeasible_topic_as_jax(name):
    live = {1, 2, 3}
    racks = {1: "a", 2: "a", 3: "b"}
    cur = {p: [1, 3] for p in range(6)}
    with pytest.raises(ValueError) as ref:
        JaxAssigner(name).generate_assignments([("x", cur)], live, racks, 3)
    with pytest.raises(ValueError) as got:
        TopicAssigner(name).generate_assignments([("x", cur)], live, racks, 3)
    assert str(got.value) == str(ref.value)


def test_bench_builds_the_reference_headline():
    # scripts/torch_bench.py's config 4 is bench.py's headline.
    from bench import build_headline
    from kafka_assigner_tpu_torch.models.synthetic import build_config4

    topic_map, live, rack_map = build_config4()
    topics, ref_live, ref_racks = build_headline()
    assert list(topic_map.items()) == topics
    assert (live, rack_map) == (ref_live, ref_racks)


# --- KG1's step probe: its host logic -------------------------------------------


def test_probe_slot_is_one_headroom_a_lane_and_the_weight():
    slot = gcases.probe_slot(seed=3, weight=11)
    assert slot.dtype == np.int32 and slot.shape == (gp.PROBE_WORDS,)
    assert slot[-1] == 11 and (slot[:-1] >= 1 << 28).all() and (slot[:-1] < 1 << 29).all()
    assert np.array_equal(slot, gcases.probe_slot(seed=3, weight=11))


@pytest.mark.parametrize("slot", [
    gcases.probe_slot(0),
    np.append(np.full(32, 100), 7).astype(np.int32),          # every lane tied
    np.append(np.arange(32) % 5, 3).astype(np.int32),         # overflows
])
def test_probe_picks_are_the_plain_scan_at_one_consumer_a_lane(slot):
    # With one consumer a lane, the probe's chain is KG1's own step: the
    # picks equal the plain scan on 32 live consumers of capacity = the
    # headrooms, every row an orphan of the probe's weight.
    steps = 300
    pick, over = gcases.probe_picks(slot, steps)
    w = torch.full((1, steps), int(slot[-1]), dtype=torch.int32)
    assigned = torch.full((1, steps), -1, dtype=torch.int32)
    load = torch.zeros((1, 32), dtype=torch.int32)
    overflowed = gp.pack_scan_plain(
        w, torch.as_tensor(slot[:-1]), torch.arange(steps, dtype=torch.int32),
        torch.ones((1, 32), dtype=torch.bool), torch.ones((1, steps), dtype=torch.bool),
        assigned, load,
    )
    assert pick == int(assigned[0, -1]) and over == int(overflowed[0])


def test_step_probe_takes_only_a_slot_on_the_card():
    with pytest.raises(ValueError, match="33 int32 words"):
        gp.step_probe(torch.as_tensor(gcases.probe_slot()), 10)


# --- on the card -------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ballot", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_step_probe_walks_the_chain_on_card(cuda_device, seed, ballot):
    # Both steps, two reductions or a reduction and a ballot, pick alike.
    slot = gcases.probe_slot(seed)
    before = gp.launches["group_pack"]
    out = gp.step_probe(torch.as_tensor(slot, device=cuda_device), 1000, ballot).cpu()
    assert (int(out[0]), int(out[1])) == gcases.probe_picks(slot, 1000)
    assert int(out[2]) > 0 and gp.launches["group_pack"] == before


@pytest.mark.cuda
def test_lanes_on_card_match_cpu(cuda_device, monkeypatch):
    live, racks = _cluster()
    topics = _mixed_topics()
    want = TopicAssigner(device="cpu").generate_assignments(topics, live, racks)
    for lane in ("native", "device"):
        monkeypatch.setenv("KA_LEADERSHIP", lane)
        lead.launches["leadership"] = 0
        assigner = TopicAssigner(device="cuda")
        assert assigner.generate_assignments(topics, live, racks) == want
        assert assigner.solver.last_leadership == ("native" if lane == "native" else "cuda")
        assert (lead.launches["leadership"] > 0) == (lane == "device")
