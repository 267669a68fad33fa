/* Host codec: the dict<->tensor boundary of the solve, as a CPython
 * extension.
 *
 * The solver's device program consumes/produces dense int32 tensors; the
 * public API (mirroring KafkaTopicAssigner.generateAssignment,
 * KafkaTopicAssigner.java:42-72) speaks Python dicts of replica lists. At
 * the 5k-broker / 200k-partition headline that boundary is pure host time on
 * the critical path: building ndarray rows from 200k Python lists costs
 * ~60 ms (np.asarray of list-of-lists) and converting results back costs
 * ~65 ms (tolist + dict construction). This module does both directly
 * against the buffers — one pass, no intermediate objects — for ~5-10x less
 * boundary time. The numpy reference path remains in models/problem.py
 * (KA_HOSTCODEC=0 selects it; differential-tested equal in
 * tests/test_hostcodec.py).
 *
 * No pybind11 in this image: raw CPython API, compiled by native/build.py
 * alongside the greedy oracle.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* Exported by CPython (3.12 ships it in the internal headers only, but the
 * symbol is public in libpython): presizing the per-partition result dicts
 * skips ~5 rehash-grow cycles per 100-entry dict on the decode path.
 * Declared WEAK so the module still imports if a future CPython hides the
 * private symbol — the loader then leaves the address NULL and we fall back
 * to PyDict_New() instead of failing the import (and silently losing the
 * whole codec, which is much more than the presize win). */
extern PyObject *_PyDict_NewPresized(Py_ssize_t minused)
    __attribute__((weak));

static inline PyObject *dict_new_presized(Py_ssize_t minused) {
    return _PyDict_NewPresized ? _PyDict_NewPresized(minused)
                               : PyDict_New();
}

/* ---- helpers ---------------------------------------------------------- */

/* Binary search in a sorted int64 array; returns index or -1. */
static inline int64_t find_broker(const int64_t *ids, int64_t n, int64_t key) {
    int64_t lo = 0, hi = n - 1;
    while (lo <= hi) {
        int64_t mid = (lo + hi) >> 1;
        int64_t v = ids[mid];
        if (v < key) lo = mid + 1;
        else if (v > key) hi = mid - 1;
        else return mid;
    }
    return -1;
}

/* Direct id->index lookup table over [min_id, max_id] when the id range is
 * compact (real clusters use small dense broker ids) — the binary search
 * above cost ~30 ms of the headline encode (600k lookups x ~12 probes);
 * the LUT costs one probe. Falls back to search for sparse id spaces. */
#define LUT_MAX_SPAN (1 << 22)

typedef struct {
    int32_t *tab; /* NULL when unusable */
    int64_t min_id, span;
} BrokerLut;

static void lut_build(BrokerLut *lut, const int64_t *ids, int64_t n) {
    lut->tab = NULL;
    if (n == 0) return;
    int64_t span = ids[n - 1] - ids[0] + 1; /* ids sorted ascending */
    if (span <= 0 || span > LUT_MAX_SPAN) return;
    int32_t *tab = (int32_t *)malloc(sizeof(int32_t) * (size_t)span);
    if (!tab) return; /* fall back silently */
    memset(tab, 0xFF, sizeof(int32_t) * (size_t)span); /* -1 */
    for (int64_t i = 0; i < n; ++i) tab[ids[i] - ids[0]] = (int32_t)i;
    lut->tab = tab;
    lut->min_id = ids[0];
    lut->span = span;
}

static inline int64_t lut_find(const BrokerLut *lut, const int64_t *ids,
                               int64_t n, int64_t key) {
    if (lut->tab) {
        int64_t off = key - lut->min_id;
        return (off >= 0 && off < lut->span) ? lut->tab[off] : -1;
    }
    return find_broker(ids, n, key);
}

/* (key, value) pair carried through the per-topic sort; cmp_i64 compares
 * the leading int64 key. */
typedef struct { int64_t key; PyObject *val; } KV;

static int cmp_i64(const void *a, const void *b) {
    int64_t x = *(const int64_t *)a, y = *(const int64_t *)b;
    return (x > y) - (x < y);
}

/* Extract a C-contiguous buffer from a numpy array via the buffer
 * protocol (avoids linking against numpy's C API — the buffer protocol is
 * stable CPython). itemsize/format are validated by the caller passing the
 * right dtype; we check itemsize only. */
typedef struct {
    Py_buffer view;
    int held;
} Buf;

static int buf_get(PyObject *obj, Buf *b, int writable, Py_ssize_t itemsize,
                   const char *what) {
    int flags = PyBUF_C_CONTIGUOUS | (writable ? PyBUF_WRITABLE : 0);
    if (PyObject_GetBuffer(obj, &b->view, flags) != 0) return -1;
    b->held = 1;
    if (b->view.itemsize != itemsize) {
        PyErr_Format(PyExc_TypeError, "%s: expected itemsize %zd, got %zd",
                     what, itemsize, b->view.itemsize);
        PyBuffer_Release(&b->view);
        b->held = 0;
        return -1;
    }
    return 0;
}

static void buf_release(Buf *b) {
    if (b->held) {
        PyBuffer_Release(&b->view);
        b->held = 0;
    }
}

/* ---- dimension scan --------------------------------------------------- */

/* scan_dims(curs) -> (max_partitions, max_width)
 *
 * One C pass over the group's dicts to size the batch tensors (the numpy
 * path pays ~200k Python len() calls for the same numbers at headline
 * scale). Non-sequence replica values report length 0 here and fail with a
 * descriptive error in encode_rows. */
static PyObject *scan_dims(PyObject *self, PyObject *arg) {
    if (!PyList_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "curs must be a list of dicts");
        return NULL;
    }
    Py_ssize_t max_p = 0, max_w = 0;
    for (Py_ssize_t t = 0; t < PyList_GET_SIZE(arg); ++t) {
        PyObject *d = PyList_GET_ITEM(arg, t);
        if (!PyDict_Check(d)) {
            PyErr_Format(PyExc_TypeError, "curs[%zd] is not a dict", t);
            return NULL;
        }
        Py_ssize_t p = PyDict_Size(d);
        if (p > max_p) max_p = p;
        Py_ssize_t pos = 0;
        PyObject *k, *v;
        while (PyDict_Next(d, &pos, &k, &v)) {
            Py_ssize_t w = PyObject_Length(v);
            if (w < 0) {
                PyErr_Clear();
                continue;
            }
            if (w > max_w) max_w = w;
        }
    }
    return Py_BuildValue("nn", max_p, max_w);
}

/* ---- encode ----------------------------------------------------------- */

/* encode_rows(curs, broker_ids, currents, p_reals, part_ids) -> width_used
 *
 * curs:       list of B dicts {partition_id(int-like): sequence of broker
 *             ids (int-like)}
 * broker_ids: int64 (N,) SORTED ascending (the cluster vocabulary)
 * currents:   int32 (B_pad, P_pad, W) prefilled -1; rows filled in place
 * p_reals:    int32 (B_pad,) out
 * part_ids:   int64 (B_pad, P_pad) prefilled -1; sorted partition ids out
 *
 * Semantics match models/problem.py encode rows: partition ids sorted
 * ascending, replica lists written in order, unknown/dead brokers -> -1,
 * ragged lists allowed (shorter rows keep -1 tail). Raises ValueError when
 * a replica list is longer than W or a partition count exceeds P_pad.
 */
static PyObject *encode_rows(PyObject *self, PyObject *args) {
    PyObject *curs, *broker_obj, *cur_obj, *pre_obj, *pid_obj;
    if (!PyArg_ParseTuple(args, "OOOOO", &curs, &broker_obj, &cur_obj,
                          &pre_obj, &pid_obj))
        return NULL;
    if (!PyList_Check(curs)) {
        PyErr_SetString(PyExc_TypeError, "curs must be a list of dicts");
        return NULL;
    }
    Buf bro = {0}, cur = {0}, pre = {0}, pid = {0};
    KV *kvs = NULL;
    BrokerLut lut = {0};
    if (buf_get(broker_obj, &bro, 0, 8, "broker_ids") != 0) goto fail;
    if (buf_get(cur_obj, &cur, 1, 4, "currents") != 0) goto fail;
    if (buf_get(pre_obj, &pre, 1, 4, "p_reals") != 0) goto fail;
    if (buf_get(pid_obj, &pid, 1, 8, "part_ids") != 0) goto fail;
    if (cur.view.ndim != 3 || pid.view.ndim != 2) {
        PyErr_SetString(PyExc_TypeError,
                        "currents must be 3-d, part_ids 2-d");
        goto fail;
    }

    const int64_t *brokers = (const int64_t *)bro.view.buf;
    int64_t n_brokers = bro.view.len / 8;
    int32_t *currents = (int32_t *)cur.view.buf;
    int32_t *p_reals = (int32_t *)pre.view.buf;
    int64_t *part_ids = (int64_t *)pid.view.buf;
    Py_ssize_t b_count = PyList_GET_SIZE(curs);
    Py_ssize_t p_pad = cur.view.shape[1], width = cur.view.shape[2];
    if (pid.view.shape[0] != cur.view.shape[0] ||
        pid.view.shape[1] != p_pad ||
        pre.view.len / 4 < cur.view.shape[0] ||
        b_count > cur.view.shape[0]) {
        PyErr_SetString(PyExc_ValueError, "encode_rows: shape mismatch");
        goto fail;
    }

    kvs = (KV *)malloc(sizeof(KV) * (size_t)(p_pad ? p_pad : 1));
    if (!kvs) {
        PyErr_NoMemory();
        goto fail;
    }
    lut_build(&lut, brokers, n_brokers);

    int64_t width_used = 1;
    for (Py_ssize_t t = 0; t < b_count; ++t) {
        PyObject *d = PyList_GET_ITEM(curs, t);
        if (!PyDict_Check(d)) {
            PyErr_Format(PyExc_TypeError, "curs[%zd] is not a dict", t);
            goto fail;
        }
        Py_ssize_t p = PyDict_Size(d);
        if (p > p_pad) {
            PyErr_Format(PyExc_ValueError,
                         "topic %zd has %zd partitions > p_pad %zd", t, p,
                         p_pad);
            goto fail;
        }
        /* collect (key, value) pairs — values fetched after sorting via a
         * second dict lookup would re-hash, so carry them along — then sort
         * by key (cmp_i64 compares the first struct member). */
        Py_ssize_t pos = 0, i = 0;
        PyObject *k, *v;
        while (PyDict_Next(d, &pos, &k, &v)) {
            int64_t kv = PyLong_AsLongLong(k);
            if (kv == -1 && PyErr_Occurred()) {
                /* non-int key: fall back through PyNumber_Index (np ints) */
                PyErr_Clear();
                PyObject *ik = PyNumber_Index(k);
                if (!ik) goto fail;
                kv = PyLong_AsLongLong(ik);
                Py_DECREF(ik);
                if (kv == -1 && PyErr_Occurred()) goto fail;
            }
            kvs[i].key = kv;
            kvs[i].val = v; /* borrowed; dict owns while the GIL is held */
            ++i;
        }
        qsort(kvs, (size_t)p, sizeof(KV), cmp_i64);
        int32_t *row = currents + (size_t)t * p_pad * width;
        int64_t *prow = part_ids + (size_t)t * p_pad;
        int bad = 0;
        for (Py_ssize_t j = 0; j < p && !bad; ++j) {
            prow[j] = kvs[j].key;
            PyObject *fast =
                PySequence_Fast(kvs[j].val, "replica list must be a sequence");
            if (!fast) {
                bad = 1;
                break;
            }
            Py_ssize_t w = PySequence_Fast_GET_SIZE(fast);
            if (w > width) {
                PyErr_Format(PyExc_ValueError,
                             "replica list of length %zd exceeds width %zd",
                             w, width);
                Py_DECREF(fast);
                bad = 1;
                break;
            }
            if (w > width_used) width_used = w;
            PyObject **items = PySequence_Fast_ITEMS(fast);
            for (Py_ssize_t s = 0; s < w; ++s) {
                int64_t bid = PyLong_AsLongLong(items[s]);
                if (bid == -1 && PyErr_Occurred()) {
                    PyErr_Clear();
                    PyObject *ib = PyNumber_Index(items[s]);
                    /* `fast` is released once, after this loop: a release
                     * here too would free a replica list the caller's dict
                     * still holds. */
                    if (!ib) {
                        bad = 1;
                        break;
                    }
                    bid = PyLong_AsLongLong(ib);
                    Py_DECREF(ib);
                    if (bid == -1 && PyErr_Occurred()) {
                        bad = 1;
                        break;
                    }
                }
                int64_t idx = lut_find(&lut, brokers, n_brokers, bid);
                row[(size_t)j * width + s] = (int32_t)idx;
            }
            Py_DECREF(fast);
        }
        if (bad) goto fail;
        p_reals[t] = (int32_t)p;
    }

    buf_release(&bro);
    buf_release(&cur);
    buf_release(&pre);
    buf_release(&pid);
    free(kvs);
    free(lut.tab);
    return PyLong_FromLongLong(width_used);

fail:
    buf_release(&bro);
    buf_release(&cur);
    buf_release(&pre);
    buf_release(&pid);
    free(kvs);
    free(lut.tab);
    return NULL;
}

/* ---- decode ----------------------------------------------------------- */

/* decode_rows(ordered, broker_ids, part_ids, p_reals, b_real)
 *   -> list of b_real dicts {partition_id: [broker_id, ...]}
 *
 * ordered:  int32 (B, P_pad, RF) broker indices, -1 for empty slots
 * broker_ids: int64 (N,)
 * part_ids: int64 (B, P_pad)
 * p_reals:  int32 (B,)
 *
 * -1 slots are skipped (shorter lists), matching
 * models/problem.py decode_assignment's incomplete-row branch; complete rows
 * produce RF-length lists identically.
 */
static PyObject *decode_rows(PyObject *self, PyObject *args) {
    PyObject *ord_obj, *broker_obj, *pid_obj, *pre_obj;
    Py_ssize_t b_real;
    if (!PyArg_ParseTuple(args, "OOOOn", &ord_obj, &broker_obj, &pid_obj,
                          &pre_obj, &b_real))
        return NULL;
    Buf ordb = {0}, bro = {0}, pid = {0}, pre = {0};
    PyObject *out = NULL;
    PyObject **bid_cache = NULL;
    int64_t n_cache = 0;
    if (buf_get(ord_obj, &ordb, 0, 4, "ordered") != 0) goto fail;
    if (buf_get(broker_obj, &bro, 0, 8, "broker_ids") != 0) goto fail;
    if (buf_get(pid_obj, &pid, 0, 8, "part_ids") != 0) goto fail;
    if (buf_get(pre_obj, &pre, 0, 4, "p_reals") != 0) goto fail;
    if (ordb.view.ndim != 3 || pid.view.ndim != 2) {
        PyErr_SetString(PyExc_TypeError, "ordered must be 3-d, part_ids 2-d");
        goto fail;
    }
    const int32_t *ordered = (const int32_t *)ordb.view.buf;
    const int64_t *brokers = (const int64_t *)bro.view.buf;
    const int64_t *part_ids = (const int64_t *)pid.view.buf;
    const int32_t *p_reals = (const int32_t *)pre.view.buf;
    int64_t n_brokers = bro.view.len / 8;
    Py_ssize_t p_pad = ordb.view.shape[1], rf = ordb.view.shape[2];
    if (b_real > ordb.view.shape[0] || pid.view.shape[0] < b_real ||
        pid.view.shape[1] != p_pad || pre.view.len / 4 < b_real) {
        PyErr_SetString(PyExc_ValueError, "decode_rows: shape mismatch");
        goto fail;
    }

    /* One PyLong per broker, created once and INCREF'd into every result
     * list: the headline decode emits 600k broker ids drawn from ~5k
     * distinct values — fresh PyLong_FromLongLong per slot was most of the
     * decode cost. */
    bid_cache = (PyObject **)calloc((size_t)(n_brokers ? n_brokers : 1),
                                    sizeof(PyObject *));
    if (!bid_cache) {
        PyErr_NoMemory();
        goto fail;
    }
    n_cache = n_brokers;
    for (int64_t i = 0; i < n_brokers; ++i) {
        bid_cache[i] = PyLong_FromLongLong(brokers[i]);
        if (!bid_cache[i]) goto fail;
    }

    out = PyList_New(b_real);
    if (!out) goto fail;
    for (Py_ssize_t t = 0; t < b_real; ++t) {
        Py_ssize_t p = p_reals[t];
        if (p < 0 || p > p_pad) {
            PyErr_Format(PyExc_ValueError,
                         "p_reals[%zd]=%zd out of range for p_pad %zd", t, p,
                         p_pad);
            goto fail;
        }
        PyObject *d = dict_new_presized(p);
        if (!d) goto fail;
        PyList_SET_ITEM(out, t, d);
        const int32_t *rows = ordered + (size_t)t * p_pad * rf;
        const int64_t *prow = part_ids + (size_t)t * p_pad;
        for (Py_ssize_t j = 0; j < p; ++j) {
            const int32_t *slot = rows + (size_t)j * rf;
            Py_ssize_t count = 0;
            for (Py_ssize_t s = 0; s < rf; ++s) {
                if (slot[s] >= n_brokers) {
                    /* Corrupt solver output must fail as loudly as the numpy
                     * decode path (which raises IndexError on the broker-id
                     * gather); silently dropping the slot would mask a
                     * solver bug as a short replica list. idx < 0 stays a
                     * skip — it is the legitimate padding encoding. */
                    PyErr_Format(PyExc_ValueError,
                                 "decode: broker index %d out of range "
                                 "(n_brokers=%zd) at topic %zd partition %zd",
                                 (int)slot[s], (Py_ssize_t)n_brokers, t, j);
                    goto fail;
                }
                if (slot[s] >= 0) ++count;
            }
            PyObject *lst = PyList_New(count);
            if (!lst) goto fail;
            Py_ssize_t w = 0;
            for (Py_ssize_t s = 0; s < rf; ++s) {
                int32_t idx = slot[s];
                if (idx < 0) continue;
                PyObject *bid = bid_cache[idx];
                Py_INCREF(bid);
                PyList_SET_ITEM(lst, w++, bid);
            }
            PyObject *key = PyLong_FromLongLong(prow[j]);
            if (!key || PyDict_SetItem(d, key, lst) != 0) {
                Py_XDECREF(key);
                Py_DECREF(lst);
                goto fail;
            }
            Py_DECREF(key);
            Py_DECREF(lst);
        }
    }
    for (int64_t i = 0; i < n_cache; ++i) Py_XDECREF(bid_cache[i]);
    free(bid_cache);
    buf_release(&ordb);
    buf_release(&bro);
    buf_release(&pid);
    buf_release(&pre);
    return out;

fail:
    for (int64_t i = 0; i < n_cache; ++i) Py_XDECREF(bid_cache[i]);
    free(bid_cache);
    Py_XDECREF(out);
    buf_release(&ordb);
    buf_release(&bro);
    buf_release(&pid);
    buf_release(&pre);
    return NULL;
}

/* ---- module ----------------------------------------------------------- */

static PyMethodDef methods[] = {
    {"scan_dims", scan_dims, METH_O,
     "One-pass (max_partitions, max_width) over a list of assignment dicts."},
    {"encode_rows", encode_rows, METH_VARARGS,
     "Fill currents/p_reals/part_ids rows from a list of assignment dicts."},
    {"decode_rows", decode_rows, METH_VARARGS,
     "Build [{partition: [broker, ...]}] from an ordered index tensor."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "ka_hostcodec_torch",
    "Host-side dict<->tensor codec for the assignment solver.", -1, methods,
};

PyMODINIT_FUNC PyInit_ka_hostcodec_torch(void) {
    return PyModule_Create(&moduledef);
}
