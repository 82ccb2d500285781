/* Native host ops for picovdb_tpu_torch.
 *
 * The device returns (scores, slot ids); turning them into the reference's
 * dict-per-hit result contract (picovdb/pico_vdb.py:752-775) is a pure
 * Python loop costing ~3 us per hit on one core — the end-to-end throughput
 * ceiling once the TPU side is fast. This extension rebuilds that loop in
 * C++ against the CPython API (~10x): bounds/score checks, doc lookup,
 * dict copy, metrics insertion, early stop at top_k.
 *
 * Deliberately dependency-free: raw CPython C API + the buffer protocol
 * (no pybind11, no numpy headers). The Python wrapper
 * (picovdb_tpu_torch/hostops.py) compiles it on first use and falls back to the
 * Python loop when a toolchain is unavailable.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cmath>
#include <cstdint>

namespace {

struct BufferGuard {
    Py_buffer view{};
    bool held = false;
    ~BufferGuard() {
        if (held) PyBuffer_Release(&view);
    }
};

/* assemble(vals, idxs, docs, metrics_key, top_k, better_than) -> list[list[dict]]
 *
 * vals: C-contiguous float32 buffer of shape (Q, K)
 * idxs: C-contiguous int32 buffer of shape (Q, K)
 * docs: list of dict-or-None, indexed by slot id
 * metrics_key: str key for the score field ("_metrics_")
 * top_k: int, max results per query
 * better_than: float score floor or None
 */
PyObject* assemble(PyObject*, PyObject* args) {
    PyObject *vals_obj, *idxs_obj, *docs_obj, *metrics_key, *better_obj;
    Py_ssize_t top_k;
    if (!PyArg_ParseTuple(args, "OOO!UnO", &vals_obj, &idxs_obj,
                          &PyList_Type, &docs_obj, &metrics_key, &top_k,
                          &better_obj)) {
        return nullptr;
    }

    BufferGuard vals_g, idxs_g;
    if (PyObject_GetBuffer(vals_obj, &vals_g.view,
                           PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0)
        return nullptr;
    vals_g.held = true;
    if (PyObject_GetBuffer(idxs_obj, &idxs_g.view,
                           PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0)
        return nullptr;
    idxs_g.held = true;

    if (vals_g.view.ndim != 2 || idxs_g.view.ndim != 2 ||
        vals_g.view.itemsize != 4 || idxs_g.view.itemsize != 4) {
        PyErr_SetString(PyExc_TypeError,
                        "assemble expects (Q,K) float32 and int32 buffers");
        return nullptr;
    }
    const Py_ssize_t q = vals_g.view.shape[0];
    const Py_ssize_t kk = vals_g.view.shape[1];
    if (idxs_g.view.shape[0] != q || idxs_g.view.shape[1] != kk) {
        PyErr_SetString(PyExc_ValueError, "vals/idxs shape mismatch");
        return nullptr;
    }
    const float* vals = static_cast<const float*>(vals_g.view.buf);
    const int32_t* idxs = static_cast<const int32_t*>(idxs_g.view.buf);
    const Py_ssize_t n_docs = PyList_GET_SIZE(docs_obj);

    const bool has_floor = better_obj != Py_None;
    double floor = 0.0;
    if (has_floor) {
        floor = PyFloat_AsDouble(better_obj);
        if (floor == -1.0 && PyErr_Occurred()) return nullptr;
    }

    PyObject* out = PyList_New(q);
    if (!out) return nullptr;

    for (Py_ssize_t qi = 0; qi < q; ++qi) {
        PyObject* row = PyList_New(0);
        if (!row) {
            Py_DECREF(out);
            return nullptr;
        }
        Py_ssize_t taken = 0;
        for (Py_ssize_t j = 0; j < kk && taken < top_k; ++j) {
            const int32_t idx = idxs[qi * kk + j];
            const float score = vals[qi * kk + j];
            if (idx < 0 || idx >= n_docs) continue;
            if (std::isinf(score) || std::isnan(score)) {
                if (score < 0 || std::isnan(score)) continue;
            }
            if (has_floor && score < floor) continue;
            PyObject* doc = PyList_GET_ITEM(docs_obj, idx); /* borrowed */
            if (doc == Py_None) continue;
            if (!PyDict_Check(doc)) continue;
            PyObject* rec = PyDict_Copy(doc);
            if (!rec) {
                Py_DECREF(row);
                Py_DECREF(out);
                return nullptr;
            }
            PyObject* score_obj = PyFloat_FromDouble((double)score);
            if (!score_obj || PyDict_SetItem(rec, metrics_key, score_obj) < 0) {
                Py_XDECREF(score_obj);
                Py_DECREF(rec);
                Py_DECREF(row);
                Py_DECREF(out);
                return nullptr;
            }
            Py_DECREF(score_obj);
            if (PyList_Append(row, rec) < 0) {
                Py_DECREF(rec);
                Py_DECREF(row);
                Py_DECREF(out);
                return nullptr;
            }
            Py_DECREF(rec);
            ++taken;
        }
        PyList_SET_ITEM(out, qi, row); /* steals */
    }
    return out;
}

PyMethodDef methods[] = {
    {"assemble", assemble, METH_VARARGS,
     "Assemble device (scores, slot ids) into result dicts."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_hostops",
    "Native host ops for picovdb_tpu_torch", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__hostops(void) { return PyModule_Create(&moduledef); }
