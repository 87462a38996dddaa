/* fastclone: C deep-clone for the Store's API-object trees.
 *
 * The port's copy of native/fastclone.c. lws_tpu_torch/core/fastclone.py
 * builds it with the host C compiler at the store's first clone, into
 * lws_tpu_torch/_build/.
 *
 * The control plane's correctness model (reference: the k8s apiserver always
 * hands out decoded copies) requires a deep copy at every read/write/notify
 * boundary. Profiling showed generic copy.deepcopy at ~95% of control-plane
 * convergence time, and even a specialized Python clone stays the top cost.
 * API objects are trees of dataclasses / dicts / lists / scalars / enums
 * with no cycles or shared refs, so a C walk is safe and ~10x faster.
 *
 * Fallback contract: anything unrecognized is delegated to the Python
 * fallback callable supplied at init (copy.deepcopy), so semantics match the
 * pure-Python `_clone` exactly.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

static PyObject *enum_type = NULL;     /* enum.Enum */
static PyObject *fallback = NULL;      /* copy.deepcopy */
static PyObject *str_dcfields = NULL;  /* "__dataclass_fields__" */
static PyObject *str_dunder_dict = NULL; /* "__dict__" */

/* Depth bound: API objects are shallow trees (<20 levels). A cyclic object
 * would otherwise exhaust the C stack and crash the interpreter; past the
 * bound we delegate to copy.deepcopy, whose memo handles cycles correctly. */
#define CLONE_MAX_DEPTH 200

static PyObject *clone_obj(PyObject *x, int depth);

static PyObject *
clone_dict(PyObject *x, int depth)
{
    PyObject *out = PyDict_New();
    if (out == NULL)
        return NULL;
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(x, &pos, &key, &value)) {
        PyObject *cv = clone_obj(value, depth);
        if (cv == NULL || PyDict_SetItem(out, key, cv) < 0) {
            Py_XDECREF(cv);
            Py_DECREF(out);
            return NULL;
        }
        Py_DECREF(cv);
    }
    return out;
}

static PyObject *
clone_list(PyObject *x, int depth)
{
    Py_ssize_t n = PyList_GET_SIZE(x);
    PyObject *out = PyList_New(n);
    if (out == NULL)
        return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *cv = clone_obj(PyList_GET_ITEM(x, i), depth);
        if (cv == NULL) {
            Py_DECREF(out);
            return NULL;
        }
        PyList_SET_ITEM(out, i, cv); /* steals ref */
    }
    return out;
}

static PyObject *
clone_tuple(PyObject *x, int depth)
{
    Py_ssize_t n = PyTuple_GET_SIZE(x);
    PyObject *out = PyTuple_New(n);
    if (out == NULL)
        return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *cv = clone_obj(PyTuple_GET_ITEM(x, i), depth);
        if (cv == NULL) {
            Py_DECREF(out);
            return NULL;
        }
        PyTuple_SET_ITEM(out, i, cv); /* steals ref */
    }
    return out;
}

static PyObject *
clone_dataclass(PyObject *x, PyTypeObject *tp, int depth)
{
    /* new = cls.__new__(cls); new.__dict__ = clone(x.__dict__) */
    PyObject *new = tp->tp_alloc(tp, 0);
    if (new == NULL)
        return NULL;
    PyObject **dictptr = _PyObject_GetDictPtr(x);
    PyObject **newdictptr = _PyObject_GetDictPtr(new);
    if (dictptr == NULL || *dictptr == NULL || newdictptr == NULL) {
        /* __slots__ or exotic layout: fall back for full generality */
        Py_DECREF(new);
        return PyObject_CallFunctionObjArgs(fallback, x, NULL);
    }
    PyObject *cloned = clone_dict(*dictptr, depth);
    if (cloned == NULL) {
        Py_DECREF(new);
        return NULL;
    }
#if PY_VERSION_HEX >= 0x030D0000
    /* 3.13+: objects use inline-values/managed-dict layouts where
     * _PyObject_GetDictPtr materializes a dict a raw slot write would leak,
     * and raw writes bypass the managed-dict bookkeeping. The generic
     * setter handles both layouts correctly. */
    if (PyObject_SetAttr(new, str_dunder_dict, cloned) < 0) {
        /* Frozen dataclasses override __setattr__ to reject all writes,
         * including __dict__; match the pure-Python fallback instead of
         * raising where _py_clone would succeed. */
        PyErr_Clear();
        Py_DECREF(cloned);
        Py_DECREF(new);
        return PyObject_CallFunctionObjArgs(fallback, x, NULL);
    }
    Py_DECREF(cloned);
#else
    /* tp_alloc'd instances normally start with a NULL dict slot, but be
     * defensive: never overwrite a live dict without releasing it. */
    Py_XDECREF(*newdictptr);
    *newdictptr = cloned; /* owns the new dict */
#endif
    return new;
}

static PyObject *
clone_obj(PyObject *x, int depth)
{
    PyTypeObject *tp = Py_TYPE(x);
    if (++depth > CLONE_MAX_DEPTH)
        return PyObject_CallFunctionObjArgs(fallback, x, NULL);
    /* scalars: immutable, shared */
    if (x == Py_None || x == Py_True || x == Py_False ||
        tp == &PyUnicode_Type || tp == &PyLong_Type || tp == &PyFloat_Type) {
        Py_INCREF(x);
        return x;
    }
    if (tp == &PyDict_Type)
        return clone_dict(x, depth);
    if (tp == &PyList_Type)
        return clone_list(x, depth);
    /* dataclass instance: type carries __dataclass_fields__ */
    PyObject *fields = PyObject_GetAttr((PyObject *)tp, str_dcfields);
    if (fields != NULL) {
        Py_DECREF(fields);
        return clone_dataclass(x, tp, depth);
    }
    PyErr_Clear();
    /* enum members are immutable singletons */
    int is_enum = PyObject_IsInstance(x, enum_type);
    if (is_enum < 0)
        return NULL;
    if (is_enum) {
        Py_INCREF(x);
        return x;
    }
    if (tp == &PyTuple_Type)
        return clone_tuple(x, depth);
    return PyObject_CallFunctionObjArgs(fallback, x, NULL);
}

static PyObject *
py_clone(PyObject *self, PyObject *arg)
{
    (void)self;
    if (enum_type == NULL || fallback == NULL) {
        PyErr_SetString(PyExc_RuntimeError, "call _fastclone.init() first");
        return NULL;
    }
    return clone_obj(arg, 0);
}

static PyObject *
py_init(PyObject *self, PyObject *args)
{
    (void)self;
    PyObject *et, *fb;
    if (!PyArg_ParseTuple(args, "OO", &et, &fb))
        return NULL;
    Py_XDECREF(enum_type);
    Py_XDECREF(fallback);
    Py_INCREF(et);
    Py_INCREF(fb);
    enum_type = et;
    fallback = fb;
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"clone", py_clone, METH_O, "Deep-clone an API object tree."},
    {"init", py_init, METH_VARARGS, "Set (enum.Enum, fallback_deepcopy)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastclone", NULL, -1, methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC
PyInit__fastclone(void)
{
    str_dcfields = PyUnicode_InternFromString("__dataclass_fields__");
    str_dunder_dict = PyUnicode_InternFromString("__dict__");
    if (str_dcfields == NULL || str_dunder_dict == NULL)
        return NULL;
    return PyModule_Create(&moduledef);
}
