// C inference ABI implementation: embeds CPython and drives
// paddle_tpu_torch.capi_runtime (see paddle_tpu_capi.h for the design
// note; reference analogs: legacy/capi/gradient_machine.cpp,
// inference/api/api_impl.cc NativePaddlePredictor).
//
// Build: python -m paddle_tpu_torch.capi.build
//        ->  paddle_tpu_torch/_build/libpaddle_tpu_capi.so

#include "paddle_tpu_capi.h"

#include <Python.h>

#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_last_error = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c) g_last_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

// Owns the interpreter bootstrap. If the host process already runs Python
// (e.g. the ABI is exercised from ctypes in tests), we only take the GIL.
// When WE initialize the interpreter, the GIL is immediately released via
// PyEval_SaveThread so later calls — from ANY thread — can take it with
// PyGILState_Ensure; holding it across the return would deadlock every
// other thread of a multithreaded embedder.
void ensure_interpreter() {
  static bool bootstrapped = [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      PyEval_SaveThread();  // release the GIL the init left us holding
    }
    return true;
  }();
  (void)bootstrapped;
}

class GILHolder {
 public:
  GILHolder() {
    ensure_interpreter();
    state_ = PyGILState_Ensure();
  }
  ~GILHolder() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_{};
};

struct Predictor {
  PyObject* handle;  // capi_runtime.Predictor instance
};

struct Results {
  PyObject* arrays;                       // list of (name, np.ndarray)
  std::vector<std::string> names;
  std::vector<std::vector<int64_t>> shapes;
  std::vector<PD_DType> dtypes;
  std::vector<Py_buffer> buffers;         // held until destroy
};

const char* dtype_str(PD_DType d) {
  switch (d) {
    case PD_FLOAT32: return "float32";
    case PD_INT32: return "int32";
    case PD_INT64: return "int64";
  }
  return "float32";
}

bool dtype_from_str(const char* s, PD_DType* out) {
  if (!strcmp(s, "float32")) { *out = PD_FLOAT32; return true; }
  if (!strcmp(s, "int32")) { *out = PD_INT32; return true; }
  if (!strcmp(s, "int64")) { *out = PD_INT64; return true; }
  return false;
}

size_t dtype_size(PD_DType d) { return d == PD_FLOAT32 || d == PD_INT32 ? 4 : 8; }

}  // namespace

extern "C" {

PD_Predictor PD_CreatePredictor(const char* model_dir) {
  GILHolder gil;
  g_last_error.clear();
  PyObject* mod = PyImport_ImportModule("paddle_tpu_torch.capi_runtime");
  if (!mod) { set_error_from_python(); return nullptr; }
  PyObject* h = PyObject_CallMethod(mod, "create", "s", model_dir);
  Py_DECREF(mod);
  if (!h) { set_error_from_python(); return nullptr; }
  auto* p = new Predictor{h};
  return p;
}

PD_Results PD_PredictorRun(PD_Predictor pred, const PD_Tensor* inputs,
                           int num_inputs) {
  GILHolder gil;
  g_last_error.clear();
  auto* p = static_cast<Predictor*>(pred);
  if (!p) { g_last_error = "null predictor"; return nullptr; }

  PyObject* feed = PyList_New(num_inputs);
  for (int i = 0; i < num_inputs; ++i) {
    const PD_Tensor& t = inputs[i];
    size_t n = dtype_size(t.dtype);
    for (int d = 0; d < t.rank; ++d) n *= static_cast<size_t>(t.shape[d]);
    PyObject* shape = PyTuple_New(t.rank);
    for (int d = 0; d < t.rank; ++d)
      PyTuple_SET_ITEM(shape, d, PyLong_FromLongLong(t.shape[d]));
    // copy the caller's buffer into bytes: the runtime's arrays may
    // outlive this call, so no aliasing of caller memory
    PyObject* data = PyBytes_FromStringAndSize(
        static_cast<const char*>(t.data), static_cast<Py_ssize_t>(n));
    PyObject* entry = Py_BuildValue(
        "(sNsN)", t.name ? t.name : "", shape, dtype_str(t.dtype), data);
    PyList_SET_ITEM(feed, i, entry);
  }

  PyObject* out = PyObject_CallMethod(p->handle, "run", "(N)", feed);
  if (!out) { set_error_from_python(); return nullptr; }

  auto* res = new Results{};
  res->arrays = out;  // list of (name, dtype_str, ndarray)
  Py_ssize_t n = PyList_Size(out);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PyList_GetItem(out, i);
    const char* name = PyUnicode_AsUTF8(PyTuple_GetItem(item, 0));
    const char* dts = PyUnicode_AsUTF8(PyTuple_GetItem(item, 1));
    PyObject* arr = PyTuple_GetItem(item, 2);
    PD_DType dt = PD_FLOAT32;
    if (!dtype_from_str(dts, &dt)) {
      g_last_error = std::string("unsupported output dtype ") + dts;
      PD_DestroyResults(res);
      return nullptr;
    }
    Py_buffer view;
    if (PyObject_GetBuffer(arr, &view, PyBUF_C_CONTIGUOUS) != 0) {
      set_error_from_python();
      PD_DestroyResults(res);
      return nullptr;
    }
    res->names.emplace_back(name);
    res->dtypes.push_back(dt);
    std::vector<int64_t> shp(view.ndim);
    for (int d = 0; d < view.ndim; ++d) shp[d] = view.shape[d];
    res->shapes.push_back(std::move(shp));
    res->buffers.push_back(view);
  }
  return res;
}

int PD_ResultsNum(PD_Results r) {
  auto* res = static_cast<Results*>(r);
  return res ? static_cast<int>(res->names.size()) : 0;
}

const char* PD_ResultsName(PD_Results r, int i) {
  return static_cast<Results*>(r)->names[i].c_str();
}

PD_DType PD_ResultsDType(PD_Results r, int i) {
  return static_cast<Results*>(r)->dtypes[i];
}

int PD_ResultsRank(PD_Results r, int i) {
  return static_cast<int>(static_cast<Results*>(r)->shapes[i].size());
}

const int64_t* PD_ResultsShape(PD_Results r, int i) {
  return static_cast<Results*>(r)->shapes[i].data();
}

const void* PD_ResultsData(PD_Results r, int i) {
  return static_cast<Results*>(r)->buffers[i].buf;
}

size_t PD_ResultsByteSize(PD_Results r, int i) {
  return static_cast<size_t>(static_cast<Results*>(r)->buffers[i].len);
}

void PD_DestroyResults(PD_Results r) {
  auto* res = static_cast<Results*>(r);
  if (!res) return;
  GILHolder gil;
  for (auto& b : res->buffers) PyBuffer_Release(&b);
  Py_XDECREF(res->arrays);
  delete res;
}

void PD_DestroyPredictor(PD_Predictor pred) {
  auto* p = static_cast<Predictor*>(pred);
  if (!p) return;
  GILHolder gil;
  Py_XDECREF(p->handle);
  delete p;
}

const char* PD_LastError(void) { return g_last_error.c_str(); }

}  // extern "C"
