// obmdc_torch: the C library API of the PyTorch + CUDA port (the
// reference's library.cpp analogue: lammps_open / lammps_command /
// lammps_file / lammps_get_natoms / lammps_gather_atoms /
// lammps_scatter_atoms / extract-thermo surface).
//
// The ten extern "C" symbols and signatures of native/obmdc.cpp, so that
// native/obmd.f90 binds to this library unchanged.  It embeds CPython and
// drives the port's deck front end through obmd_tpu_torch/capi.py's
// Session (one obmd_tpu_torch.io.script.Interpreter per handle), so C and
// Fortran programs run decks on the GPU as the reference's C API clients
// do.  The device comes from OBMD_PLATFORM: unset (or cuda, gpu) means the
// GPU, cpu the plain PyTorch versions; unset on a machine without a GPU,
// obmd_open leaves an error naming the missing GPU for obmd_last_error.
//
// Built at first use by obmd_tpu_torch/_build.py (g++ -O2 -fPIC -std=c++17
// -shared, with the include and link flags of the building interpreter's
// sysconfig) into obmd_tpu_torch/csrc/build/;
// obmd_tpu_torch._build.capi_library() returns its path.  A client links
// against that path; the obmd_tpu_torch package must be importable
// (PYTHONPATH holding the repository's root) when it runs.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>
#include <string>

namespace {

struct Handle {
  PyObject* ns = nullptr;  // per-handle namespace dict
  std::string err;
};

const char* kBootstrap = R"PY(
from obmd_tpu_torch.capi import open_session as _open_session

_h = _open_session()
_command = _h.command
_file = _h.file
_natoms = _h.natoms
_thermo = _h.thermo
_gather = _h.gather
_gather_int = _h.gather_int
_scatter = _h.scatter
)PY";

bool ensure_python() {
  if (!Py_IsInitialized()) Py_InitializeEx(0);
  return Py_IsInitialized();
}

void capture_error(Handle* h) {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  if (value) {
    PyObject* s = PyObject_Str(value);
    h->err = s ? PyUnicode_AsUTF8(s) : "unknown python error";
    Py_XDECREF(s);
  } else {
    h->err = "unknown error";
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

PyObject* call(Handle* h, const char* fn, PyObject* args) {
  PyObject* f = PyDict_GetItemString(h->ns, fn);  // borrowed
  if (!f) {
    h->err = std::string("missing bootstrap function ") + fn;
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* r = PyObject_CallObject(f, args);
  Py_XDECREF(args);
  if (!r) capture_error(h);
  return r;
}

}  // namespace

extern "C" {

void* obmd_open(void) {
  if (!ensure_python()) return nullptr;
  auto* h = new Handle();
  h->ns = PyDict_New();
  PyDict_SetItemString(h->ns, "__builtins__", PyEval_GetBuiltins());
  PyObject* r = PyRun_String(kBootstrap, Py_file_input, h->ns, h->ns);
  if (!r) {
    capture_error(h);
    return h;  // error readable via obmd_last_error
  }
  Py_DECREF(r);
  return h;
}

const char* obmd_last_error(void* vh) {
  auto* h = static_cast<Handle*>(vh);
  return h->err.empty() ? nullptr : h->err.c_str();
}

int obmd_command(void* vh, const char* line) {
  auto* h = static_cast<Handle*>(vh);
  h->err.clear();
  PyObject* r = call(h, "_command", Py_BuildValue("(s)", line));
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

int obmd_file(void* vh, const char* path) {
  auto* h = static_cast<Handle*>(vh);
  h->err.clear();
  PyObject* r = call(h, "_file", Py_BuildValue("(s)", path));
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

long long obmd_get_natoms(void* vh) {
  auto* h = static_cast<Handle*>(vh);
  h->err.clear();
  PyObject* r = call(h, "_natoms", PyTuple_New(0));
  if (!r) return -1;
  long long n = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return n;
}

double obmd_get_thermo(void* vh, const char* what) {
  auto* h = static_cast<Handle*>(vh);
  h->err.clear();
  PyObject* r = call(h, "_thermo", Py_BuildValue("(s)", what));
  if (!r) return -1.0;
  double v = PyFloat_AsDouble(r);
  Py_DECREF(r);
  return v;
}

// Gather a per-atom [natoms, 3] field ("x", "v", "f") in ascending-tag
// order into `out` (caller allocates 3*natoms doubles) — the
// lammps_gather_atoms analogue.
int obmd_gather(void* vh, const char* name, double* out) {
  auto* h = static_cast<Handle*>(vh);
  h->err.clear();
  PyObject* r = call(h, "_gather", Py_BuildValue("(s)", name));
  if (!r) return -1;
  char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(r, &buf, &len) != 0) {
    capture_error(h);
    Py_DECREF(r);
    return -1;
  }
  memcpy(out, buf, len);
  Py_DECREF(r);
  return 0;
}

// Gather a per-atom integer field ("id", "type" (1-based), "mol") in
// ascending-tag order into `out` (caller allocates natoms int64s).
int obmd_gather_int(void* vh, const char* name, long long* out) {
  auto* h = static_cast<Handle*>(vh);
  h->err.clear();
  PyObject* r = call(h, "_gather_int", Py_BuildValue("(s)", name));
  if (!r) return -1;
  char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(r, &buf, &len) != 0) {
    capture_error(h);
    Py_DECREF(r);
    return -1;
  }
  memcpy(out, buf, len);
  Py_DECREF(r);
  return 0;
}

// Scatter a per-atom [natoms, 3] field ("x", "v", "f") from ascending-tag
// order back into the system — the lammps_scatter_atoms analogue.
// Scattering "x" rebuilds the neighbor structures.
int obmd_scatter(void* vh, const char* name, const double* in,
                 long long natoms) {
  auto* h = static_cast<Handle*>(vh);
  h->err.clear();
  PyObject* r = call(h, "_scatter",
                     Py_BuildValue("(sy#)", name, (const char*)in,
                                   (Py_ssize_t)(3 * natoms * sizeof(double))));
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

void obmd_close(void* vh) {
  auto* h = static_cast<Handle*>(vh);
  Py_XDECREF(h->ns);
  delete h;
}

}  // extern "C"
