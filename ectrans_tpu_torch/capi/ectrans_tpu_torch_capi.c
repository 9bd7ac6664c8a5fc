/*
 * ectrans_tpu C API implementation: embeds CPython and forwards to
 * ectrans_tpu_torch.capi_bridge (the transi-equivalent native layer; the
 * reference's transi is C over Fortran, src/transi/transi.c — here it is
 * C over the embedded Python/PyTorch engine).
 *
 * Raw pointers are passed to the bridge as (address, length) integers;
 * the bridge wraps them zero-copy with numpy.ctypeslib and runs the
 * transforms on the handle's device (a CUDA card by default).
 *
 * GIL: when this library initializes the interpreter itself, the
 * initializing thread keeps the GIL (single-threaded embedding).  When a
 * host application pre-initialized Python, every entry point takes
 * PyGILState_Ensure/Release so calls are safe from any thread even if the
 * embedder released the GIL.
 *
 * Build:  cc -shared -fPIC ectrans_tpu_torch_capi.c $(python3-config \
 *         --includes --embed --libs) -o libectrans_tpu_torch.so
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include "ectrans_tpu.h"

static PyObject *g_bridge = NULL;
static int g_we_initialized = 0;

typedef struct {
  int took;
  PyGILState_STATE st;
} gil_t;

static gil_t gil_begin(void) {
  gil_t g;
  g.took = 0;
  if (!g_we_initialized && Py_IsInitialized()) {
    g.st = PyGILState_Ensure();
    g.took = 1;
  }
  return g;
}

static void gil_end(gil_t g) {
  if (g.took) PyGILState_Release(g.st);
}

static int ensure_init(void) {
  if (g_bridge != NULL) return ECTRANS_TPU_SUCCESS;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = 1;
  }
  g_bridge = PyImport_ImportModule("ectrans_tpu_torch.capi_bridge");
  if (g_bridge == NULL) {
    PyErr_Print();
    return ECTRANS_TPU_ERR_INIT;
  }
  return ECTRANS_TPU_SUCCESS;
}

/* call bridge.<name>(args...) and return a new reference or NULL */
static PyObject *bridge_call(const char *name, PyObject *args) {
  PyObject *fn = PyObject_GetAttrString(g_bridge, name);
  if (fn == NULL) return NULL;
  PyObject *out = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  return out;
}

/* build args with Py_BuildValue fmt, call, discard result; err on NULL */
static int call_simple(const char *name, const char *fmt, ...) {
  gil_t g = gil_begin();
  if (ensure_init() != 0) {
    gil_end(g);
    return ECTRANS_TPU_ERR_INIT;
  }
  va_list va;
  va_start(va, fmt);
  PyObject *args = Py_VaBuildValue(fmt, va);
  va_end(va);
  if (args == NULL) {
    gil_end(g);
    return ECTRANS_TPU_ERR_TRANS;
  }
  PyObject *out = bridge_call(name, args);
  Py_DECREF(args);
  if (out == NULL) {
    PyErr_Print();
    gil_end(g);
    return ECTRANS_TPU_ERR_TRANS;
  }
  Py_DECREF(out);
  gil_end(g);
  return ECTRANS_TPU_SUCCESS;
}

#define PTR(p) ((unsigned long long)(uintptr_t)(p))

int ectrans_tpu_init(void) {
  gil_t g = gil_begin();
  int rc = ensure_init();
  gil_end(g);
  return rc;
}

int ectrans_tpu_setup(const char *grid, int nsmax) {
  gil_t g = gil_begin();
  if (ensure_init() != 0) {
    gil_end(g);
    return ECTRANS_TPU_ERR_INIT;
  }
  PyObject *args = Py_BuildValue("(si)", grid, nsmax);
  PyObject *out = bridge_call("setup", args);
  Py_DECREF(args);
  if (out == NULL) {
    PyErr_Print();
    gil_end(g);
    return ECTRANS_TPU_ERR_SETUP;
  }
  long h = PyLong_AsLong(out);
  Py_DECREF(out);
  gil_end(g);
  return (int)h;
}

int ectrans_tpu_set_radius(double radius) {
  return call_simple("set_radius", "(d)", radius);
}

int ectrans_tpu_setup_ex(const char *grid, int nsmax, double radius,
                         double stretch) {
  gil_t g = gil_begin();
  if (ensure_init() != 0) {
    gil_end(g);
    return ECTRANS_TPU_ERR_INIT;
  }
  PyObject *args = Py_BuildValue("(sidd)", grid, nsmax, radius, stretch);
  PyObject *out = bridge_call("setup_ex", args);
  Py_DECREF(args);
  if (out == NULL) {
    PyErr_Print();
    gil_end(g);
    return ECTRANS_TPU_ERR_SETUP;
  }
  long h = PyLong_AsLong(out);
  Py_DECREF(out);
  gil_end(g);
  return (int)h;
}

int ectrans_tpu_invtrans_full(int handle, int nvordiv, int nscalar,
                              const double *spvor, const double *spdiv,
                              const double *spscalar, int lscalarders,
                              int luvder_ew, int lvordivgp, double *gp) {
  gil_t g = gil_begin();
  if (ensure_init() != 0) {
    gil_end(g);
    return ECTRANS_TPU_ERR_INIT;
  }
  PyObject *args = Py_BuildValue("(iiiKKKiiiK)", handle, nvordiv, nscalar,
                                 PTR(spvor), PTR(spdiv), PTR(spscalar),
                                 lscalarders, luvder_ew, lvordivgp, PTR(gp));
  if (args == NULL) {
    gil_end(g);
    return ECTRANS_TPU_ERR_TRANS;
  }
  PyObject *out = bridge_call("invtrans_full", args);
  Py_DECREF(args);
  if (out == NULL) {
    PyErr_Print();
    gil_end(g);
    return ECTRANS_TPU_ERR_TRANS;
  }
  long nfld_out = PyLong_AsLong(out);
  Py_DECREF(out);
  gil_end(g);
  return (int)nfld_out;
}

int ectrans_tpu_dirtrans_full(int handle, int nvordiv, int nscalar,
                              const double *gp, double *spvor, double *spdiv,
                              double *spscalar) {
  return call_simple("dirtrans_full", "(iiiKKKK)", handle, nvordiv, nscalar,
                     PTR(gp), PTR(spvor), PTR(spdiv), PTR(spscalar));
}

int ectrans_tpu_inquire(int handle, int *nspec2, int *ngptot, int *ndgl,
                        int *ndlon, int *nsmax) {
  gil_t g = gil_begin();
  if (ensure_init() != 0) {
    gil_end(g);
    return ECTRANS_TPU_ERR_INIT;
  }
  PyObject *args = Py_BuildValue("(i)", handle);
  PyObject *out = bridge_call("inquire", args);
  Py_DECREF(args);
  if (out == NULL) {
    PyErr_Print();
    gil_end(g);
    return ECTRANS_TPU_ERR_HANDLE;
  }
  long a, b, c, d, e;
  if (!PyArg_ParseTuple(out, "lllll", &a, &b, &c, &d, &e)) {
    Py_DECREF(out);
    gil_end(g);
    return ECTRANS_TPU_ERR_HANDLE;
  }
  Py_DECREF(out);
  gil_end(g);
  if (nspec2) *nspec2 = (int)a;
  if (ngptot) *ngptot = (int)b;
  if (ndgl) *ndgl = (int)c;
  if (ndlon) *ndlon = (int)d;
  if (nsmax) *nsmax = (int)e;
  return ECTRANS_TPU_SUCCESS;
}

int ectrans_tpu_nloen(int handle, int *nloen) {
  return call_simple("fill_nloen", "(iK)", handle, PTR(nloen));
}

int ectrans_tpu_invtrans(int handle, int nfld, const double *spec,
                         double *gp) {
  return call_simple("invtrans_scalar", "(iiKK)", handle, nfld, PTR(spec),
                     PTR(gp));
}

int ectrans_tpu_dirtrans(int handle, int nfld, const double *gp,
                         double *spec) {
  return call_simple("dirtrans_scalar", "(iiKK)", handle, nfld, PTR(gp),
                     PTR(spec));
}

int ectrans_tpu_invtrans_vordiv(int handle, int nfld, const double *spvor,
                                const double *spdiv, double *u, double *v) {
  return call_simple("invtrans_vordiv", "(iiKKKK)", handle, nfld, PTR(spvor),
                     PTR(spdiv), PTR(u), PTR(v));
}

int ectrans_tpu_dirtrans_vordiv(int handle, int nfld, const double *u,
                                const double *v, double *spvor,
                                double *spdiv) {
  return call_simple("dirtrans_vordiv", "(iiKKKK)", handle, nfld, PTR(u),
                     PTR(v), PTR(spvor), PTR(spdiv));
}

int ectrans_tpu_invtrans_adj(int handle, int nfld, const double *gp_ad,
                             double *spec_ad) {
  return call_simple("invtrans_adj_scalar", "(iiKK)", handle, nfld,
                     PTR(gp_ad), PTR(spec_ad));
}

int ectrans_tpu_dirtrans_adj(int handle, int nfld, const double *spec_ad,
                             double *gp_ad) {
  return call_simple("dirtrans_adj_scalar", "(iiKK)", handle, nfld,
                     PTR(spec_ad), PTR(gp_ad));
}

int ectrans_tpu_specnorm(int handle, int nfld, const double *spec,
                         double *norms) {
  return call_simple("specnorm", "(iiKK)", handle, nfld, PTR(spec),
                     PTR(norms));
}

int ectrans_tpu_vordiv_to_uv(int handle, int nfld, const double *spvor,
                             const double *spdiv, double *u, double *v) {
  return call_simple("vordiv_to_uv", "(iiKKKK)", handle, nfld, PTR(spvor),
                     PTR(spdiv), PTR(u), PTR(v));
}

int ectrans_tpu_gpnorm(int handle, int nfld, const double *gp, double *out) {
  return call_simple("gpnorm", "(iiKK)", handle, nfld, PTR(gp), PTR(out));
}

int ectrans_tpu_invtrans_lonlat(int handle, int nlat, int nlon, int nfld,
                                const double *spec, double *gp) {
  return call_simple("invtrans_lonlat", "(iiiiKK)", handle, nlat, nlon, nfld,
                     PTR(spec), PTR(gp));
}

int ectrans_tpu_distgrid(int handle, int nfld, const double *global_gp,
                         double *local_gp) {
  return call_simple("distgrid", "(iiKK)", handle, nfld, PTR(global_gp),
                     PTR(local_gp));
}

int ectrans_tpu_gathgrid(int handle, int nfld, const double *local_gp,
                         double *global_gp) {
  return call_simple("gathgrid", "(iiKK)", handle, nfld, PTR(local_gp),
                     PTR(global_gp));
}

int ectrans_tpu_distspec(int handle, int nfld, const double *global_sp,
                         double *local_sp) {
  return call_simple("distspec", "(iiKK)", handle, nfld, PTR(global_sp),
                     PTR(local_sp));
}

int ectrans_tpu_gathspec(int handle, int nfld, const double *local_sp,
                         double *global_sp) {
  return call_simple("gathspec", "(iiKK)", handle, nfld, PTR(local_sp),
                     PTR(global_sp));
}

int ectrans_tpu_invtrans_f(int handle, int nfld, const float *spec,
                           float *gp) {
  return call_simple("invtrans_scalar_f", "(iiKK)", handle, nfld, PTR(spec),
                     PTR(gp));
}

int ectrans_tpu_dirtrans_f(int handle, int nfld, const float *gp,
                           float *spec) {
  return call_simple("dirtrans_scalar_f", "(iiKK)", handle, nfld, PTR(gp),
                     PTR(spec));
}

int ectrans_tpu_set_legpol_dir(const char *path) {
  return call_simple("set_legpol_dir", "(s)", path);
}

int ectrans_tpu_setup_lam(int nx, int ny, int nxux, int nyux, int msmax,
                          int nsmax, double dx, double dy) {
  gil_t g = gil_begin();
  if (ensure_init() != 0) {
    gil_end(g);
    return ECTRANS_TPU_ERR_INIT;
  }
  PyObject *args =
      Py_BuildValue("(iiiiiidd)", nx, ny, nxux, nyux, msmax, nsmax, dx, dy);
  PyObject *out = bridge_call("setup_lam", args);
  Py_DECREF(args);
  if (out == NULL) {
    PyErr_Print();
    gil_end(g);
    return ECTRANS_TPU_ERR_SETUP;
  }
  long h = PyLong_AsLong(out);
  Py_DECREF(out);
  gil_end(g);
  return (int)h;
}

int ectrans_tpu_inquire_lam(int handle, int *nspec2, int *ngptot, int *nx,
                            int *ny) {
  gil_t g = gil_begin();
  if (ensure_init() != 0) {
    gil_end(g);
    return ECTRANS_TPU_ERR_INIT;
  }
  PyObject *args = Py_BuildValue("(i)", handle);
  PyObject *out = bridge_call("inquire_lam", args);
  Py_DECREF(args);
  if (out == NULL) {
    PyErr_Print();
    gil_end(g);
    return ECTRANS_TPU_ERR_HANDLE;
  }
  long a, b, c, d;
  if (!PyArg_ParseTuple(out, "llll", &a, &b, &c, &d)) {
    Py_DECREF(out);
    gil_end(g);
    return ECTRANS_TPU_ERR_HANDLE;
  }
  Py_DECREF(out);
  gil_end(g);
  if (nspec2) *nspec2 = (int)a;
  if (ngptot) *ngptot = (int)b;
  if (nx) *nx = (int)c;
  if (ny) *ny = (int)d;
  return ECTRANS_TPU_SUCCESS;
}

int ectrans_tpu_invtrans_lam(int handle, int nfld, const double *spec,
                             double *gp) {
  return call_simple("invtrans_lam_scalar", "(iiKK)", handle, nfld, PTR(spec),
                     PTR(gp));
}

int ectrans_tpu_dirtrans_lam(int handle, int nfld, const double *gp,
                             double *spec) {
  return call_simple("dirtrans_lam_scalar", "(iiKK)", handle, nfld, PTR(gp),
                     PTR(spec));
}

int ectrans_tpu_release_lam(int handle) {
  return call_simple("release_lam", "(i)", handle);
}

int ectrans_tpu_release(int handle) {
  return call_simple("release", "(i)", handle);
}

int ectrans_tpu_finalize(void) {
  gil_t g = gil_begin();
  Py_XDECREF(g_bridge);
  g_bridge = NULL;
  gil_end(g);
  if (g_we_initialized && Py_IsInitialized()) {
    Py_Finalize();
    g_we_initialized = 0;
  }
  return ECTRANS_TPU_SUCCESS;
}
