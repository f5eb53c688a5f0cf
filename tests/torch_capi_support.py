"""The C client of tests/test_c_api.py, built against a C library API (the
JAX package's native/libobmdc.so or the port's obmdc_torch), with one
addition: given a second argument, it writes the tag-ordered positions
and ids after its `run 5` to that file (read_client_dump).  CLIENT_C is
this file's own copy of test_c_api.py's client source
(tests/test_torch_c_api.py holds the two equal), so this file imports
no JAX and no JAX test, and chip_smoke.py builds the same client on the
card (it loads this file by path: the machine with the card has another
package named `tests` on its path)."""
import os
import shutil
import subprocess
import sys
import sysconfig

import numpy as np


# tests/test_c_api.py's client, as it stands there
CLIENT_C = r"""
#include <stdio.h>
#include <stdlib.h>
extern void* obmd_open(void);
extern int obmd_file(void*, const char*);
extern long long obmd_get_natoms(void*);
extern double obmd_get_thermo(void*, const char*);
extern int obmd_gather(void*, const char*, double*);
extern int obmd_gather_int(void*, const char*, long long*);
extern int obmd_scatter(void*, const char*, const double*, long long);
extern int obmd_command(void*, const char*);
extern const char* obmd_last_error(void*);
extern void obmd_close(void*);
int main(int argc, char** argv) {
  void* h = obmd_open();
  const char* e = obmd_last_error(h);
  if (e) { fprintf(stderr, "open: %s\n", e); return 1; }
  if (obmd_file(h, argv[1]) != 0) {
    fprintf(stderr, "file: %s\n", obmd_last_error(h)); return 1; }
  long long n = obmd_get_natoms(h);
  double T = obmd_get_thermo(h, "temp");
  double step = obmd_get_thermo(h, "step");
  double* x = malloc(3 * n * sizeof(double));
  if (obmd_gather(h, "x", x) != 0) {
    fprintf(stderr, "gather: %s\n", obmd_last_error(h)); return 1; }
  /* typed id gather: ascending tags 1..n */
  long long* ids = malloc(n * sizeof(long long));
  if (obmd_gather_int(h, "id", ids) != 0) {
    fprintf(stderr, "gather_int: %s\n", obmd_last_error(h)); return 1; }
  int ids_ok = (ids[0] == 1 && ids[n - 1] == n);
  for (long long i = 1; i < n; i++) if (ids[i] <= ids[i - 1]) ids_ok = 0;
  /* scatter/gather pairing: halve all velocities, read them back */
  double* v = malloc(3 * n * sizeof(double));
  if (obmd_gather(h, "v", v) != 0) {
    fprintf(stderr, "gather v: %s\n", obmd_last_error(h)); return 1; }
  double v00 = v[0];
  for (long long i = 0; i < 3 * n; i++) v[i] *= 0.5;
  if (obmd_scatter(h, "v", v, n) != 0) {
    fprintf(stderr, "scatter: %s\n", obmd_last_error(h)); return 1; }
  if (obmd_gather(h, "v", v) != 0) {
    fprintf(stderr, "regather: %s\n", obmd_last_error(h)); return 1; }
  int v_ok = (v00 == 0.0) ? 1 : (v[0] / v00 > 0.49 && v[0] / v00 < 0.51);
  /* scatter x (triggers a neighbor rebuild) and keep running */
  if (obmd_scatter(h, "x", x, n) != 0) {
    fprintf(stderr, "scatter x: %s\n", obmd_last_error(h)); return 1; }
  if (obmd_command(h, "run 5") != 0) {
    fprintf(stderr, "run: %s\n", obmd_last_error(h)); return 1; }
  double step2 = obmd_get_thermo(h, "step");
  printf("natoms=%lld temp=%.4f step=%.0f x0=%.4f ids_ok=%d v_ok=%d "
         "step2=%.0f\n", n, T, step, x[0], ids_ok, v_ok, step2);
  obmd_close(h);
  return 0;
}
"""

_STEP2 = '  double step2 = obmd_get_thermo(h, "step");\n'
_DUMP_X = _STEP2 + r'''  if (argc > 2) {
    long long nf = obmd_get_natoms(h);
    double* xf = malloc(3 * nf * sizeof(double));
    long long* idf = malloc(nf * sizeof(long long));
    if (obmd_gather(h, "x", xf) != 0 || obmd_gather_int(h, "id", idf) != 0) {
      fprintf(stderr, "final gather: %s\n", obmd_last_error(h)); return 1; }
    FILE* fp = fopen(argv[2], "wb");
    if (!fp || fwrite(xf, sizeof(double), 3 * nf, fp) != (size_t)(3 * nf)
        || fwrite(idf, sizeof(long long), nf, fp) != (size_t)nf) {
      fprintf(stderr, "cannot write %s\n", argv[2]); return 1; }
    fclose(fp);
  }
'''


def client_source() -> str:
    if CLIENT_C.count(_STEP2) != 1:
        raise RuntimeError("the client has no single step2 line to add the "
                           "dump after")
    return CLIENT_C.replace(_STEP2, _DUMP_X)


def build_client(lib: str, out_dir: str) -> str:
    """Compile the client against the shared library at `lib` (linked by
    path, with an rpath to its folder and to libpython's); returns the
    executable's path."""
    gcc = shutil.which("gcc") or shutil.which("cc")
    if gcc is None:
        raise RuntimeError("no C compiler (gcc or cc) on PATH")
    src = os.path.join(out_dir, "client.c")
    exe = os.path.join(out_dir, "client")
    with open(src, "w") as fh:
        fh.write(client_source())
    libdir = sysconfig.get_config_var("LIBDIR")
    subprocess.run([gcc, src, "-o", exe, os.path.abspath(lib),
                    "-L" + libdir, "-lpython%d.%d" % sys.version_info[:2],
                    "-Wl,-rpath," + os.path.dirname(os.path.abspath(lib)),
                    "-Wl,-rpath," + libdir], check=True, capture_output=True)
    return exe


def parse_client_line(stdout: str) -> dict:
    """The client's last line, `natoms=... step2=...`, as {key: str}."""
    line = stdout.strip().splitlines()[-1]
    return dict(kv.split("=", 1) for kv in line.split())


def read_client_dump(path):
    """(x [n, 3] float64, ids [n] int64) of the client's dump."""
    raw = np.fromfile(path, dtype=np.uint8)
    n = raw.size // 32
    x = raw[:24 * n].view(np.float64).reshape(n, 3)
    return x, raw[24 * n:].view(np.int64)
