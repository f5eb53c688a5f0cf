"""Builds the port's CUDA kernels and host libraries and binds them with
ctypes.

Each kernel source under `csrc/` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), at first use, into `csrc/build/` (listed in `.gitignore`).
The library name carries a hash of the source and the flags, so an edited
source is rebuilt and never loaded stale.  `build_all` starts one `nvcc`
per source at once (per part, for a source split into translation units:
SOURCE_PARTS) and waits for all of them; kernels that share a source
share its library.

Every kernel has one `Kernel` record here.  Its wrapper adds one to
`launches` each time it launches the kernel, and only there, so a run can
show which kernels its main path went through.

The host libraries (`HostLibrary`: the data-file reader and dump writers
of `csrc/obmdio.cpp`, the C library API of `csrc/obmdc_torch.cpp`) are
host C++ with no CUDA, built by the host's C++ compiler the same way (a
hashed name, a temporary output renamed into place), so they build on a
machine without the CUDA toolkit too.  `build_all` builds them beside the
kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
# -split-compile=0: nvcc runs a translation unit's optimizer on every core
# of the host (its front end, code generation and ptxas take one core)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")
# Sources compiled as several translation units at once, their parts
# selected by a macro (the source's header says which instantiations each
# holds), and linked into one library: -split-compile parallelizes only
# the optimizer, so pair_kernel.cu's instantiations as one unit took
# about a minute to build (PERF.md §6); usher_kernel.cu's float64 entry
# points build beside its float32 ones.  Undefined references fail the
# link.
SOURCE_PARTS = {"pair_kernel.cu": ("OBMD_PAIR_PART", 12),
                "usher_kernel.cu": ("OBMD_USHER_PART", 2)}
NVCC_COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)
NVCC_LINK_FLAGS = (NVCC_FLAGS[0], "-shared", "-Xlinker", "-z", "-Xlinker",
                   "defs")

# the host libraries' compiler flags (no CUDA)
HOST_CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_U = ctypes.c_uint32


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its source, C symbol and launch count."""

    name: str
    source: str                      # file name under csrc/
    symbol: str
    argtypes: Tuple
    replaces: str                    # the TPU kernel it replaces
    launches: int = 0
    launches_by_shape: Dict[str, int] = dataclasses.field(default_factory=dict)
    build_seconds: Optional[float] = None
    ptxas_info: str = ""
    _fn: object = None

    @property
    def source_path(self) -> Path:
        return CSRC / self.source

    def library_path(self) -> Path:
        flags = NVCC_FLAGS + tuple(map(str, SOURCE_PARTS.get(self.source,
                                                              ())))
        h = hashlib.sha256(self.source_path.read_bytes()
                           + " ".join(flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source_path.stem}-{h}.so"

    def count(self, shape_key: str) -> None:
        self.launches += 1
        self.launches_by_shape[shape_key] = (
            self.launches_by_shape.get(shape_key, 0) + 1)

    def function(self):
        """The bound C entry point, building the library on first use."""
        if self._fn is None:
            lib_path = self.library_path()
            if not lib_path.exists():
                build_all([self])
            lib = ctypes.CDLL(str(lib_path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


# fld, tag, occ, pbond, out, nb, cap, lanes, nx, ny, nz, s, p, per_x,
# per_y, per_z, law, n_excl, lx, ly, lz, inv_lx, inv_ly, inv_lz, a0, gamma,
# sigma, cut, inv_cut, dtinvsqrt, lj1, lj2, salt, tables (host float32),
# ntypes, gaussian, ramp, sig_scale, the tile plan (tile_x, tile_y, tile_z,
# split, shared memory bytes), the body (1: dense), the dense body's
# scratch, the grid's origin lo (x, y, z), stream
_PAIR_ARGS = (_P,) * 5 + (_I,) * 13 + (_F,) * 14 + (_U, _P, _I, _I, _I, _F) \
    + (_I,) * 6 + (_P,) + (_F,) * 3 + (_P,)
_L = ctypes.c_longlong
# per side x, type, valid, B; cand_l, cand_r, K, scratch, scratch words,
# out_pos, out_acc, out_iters, cells, grid, bounds, coef (host arrays),
# ntypes, nattempt, ly, lz, thresh, etarget, ds0, uovlp, dsovlp, four_eps,
# eps, stream; the float64 entry points take the nine reals as doubles
_USHER_ARGS = ((_P,) * 3 + (_I,)) * 2 + (_P, _P, _I, _P, _L) + (_P,) * 7 \
    + (_I,) * 2 + (_F,) * 9 + (_P,)
_USHER_ARGS_F64 = _USHER_ARGS[:-10] + (_D,) * 9 + (_P,)
# the float64 rows' TPU counterpart: the same kernel, which the JAX nlist
# engine runs as the XLA usher_search_subset at x64
_F64_REPLACES = ("obmd_tpu/forces/pallas_usher.py:110 (float64; the JAX "
                 "nlist engine's XLA usher_search_subset at x64)")

KERNELS: Dict[str, Kernel] = {
    "pair": Kernel(
        name="pair", source="pair_kernel.cu", symbol="obmd_pair",
        argtypes=_PAIR_ARGS,
        replaces="obmd_tpu/forces/pallas_dpd.py:575 and :324"),
    "dpd_full": Kernel(
        name="dpd_full", source="pair_kernel.cu", symbol="obmd_dpd_full",
        argtypes=_PAIR_ARGS,
        replaces="obmd_tpu/forces/pallas_dpd.py:909"),
    "usher_search": Kernel(
        name="usher_search", source="usher_kernel.cu",
        symbol="obmd_usher_search", argtypes=_USHER_ARGS,
        replaces="obmd_tpu/forces/pallas_usher.py:110"),
    # the DPD entry point on dpd/ext's conservative rows, counted apart.
    # The TPU kernel holds these rows, but no JAX path launches them: its
    # cellpad engine refuses dpd/ext and its nlist stage searches with
    # the XLA usher_search_subset (obmd_tpu/obmd/stage.py:397-420), for
    # which this kernel stands on the port's nlist engine
    "usher_search_dpdext": Kernel(
        name="usher_search_dpdext", source="usher_kernel.cu",
        symbol="obmd_usher_search", argtypes=_USHER_ARGS,
        replaces="obmd_tpu/forces/pallas_usher.py:110 (dpd/ext rows "
                 ":48-56)"),
    "usher_search_lj": Kernel(
        name="usher_search_lj", source="usher_kernel.cu",
        symbol="obmd_usher_search_lj", argtypes=_USHER_ARGS,
        replaces="obmd_tpu/forces/pallas_usher.py:110 (lj rows :57-75, "
                 "E and F :155-166)"),
    # the same entry point on the neutral lj/cut/rf rows, counted apart
    "usher_search_ljrf": Kernel(
        name="usher_search_ljrf", source="usher_kernel.cu",
        symbol="obmd_usher_search_lj", argtypes=_USHER_ARGS,
        replaces="obmd_tpu/forces/pallas_usher.py:110 (neutral lj/cut/rf "
                 "rows :57-75, E and F :155-166)"),
    # each law again on a float64 scene's subsets (usher_kernel.py picks
    # the instantiation from the subset's dtype)
    "usher_search_f64": Kernel(
        name="usher_search_f64", source="usher_kernel.cu",
        symbol="obmd_usher_search_f64", argtypes=_USHER_ARGS_F64,
        replaces=_F64_REPLACES),
    "usher_search_dpdext_f64": Kernel(
        name="usher_search_dpdext_f64", source="usher_kernel.cu",
        symbol="obmd_usher_search_f64", argtypes=_USHER_ARGS_F64,
        replaces=_F64_REPLACES),
    "usher_search_lj_f64": Kernel(
        name="usher_search_lj_f64", source="usher_kernel.cu",
        symbol="obmd_usher_search_lj_f64", argtypes=_USHER_ARGS_F64,
        replaces=_F64_REPLACES),
    "usher_search_ljrf_f64": Kernel(
        name="usher_search_ljrf_f64", source="usher_kernel.cu",
        symbol="obmd_usher_search_lj_f64", argtypes=_USHER_ARGS_F64,
        replaces=_F64_REPLACES),
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.launches_by_shape.clear()


@dataclasses.dataclass
class HostLibrary:
    """A host C++ library of the port: its source under csrc/ (whose header
    names the JAX package's library it stands for), and whether it embeds
    CPython (then the include and link flags come from this interpreter's
    sysconfig)."""

    name: str
    source: str
    embeds_python: bool = False
    build_seconds: Optional[float] = None

    @property
    def source_path(self) -> Path:
        return CSRC / self.source

    def flags(self) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        """(compile flags, link flags after the source)."""
        if not self.embeds_python:
            return HOST_CXX_FLAGS, ()
        libdir = sysconfig.get_config_var("LIBDIR")
        include = "-I" + sysconfig.get_config_var("INCLUDEPY")
        return (HOST_CXX_FLAGS + (include,),
                ("-L" + libdir, "-lpython%d.%d" % sys.version_info[:2],
                 "-Wl,-rpath," + libdir))

    def library_path(self) -> Path:
        cflags, lflags = self.flags()
        h = hashlib.sha256(self.source_path.read_bytes()
                           + " ".join(cflags + lflags).encode()
                           ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source_path.stem}-{h}.so"

    def path(self) -> Path:
        """The built library, building it on first use."""
        out = self.library_path()
        if not out.exists():
            build_all([], [self])
        return out


HOST_LIBRARIES: Dict[str, HostLibrary] = {
    "obmdio": HostLibrary(name="obmdio", source="obmdio.cpp"),
    "obmdc": HostLibrary(name="obmdc", source="obmdc_torch.cpp",
                         embeds_python=True),
}


def capi_library() -> Path:
    """The port's C library API (obmd_open ... obmd_close, the symbols of
    native/obmdc.cpp), built on first use: the shared library a C or
    Fortran client links against."""
    return HOST_LIBRARIES["obmdc"].path()


def cxx_path() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if found is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the host "
                           "libraries are built at first use")
    return found


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build_all(kernels=None, libraries=None) -> Dict[str, float]:
    """Compile every kernel and host library whose library is missing, one
    compiler per source, all started together; with neither argument given,
    every kernel and every host library.  Returns seconds per kernel and
    library; raises with the compiler's output if any build fails."""
    if kernels is None and libraries is None:
        kernels, libraries = KERNELS.values(), HOST_LIBRARIES.values()
    kernels, libraries = list(kernels or ()), list(libraries or ())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    by_lib: Dict[Path, list] = {}
    for k in kernels:
        by_lib.setdefault(k.library_path(), []).append(k)
    jobs = []
    # a parted source's library: (kernels, library, temporary, objects,
    # link command), linked once all its parts have compiled
    links = []
    t0 = time.perf_counter()
    nvcc = None
    for out, ks in by_lib.items():
        if out.exists():
            for k in ks:
                k.build_seconds = 0.0
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src = str(ks[0].source_path)
        if ks[0].source not in SOURCE_PARTS:
            jobs.append((ks, out, tmp, [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                                        src]))
            continue
        macro, n = SOURCE_PARTS[ks[0].source]
        objs = [out.with_suffix(f".{os.getpid()}.part{i}.o")
                for i in range(n)]
        for i, obj in enumerate(objs):
            jobs.append((ks, None, obj, [nvcc, *NVCC_COMPILE_FLAGS,
                                         f"-D{macro}={i}", "-o", str(obj),
                                         src]))
        links.append((ks, out, tmp, objs, [nvcc, *NVCC_LINK_FLAGS, "-o",
                                           str(tmp), *map(str, objs)]))
    for lib in libraries:
        out = lib.library_path()
        if out.exists():
            lib.build_seconds = 0.0
            continue
        cflags, lflags = lib.flags()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        jobs.append(([lib], out, tmp, [cxx_path(), *cflags, "-o", str(tmp),
                                       str(lib.source_path), *lflags]))
    procs = [(ks, out, tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for ks, out, tmp, cmd in jobs]

    def finish(job):
        """The compiler's output and its seconds, read as it ends."""
        log, _ = job[3].communicate()
        return log, time.perf_counter() - t0
    with ThreadPoolExecutor(max_workers=max(len(procs), 1)) as pool:
        ended = list(pool.map(finish, procs))
    failed, part_logs = [], {}
    for (ks, out, tmp, p), (log, secs) in zip(procs, ended):
        if out is None:
            part_logs.setdefault(id(ks), []).append(log)
        for k in ks:
            k.build_seconds = secs
            if isinstance(k, Kernel) and out is not None:
                k.ptxas_info = ptxas_lines(log)
        if p.returncode != 0:
            failed.append(f"{ks[0].source}: {' '.join(p.args[-4:])} "
                          f"rc={p.returncode}\n{log}")
            continue
        if out is not None:
            os.replace(tmp, out)
    for ks, out, tmp, objs, cmd in links:
        if not failed:
            p = subprocess.run(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            if p.returncode != 0:
                failed.append(f"{ks[0].source}: link rc={p.returncode}\n"
                              f"{p.stdout}")
            else:
                os.replace(tmp, out)
        secs = time.perf_counter() - t0
        for k in ks:
            k.build_seconds = secs
            if isinstance(k, Kernel):
                k.ptxas_info = ptxas_lines("\n".join(part_logs[id(ks)]))
        for obj in objs:
            obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return {k.name: k.build_seconds for k in kernels + libraries}


def check(rc: int, kernel: Kernel) -> None:
    """Raise on a refused launch (the C entry point returns
    cudaGetLastError() right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with error "
                           f"code {rc}")


def ptxas_lines(log: str) -> str:
    """The resource report of nvcc's -Xptxas -v output: its ptxas lines
    and the stack-frame line under each function."""
    return "\n".join(line for line in log.splitlines()
                     if "ptxas" in line or "bytes stack frame" in line)


def ptxas_table(log: str) -> Dict[str, Tuple[int, int, int, int]]:
    """{function symbol: (registers, stack bytes, shared bytes, spill store
    bytes)} of a ptxas report (ptxas_lines)."""
    out: Dict[str, list] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) "
                      r"'?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, [0, 0, 0, 0])
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out[name][1] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[name][3] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[name][2] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def instantiation(symbol: str):
    """The template arguments of a pair_kernel instantiation as a tuple of
    ints (law, legacy, exclusion channels, types, gauss, ramp, one cell,
    open), or None for another function.  The exclusion flag of an older
    source (a bool, 1 = two channels) reads as 2, so that both sources'
    instantiations line up."""
    m = re.search(r"pair_kernelI((?:L[bi]\d+E)+)E", symbol)
    if m is None:
        return None
    args = [int(a) for a in re.findall(r"L[bi](\d+)E", m.group(1))]
    if re.findall(r"L([bi])\d+E", m.group(1))[2] == "b":
        args[2] *= 2
    return tuple(args)


def compare_ptxas(old_src: str, new_src: str) -> dict:
    """Compile two versions of a kernel source with NVCC_FLAGS at once and
    line up their pair_kernel instantiations: each one present in both with
    its (registers, stack, shared, spill stores) unchanged or changed, and
    those only in one; the other kernels of each (the dense body and its
    compaction pass) by symbol.  Returns the figures and each build's
    seconds."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs, t0 = [], time.perf_counter()
        for k, src in enumerate((old_src, new_src)):
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", os.path.join(tmp, f"{k}.so"), src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, secs = [], []
        for p in procs:
            log, _ = p.communicate()
            secs.append(time.perf_counter() - t0)
            if p.returncode != 0:
                raise RuntimeError(f"nvcc rc={p.returncode}\n{log}")
            logs.append(log)
    tables, others = [], []
    for log in logs:
        tab, other = {}, {}
        for sym, res in ptxas_table(ptxas_lines(log)).items():
            key = instantiation(sym)
            if key is not None:
                tab[key] = res
            elif sym.startswith("_Z"):
                other[sym] = res
        tables.append(tab)
        others.append(other)
    old, new = tables
    both = sorted(set(old) & set(new))

    def only(a, b):
        return [dict(args=k, res=a[k]) for k in sorted(set(a) - set(b))]
    return dict(
        old=len(old), new=len(new), build_s=secs,
        unchanged=sum(old[k] == new[k] for k in both),
        changed=[dict(args=k, old=old[k], new=new[k]) for k in both
                 if old[k] != new[k]],
        only_old=only(old, new), only_new=only(new, old),
        other_old=others[0], other_new=others[1])


if __name__ == "__main__":
    # python3 -m obmd_tpu_torch._build OLD.cu NEW.cu: the ptxas resources
    # (registers, stack, shared memory) of each pair_kernel instantiation
    # of two versions of a source, lined up, as one JSON line
    if len(sys.argv) != 3:
        sys.exit("usage: python3 -m obmd_tpu_torch._build OLD.cu NEW.cu")
    print(json.dumps(compare_ptxas(sys.argv[1], sys.argv[2])))
