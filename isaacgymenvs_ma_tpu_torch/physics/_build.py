"""Build the CUDA kernels with nvcc and bind them through ctypes.

Route: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` per source into one shared library each, with a plain C interface
(``extern "C" int <name>_launch(int device, ..., int N, void* stream)``
returning the CUDA error code).  The library links its own CUDA runtime,
so each launch selects the tensors' device itself.
Each plan's header (``DynPlan.header``: the static tree for B1-B3;
``ContactPlan.header``: the row masks and loop constants for B4;
``SpdPlan.header``: the matrix size for B5) is force-included (``-include``), so the static scene is compiled into the
kernels.

Libraries go to ``build/torch_kernels/<hash>/`` next to the package (a
directory git ignores), keyed by a hash of the sources, the header and the
flags; they are built at first use and reused afterwards.  A missing
``nvcc`` or a failed compile raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures: (int device, void* tensors..., int N, void* stream)
_ARGTYPES = {
    name: [ctypes.c_int] + [ctypes.c_void_p] * n_ptr
    + [ctypes.c_int, ctypes.c_void_p]
    for name, n_ptr in (("fk_motion", 4), ("dyn_forward", 11),
                        ("dyn_cached", 7), ("contact_solve", 23),
                        ("spd_inverse", 2))
}


NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def nvcc_path() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append(NVCC_DEFAULT)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin):"
        " the CUDA kernels cannot be built")


def _sources(name):
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def lib_dir(name: str, header: str) -> Path:
    """Build directory of one kernel for one scene header."""
    h = hashlib.sha256()
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(header.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"


def _load(name: str, so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, name + "_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return lib


def build(plan, names=None, wait=True):
    """Build (where not yet built) and load the named kernels of ``plan``
    (default: all of ``plan.kernel_names``), one nvcc process per source,
    all started together.  Stores the loaded libraries in ``plan.libs`` and
    the compiler reports in ``plan.build_log``; returns ``plan.libs``.

    ``wait=False`` only starts the compilers and returns a callable that
    waits for them and loads the libraries, so that the builds of several
    plans run side by side."""
    header = plan.header()
    names = plan.kernel_names if names is None else names
    procs = {}
    for name in names:
        if name in plan.libs:
            continue
        d = lib_dir(name, header)
        so = d / f"lib{name}.so"
        if so.is_file():
            plan.libs[name] = _load(name, so)
            log = d / "nvcc.log"
            plan.build_log[name] = log.read_text() if log.is_file() else ""
            continue
        nvcc = nvcc_path()
        d.mkdir(parents=True, exist_ok=True)
        hdr = d / "scene.h"
        hdr.write_text(header)
        tmp = d / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-include", str(hdr),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       d, tmp, so)

    def finish():
        errors = []
        for name, (proc, d, tmp, so) in procs.items():
            out, _ = proc.communicate()
            (d / "nvcc.log").write_text(out)
            plan.build_log[name] = out
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name} "
                              f"(rc {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, so)   # atomic: a reader never sees a partial .so
            plan.libs[name] = _load(name, so)
        if errors:
            raise RuntimeError("\n".join(errors))
        return plan.libs

    return finish() if wait else finish


def load(plan, name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    lib = plan.libs.get(name)
    if lib is None:
        lib = build(plan, (name,))[name]
    return lib
