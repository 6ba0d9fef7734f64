"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use, each source is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), the objects are linked into one shared
library with a plain C interface under ``<repo>/build/kernels/``, and the
library is loaded with ``ctypes``.  The library's file name carries a hash
of the sources and flags, so an edited source is rebuilt and a built one is
reused.  Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("poseidon.cu", "ntt.cu", "grand_product.cu", "fieldops.cu")
HEADERS = ("montgomery.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_info: dict = {}      # seconds, library path, ptxas report of the build


def nvcc() -> str:
    """Path of the CUDA compiler; raises if there is none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode() + b"\0" + (CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library, unless
    a library built from these exact sources exists.  Returns its path."""
    lib_path = BUILD_DIR / f"libzkgraph_kernels_{_digest()}.so"
    if lib_path.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("log", "(reused an existing build)")
        build_info["library"] = str(lib_path)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [cc, *ARCH, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    failed = []
    for name, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"tmp_{tag}.so"
    link = subprocess.run([cc, *ARCH, "-shared", *map(str, objs), "-o",
                           str(tmp)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0,
                      log="\n".join(logs), library=str(lib_path))
    return lib_path


def load():
    """The loaded kernel library (built at first call), with its C entry
    points' argument types declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, i, u = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_uint)
            lib.zk_poseidon_permute.argtypes = [vp, vp, vp, ll, i, vp]
            lib.zk_poseidon_permute.restype = i
            lib.zk_ntt_pass.argtypes = [vp, vp, vp, ll, i, i, i, i, i, u, i,
                                        vp]
            lib.zk_ntt_pass.restype = i
            lib.zk_grand_product_scratch.argtypes = [ll, ll, i]
            lib.zk_grand_product_scratch.restype = ll
            lib.zk_grand_product.argtypes = [vp, vp, vp, ll, ll, i, i, vp]
            lib.zk_grand_product.restype = i
            lib.zk_fieldops.argtypes = [vp, vp, vp, vp, ll, i, vp]
            lib.zk_fieldops.restype = i
            _lib = lib
        return _lib


def check(rc: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
