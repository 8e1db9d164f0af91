"""Build and load the port's CUDA kernels.

The sources in ``repro_torch/csrc/*.cu`` have a plain C interface. At first
use they are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per
source, all started together), linked into one shared library under
``build/`` at the repository root, and loaded with ``ctypes``. The library's
file name carries a hash of the sources, their shared header and the
flags, so a changed source or header rebuilds. A build holds an exclusive
``flock`` on ``build/.build.lock`` and renames the linked library into place,
so processes that load at once (the ranks of a sharded calibration) make
one build and never read a half-written file. Nothing here runs at import
time: this module is imported on machines without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("lowrank_linear.cu", "paged_attention.cu", "chunked_prefill.cu",
           "flash_attention.cu", "gram_accum.cu")
HEADERS = ("common.cuh",)       # included by the sources
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the library's entry points: name -> (restype, argtypes)
SIGNATURES = {
    "repro_lowrank_linear": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _P]),
    "repro_paged_attention": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _F, _F, _I, _I, _I, _I, _I, _P]),
    "repro_chunked_prefill": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _F, _I, _I, _I, _I, _I, _P]),
    "repro_flash_attention": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                                   _P]),
    "repro_gram_accum": (_I, [_P, _P, _I, _I, _I, _I, _P]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or PATH."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from repro_torch/csrc at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"repro_torch_kernels-{_digest()}.so"


def build(verbose: bool = False) -> Path:
    """Compile (if the sources changed) and return the shared library path.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report of
    registers, shared memory and spills per kernel. Processes that call it
    at once take turns on the build lock: the first builds, the others find
    its library."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # released when the file closes
        if not so.exists():
            _compile(so, verbose)
    return so


def _compile(so: Path, verbose: bool) -> None:
    """nvcc every source into a temporary directory, link, rename to ``so``."""
    cc = nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(str(obj))
            cmd = [cc, *NVCC_FLAGS, *extra, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, p in procs:
            out, _ = p.communicate()
            if verbose and out:
                print(f"[nvcc {name}]\n{out}", flush=True)
            if p.returncode != 0:
                failed.append(f"{name} (exit {p.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run([cc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp_so)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is not None:            # every launch comes here: skip the lock
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
