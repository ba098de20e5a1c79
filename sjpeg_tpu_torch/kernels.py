"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, `_build/lib<name>-<hash>.so`, where the hash covers the sources
and flags, so an edited source builds anew.  The first use of any kernel
builds every missing library, one nvcc per source, all started together.
Nothing builds while the package is imported.  A module lock serialises
the first builds and loads of concurrent threads (the serving wrappers
launch from several), and temporary names carry the pid and the thread.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_functions = {}
_lock = threading.RLock()


def nvcc_path() -> str:
    """The nvcc on PATH, else the one under CUDA_HOME or /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "at first use and need the CUDA toolkit")


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Build every missing library; returns {name: nvcc output} for the
    libraries built by this call.  Raises with nvcc's output on failure."""
    with _lock:
        todo = [n for n in kernel_names() if not library_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(exist_ok=True)
        nvcc = nvcc_path()
        jobs = []
        for name in todo:
            target = library_path(name)
            tmp = target.with_name(f"{target.name}.{os.getpid()}."
                                  f"{threading.get_ident()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            jobs.append((name, target, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, errors = {}, []
        for name, target, tmp, proc in jobs:
            logs[name] = proc.communicate()[0]
            if proc.returncode:
                errors.append(f"{name}: nvcc exited {proc.returncode}\n"
                              f"{logs[name]}")
            else:
                os.replace(tmp, target)    # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return logs


def function(lib_name: str, fn_name: str, argtypes):
    """The C function `fn_name` of library `lib_name`, built if needed.
    Pointers and the stream are c_void_p, ints c_int; it returns an int
    CUDA error code."""
    key = (lib_name, fn_name)
    fn = _functions.get(key)
    if fn is None:
        with _lock:
            if key not in _functions:
                build_all()
                fn = getattr(ctypes.CDLL(str(library_path(lib_name))),
                             fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _functions[key] = fn
            fn = _functions[key]
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
