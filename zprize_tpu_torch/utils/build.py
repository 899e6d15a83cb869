"""Build the CUDA sources of ``csrc/``, and its host C++ sources, into plain
shared libraries and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>.so`` inside the package
(listed in ``.gitignore``), compiled for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

at first use, and again when any source in ``csrc/`` is newer than the
library.  The sources expose a plain C interface and include no PyTorch
header, so a build takes seconds.  All sources build in parallel, one
``nvcc`` each.  A failed build raises with the compiler's output; the
compiler's register and spill report is kept beside each library as
``lib<name>.log``.

Each host source ``csrc/<name>.cc`` (code for the CPU, such as the
verifier's linear combination) becomes ``_build/lib<name>.so`` too, built
with the host C++ compiler

    c++ -std=c++17 -O3 -shared -fPIC

at first use, and again when the source is newer than the library.  Its
failure raises with the compiler's output as well.  `build_all` starts the
host builds beside the nvcc ones; `load` of a host library runs only its
own build, so it needs no CUDA toolkit.

The stale check and the build hold an exclusive `flock` on
``_build/.lock``, so that processes started together (the ranks of a
sharded run) build a library once: the others wait, then find it current.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX = "c++"
CXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def cxx_path() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"host C++ compiler {CXX!r} not found: the host "
                           "libraries cannot be built")
    return found


def _sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _host_sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cc"))


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(os.path.join(CSRC, f))
                 for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))
    return newest > os.path.getmtime(lib)


def _host_stale(name: str) -> bool:
    lib = _lib_path(name)
    return (not os.path.exists(lib) or os.path.getmtime(
        os.path.join(CSRC, f"{name}.cc")) > os.path.getmtime(lib))


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on the build directory across processes."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _start_host(name: str):
    tmp = _lib_path(name) + f".{os.getpid()}.tmp"
    cmd = [cxx_path(), *CXX_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cc")]
    return tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def build_host(name: str) -> str | None:
    """Compile ``csrc/<name>.cc`` with the host compiler if it is stale.
    Returns the compiler log, or None if the library was current."""
    with _build_lock():
        if not _host_stale(name):
            return None
        return _finish({name: _start_host(name)})[name]


def build_all() -> dict[str, str]:
    """Compile every stale ``csrc/*.cu`` and ``csrc/*.cc`` (all at once,
    one nvcc or c++ each).  Returns {name: compiler log} for the sources
    it built."""
    with _build_lock():
        names = [n for n in _sources() if _stale(n)]
        host = [n for n in _host_sources() if _host_stale(n)]
        if not names and not host:
            return {}
        nvcc = nvcc_path() if names else None
        procs = {name: _start_host(name) for name in host}
        for name in names:
            tmp = _lib_path(name) + f".{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        return _finish(procs)


def _finish(procs: dict) -> dict[str, str]:
    """Wait for the compilers; move each library into place or raise with
    the output of every failed build."""
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        with open(os.path.join(BUILD_DIR, f"lib{name}.log"), "w") as fh:
            fh.write(out)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("the build failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` or
    ``csrc/<name>.cc`` (built if stale)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if name in _host_sources():
                build_host(name)
            else:
                build_all()
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib
