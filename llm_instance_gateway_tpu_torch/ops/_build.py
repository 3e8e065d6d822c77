"""Build and load the hand-written CUDA kernels in ``ops/csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C launch function and compiles on
its own into ``build/kernels/<name>-<hash>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

— no PyTorch headers, so a source builds in seconds.  The libraries load
with ``ctypes``; pointers and the stream travel as ``c_void_p``, and every
launch function returns ``cudaGetLastError()`` so a refused launch raises
in the wrapper instead of passing silently.

Builds run at first use (``python3 chip_smoke.py`` alone builds
everything); ``build_all`` starts one ``nvcc`` per source at once.  The
hash of the source names the library, so an edited kernel never loads a
stale build.  Nothing here runs at import: the CPU tests import every
module on hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
KERNELS = ("flash_prefill", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a host with the CUDA "
            "toolkit (tensors on the CPU take the plain PyTorch versions)")
    return path


def source_path(name: str) -> str:
    return os.path.join(_CSRC, f"{name}.cu")


def _lib_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build_all(names=KERNELS, verbose: bool = False) -> dict[str, str]:
    """Compile every missing library in parallel (one nvcc per source).
    Returns name -> library path; raises with nvcc's output on failure.
    ``verbose`` adds ``-Xptxas -v`` and returns its report in
    ``build_all.last_log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for name, out in paths.items():
        if os.path.exists(out) and not verbose:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, source_path(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    build_all.last_log = logs
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return paths


build_all.last_log = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = build_all((name,))[name]
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
