"""Build and load the hand-written CUDA kernels in ``ops/csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C launch function and compiles on
its own into ``build/kernels/<name>-<hash>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

— no PyTorch headers, so a source builds in seconds.  The libraries load
with ``ctypes``; pointers and the stream travel as ``c_void_p``, and every
launch function returns ``cudaGetLastError()`` so a refused launch raises
in the wrapper instead of passing silently.

``load`` sets each launch function's ``restype``/``argtypes`` once, from
``SIGNATURES``, so a wrapper's call converts its arguments without
rebuilding the converters every time.

Builds run at first use (``python3 chip_smoke.py`` alone builds
everything); ``build_all`` starts one ``nvcc`` per source at once.  The
hash of the source and of the shared headers (``csrc/*.cuh``) names the
library, so an edited kernel never loads a stale build.  Nothing here runs
at import: the CPU tests import every module on hosts without ``nvcc``.
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
KERNELS = ("flash_prefill", "decode_attention", "chunk_attention",
           "paged_decode_attention", "decode_attention_quant",
           "paged_decode_attention_quant")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Each library's ``<name>_launch``: pointers (inputs, outputs, scratch),
# then the int shape arguments, the softmax scale, [split_len,] stream.
SIGNATURES = {
    "flash_prefill": [_P] * 4 + [_I] * 6 + [_F, _P],
    "chunk_attention": [_P] * 4 + [_I] * 8 + [_F, _P],
    "decode_attention": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
    "decode_attention_quant": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
    "paged_decode_attention": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
    "paged_decode_attention_quant": [_P] * 9 + [_I] * 7 + [_F, _I, _P],
}

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
    digest = hashlib.sha256()
    headers = sorted(n for n in os.listdir(_CSRC) if n.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(_CSRC, h)
                                       for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


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
    """The loaded library for kernel ``name``, built on first use, its
    ``<name>_launch`` typed from ``SIGNATURES``."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build_all((name,))[name])
            fn = getattr(lib, f"{name}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = SIGNATURES[name]
            _libs[name] = lib
        return _libs[name]


# Launches per thread, by library, beside the wrappers' module counters: a
# CUDA-graph capture keeps as the graph's what ITS thread launched, not what
# another engine's thread launched meanwhile (server/decode_graphs.py).
_thread_launches = threading.local()


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by the launch of
    library ``what``; else tally the launch for the calling thread."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
    counts = getattr(_thread_launches, "counts", None)
    if counts is None:
        counts = _thread_launches.counts = {}
    counts[what] = counts.get(what, 0) + 1


def thread_launches() -> dict[str, int]:
    """The calling thread's launches so far, by library."""
    return dict(getattr(_thread_launches, "counts", {}))
