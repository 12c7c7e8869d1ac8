"""Build and load the CUDA kernels in ``csrc/``.

Each source has a plain C interface and is compiled on first use with
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``kernels/build/`` (listed in ``.gitignore``), then loaded with ctypes.
No PyTorch headers are included, so a build takes seconds. ``build_all``
starts one ``nvcc`` per source, all at once, and waits for them.
``--use_fast_math`` is deliberately absent: ``tanhf`` and ``expf`` in the
scorer must stay accurate.

A library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and a
stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("fused_query", "sparse_dot", "scorer_mlp", "topk_select",
           "pq_score")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# loaded libraries and their entry points
_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple, object] = {}


def nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC to its path)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all() -> dict[str, str]:
    """Compile every missing library, one nvcc process per source, all in
    parallel. Returns the compiler output (ptxas register and shared
    memory report) per source built by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def function(lib_name: str, fn_name: str, argtypes):
    """A C entry point with its ctypes signature set. Every entry point
    returns an int: the ``cudaError_t`` of its launch (0 = success), or
    the answer of a query."""
    fn = _FNS.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(library(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[(lib_name, fn_name)] = fn
    return fn


def check(code: int, lib_name: str, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if code != 0:
        msg = library(lib_name).error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def device_kind(t: torch.Tensor, what: str) -> str:
    """"cuda" (launch the kernel) or "cpu" (run the plain version); any
    other device has no kernel and raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {t.device}")
    return t.device.type


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device, for the launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
