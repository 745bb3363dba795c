"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library for ``sm_90a``, then loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds, not minutes.
Libraries land in ``kernels/_build/`` (git-ignored), named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.

Nothing here runs at import time: the first ``load(name)`` builds,
and only the kernel wrappers call it, only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock
from kubeflow_rm_tpu_torch.utils.profiling import annotate

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: C signatures of each library's entry points: {symbol: argtypes}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_fwd": {
        "kfrm_flash_fwd": [_P, _P, _P, _P, _P, _P, _P,  # q k v segq segkv o lse
                           _I, _I, _I, _I, _I, _I,      # BH Hq T D group causal
                           _F, _P],                     # scale stream
    },
    "flash_bwd": {
        "kfrm_flash_bwd_dq": [_P, _P, _P, _P,           # q k v do
                              _P, _P, _P, _P, _P,       # lse delta segq segkv dq
                              _I, _I, _I, _I, _I, _I,   # BH Hq T D group causal
                              _F, _P],                  # scale stream
        "kfrm_flash_bwd_dkv": [_P, _P, _P, _P,          # q k v do
                               _P, _P, _P, _P,          # lse delta segq segkv
                               _P, _P,                  # dk dv
                               _I, _I, _I, _I, _I, _I,  # BKV Hq T D group causal
                               _F, _P],                 # scale stream
    },
}

_lock = make_lock("kernels.build")
_loaded: dict[str, ctypes.CDLL] = {}
#: ptxas report of each library built by this process (registers,
#: shared memory, spills), for the smoke script to print
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler of the toolkit PyTorch finds (``CUDA_HOME``,
    ``nvcc`` on PATH, or the default install location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH")
    return str(nvcc)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library is built; returns
    (process or None, temp path, final path)."""
    lib = library_path(name)
    if lib.exists():
        return None, None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def build(names=None) -> dict[str, Path]:
    """Compile the named kernels (all of ``SIGNATURES`` by default), one
    ``nvcc`` per source, all started together. Raises with the compiler
    output if any build fails."""
    names = list(SIGNATURES if names is None else names)
    started = {n: _start(n) for n in names}
    errors = []
    for n, (proc, tmp, lib) in started.items():
        if proc is None:
            continue
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):"
                          f"\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: lib for n, (_, _, lib) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            # a set-up part: the build, or the cached library's load
            with annotate("kernels.load"):
                path = build([name])[name]
                lib = ctypes.CDLL(str(path))
            for symbol, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kfrm_error_string.argtypes = [ctypes.c_int]
            lib.kfrm_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return lib.kfrm_error_string(err).decode(errors="replace")
