"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so`` (the hash
is of the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source never loads a stale library), compiled for Hopper
(``sm_90a``) with a plain C interface.  The build runs at first use,
never at import; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# no --use_fast_math: expf/log1pf must be the functions torch's own CUDA
# kernels use, so a kernel and its plain version do the same arithmetic
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# exported C functions: name -> (argtypes, restype)
_SIGNATURES = {
    "beam_search": {
        "radian_beam_decode": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
        "radian_beam_backtrace": ([_P, _P, _I, _I, _I, _P], _I),
        "radian_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "beam_search_lm": {
        "radian_beam_decode_lm": ([_P, _P, _P, _P, _I, _I, _F, _F, _P, _P, _P,
                                   _I, _I, _I, _P], _I),
        "radian_cuda_error_string": ([_I], ctypes.c_char_p),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a host "
                       "with the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all() -> dict[str, dict]:
    """Compile every ``csrc/*.cu`` not yet built, one ``nvcc`` per source,
    all started together.  Returns ``{name: {"seconds", "ptxas"}}``."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = None
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        name = src.stem
        out = _target(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build_all()
        lib = ctypes.CDLL(str(out))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.radian_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
