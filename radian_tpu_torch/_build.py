"""Build the package's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, compiled
by ``nvcc`` for Hopper (``sm_90a``) with a plain C interface; the host
C++ ``csrc/<name>.cc`` (the chunk-mode stitcher, the TFRecord codec, the
OpenMP host decoder) is compiled the same way by ``g++``, with any extra
flags of ``GXX_EXTRA_FLAGS``.  The hash is of the source, the flags
and, for CUDA, the shared ``csrc/*.cuh`` headers, so an edited source
never loads a stale library.  The build runs at first use, never at
import; a failed build or load raises.
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

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# no --use_fast_math: expf/log1pf must be the functions torch's own CUDA
# kernels use, so a kernel and its plain version do the same arithmetic
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
# flags a host source needs beyond GXX_FLAGS (hashed into its file name)
GXX_EXTRA_FLAGS = {"beamsearch": ["-fopenmp"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_long
_LL = ctypes.c_longlong
# exported C functions: name -> (argtypes, restype)
_SIGNATURES = {
    "beam_search": {
        "radian_beam_decode": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "radian_beam_backtrace": ([_P, _P, _I, _I, _I, _I, _P], _I),
        "radian_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "beam_search_lm": {
        "radian_beam_decode_lm": ([_P, _P, _P, _P, _I, _I, _F, _F, _P, _P, _P,
                                   _I, _I, _I, _I, _P], _I),
        "radian_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "tcn_conv": {
        "radian_tcn_conv": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _P], _I),
        "radian_tcn_conv_in": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        "radian_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "crf_viterbi": {
        "radian_crf_viterbi": ([_P, _I, _P, _P, _I, _I, _I, _I, _P], _I),
        "radian_crf_backtrace": ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
        "radian_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "tx_attention": {
        "radian_tx_attention": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                 _I, _P], _I),
        "radian_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "tx_norm": {
        "radian_tx_norm": ([_P, _P, _P, _P, _LL, _I, _F, _F, _I, _P], _I),
        "radian_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "seqmatch": {
        "LongestBlock": ([_P, _L, _P, _L, _P], None),
        "AssembleFragments": ([_P, _P, _L, _P], _L),
        "AssembleRead": ([_P, _L, _L, _P], _L),
        "AssembleRead2": ([_P, _P, _L, _L, _P], _L),
    },
    "beamsearch": {
        "BeamSearchBatch": ([_P, _L, _L, _P, _I, _P, _P, _I, ctypes.c_double,
                             ctypes.c_double, _P, _P, _P], None),
    },
    "tfrecord": {
        "ParseShard": ([ctypes.c_char_p, _L, _L, _L, _L,
                        ctypes.POINTER(_F), ctypes.POINTER(_F),
                        ctypes.POINTER(_LL), ctypes.POINTER(_LL), _I], _L),
        "WriteExample": ([ctypes.POINTER(_F), _L, ctypes.POINTER(_F), _L,
                          _LL, _LL, ctypes.POINTER(ctypes.c_ubyte), _L], _L),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
# the chunk stitch and the shard reader load from threads
_LOAD_LOCK = threading.Lock()


def _compiler(suffix: str) -> str:
    name, default = {".cu": ("nvcc", "/usr/local/cuda/bin/nvcc"),
                     ".cc": ("g++", "/usr/bin/g++")}[suffix]
    found = shutil.which(name)
    if found:
        return found
    if Path(default).exists():
        return default
    raise RuntimeError(f"{name} not found: the {suffix} sources are built "
                       f"on a host with {name}")


def _source(name: str) -> Path:
    for suffix in (".cu", ".cc"):
        src = CSRC / f"{name}{suffix}"
        if src.exists():
            return src
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cc")


def _flags(src: Path) -> list[str]:
    if src.suffix == ".cu":
        return NVCC_FLAGS
    return [*GXX_FLAGS, *GXX_EXTRA_FLAGS.get(src.stem, [])]


def _target(name: str) -> Path:
    src = _source(name)
    digest = hashlib.sha1(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.read_bytes())
    digest.update(" ".join(_flags(src)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named sources (default: every ``csrc/*.cu`` and
    ``csrc/*.cc``) not yet built, one compiler process per source, all
    started together.  Returns ``{name: {"seconds", "ptxas"}}``."""
    if names is None:
        names = sorted(p.stem for p in (*CSRC.glob("*.cu"),
                                         *CSRC.glob("*.cc")))
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        src, out = _source(name), _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_compiler(src.suffix), *_flags(src), "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building csrc/{_source(name).name} failed "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` or ``.cc``, building it if
    needed."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build([name])
            lib = ctypes.CDLL(str(out))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _LIBS[name] = lib
        return lib


def target(t) -> tuple[int, int]:
    """``(ordinal, stream)`` a launch for CUDA tensor ``t`` goes to:
    ``t``'s device, whatever the calling thread's current device, and
    that device's current stream.  The C entries make the ordinal
    current for the kernels' own (static) CUDA runtime before they
    launch."""
    import torch

    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.radian_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
