"""Builds the hand-written Hopper kernels and loads them with ctypes.

Every ``csrc/<name>.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all
started at once, into an object file; one more ``nvcc`` links the objects
into a single shared library with a plain C interface. The build runs on
first use, under ``chimera_st_tpu_torch/_build/`` (listed in
``.gitignore``). The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged tree is reused.

Nothing here runs at import time: the CPU-only test environment has no
``nvcc`` and imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("encoder_attention", "conv_tail", "decode_attention", "logmel")
HEADERS = ("common.cuh", "sm90.cuh")
COMPILE_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
]
LINK_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-shared"]
# element-type codes of the C interfaces (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# C signatures: every entry point returns the launch's cudaError_t
_SIGNATURES = {
    "encoder_attention": (
        "chimera_encoder_attention",
        [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    ),
    "conv_tail": (
        "chimera_conv_tail_layer",
        [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "decode_attention": (
        "chimera_decode_attention",
        [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "logmel": (
        "chimera_logmel",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _P],
    ),
    # the empty kernel of csrc/decode_attention.cu: what a launch alone costs
    "launch_floor": ("chimera_launch_floor", [_P]),
}

_library: Optional[ctypes.CDLL] = None
_loaded: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    h = hashlib.sha1(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for name in (*(f"{s}.cu" for s in SOURCES), *HEADERS):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libchimera_kernels_{h.hexdigest()[:12]}.so"


def _run(cmds):
    """Runs the commands in parallel; returns their combined output or
    raises with the output of every command that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    failed = [f"$ {' '.join(c)}\n{log}" for c, p, log in zip(cmds, procs, logs) if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "\n".join(logs)


def build() -> Optional[str]:
    """Builds the kernel library if it is missing. Returns the compiler's
    output (ptxas register and shared-memory report) of a fresh build, or
    None when the library was already there."""
    lib = library_path()
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{s}.{tag}.o" for s in SOURCES]
    log = _run([[nvcc, *COMPILE_FLAGS, "-c", "-o", str(o), str(CSRC_DIR / f"{s}.cu")]
                for s, o in zip(SOURCES, objs)])
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    log += _run([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, lib)  # atomic: a concurrent process never sees half a file
    for o in objs:
        o.unlink()
    return log


def kernel(name: str):
    """The C entry point of csrc/<name>.cu, the library built on first use."""
    global _library
    fn = _loaded.get(name)
    if fn is None:
        if _library is None:
            build()
            _library = ctypes.CDLL(str(library_path()))
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(_library, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, not {t.dtype}")
    return code


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
