"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, under
``build/kernels/`` at the root of the checkout, the first time a kernel is
needed.  The library file name carries a digest of the sources and flags,
so an edited source is rebuilt and a stale library is never loaded.  All
missing libraries are compiled in parallel, one ``nvcc`` per source.

Libraries are loaded with ``ctypes``: every entry point takes its pointers
and the CUDA stream as ``c_void_p`` and returns ``cudaGetLastError()``
after its launches, which :func:`check` turns into an exception.

Nothing here runs at import time: the CPU-only tests import every module
of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("decode_attn", "decode_attn_paged", "decode_attn_paged_int8",
           "exit_head", "quantize", "exit_quant")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")     # optimise on every core at once

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return found


def _library(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, all at
    once.  Returns each kernel's compiler log (``-Xptxas -v``: registers,
    shared memory and spills per kernel), read back from the build
    directory for libraries built earlier.  Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = _library(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for\n" + "\n".join(failed))
    return {name: _library(name).with_suffix(".log").read_text()
            for name in names}


def function(name: str, symbol: str,
             argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of kernel library ``name``, built and loaded
    on first use, with its argument types declared."""
    key = (name, symbol)
    if key not in _fns:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(_library(name)))
        fn = getattr(_libs[name], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def check(name: str, code: int) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        err = _libs[name].rt_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} kernel failed: CUDA error {code} "
                           f"({err(code).decode()})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def require(op: str, name: str, t: torch.Tensor, *, device: torch.device,
            shape: Sequence[int], dtypes, align: int = 16) -> None:
    """Validate one kernel operand before its pointer crosses to C: the
    kernel's device, one of ``dtypes``, exactly ``shape``, contiguous and
    ``align``-byte aligned (16 for operands that the kernels read with
    16-byte vector loads; an operand read element by element needs only
    its element's alignment)."""
    if t.device != device or device.type != "cuda":
        raise ValueError(f"{op}: {name} is on {t.device}; the kernel needs "
                         f"every operand on one CUDA device ({device})")
    if t.dtype not in dtypes:
        raise ValueError(f"{op}: {name} has dtype {t.dtype}, expected one "
                         f"of {sorted(map(str, dtypes))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{op}: {name} must be {align}-byte aligned")
