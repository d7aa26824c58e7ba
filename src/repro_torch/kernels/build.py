"""Build and load the port's CUDA sources, and check what they take.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` at its first
use into ``kernels/build/`` (gitignored), as a shared library with a plain
C interface loaded by ctypes.  A library's file name carries a hash of
its source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  Two
sources build in parallel (one lock per source); nothing is built when a
module is imported.  ``route`` is the device rule the kernel wrappers
share.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: per source name, filled by its first load in this process: seconds,
#: library path, and ptxas's register / shared-memory report
build_info: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


def _tag(source: Path) -> str:
    h = hashlib.sha1(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def load(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build `source` (once per revision) and load it; `bind` declares the
    C functions' argument and result types on the loaded library."""
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(source.name, threading.Lock())
    with lock:
        if source.name in _LIBS:
            return _LIBS[source.name]
        lib_path = BUILD_DIR / f"lib{source.stem}-{_tag(source)}.so"
        t0 = time.perf_counter()
        log = ""
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
                   str(source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed on {source.name} ({proc.returncode}):\n{log}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        bind(lib)
        build_info[source.name] = dict(seconds=time.perf_counter() - t0,
                                       path=str(lib_path), log=log)
        _LIBS[source.name] = lib
        return lib


def route(device: torch.device) -> str:
    """The device rule of every kernel wrapper: ``"plain"`` for a CPU
    tensor (the plain version), ``"kernel"`` for a CUDA tensor (the kernel
    or an exception), ``"meta"`` for a meta tensor (empty meta outputs of
    the kernel's shapes, dtypes and strides, no launch, the kernel's work
    charged to ``utils/op_cost``'s counter).  Any other device raises."""
    kind = {"cpu": "plain", "cuda": "kernel", "meta": "meta"}.get(device.type)
    if kind is None:
        raise ValueError(f"the port's kernels take CPU, CUDA or meta tensors, "
                         f"not {device}")
    return kind


def check_card(device: torch.device, what: str) -> None:
    """Raise unless `device` is an sm_90 card (the sources are built for
    sm_90a only)."""
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(f"{what} is built for sm_90a (H100); {device} has "
                           f"capability {cap}")


def check_operands(device: torch.device,
                   named: Iterable[Tuple[str, torch.Tensor]]) -> None:
    """Raise unless every tensor is float32, contiguous and on `device`.
    On meta (the cost tools' route) any floating dtype passes: a meta
    route counts the float32 kernel's work at the dtypes it receives
    (``meta_name``)."""
    for name, t in named:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32 and not (
                device.type == "meta" and t.is_floating_point()):
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def meta_name(kernel: str, dtype: torch.dtype) -> str:
    """The name a float32-only kernel's meta route charges its work under:
    the kernel's own for float32 operands, else the route it counts and
    the dtype it was handed (``"ssm_scan_f32 at bfloat16"``: the float32
    kernel's operations, the operands' own bytes)."""
    if dtype == torch.float32:
        return kernel
    return f"{kernel} at {str(dtype).replace('torch.', '')}"
