"""Build and load the port's hand-written CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled on first use by
``nvcc`` into its own shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), under ``build/kernels/`` at the root
of the checkout, and loaded with ``ctypes``.  Libraries are named by a
hash of their source and flags, so an edited source is rebuilt and a
stale library is never loaded.  ``build_all()`` starts one ``nvcc`` per
source, all at once, and waits for them.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "MAX_CLUSTER", "build_all", "load", "function",
           "check", "sm_count", "smem_limits"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("flash_attention", "fused_bn_act", "int8_matmul", "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_CLUSTER = 8  # the portable thread-block cluster size

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_funcs: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built on first use "
        "on a machine with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a half file
    return log


def build_all() -> Dict[str, object]:
    """Build every kernel library that is not built yet, one ``nvcc`` per
    source started together.  Returns {"seconds", "logs": {name: nvcc
    output}}; the logs hold ptxas's registers and spills per kernel."""
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        logs = {n: _finish(n, s) for n, s in started.items() if s}
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start(name)
            if started:
                _finish(name, started)
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def function(name: str, symbol: str, argtypes):
    """C entry `symbol` of kernel library `name`, with its argtypes and an
    int return (the cudaError_t) declared once."""
    key = f"{name}:{symbol}"
    fn = _funcs.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _funcs[key] = fn
    return fn


def check(err: int, what: str):
    """Raise if a kernel's C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA card `index` (132 on an H100 SXM,
    114 on a PCIe one): the cluster kernels' launch plans size their grids
    by it."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def smem_limits(index: int) -> tuple:
    """(per SM, most one block may opt into) shared memory bytes of CUDA
    card `index` (233,472 and 232,448 on an H100): K9's ring plan sizes
    its row slots by them."""
    import torch
    props = torch.cuda.get_device_properties(index)
    return (props.shared_memory_per_multiprocessor,
            props.shared_memory_per_block_optin)
