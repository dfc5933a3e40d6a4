"""Build and load the port's CUDA kernels.

The sources under ``repro_torch/csrc`` have a plain C interface.  At first
use they are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source,
all started together, then one link) into ``repro_torch/_build/<hash>/``,
keyed by a hash of the flags and of every file under ``csrc/`` (sources
and headers), and loaded with ``ctypes``.  No PyTorch header is compiled,
so a build takes seconds.  The library links without ``-lcuda``: the
kernels that need a driver function (K2's, K10's and K11's TMA tensor
maps, ``cuTensorMapEncodeTiled``, in ``csrc/tma.cuh``) take it through
``cudaGetDriverEntryPoint``.  ``nvcc`` comes from ``PATH`` or
``CUDA_HOME``; without it the build raises — there is no CPU stand-in for
a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE / "_build"
SOURCES = ("rma_copy.cu", "flash_attn.cu", "ishmem_device.cu",
           "ring_collectives.cu", "flash_partial.cu", "reduce_tile.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libishmem_kernels.so"

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C signatures of csrc/*.cu; every function returns a cudaError_t code
SIGNATURES = {
    "ishmem_copy_into": [_I, _P, _P, _LL, _P],
    "ishmem_flash_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _F, _P],
    "ishmem_paged_gather": [_I, _P, _P, _P, _LL, _LL, _I, _P],
    "ishmem_fused_paged_attn": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _LL, _LL, _LL, _I, _I, _I, _F, _P],
    "ishmem_remote_put": [_I, _P, _P, _P, _LL, _I, _LL, _I, _I, _P],
    "ishmem_ring_allgather": [_I, _P, _P, _I, _LL, _P],
    "ishmem_ring_reduce_scatter": [_I, _P, _P, _I, _LL, _I, _P],
    "ishmem_push_broadcast": [_I, _P, _P, _I, _LL, _I, _P],
    "ishmem_barrier_push": [_I, _P, _P, _I, _I, _P],
    "ishmem_coop_noop": [_I, _I, _P],
    "ishmem_flash_partial_split": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _F, _P],
    "ishmem_flash_partial": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P],
    "ishmem_reduce_tile": [_I, _P, _P, _I, _LL, _I, _I, _P],
}

_lib = None
_lock = threading.Lock()
# every entry point of SIGNATURES as a ctypes function with its argtypes and
# restype set, bound once when the library loads; ops.launch indexes it
ENTRIES: dict = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the "
                       "port's CUDA kernels cannot be built")


def build_dir() -> Path:
    """The build's directory, keyed by the flags and every file under
    ``csrc/`` (headers too: an edit to one must not load a stale
    library)."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        digest.update(path.relative_to(CSRC).as_posix().encode())
        digest.update(path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build() -> Path:
    """Compile (if this exact source set is not built yet) and return the
    shared library's path.  The compiler's output, register and spill
    counts included, is kept in ``build.log`` beside it."""
    out = build_dir()
    so = out / LIB_NAME
    if so.exists():
        return so
    out.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    objs = [out / f"{name}.{os.getpid()}.o" for name in SOURCES]
    procs = [subprocess.Popen([cc, *FLAGS, "-c", str(CSRC / name), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for name, obj in zip(SOURCES, objs)]
    logs, failed = [], []
    for name, proc in zip(SOURCES, procs):
        text, _ = proc.communicate()
        logs.append(f"== {name}\n{text}")
        if proc.returncode:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out / f"{LIB_NAME}.{os.getpid()}"
    link = subprocess.run([cc, "-shared", *map(str, objs), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (out / "build.log").write_text("\n".join(logs))
    os.replace(tmp, so)              # atomic: a concurrent build sees all or
    for obj in objs:                 # nothing of the library
        obj.unlink()
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use).  Once it is loaded
    this takes no lock: the lock guards only the first build and load."""
    if _lib is not None:
        return _lib
    return _load()


def entries() -> dict:
    """``ENTRIES``, loading the library at first use."""
    if not ENTRIES:
        _load()
    return ENTRIES


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            bound = {}
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                bound[name] = fn
            handle.ishmem_error_string.argtypes = [ctypes.c_int]
            handle.ishmem_error_string.restype = ctypes.c_char_p
            ENTRIES.update(bound)
            _lib = handle
        return _lib
