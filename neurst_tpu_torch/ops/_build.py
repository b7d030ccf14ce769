"""Builds the port's CUDA kernels and host libraries and loads them with
ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled on
its own with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a
shared library under ``build/torch_kernels/`` at the repository root
(listed in ``.gitignore``); each ``csrc/<name>.cpp`` (host code: the
record reader's crc32c, the FLAC decoder, the zstd decoder) likewise with the host C++
compiler (``$CXX``, else ``c++``).  The library's file name carries a hash of
its source and of every ``csrc/*.cuh`` header the source includes
(``#include "..."``, followed transitively), so an edited source or
shared header is rebuilt and an unchanged one is loaded as it is.
Nothing here runs at import: the first call that
launches a kernel builds it, and ``build()`` builds every kernel at
once, one compiler per source, all started together.  A library is
written to a file of the process's own and renamed into place, so
processes that build the same library at once do not clash.

A build that fails raises ``RuntimeError`` with the compiler's output.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["KERNEL_SOURCES", "HOST_SOURCES", "BUILD_DIR", "build", "load",
           "library_path"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# kernel name -> source file under csrc/
KERNEL_SOURCES = {
    "flash_attention_fwd": "flash_attention_fwd.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "fused_linear_xent": "fused_linear_xent.cu",
    "fused_softmax_xent": "fused_softmax_xent.cu",
    "fused_dropout": "fused_dropout.cu",
    "fused_ffn": "fused_ffn.cu",
}
# host library name -> source file under csrc/
HOST_SOURCES = {"crc32c": "crc32c.cpp",
                "flac_decoder": "flac_decoder.cpp",
                "zstd_decompress": "zstd_decompress.cpp"}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME \
        else []
    candidates.append(shutil.which("nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _cxx() -> str:
    path = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not path:
        raise RuntimeError("no host C++ compiler (c++ or $CXX) to build the "
                           "port's host libraries")
    return path


def _compiler(name: str):
    """(command prefix, flags) of the library's compiler."""
    if name in HOST_SOURCES:
        return [_cxx()], CXX_FLAGS
    return [_nvcc()], NVCC_FLAGS


def _source(name: str) -> Path:
    return CSRC_DIR / (HOST_SOURCES.get(name) or KERNEL_SOURCES[name])


def _sources(path: Path, seen=None):
    """``path`` and the local headers it includes, in include order."""
    seen = [] if seen is None else seen
    if path in seen:
        return seen
    seen.append(path)
    for header in _INCLUDE.findall(path.read_text()):
        local = path.parent / header
        if local.exists():
            _sources(local, seen)
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _sources(_source(name)):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(CXX_FLAGS if name in HOST_SOURCES
                           else NVCC_FLAGS).encode())
    digest = digest.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compiles the named libraries (every kernel and host library by
    default) that are not built yet, all in parallel.  Returns {name:
    seconds} of the compiles run; the compiler's report of each (ptxas's
    for a kernel) lands in ``<library>.log``."""
    names = list([*KERNEL_SOURCES, *HOST_SOURCES] if names is None
                 else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        compiler, flags = _compiler(name)
        cmd = [*compiler, *flags, "-o", str(tmp), str(_source(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, lib, time.perf_counter())
    seconds, failures = {}, []
    for name, (proc, tmp, lib, start) in jobs.items():
        output, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        lib.with_suffix(".log").write_text(output)
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{output}")
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's (or host library's) shared library, built first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
