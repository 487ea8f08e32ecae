"""Build and load the port's native code at first use.

Two shared libraries, each built into ``soundkit_tpu_torch/_build/``
under a name keyed by a hash of its sources and flags, so a checkout
builds once and a source edit rebuilds:

- the CUDA kernels, ``csrc/*.cu``, compiled by ``nvcc`` for ``sm_90a``
  into one library with a plain C interface, loaded with ``ctypes``;
- the AAC-LC host syntax parser, the JAX package's unchanged
  ``soundkit_tpu/native/src/aac_parse.cpp``, compiled alone by ``g++``
  (bound in ``native.py``). It needs only the C++ standard library, so
  the build links no FFmpeg and uses no ``-march=native``.

A failed build raises :class:`BuildError` with the compiler's output.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence


PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR / "_build"
CSRC_DIR = PKG_DIR / "csrc"
NATIVE_DIR = PKG_DIR.parent / "soundkit_tpu" / "native"
PARSER_SOURCES = (NATIVE_DIR / "src" / "aac_parse.cpp",)
PARSER_HEADERS = (NATIVE_DIR / "generated" / "aac_tables.h",)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")


class BuildError(RuntimeError):
    pass


def _compiler(name: str, fallback: str) -> str:
    path = shutil.which(name)
    if path:
        return path
    if Path(fallback).is_file():
        return fallback
    raise BuildError(f"{name} not found on PATH or at {fallback}")


def _build(stem: str, compiler: str, flags: Sequence[str], sources: Sequence[Path],
           deps: Sequence[Path]) -> Path:
    """Compile ``sources`` into ``_build/<stem>-<hash>.so`` unless it exists."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in (*sources, *deps):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(
            f"build of {stem} failed ({' '.join(cmd)}):\n{proc.stdout}\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def kernel_library_path() -> Path:
    nvcc = _compiler("nvcc", "/usr/local/cuda/bin/nvcc")
    return _build("soundkit_kernels", nvcc, NVCC_FLAGS, sorted(CSRC_DIR.glob("*.cu")), ())


@functools.lru_cache(maxsize=1)
def parser_library_path() -> Path:
    gxx = _compiler("g++", "/usr/bin/g++")
    return _build("aac_parse", gxx, GXX_FLAGS, PARSER_SOURCES, PARSER_HEADERS)


@functools.lru_cache(maxsize=1)
def kernels() -> ctypes.CDLL:
    """The CUDA kernel library with every entry point's C signature.

    Each entry point takes device pointers and the CUDA stream as
    ``c_void_p`` (a missing argtype would cut a pointer to 32 bits) and
    returns the ``cudaError_t`` of its launch.
    """
    lib = ctypes.CDLL(str(kernel_library_path()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.skt_imdct_window.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.skt_dequant_imdct_window.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.skt_spectral_decode.argtypes = [p, i, p, p, i, p, p, p, i, p]
    lib.skt_tns_filter.argtypes = [p, p, p, p, p, p, i, i, p]
    for fn in (lib.skt_imdct_window, lib.skt_dequant_imdct_window,
               lib.skt_spectral_decode, lib.skt_tns_filter):
        fn.restype = ctypes.c_int
    return lib
