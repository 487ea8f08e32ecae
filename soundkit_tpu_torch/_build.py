"""Build and load the port's native code at first use.

Seven shared libraries, each built into ``soundkit_tpu_torch/_build/``
under a name keyed by a hash of its sources and flags, so a checkout
builds once and a source edit rebuilds. Each is built the same way: one
compiler process a source, all started together, then one link:

- the CUDA kernels, ``csrc/*.cu`` (and the headers ``csrc/*.cuh`` they
  share), compiled by ``nvcc`` for ``sm_90a`` into one library with a
  plain C interface, loaded with ``ctypes``;
- the AAC-LC host syntax parser, ``native_src/src/aac_parse.cpp`` with
  its table header ``native_src/generated/aac_tables.h`` (verbatim
  copies of the JAX package's), compiled alone by ``g++`` (bound in
  ``native.py``). It needs only the C++ standard library, so the build
  links no FFmpeg and uses no ``-march=native``;
- the FLAC host walk, ``native_src/src/flac.cpp`` (a verbatim copy too;
  frame and subframe headers, the coding-span table and the export of a
  collect's wire), compiled alone by ``g++`` with the same flags;
- the MP3 host syntax parser, ``native_src/src/mp3_parse.cpp`` with its
  table header ``native_src/generated/mp3_tables.h`` (verbatim copies;
  frame sync, side info, bit reservoir, Huffman spectra and the compact
  granule wire), compiled alone by ``g++`` with the same flags;
- the Opus host parse, ``opus_parse``: ``native_src/src/celt_parse.cpp``
  (range decode, allocation, PVQ, anti-collapse and denormalization,
  writing a collect's spectral wire), ``silk_parse.cpp`` (the SILK walk
  that exports the synthesis inputs) and ``hybrid_glue.cpp`` (the hybrid
  walk, which chains the SILK export and the CELT continuation over the
  parse states of both), verbatim copies compiled by ``g++`` with the
  same flags into one library. They are one library because the glue
  calls both walks directly and each source keeps its spec tables in a
  library-global, pushed at load time (``codecs/celt_native.py``,
  ``codecs/silk_native.py``);
- the Vorbis packet parse, ``native_src/src/vorbis_parse.cpp`` (a
  verbatim copy; codebook Huffman, floor1, residue, coupling and the
  floor multiply of one audio packet), compiled alone by ``g++`` with the
  same flags; the setup is pushed per stream (``codecs/vorbis_native.py``);
- the FLAC frame packer of the encode direction,
  ``native_src/src/flac_pack.cpp`` (a verbatim copy; the Rice partition
  search, CRCs and bit packing of frames from the analysis plans),
  compiled alone by ``g++`` with the same flags.

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
NATIVE_DIR = PKG_DIR / "native_src"
PARSER_SOURCES = (NATIVE_DIR / "src" / "aac_parse.cpp",)
PARSER_HEADERS = (NATIVE_DIR / "generated" / "aac_tables.h",)
FLAC_SOURCES = (NATIVE_DIR / "src" / "flac.cpp",)
MP3_SOURCES = (NATIVE_DIR / "src" / "mp3_parse.cpp",)
MP3_HEADERS = (NATIVE_DIR / "generated" / "mp3_tables.h",)
OPUS_SOURCES = tuple(NATIVE_DIR / "src" / f for f in ("celt_parse.cpp", "silk_parse.cpp",
                                                      "hybrid_glue.cpp"))
VORBIS_SOURCES = (NATIVE_DIR / "src" / "vorbis_parse.cpp",)
FLAC_PACK_SOURCES = (NATIVE_DIR / "src" / "flac_pack.cpp",)

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


def _run_all(cmds: Sequence[Sequence[str]]) -> list:
    """Run the commands together; (command, return code, output) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outputs = [p.communicate()[0] for p in procs]
    return [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outputs)]


def _build(stem: str, compiler: str, flags: Sequence[str], sources: Sequence[Path],
           deps: Sequence[Path]) -> Path:
    """Compile ``sources`` into ``_build/<stem>-<hash>.so`` unless it exists:
    one compiler process a source, all started together, then one link."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in (*sources, *deps):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{i}.o") for i in range(len(sources))]
    cflags = [f for f in flags if f != "-shared"]
    steps = [[[compiler, *cflags, "-c", "-o", str(o), str(src)] for o, src in zip(objs, sources)],
             [[compiler, "-shared", "-o", str(tmp), *map(str, objs)]]]
    log = ""
    try:
        for cmds in steps:
            for cmd, rc, output in _run_all(cmds):
                log += output
                if rc != 0:
                    tmp.unlink(missing_ok=True)
                    raise BuildError(f"build of {stem} failed ({' '.join(cmd)}):\n{output}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def kernel_library_path() -> Path:
    nvcc = _compiler("nvcc", "/usr/local/cuda/bin/nvcc")
    return _build("soundkit_kernels", nvcc, NVCC_FLAGS, sorted(CSRC_DIR.glob("*.cu")),
                  sorted(CSRC_DIR.glob("*.cuh")))


@functools.lru_cache(maxsize=1)
def parser_library_path() -> Path:
    gxx = _compiler("g++", "/usr/bin/g++")
    return _build("aac_parse", gxx, GXX_FLAGS, PARSER_SOURCES, PARSER_HEADERS)


@functools.lru_cache(maxsize=1)
def flac_library_path() -> Path:
    gxx = _compiler("g++", "/usr/bin/g++")
    return _build("flac_walk", gxx, GXX_FLAGS, FLAC_SOURCES, ())


@functools.lru_cache(maxsize=1)
def mp3_library_path() -> Path:
    gxx = _compiler("g++", "/usr/bin/g++")
    return _build("mp3_parse", gxx, GXX_FLAGS, MP3_SOURCES, MP3_HEADERS)


@functools.lru_cache(maxsize=1)
def opus_library_path() -> Path:
    gxx = _compiler("g++", "/usr/bin/g++")
    return _build("opus_parse", gxx, GXX_FLAGS, OPUS_SOURCES, ())


@functools.lru_cache(maxsize=1)
def vorbis_library_path() -> Path:
    gxx = _compiler("g++", "/usr/bin/g++")
    return _build("vorbis_parse", gxx, GXX_FLAGS, VORBIS_SOURCES, ())


@functools.lru_cache(maxsize=1)
def flac_pack_library_path() -> Path:
    gxx = _compiler("g++", "/usr/bin/g++")
    return _build("flac_pack", gxx, GXX_FLAGS, FLAC_PACK_SOURCES, ())


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
    lib.skt_spectral_decode.argtypes = [p, i, p, p, i, p, p, i, p, i, p]
    lib.skt_tns_filter.argtypes = [p, p, p, p, p, i, i, p]
    lib.skt_g711_decode.argtypes = [p, p, p, p, i, i, p]
    lib.skt_g711_launch_floor.argtypes = [i, i, p]
    lib.skt_g726_scan.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.skt_g722_scan.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.skt_flac_rice_plane.argtypes = [p, i, i, p, p, p, p, p, i, p, p, p, p, i, p]
    lib.skt_flac_lpc.argtypes = [p, p, p, p, p, p, p, p, p, i, i, p]
    lib.skt_mp3_granule.argtypes = [p, *[i] * 7, p, p, p, p, p, p, i, i, p]
    lib.skt_celt_postfilter.argtypes = [*[p] * 11, i, i, p]
    lib.skt_silk_synth.argtypes = [*[p] * 12, i, i, p]
    lib.skt_vorbis_overlap.argtypes = [*[p] * 7, i, i, i, i, p]
    lib.skt_flac_analyze.argtypes = [p, i, i, i, i, i, i, p, p]
    lib.skt_flac_analyze_occupancy.argtypes = [i, p]
    lib.skt_resample.argtypes = [*[p] * 5, *[i] * 6, p]
    lib.skt_stretch_ola.argtypes = [*[p] * 4, *[i] * 6, p]
    lib.skt_phase_lock.argtypes = [*[p] * 5, i, i, p]
    for fn in (lib.skt_imdct_window, lib.skt_dequant_imdct_window,
               lib.skt_spectral_decode, lib.skt_tns_filter, lib.skt_g711_decode,
               lib.skt_g711_launch_floor, lib.skt_g726_scan, lib.skt_g722_scan,
               lib.skt_flac_rice_plane, lib.skt_flac_lpc, lib.skt_mp3_granule,
               lib.skt_celt_postfilter, lib.skt_silk_synth, lib.skt_vorbis_overlap,
               lib.skt_flac_analyze, lib.skt_flac_analyze_occupancy, lib.skt_resample,
               lib.skt_stretch_ola, lib.skt_phase_lock):
        fn.restype = ctypes.c_int
    return lib
