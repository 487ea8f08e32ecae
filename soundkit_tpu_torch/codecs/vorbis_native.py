"""Vorbis packet parse of the port (counterpart of
``soundkit_tpu/codecs/vorbis_native.py``): per-packet bit unpack,
codebook Huffman, floor1, residue, coupling and the floor multiply in the
port's build of ``native_src/src/vorbis_parse.cpp``
(``native.vorbis_library``), emitting the spectra that the batched
synthesis (``ops/vorbis_batch.py``) consumes.

Header and setup parsing stay in the port's copy of the Python decoder
(``codecs/vorbis_core.py``, ``VorbisSetup``); this module exports the
parsed setup (codebooks with their prebuilt VQ tables, the floor1,
residue, mapping and mode configs) to the C++ side once per stream. A
setup with a floor0 raises ``VorbisNativeUnsupported``: its packets take
``VorbisSetup.decode_packet_spectrum``. Everything but :func:`_lib` is
the JAX package's module verbatim.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from soundkit_tpu_torch.codecs.vorbis_core import (
    Floor1,
    VorbisSetup,
    VorbisSpectrum,
    floor1_inverse_db_table,
)
from soundkit_tpu_torch.native import vorbis_library


class VorbisNativeUnsupported(RuntimeError):
    pass


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _lib():
    return vorbis_library()


def _ptr_i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeVorbisParser:
    """One stream's packet parser, built from a parsed VorbisSetup."""

    def __init__(self, setup: VorbisSetup):
        for fl in setup.floors:
            if not isinstance(fl, Floor1):
                raise VorbisNativeUnsupported("floor0 stream")
        self._lib = _lib()
        self.setup = setup
        self.channels = setup.channels
        self.n1 = setup.blocksize1
        inv = np.ascontiguousarray(floor1_inverse_db_table(),
                                   dtype=np.float64)
        self._h = self._lib.skt_vorbis_new(
            setup.channels, setup.blocksize0, setup.blocksize1,
            inv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if not self._h:
            raise VorbisNativeUnsupported("skt_vorbis_new failed")
        try:
            self._export(setup)
        except Exception:
            self._lib.skt_vorbis_free(self._h)
            self._h = None
            raise
        self._spec = np.zeros((setup.channels, setup.blocksize1 // 2),
                              dtype=np.float64)

    def _export(self, s: VorbisSetup) -> None:
        lib = self._lib
        for b in s.codebooks:
            lens = _i32(b.lengths)
            if b.vq is not None:
                vq = np.ascontiguousarray(b.vq.reshape(-1),
                                          dtype=np.float64)
                vp = vq.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
                n = vq.size
            else:
                vp, n = None, 0
            if lib.skt_vorbis_add_codebook(
                    self._h, b.dim, b.entries, _ptr_i32(lens), vp, n) != 0:
                raise VorbisNativeUnsupported("codebook build failed")
        for f in s.floors:
            pcl = _i32(f.partition_class_list)
            dims = _i32(f.class_dims)
            subs = _i32(f.class_subclasses)
            masters = _i32(f.class_masterbooks)
            flat = _i32([bk for row in f.subclass_books for bk in row])
            xl = _i32(f.x_list)
            lib.skt_vorbis_add_floor1(
                self._h, _ptr_i32(pcl), len(pcl), _ptr_i32(dims),
                _ptr_i32(subs), _ptr_i32(masters), _ptr_i32(flat),
                len(f.class_dims), f.multiplier, _ptr_i32(xl), len(xl))
        for r in s.residues:
            books = _i32(np.asarray(r.books).reshape(-1))
            if lib.skt_vorbis_add_residue(
                    self._h, r.kind, r.begin, r.end, r.partition_size,
                    r.classifications, r.classbook, _ptr_i32(books)) != 0:
                raise VorbisNativeUnsupported("residue config rejected")
        for m in s.mappings:
            cm = _i32([c[0] for c in m.coupling])
            ca = _i32([c[1] for c in m.coupling])
            mux = _i32(m.mux)
            smf = _i32(m.submap_floor)
            smr = _i32(m.submap_residue)
            lib.skt_vorbis_add_mapping(
                self._h, m.submaps, _ptr_i32(cm), _ptr_i32(ca),
                len(m.coupling), _ptr_i32(mux), _ptr_i32(smf),
                _ptr_i32(smr))
        for md in s.modes:
            lib.skt_vorbis_add_mode(self._h, md.blockflag, md.mapping)
        lib.skt_vorbis_finish(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.skt_vorbis_free(self._h)
            self._h = None

    def decode_packet_spectrum(self, packet: bytes) -> Optional[VorbisSpectrum]:
        """Native twin of VorbisSetup.decode_packet_spectrum."""
        n = ctypes.c_int(0)
        prev = ctypes.c_int(0)
        nxt = ctypes.c_int(0)
        r = self._lib.skt_vorbis_packet(
            self._h, packet, len(packet),
            self._spec.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.byref(n), ctypes.byref(prev), ctypes.byref(nxt))
        if r == 1:
            return None
        if r != 0:
            raise VorbisNativeUnsupported(f"packet decode failed ({r})")
        n2 = int(n.value) // 2
        return VorbisSpectrum(
            self._spec[:, :n2].copy(), int(n.value), int(prev.value),
            int(nxt.value))
