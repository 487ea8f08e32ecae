"""Wire packers over the C++ AAC-LC host parser (copied from
``soundkit_tpu/codecs/aac_lc_native.py``).

- :func:`prepare_v4_batch_packed`: one lockstep batch of AUs as the
  packed v4 wire (raw AU bytes + section program; the spectral decode
  runs on the device);
- :func:`prepare_frame_batch_grouped`: the full wire (:class:`FrameBatch`,
  dequant-ready per-line arrays), one C call per sample-rate group, for
  batches the v4 wire cannot carry.

Both take parsers exposing the parser library as ``_lib`` and a
parser handle as ``_h`` (``soundkit_tpu_torch.native.AacHostParser``).
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from soundkit_tpu_torch.ops.aac_batch import MAX_FILTERS, MAX_ORDER, v4_wire_layout


@dataclass
class FrameBatch:
    """Fixed-shape tensors for one frame across B streams x C channels."""

    quant: np.ndarray        # [B, C, 1024] int32
    scale: np.ndarray        # [B, C, 1024] f32 (0 where zero/noise/intensity)
    ms_mask: np.ndarray      # [B, 1024] bool (CPE mid/side lines)
    int_factor: np.ndarray   # [B, 1024] f32, 0 = no intensity on that line
    perm: np.ndarray         # [B, C, 1024] int32 involutive TNS permutation
    filt_id: np.ndarray      # [B, C, 1024] int32 (-1 = no TNS)
    lpc: np.ndarray          # [B, C, MAX_FILTERS, MAX_ORDER] f32
    seq: np.ndarray          # [B, C] int32 window sequence
    shape: np.ndarray        # [B, C] int32 window shape
    chan_valid: np.ndarray   # [B, C] bool


def _parse_threads() -> int:
    """Worker threads for the batched parse: ``SKT_PARSE_THREADS`` or
    the core count. With more than one worker the PNS sign noise is
    drawn from per-worker RNG streams."""
    env = os.environ.get("SKT_PARSE_THREADS")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


def empty_frame_batch(B: int, C: int = 2) -> FrameBatch:
    perm = np.tile(np.arange(1024, dtype=np.int32), (B, C, 1))
    return FrameBatch(
        quant=np.zeros((B, C, 1024), dtype=np.int32),
        scale=np.zeros((B, C, 1024), dtype=np.float32),
        ms_mask=np.zeros((B, 1024), dtype=bool),
        int_factor=np.zeros((B, 1024), dtype=np.float32),
        perm=perm,
        filt_id=np.full((B, C, 1024), -1, dtype=np.int32),
        lpc=np.zeros((B, C, MAX_FILTERS, MAX_ORDER), dtype=np.float32),
        seq=np.zeros((B, C), dtype=np.int32),
        shape=np.zeros((B, C), dtype=np.int32),
        chan_valid=np.zeros((B, C), dtype=bool),
    )


def _parse_batch_into(parser, aus: List[Optional[bytes]], fb: FrameBatch,
                      chan_valid_u8: np.ndarray, ms_u8: np.ndarray) -> None:
    """One C call parsing every non-None lane of ``aus`` into ``fb``.

    Lanes passed as None are left untouched (the C side skips them
    before writing defaults), so several calls with disjoint lane
    subsets — one per sample-rate subgroup — compose into one batch.
    """
    B = len(aus)
    blob = bytearray()
    offsets = np.zeros(B, dtype=np.int64)
    lens = np.full(B, -1, dtype=np.int64)
    for i, au in enumerate(aus):
        if au is not None:
            offsets[i] = len(blob)
            lens[i] = len(au)
            blob.extend(au)
    parser._lib.skt_aac_parse_batch(
        parser._h, bytes(blob), offsets, lens, B,
        fb.quant.reshape(-1), fb.scale.reshape(-1), fb.perm.reshape(-1),
        fb.filt_id.reshape(-1), fb.lpc.reshape(-1), fb.seq.reshape(-1),
        fb.shape.reshape(-1), chan_valid_u8.reshape(-1),
        ms_u8.reshape(-1), fb.int_factor.reshape(-1),
    )


def prepare_frame_batch_grouped(parsers: dict, lane_sr: List[Optional[int]],
                                aus: List[Optional[bytes]]) -> FrameBatch:
    """Mixed-rate batch: one C call per distinct sr_index subgroup.

    ``parsers`` maps sr_index -> parser; ``lane_sr[i]`` is the
    sr_index of lane i's stream. The scalefactor-band tables the parser
    uses depend on sr_index, so lanes are parsed by a parser built for
    their rate. Single-rate groups take exactly one C call.
    """
    B = len(aus)
    fb = empty_frame_batch(B)
    chan_valid_u8 = np.zeros((B, 2), dtype=np.uint8)
    ms_u8 = np.zeros((B, 1024), dtype=np.uint8)
    for sr, parser in parsers.items():
        sub = [
            au if (au is not None and lane_sr[i] == sr) else None
            for i, au in enumerate(aus)
        ]
        if any(a is not None for a in sub):
            _parse_batch_into(parser, sub, fb, chan_valid_u8, ms_u8)
    fb.chan_valid[:] = chan_valid_u8.astype(bool)
    fb.ms_mask[:] = ms_u8.astype(bool)
    return fb


def v4_views(buf: np.ndarray, B: int) -> dict:
    """Every v4 field of the packed buffer as a flat numpy view."""
    layout, _total = v4_wire_layout(B)
    return {
        name: buf[off : off + int(np.prod(shp)) * np.dtype(dt).itemsize]
        .view(dt)
        .reshape(-1)
        for name, off, dt, shp in layout
    }


def prepare_v4_batch_packed(parser, aus: List[Optional[bytes]]):
    """The v4 packed wire (~1.9 KB/lane) of one lockstep batch (None
    for an idle lane): raw AU bytes + section program. The host walks
    the spectral bits length-only; the values are decoded on the device.

    Returns (buf uint8[total], max_steps, overflow: bool); on overflow
    (pulse content, more than 16 PNS bands or 128 band runs, an AU over
    1024 bytes) the affected lanes are zeroed and the caller re-parses
    the batch through the full wire. ``max_steps`` is the worst lane's
    codeword total rounded up to a multiple of 64."""
    B = len(aus)
    _layout, total = v4_wire_layout(B)
    all_active = all(au is not None for au in aus)
    buf = (np.empty if all_active else np.zeros)(total, dtype=np.uint8)
    views = v4_views(buf, B)
    ptrs = (ctypes.c_char_p * B)()
    lens = np.empty(B, dtype=np.int64)
    for i, au in enumerate(aus):
        if au is not None:
            ptrs[i] = au
            lens[i] = len(au)
        else:
            lens[i] = -1
    overflow = np.zeros(1, dtype=np.int32)
    max_cw = np.zeros(1, dtype=np.int32)
    parser._lib.skt_aac_parse_batch_v4_ptrs(
        parser._h, ptrs, lens, B, _parse_threads(),
        views["regions"], views["sf_len"], views["sf_val"],
        views["msis_len"], views["msis_ms"], views["msis_pos"],
        views["msis_sign"], views["refl"], views["crb"], views["order"],
        views["runs"], views["n_runs"], views["spec_bit"],
        views["pns"].view(np.uint8),
        views["seq"], views["shape"], views["chan_valid"], views["au"],
        max_cw, overflow,
    )
    max_steps = max((int(max_cw[0]) + 63) // 64 * 64, 64)
    return buf, max_steps, bool(overflow[0])
