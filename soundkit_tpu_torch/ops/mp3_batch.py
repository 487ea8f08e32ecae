"""Batched MP3 granule decode in PyTorch (counterpart of
``soundkit_tpu/ops/mp3_batch.py``).

One step decodes one granule for ``[B, C]`` lanes: requantize
``sign(q) |q|^(4/3) scale``, M/S stereo over the whole spectrum, the
alias-reduction butterflies (0, 1 or 31 subband boundaries a lane), the
IMDCT, overlap-add, frequency inversion and the polyphase synthesis,
with the carried state in the reference's layout: overlap ``[B, C, 32,
18]`` and the FIFO ``[B, C, 1024]`` newest first.

The decoder's step, :func:`mp3_granule_device_compact_packed`, takes one
row of the packed wire (all fields in one ``uint8`` buffer,
:func:`mp3_wire_layout`) and is K10 (``ops.mp3_synth.mp3_granule_packed``)
on the card: one launch a granule. :func:`mp3_granule_device`, its
compact-wire form and the multi-round form are plain torch on any
device, the references the tests hold to the JAX package. The compact
wire carries int16 quant and int16 quarter-exponents (the sentinel
-32768 is a silent line). Lanes with ``lane_valid`` 0 give silent PCM
and keep their state.

The host-side ``prepare_granule_batch`` of the JAX package (it consumes
the pure-Python parser's granules) is not ported; the batched decoder
takes the C++ parser's wire.
"""
from __future__ import annotations

import torch

from soundkit_tpu_torch.ops.mp3_synth import (  # noqa: F401  (the wire, re-exported)
    expq_scale, granule_lines, mp3_granule_packed, mp3_synth_plain, mp3_wire_layout,
    unpack_mp3_wire)
from soundkit_tpu_torch.utils.device import tensor_device


def mp3_granule_device(quant, scale, ms, block_type, mixed, n_alias_sb, lane_valid, overlap,
                       v_fifo):
    """One granule for all lanes: quant i32 [B, C, 576], scale f32 [B, C,
    576], ms bool [B], block_type / n_alias_sb i32 [B, C], mixed /
    lane_valid bool [B, C], overlap f32 [B, C, 32, 18], v_fifo f32 [B, C,
    1024]. Returns (pcm [B, C, 576], new_overlap, new_v_fifo)."""
    B, C, _ = quant.shape
    L = B * C
    xr = granule_lines(quant, scale, ms, n_alias_sb)
    pcm, new_overlap, new_fifo = mp3_synth_plain(
        xr.reshape(L, 576), block_type.reshape(L), mixed.reshape(L), lane_valid.reshape(L),
        overlap.reshape(L, 576), v_fifo.reshape(L, 1024))
    return (pcm.reshape(B, C, 576), new_overlap.reshape(B, C, 32, 18),
            new_fifo.reshape(B, C, 1024))


def init_state(B: int, C: int = 2, device="cuda"):
    """Zero overlap [B, C, 32, 18] and FIFO [B, C, 1024] on ``device``."""
    dev = tensor_device(device)
    return (torch.zeros((B, C, 32, 18), dtype=torch.float32, device=dev),
            torch.zeros((B, C, 1024), dtype=torch.float32, device=dev))


def mp3_granule_device_compact(quant_i16, expq, ms, block_type, mixed, n_alias_sb, lane_valid,
                               overlap, v_fifo):
    """Compact-wire variant: int16 quant + int16 quarter-exponents
    (sentinel -32768 = silent line); scale reconstructed on device."""
    return mp3_granule_device(quant_i16.to(torch.int32), expq_scale(expq), ms, block_type, mixed,
                              n_alias_sb, lane_valid, overlap, v_fifo)


def mp3_granules_device_compact_multi(quant_i16, expq, ms, block_type, mixed, n_alias_sb,
                                      lane_valid, overlap, v_fifo):
    """G granule batches in one call: the compact step over the leading
    G axis of every wire input, carrying the state (the reference's scan
    over rounds, as a host loop). Returns (pcm [G, B, C, 576], overlap,
    fifo)."""
    pcms = []
    for g in range(quant_i16.shape[0]):
        pcm, overlap, v_fifo = mp3_granule_device_compact(
            quant_i16[g], expq[g], ms[g], block_type[g], mixed[g], n_alias_sb[g], lane_valid[g],
            overlap, v_fifo)
        pcms.append(pcm)
    return torch.stack(pcms), overlap, v_fifo


def mp3_granule_device_compact_packed(buf, overlap, v_fifo, pcm_out=None):
    """One-transfer variant of :func:`mp3_granule_device_compact`;
    ``buf`` is one row of the packed wire (``models.mp3_batch_model``).
    K10 on the card; the PCM goes into ``pcm_out`` where given."""
    return mp3_granule_packed(buf, overlap, v_fifo, pcm_out)
