"""Batched MP3 granule decode in PyTorch (counterpart of
``soundkit_tpu/ops/mp3_batch.py``).

One step decodes one granule for ``[B, C]`` lanes:

- requantize ``sign(q) |q|^(4/3) scale``, M/S stereo over the whole
  spectrum, and the alias-reduction butterflies (0, 1 or 31 subband
  boundaries a lane), as plain torch;
- then K10 (``ops.mp3_synth.mp3_synth``): IMDCT, overlap-add, frequency
  inversion and the polyphase synthesis, with the carried state in the
  reference's layout: overlap ``[B, C, 32, 18]`` and the FIFO ``[B, C,
  1024]`` newest first.

The compact wire carries int16 quant and int16 quarter-exponents (the
sentinel -32768 is a silent line); the packed wire is all fields in one
``uint8`` buffer (:func:`mp3_wire_layout`), unpacked as views. Lanes
with ``lane_valid`` 0 give silent PCM and keep their state.

The host-side ``prepare_granule_batch`` of the JAX package (it consumes
the pure-Python parser's granules) is not ported; the batched decoder
takes the C++ parser's wire.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from soundkit_tpu_torch.ops import mp3_dsp
from soundkit_tpu_torch.ops.mp3_synth import mp3_synth
from soundkit_tpu_torch.utils.device import tensor_device


@functools.lru_cache(maxsize=1)
def _alias_idx():
    """Static index/coef arrays for the 31-boundary butterfly network."""
    a_idx = []  # position below boundary
    b_idx = []  # position above
    cs = []
    ca = []
    for sb in range(1, 32):
        for i in range(8):
            a_idx.append(18 * sb - 1 - i)
            b_idx.append(18 * sb + i)
            cs.append(mp3_dsp.CS[i])
            ca.append(mp3_dsp.CA[i])
    return (
        np.array(a_idx, np.int32),
        np.array(b_idx, np.int32),
        np.array(cs, np.float32),
        np.array(ca, np.float32),
    )


@functools.lru_cache(maxsize=8)
def _alias_tables(device: torch.device):
    a_idx, b_idx, cs, ca = _alias_idx()
    bnum = (np.arange(248) // 8 + 1).astype(np.int32)  # a butterfly's boundary number
    return tuple(torch.from_numpy(a).to(device) for a in (
        a_idx.astype(np.int64), b_idx.astype(np.int64), cs, ca, bnum))


def granule_lines(quant, scale, ms, n_alias_sb):
    """The lines K10 takes, f32 [B, C, 576]: requantized, M/S where
    ``ms``, then alias-reduced over each lane's ``n_alias_sb``
    boundaries."""
    B, C, _ = quant.shape
    dev = quant.device

    q = quant.to(torch.float32)
    xr = torch.sign(q) * q.abs() ** (4.0 / 3.0) * scale

    # MS stereo (full spectrum)
    if C >= 2:
        inv = np.float32(1.0 / np.sqrt(2.0)).item()
        m, s = xr[:, 0], xr[:, 1]
        msb = ms.reshape(B, 1)
        l = torch.where(msb, (m + s) * inv, m)
        r = torch.where(msb, (m - s) * inv, s)
        xr = torch.stack([l, r], dim=1)

    # alias reduction
    a_idx, b_idx, cs, ca, bnum = _alias_tables(dev)
    xa = xr[..., a_idx]
    xb = xr[..., b_idx]
    active = bnum.reshape(1, 1, -1) <= n_alias_sb[..., None]
    new_a = torch.where(active, xa * cs - xb * ca, xa)
    new_b = torch.where(active, xb * cs + xa * ca, xb)
    return xr.index_copy(-1, a_idx, new_a).index_copy(-1, b_idx, new_b)


def mp3_granule_device(quant, scale, ms, block_type, mixed, n_alias_sb, lane_valid, overlap,
                       v_fifo):
    """One granule for all lanes: quant i32 [B, C, 576], scale f32 [B, C,
    576], ms bool [B], block_type / n_alias_sb i32 [B, C], mixed /
    lane_valid bool [B, C], overlap f32 [B, C, 32, 18], v_fifo f32 [B, C,
    1024]. Returns (pcm [B, C, 576], new_overlap, new_v_fifo)."""
    B, C, _ = quant.shape
    L = B * C
    xr = granule_lines(quant, scale, ms, n_alias_sb)
    pcm, new_overlap, new_fifo = mp3_synth(
        xr.reshape(L, 576).contiguous(), block_type.reshape(L).to(torch.int32).contiguous(),
        mixed.reshape(L).to(torch.uint8).contiguous(),
        lane_valid.reshape(L).to(torch.uint8).contiguous(),
        overlap.reshape(L, 576).contiguous(), v_fifo.reshape(L, 1024).contiguous())
    return (pcm.reshape(B, C, 576), new_overlap.reshape(B, C, 32, 18),
            new_fifo.reshape(B, C, 1024))


def init_state(B: int, C: int = 2, device="cuda"):
    """Zero overlap [B, C, 32, 18] and FIFO [B, C, 1024] on ``device``."""
    dev = tensor_device(device)
    return (torch.zeros((B, C, 32, 18), dtype=torch.float32, device=dev),
            torch.zeros((B, C, 1024), dtype=torch.float32, device=dev))


def expq_scale(expq):
    """Per-line scale of the compact wire's int16 quarter-exponents:
    ``2 ** (expq / 4)``, and 0 for the silent-line sentinel -32768."""
    return torch.where(expq == -32768, 0.0, torch.exp2(0.25 * expq.to(torch.float32)))


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


# ---------------------------------------------------------------------------
# packed wire: the whole granule batch in one host buffer / one transfer
# ---------------------------------------------------------------------------

def mp3_wire_layout(B: int):
    """(name, offset, dtype, shape) inside the packed uint8 granule
    wire + total bytes. Always carries both channels; the device step
    slices to the model's channel count."""
    fields = [
        ("bt", np.int32, (B, 2)),
        ("nal", np.int32, (B, 2)),
        ("quant", np.int16, (B, 2, 576)),
        ("expq", np.int16, (B, 2, 576)),
        ("mixed", np.uint8, (B, 2)),
        ("ms", np.uint8, (B,)),
        ("valid", np.uint8, (B, 2)),
    ]
    layout = []
    off = 0
    for name, dt, shp in fields:
        size = int(np.prod(shp)) * np.dtype(dt).itemsize
        layout.append((name, off, dt, shp))
        off = (off + size + 3) & ~3
    return layout, off


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int16): torch.int16,
                 np.dtype(np.uint8): torch.uint8}


def unpack_mp3_wire(buf: torch.Tensor, B: int) -> dict:
    """The fields of one packed wire row (``uint8`` [stride]) as views."""
    out = {}
    for name, off, dt, shp in mp3_wire_layout(B)[0]:
        n = int(np.prod(shp)) * np.dtype(dt).itemsize
        out[name] = buf[off: off + n].view(_TORCH_DTYPES[np.dtype(dt)]).reshape(shp)
    return out


def mp3_granule_device_compact_packed(buf, overlap, v_fifo):
    """One-transfer variant of :func:`mp3_granule_device_compact`;
    ``buf`` is one row of the packed wire (``models.mp3_batch_model``)."""
    B, C = overlap.shape[0], overlap.shape[1]
    f = unpack_mp3_wire(buf, B)
    return mp3_granule_device_compact(
        f["quant"][:, :C], f["expq"][:, :C], f["ms"] != 0,
        f["bt"][:, :C], f["mixed"][:, :C] != 0, f["nal"][:, :C],
        f["valid"][:, :C] != 0, overlap, v_fifo,
    )
