"""Batched AAC-LC numeric decode in PyTorch (counterpart of
``soundkit_tpu/ops/aac_batch.py``).

The v4 wire (``soundkit_tpu_torch.codecs.aac_lc_native.prepare_v4_batch_packed``)
arrives as one uint8 tensor on the device. :func:`decode_frame_v4_packed`
unpacks it, decodes the spectra (K4, ``ops/aac_entropy.py``), draws
the PNS signs, expands the run-length maps, builds the TNS LPC and
regions and hands the full set of per-line tensors to
:func:`decode_frame`: dequant, M/S, intensity, the TNS filter (K5,
:func:`tns_filter`), the long and short IMDCT with the window bank
(K1, ``ops/imdct.py``) and overlap-add with the carried state.

The wire layout, the constants and the numpy functions that build the window
banks are copies of the JAX package's (:func:`v4_wire_layout`,
:func:`window_bank`, :func:`short_window_bank`).

One stated departure: a channel that idles (``chan_valid`` 0) keeps its
window shape for its next frame, as it keeps its overlap. The reference
returns the wire's ``shape`` for every lane, so a lane that idles after a
KBD frame windows its next frame's first half with the sine shape
(``soundkit_tpu/ops/aac_batch.py:347``); here a ragged lane decodes as the
same lane fed gaplessly. Lanes that never idle decode as the reference's.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.codecs.aac_lc import (
    EIGHT_SHORT_SEQUENCE,
    LONG_START_SEQUENCE,
    LONG_STOP_SEQUENCE,
    ONLY_LONG_SEQUENCE,
)
from soundkit_tpu_torch.ops.aac_dsp import half_window, imdct_matrix
from soundkit_tpu_torch.ops.aac_entropy import spectral_decode
from soundkit_tpu_torch.ops.imdct import dequant, imdct_basis, imdct_window
from soundkit_tpu_torch.utils.device import check_cuda, launch_check

N_LINES = 1024

# numpy wire dtypes -> (torch view dtype, mask widening it to int64 or None)
_WIRE_DTYPES = {
    np.dtype(np.uint8): (torch.uint8, None),
    np.dtype(np.int8): (torch.int8, None),
    np.dtype(np.int16): (torch.int16, None),
    np.dtype(np.uint16): (torch.int16, 0xFFFF),
    np.dtype(np.uint32): (torch.int32, 0xFFFFFFFF),
}


# ---------------------------------------------------------------------------
# constant banks
# ---------------------------------------------------------------------------

MAX_ORDER = 20
MAX_FILTERS = 8  # >= filters per channel frame (8 short windows x 1)


@functools.lru_cache(maxsize=1)
def window_bank() -> np.ndarray:
    """[4 seq, 2 prev_shape, 2 shape, 2048] long-path windows.

    EIGHT_SHORT entries are zeros (short path windows separately)."""
    bank = np.zeros((4, 2, 2, 2048), dtype=np.float32)
    for prev in (0, 1):
        for cur in (0, 1):
            la_prev = half_window(prev, 1024)
            ld = half_window(cur, 1024)[::-1]
            sa_prev = half_window(prev, 128)
            sd = half_window(cur, 128)[::-1]
            bank[ONLY_LONG_SEQUENCE, prev, cur] = np.concatenate([la_prev, ld])
            bank[LONG_START_SEQUENCE, prev, cur] = np.concatenate(
                [la_prev, np.ones(448), sd, np.zeros(448)]
            )
            bank[LONG_STOP_SEQUENCE, prev, cur] = np.concatenate(
                [np.zeros(448), sa_prev, np.ones(448), ld]
            )
    return bank


@functools.lru_cache(maxsize=1)
def short_window_bank() -> np.ndarray:
    """[2 prev, 2 cur, 8 windows, 256] per-subwindow short windows."""
    bank = np.zeros((2, 2, 8, 256), dtype=np.float32)
    for prev in (0, 1):
        for cur in (0, 1):
            sa_prev = half_window(prev, 128)
            sa = half_window(cur, 128)
            sd = half_window(cur, 128)[::-1]
            for i in range(8):
                asc = sa_prev if i == 0 else sa
                bank[prev, cur, i] = np.concatenate([asc, sd])
    return bank


@functools.lru_cache(maxsize=4)
def synthesis_banks(device: torch.device):
    """(long basis, long window bank [16, 2048], short basis, short
    window bank [32, 256]) on ``device``; each basis is
    :func:`ops.imdct.imdct_basis` of the IMDCT matrix (K = 1024 and 128).

    Long bank row ``seq * 4 + prev_shape * 2 + shape``; short bank row
    ``(prev_shape * 2 + shape) * 8 + subwindow``."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

    return (
        imdct_basis(dev(imdct_matrix(1024).T)),
        dev(window_bank().reshape(16, 2048)),
        imdct_basis(dev(imdct_matrix(128).T)),
        dev(short_window_bank().reshape(32, 256)),
    )


# ---------------------------------------------------------------------------
# v4 wire
# ---------------------------------------------------------------------------

V3_RUNS = 128
V4_RUNS = 128
V4_PNS = 16
V4_AU_CAP = 1024


def v4_wire_layout(B: int):
    """(name, offset, dtype, shape) of every v4 field inside the packed
    uint8 buffer + total size (4-byte aligned offsets)."""
    fields = [
        ("runs", np.uint32, (B, 2, V4_RUNS)),
        ("pns", np.uint32, (B, 2, V4_PNS)),
        ("regions", np.int16, (B, 2, MAX_FILTERS, 3)),
        ("spec_bit", np.uint16, (B, 2)),
        ("sf_len", np.uint8, (B, 2, V3_RUNS)),
        ("sf_val", np.uint8, (B, 2, V3_RUNS)),
        ("msis_len", np.uint8, (B, V3_RUNS)),
        ("msis_ms", np.uint8, (B, V3_RUNS)),
        ("msis_pos", np.int8, (B, V3_RUNS)),
        ("msis_sign", np.int8, (B, V3_RUNS)),
        ("refl", np.int8, (B, 2, MAX_FILTERS, MAX_ORDER)),
        ("crb", np.uint8, (B, 2, MAX_FILTERS)),
        ("order", np.uint8, (B, 2, MAX_FILTERS)),
        ("n_runs", np.uint8, (B, 2)),
        ("seq", np.uint8, (B, 2)),
        ("shape", np.uint8, (B, 2)),
        ("chan_valid", np.uint8, (B, 2)),
        ("au", np.uint8, (B, V4_AU_CAP)),
    ]
    layout = []
    off = 0
    for name, dt, shp in fields:
        size = int(np.prod(shp)) * np.dtype(dt).itemsize
        layout.append((name, off, dt, shp))
        off = (off + size + 3) & ~3
    return layout, off


def unpack_v4_wire(buf: torch.Tensor, B: int) -> dict:
    """Slice every v4 field out of the packed uint8 tensor and
    reinterpret it in place. u16 and u32 fields come back as int64
    (masked), the others in their own type."""
    out = {}
    for name, off, dt, shp in v4_wire_layout(B)[0]:
        dt = np.dtype(dt)
        view_dt, mask = _WIRE_DTYPES[dt]
        raw = buf[off : off + int(np.prod(shp)) * dt.itemsize]
        x = raw.view(view_dt).reshape(shp)
        if mask is not None:
            x = x.to(torch.int64) & mask
        out[name] = x
    return out


def rle_expand(lens, vals, n: int = N_LINES):
    """Per-line map from run-length tables along the last axis: line i
    takes ``vals[r]`` for the run r with cum(lens)[r-1] <= i < cum(lens)[r];
    lines past the covered total take ``vals[-1]``."""
    ends = torch.cumsum(lens.to(torch.int64), dim=-1).contiguous()
    idx = torch.arange(n, device=lens.device).expand(*ends.shape[:-1], n).contiguous()
    seg = torch.searchsorted(ends, idx, right=True).clamp(max=ends.shape[-1] - 1)
    return torch.gather(vals, -1, seg)


def tns_refl_to_lpc(refl, crb, order):
    """Raw TNS reflection indices -> direct-form LPC [..., MAX_ORDER],
    float32 throughout (ISO 13818-7 tns_data)."""
    c = refl.to(torch.float32)
    half = torch.exp2(crb.to(torch.float32) - 1.0)
    iqfac = torch.clamp_min((half - 0.5) / (math.pi / 2.0), 1e-9)[..., None]
    iqfac_m = torch.clamp_min((half + 0.5) / (math.pi / 2.0), 1e-9)[..., None]
    kk = torch.sin(c / torch.where(c >= 0, iqfac, iqfac_m))
    m_idx = torch.arange(MAX_ORDER, device=refl.device)
    order = order.to(torch.int64)[..., None]
    kk = torch.where(m_idx < order, kk, 0.0)

    lpc = torch.zeros_like(kk)
    for m in range(MAX_ORDER):
        kkm = kk[..., m : m + 1]
        # new[i] = lpc[i] + k_m * lpc[m-1-i] for i < m; new[m] = k_m
        rev = torch.zeros_like(lpc)
        if m:
            rev[..., :m] = torch.flip(lpc[..., :m], dims=(-1,))
        new = torch.where(m_idx < m, lpc + kkm * rev, lpc)
        new = torch.where(m_idx == m, kkm, new)
        lpc = torch.where(m < order, new, lpc)
    return lpc


def perm_filt_from_regions(regions):
    """TNS involutive permutation and filter-id map [B, C, N] from
    per-filter (start, end, direction) regions [B, C, F, 3]; a later
    filter wins where regions overlap."""
    B, C = regions.shape[:2]
    dev = regions.device
    idx = torch.arange(N_LINES, dtype=torch.int32, device=dev)[None, None, :]
    perm = idx.expand(B, C, N_LINES)
    filt_id = torch.full((B, C, N_LINES), -1, dtype=torch.int32, device=dev)
    r = regions.to(torch.int32)
    for f in range(regions.shape[2]):
        start = r[:, :, f, 0, None]
        end = r[:, :, f, 1, None]
        direction = r[:, :, f, 2, None]
        inside = (idx >= start) & (idx < end)
        filt_id = torch.where(inside, f, filt_id)
        perm = torch.where(inside & (direction != 0), start + end - 1 - idx, perm)
    return perm.contiguous(), filt_id


def pns_signs(pns, B: int):
    """(mask, sign) [B, C, N] of the PNS noise lines from the wire's
    ``start | nlines << 12`` entries [B, C, V4_PNS] (int64). The sign
    is the reference's per-(lane, line) hash, in int64 cut to 32 bits."""
    dev = pns.device
    line = torch.arange(N_LINES, dtype=torch.int64, device=dev)
    start = (pns & 4095)[..., None]
    nl = ((pns >> 12) & 1023)[..., None]
    mask = ((line >= start) & (line < start + nl) & (nl > 0)).any(dim=2)
    lane = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    h = (line[None, :] * 2654435761 + lane * 40503 + 12345) & 0xFFFFFFFF
    sign = torch.where(((h >> 13) & 1) == 1, 1, -1).to(torch.int32)[:, None, :]
    return mask, sign


# ---------------------------------------------------------------------------
# TNS (K5)
# ---------------------------------------------------------------------------

def tns_filter_plain(coef, perm, filt_id, lpc):
    """The reference scan, one spectral position per step, vectorized
    over (lane, channel) rows."""
    B, C, N = coef.shape
    perm = perm.long()
    x = torch.gather(coef, -1, perm)
    lrows = lpc.shape[2]
    hist = torch.zeros((B, C, MAX_ORDER), dtype=coef.dtype, device=coef.device)
    prev = torch.full((B, C), -1, dtype=filt_id.dtype, device=coef.device)
    ys = []
    for j in range(N):
        fid = filt_id[..., j]
        act = fid >= 0
        hist = torch.where((fid != prev)[..., None], 0.0, hist)
        sel = fid.clamp(0, lrows - 1).long()[..., None, None].expand(B, C, 1, MAX_ORDER)
        lrow = torch.gather(lpc, 2, sel)[..., 0, :]
        yj = torch.where(act, x[..., j] - (lrow * hist).sum(-1), x[..., j])
        hist = torch.where(act[..., None], torch.cat([yj[..., None], hist[..., :-1]], -1), hist)
        prev = fid
        ys.append(yj)
    return torch.gather(torch.stack(ys, -1), -1, perm)


def tns_filter(coef, perm, filt_id, lpc):
    """K5: coef f32 [B, C, N], perm / filt_id int32 [B, C, N], lpc f32
    [B, C, F, MAX_ORDER] -> filtered f32 [B, C, N]."""
    if coef.device.type == "cpu":
        return tns_filter_plain(coef, perm, filt_id, lpc)
    dev = check_cuda("tns_filter", coef, perm, filt_id, lpc)
    B, C, N = coef.shape
    if N != N_LINES or perm.shape != coef.shape or filt_id.shape != coef.shape:
        raise ValueError(f"tns_filter: coef{tuple(coef.shape)} perm{tuple(perm.shape)}")
    if lpc.shape[:2] != (B, C) or lpc.shape[3] != MAX_ORDER or lpc.shape[2] < 1:
        raise ValueError(f"tns_filter: lpc{tuple(lpc.shape)}")
    if coef.dtype != torch.float32 or lpc.dtype != torch.float32 \
            or perm.dtype != torch.int32 or filt_id.dtype != torch.int32:
        raise TypeError("tns_filter: coef / lpc float32, perm / filt_id int32")
    out = torch.empty_like(coef)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.kernels().skt_tns_filter(
        coef.data_ptr(), perm.data_ptr(), filt_id.data_ptr(), lpc.data_ptr(),
        out.data_ptr(), B * C, lpc.shape[2], stream,
    )
    launch_check("tns_filter", rc)
    tns_filter.launches += 1
    return out


tns_filter.launches = 0


# ---------------------------------------------------------------------------
# frame step
# ---------------------------------------------------------------------------

def init_state(B: int, C: int, device) -> tuple:
    """(saved [B, C, 1024] f32, prev window shape [B, C] i32), zeroed."""
    return (
        torch.zeros((B, C, N_LINES), dtype=torch.float32, device=device),
        torch.zeros((B, C), dtype=torch.int32, device=device),
    )


def _overlap_short(subs):
    """Eight windowed 256-sample subframes [rows, 8, 256] overlapped
    into the 2048-sample frame, starting at sample 448."""
    first = torch.nn.functional.pad(subs[..., :128], (0, 0, 0, 1))
    second = torch.nn.functional.pad(subs[..., 128:], (0, 0, 1, 0))
    mid = (first + second).reshape(subs.shape[0], 9 * 128)
    return torch.nn.functional.pad(mid, (448, 448))


def decode_frame(quant, scale, ms_mask, int_factor, perm, filt_id, lpc, seq,
                 shape, prev_shape, chan_valid, saved):
    """One frame for all streams: (pcm [B, C, 1024] / 32768, new saved,
    new prev_shape), as ``_aac_decode_frame_device``."""
    B, C, N = quant.shape
    dev = quant.device
    coef = dequant(quant, scale)

    if C >= 2:
        m, s = coef[:, 0], coef[:, 1]
        left = torch.where(ms_mask, m + s, m)
        right = torch.where(ms_mask, m - s, s)
        right = torch.where(int_factor != 0.0, left * int_factor, right)
        coef = torch.stack([left, right], dim=1)

    coef = tns_filter(coef.contiguous(), perm.to(torch.int32).contiguous(),
                      filt_id.to(torch.int32).contiguous(),
                      lpc.to(torch.float32).contiguous())

    rows = B * C
    flat = coef.reshape(rows, N)
    m_long, bank_long, m_short, bank_short = synthesis_banks(dev)
    seq_f = seq.reshape(-1).to(torch.int32)
    shape_f = shape.reshape(-1).to(torch.int32)
    prev_f = prev_shape.reshape(-1).to(torch.int32)
    z_long = imdct_window(flat, m_long, bank_long, seq_f * 4 + prev_f * 2 + shape_f)

    sub = torch.arange(8, dtype=torch.int32, device=dev)
    win_short = ((prev_f * 2 + shape_f)[:, None] * 8 + sub).reshape(-1)
    subs = imdct_window(flat.reshape(rows * 8, 128), m_short, bank_short, win_short)
    z_short = _overlap_short(subs.reshape(rows, 8, 256))

    is_short = (seq_f == EIGHT_SHORT_SEQUENCE)[:, None]
    z = torch.where(is_short, z_short, z_long).reshape(B, C, 2 * N)

    valid = chan_valid.bool()[..., None]
    out = torch.where(valid, saved + z[..., :N], 0.0)
    new_saved = torch.where(valid, z[..., N:], saved)
    # an idle channel keeps its window shape, as it keeps its overlap
    # (a departure from the reference, which takes the wire's; see the
    # module's docstring)
    new_shape = torch.where(chan_valid.bool(), shape.to(torch.int32), prev_shape.to(torch.int32))
    return out / 32768.0, new_saved, new_shape


def decode_frame_v4_packed(buf, prev_shape, saved):
    """Device step over the packed v4 wire (uint8 tensor on the
    device), as ``aac_decode_frame_device_v4_packed``. The wire always
    carries two channels; the state's channel count selects how many
    are decoded."""
    B, C = prev_shape.shape
    f = unpack_v4_wire(buf, B)
    lanes = 2 * B

    quant = spectral_decode(
        f["au"],
        f["spec_bit"].reshape(lanes).to(torch.int32),
        f["runs"].reshape(lanes, -1).to(torch.int32),
        f["n_runs"].reshape(lanes).to(torch.int32),
    ).reshape(B, 2, N_LINES)[:, :C]

    pns_mask, sign = pns_signs(f["pns"][:, :C], B)
    quant = torch.where(pns_mask, sign, quant)

    line_sf = rle_expand(f["sf_len"][:, :C], f["sf_val"][:, :C])
    scale = torch.where(line_sf > 0, torch.exp2(0.25 * (line_sf.to(torch.float32) - 100.0)), 0.0)
    ms_line = rle_expand(f["msis_len"], f["msis_ms"])
    is_pos = rle_expand(f["msis_len"], f["msis_pos"])
    is_sign = rle_expand(f["msis_len"], f["msis_sign"])
    int_factor = torch.where(
        is_sign != 0,
        is_sign.to(torch.float32) * torch.exp2(-0.25 * is_pos.to(torch.float32)),
        0.0,
    )
    lpc = tns_refl_to_lpc(f["refl"][:, :C], f["crb"][:, :C], f["order"][:, :C])
    perm, filt_id = perm_filt_from_regions(f["regions"][:, :C])

    return decode_frame(
        quant, scale, ms_line != 0, int_factor, perm, filt_id, lpc,
        f["seq"][:, :C].to(torch.int32), f["shape"][:, :C].to(torch.int32),
        prev_shape, f["chan_valid"][:, :C] != 0, saved,
    )
