"""MP3 granule decode (K10): one granule of every stream from its row
of the packed wire to PCM (counterpart of
``soundkit_tpu/ops/mp3_batch.py::mp3_granule_device_compact_packed``
and the step it runs).

:func:`mp3_granule_packed` takes one ``uint8`` row of the packed wire
(:func:`mp3_wire_layout`: block types, alias boundaries, int16 quant and
quarter-exponents, the mixed, M/S and validity flags of ``B`` streams x
2 channels) and the carried state, overlap ``[B, C, 32, 18]`` and FIFO
``[B, C, 1024]`` newest first, and returns ``(pcm [B, C, 576],
new_overlap, new_fifo)`` in new tensors (the PCM into ``pcm_out`` where
given); the inputs are not updated. Channels with ``valid`` 0 give
silent PCM and keep their state.

For CUDA tensors it launches ``csrc/mp3_synth.cu`` (wire fields, scale,
requantize, M/S, alias butterflies, IMDCT, overlap-add and polyphase
synthesis in one kernel) and counts ``mp3_granule_packed.launches``. For
CPU tensors it takes :func:`mp3_granule_packed_plain`, the reference's
computation in plain torch: :func:`unpack_mp3_wire`, :func:`expq_scale`,
:func:`granule_lines` (requantize, M/S, alias), then
:func:`mp3_synth_plain` (both IMDCT paths computed, then one selected;
the 18 rounds shift the FIFO one by one), its products in IEEE float32
whatever the caller's TF32 settings (:func:`utils.device.ieee_fp32`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.ops import mp3_dsp
from soundkit_tpu_torch.utils.device import check_cuda, ieee_fp32, launch_check

GRANULE = 576
FIFO = 1024


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


# ---------------------------------------------------------------------------
# the plain version: requantize, M/S and alias glue, then the synthesis
# ---------------------------------------------------------------------------

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


def expq_scale(expq):
    """Per-line scale of the compact wire's int16 quarter-exponents:
    ``2 ** (expq / 4)``, and 0 for the silent-line sentinel -32768."""
    return torch.where(expq == -32768, 0.0, torch.exp2(0.25 * expq.to(torch.float32)))


def requantize_lines(quant, scale):
    """``sign(q) |q| ** (4 / 3) * scale``, f32, of the lines ``quant``."""
    q = quant.to(torch.float32)
    return torch.sign(q) * q.abs() ** (4.0 / 3.0) * scale


def granule_lines(quant, scale, ms, n_alias_sb):
    """The lines the synthesis takes, f32 [B, C, 576]: requantized, M/S
    where ``ms``, then alias-reduced over each lane's ``n_alias_sb``
    boundaries."""
    return stereo_alias(requantize_lines(quant, scale), ms, n_alias_sb)


def stereo_alias(xr, ms, n_alias_sb):
    """Requantized lines ``xr`` [B, C, 576], M/S where ``ms``, then
    alias-reduced over each lane's ``n_alias_sb`` boundaries."""
    B, C, _ = xr.shape
    dev = xr.device

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


@functools.lru_cache(maxsize=1)
def u_indices() -> np.ndarray:
    """The 512 FIFO positions a round's windowed sum reads: blocks
    ``128 i + [0, 32)`` and ``128 i + [96, 128)``."""
    idx = np.zeros(512, dtype=np.int32)
    for i in range(8):
        idx[64 * i : 64 * i + 32] = np.arange(128 * i, 128 * i + 32)
        idx[64 * i + 32 : 64 * i + 64] = np.arange(128 * i + 96, 128 * i + 128)
    return idx


@functools.lru_cache(maxsize=1)
def _inv_mask() -> np.ndarray:
    m = np.ones((32, 18), np.float32)
    m[1::2, 1::2] = -1.0
    return m


@functools.lru_cache(maxsize=8)
def plain_tables(device: torch.device) -> dict:
    """The plain version's float32 tables on ``device``."""
    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return dict(
        m36=f32(mp3_dsp.imdct_matrix(36)), wins=f32(mp3_dsp.imdct_windows()),
        m12=f32(mp3_dsp.imdct_matrix(12)), ws=f32(mp3_dsp.short_window()),
        n=f32(mp3_dsp.synth_matrix()), d=f32(mp3_dsp.synth_window()),
        u_idx=torch.from_numpy(u_indices().astype(np.int64)).to(device),
        inv=f32(_inv_mask()),
    )


@functools.lru_cache(maxsize=8)
def kernel_tables(device: torch.device) -> torch.Tensor:
    """K10's packed float32 table on ``device``, in the order of the
    ``T_*`` offsets of ``csrc/mp3_synth.cu``: IMDCT 36 transposed [18,
    36], the window bank [4, 36], IMDCT 12 transposed [6, 12], the short
    window [12], the alias butterflies' cs [8] and ca [8], the matrixing
    transposed [32, 64] and the D window [512]."""
    parts = (mp3_dsp.imdct_matrix(36).T, mp3_dsp.imdct_windows(), mp3_dsp.imdct_matrix(12).T,
             mp3_dsp.short_window(), mp3_dsp.CS, mp3_dsp.CA, mp3_dsp.synth_matrix().T,
             mp3_dsp.synth_window())
    flat = np.concatenate([np.asarray(p, np.float32).reshape(-1) for p in parts])
    return torch.from_numpy(flat).to(device)


def window_rows(block_type: torch.Tensor) -> torch.Tensor:
    """Window-bank row of each lane's long path, as the reference's
    gather takes ``wins[where(bt == 2, 0, bt)]``: a negative row counts
    from the end, then the row is clamped to 0..3."""
    bt = block_type.to(torch.int64)
    row = torch.where(bt == 2, 0, bt)
    return torch.where(row < 0, row + 4, row).clamp(0, 3)


def mp3_synth_plain(xr, block_type, mixed, lane_valid, overlap, fifo):
    """The reference's synthesis (``ops/mp3_batch.py:167-226``) for L
    channel lanes: ``xr`` f32 [L, 576] (the lines after requantize, M/S
    and alias), ``block_type`` [L], ``mixed`` and ``lane_valid`` [L]
    (bool or uint8), ``overlap`` [L, 576], ``fifo`` [L, 1024] ->
    ``(pcm [L, 576], new_overlap, new_fifo)``."""
    L = xr.shape[0]
    tb = plain_tables(xr.device)
    valid = lane_valid.bool()
    mixed_f = mixed.bool().reshape(L, 1, 1)
    sb_ids = torch.arange(32, device=xr.device).reshape(1, 32, 1)
    flat = xr.reshape(L, 32, 18)
    with ieee_fp32():
        z_long = torch.einsum("lsk,nk->lsn", flat, tb["m36"])  # [L, 32, 36]
        w_long = tb["wins"][window_rows(block_type)]  # [L, 36]
        w_sel = torch.where(mixed_f & (sb_ids < 2), tb["wins"][0].reshape(1, 1, 36),
                            w_long[:, None, :])
        z_long = z_long * w_sel

        xs = flat.reshape(L, 32, 6, 3).transpose(2, 3)  # [L, 32, 3, 6]
        zs = torch.einsum("lswk,nk->lswn", xs, tb["m12"]) * tb["ws"]  # [L, 32, 3, 12]
        z_short = torch.zeros((L, 32, 36), dtype=zs.dtype, device=xr.device)
        for w in range(3):
            z_short[:, :, 6 + 6 * w: 18 + 6 * w] += zs[:, :, w]

        is_short = (block_type == 2).reshape(L, 1, 1)
        z = torch.where(is_short & ~(mixed_f & (sb_ids < 2)), z_short, z_long)

        ov = overlap.reshape(L, 32, 18)
        out = (z[..., :18] + ov) * tb["inv"]
        new_overlap = torch.where(valid.reshape(L, 1, 1), z[..., 18:], ov).reshape(L, GRANULE)

        ff = fifo
        outs = []
        for r in range(18):
            v = out[:, :, r] @ tb["n"].T  # [L, 64]
            ff = torch.cat([v, ff[:, :960]], dim=1)
            u = ff[:, tb["u_idx"]]  # [L, 512]
            outs.append((u * tb["d"]).reshape(L, 16, 32).sum(dim=1))
    pcm = torch.where(valid.reshape(L, 1), torch.stack(outs, dim=1).reshape(L, GRANULE), 0.0)
    new_fifo = torch.where(valid.reshape(L, 1), ff, fifo)
    return pcm, new_overlap, new_fifo


def mp3_granule_packed_plain(buf, overlap, fifo):
    """:func:`mp3_granule_packed` in plain torch: the wire's views, the
    scale, :func:`granule_lines`, then :func:`mp3_synth_plain`."""
    B, C = overlap.shape[0], overlap.shape[1]
    L = B * C
    f = unpack_mp3_wire(buf, B)
    xr = granule_lines(f["quant"][:, :C].to(torch.int32), expq_scale(f["expq"][:, :C]),
                       f["ms"] != 0, f["nal"][:, :C])
    pcm, new_overlap, new_fifo = mp3_synth_plain(
        xr.reshape(L, GRANULE), f["bt"][:, :C].reshape(L), f["mixed"][:, :C].reshape(L),
        f["valid"][:, :C].reshape(L), overlap.reshape(L, GRANULE), fifo.reshape(L, FIFO))
    return (pcm.reshape(B, C, GRANULE), new_overlap.reshape(B, C, 32, 18),
            new_fifo.reshape(B, C, FIFO))


def mp3_granule_packed(buf, overlap, fifo, pcm_out=None):
    """K10: one granule of every stream from its packed wire row ``buf``
    (uint8 [stride] of :func:`mp3_wire_layout`), with ``overlap`` f32 [B,
    C, 32, 18] and ``fifo`` f32 [B, C, 1024] -> (pcm [B, C, 576],
    new_overlap, new_fifo). The PCM goes into ``pcm_out`` (f32 [B, C,
    576]) where given."""
    if buf.device.type == "cpu":
        pcm, new_overlap, new_fifo = mp3_granule_packed_plain(buf, overlap, fifo)
        if pcm_out is not None:
            pcm = pcm_out.copy_(pcm)
        return pcm, new_overlap, new_fifo
    outs = () if pcm_out is None else (pcm_out,)
    dev = check_cuda("mp3_synth", buf, overlap, fifo, *outs)
    B, C = overlap.shape[0], overlap.shape[1]
    layout, stride = mp3_wire_layout(B)
    if C not in (1, 2) or buf.shape != (stride,) or overlap.shape != (B, C, 32, 18) or \
            fifo.shape != (B, C, FIFO) or any(t.shape != (B, C, GRANULE) for t in outs):
        raise ValueError(f"mp3_synth: buf{tuple(buf.shape)} overlap{tuple(overlap.shape)} "
                         f"fifo{tuple(fifo.shape)}; want a [{stride}] wire row of B = {B}, "
                         "overlap [B, C, 32, 18], fifo [B, C, 1024], pcm_out [B, C, 576], C 1 or 2")
    if buf.dtype != torch.uint8 or any(t.dtype != torch.float32 for t in (overlap, fifo, *outs)):
        raise TypeError("mp3_synth: buf uint8; overlap, fifo and pcm_out float32")
    if fifo.data_ptr() % 16:
        raise ValueError("mp3_synth: the FIFO must start on a 16-byte boundary")
    pcm = torch.empty((B, C, GRANULE), dtype=torch.float32, device=dev) if pcm_out is None \
        else pcm_out
    new_overlap = torch.empty_like(overlap)
    new_fifo = torch.empty_like(fifo)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.kernels().skt_mp3_granule(
        buf.data_ptr(), *(off for _, off, _, _ in layout), overlap.data_ptr(), fifo.data_ptr(),
        kernel_tables(dev).data_ptr(), pcm.data_ptr(), new_overlap.data_ptr(),
        new_fifo.data_ptr(), B, C, stream)
    launch_check("mp3_synth", rc)
    mp3_granule_packed.launches += 1
    return pcm, new_overlap, new_fifo


mp3_granule_packed.launches = 0


def requantize_probe(q, e):
    """K10's requantize arithmetic on ``q`` and ``e`` (int16, same shape):
    (``2 ** (e / 4)``, ``|q| ** (4 / 3)``, the line), f32. On a CUDA
    tensor a probe kernel evaluates them with the granule kernel's own
    device functions; on the CPU the plain version's. A measurement, not
    a decode step: K10's launch count does not move."""
    if q.device.type == "cpu":
        return (expq_scale(e), q.to(torch.float32).abs() ** (4.0 / 3.0),
                requantize_lines(q, expq_scale(e)))
    dev = check_cuda("mp3_requantize_probe", q, e)
    if q.shape != e.shape or q.dtype != torch.int16 or e.dtype != torch.int16:
        raise ValueError("mp3_requantize_probe: q and e int16 of one shape")
    qc, ec = q.contiguous(), e.contiguous()
    outs = [torch.empty(q.shape, dtype=torch.float32, device=dev) for _ in range(3)]
    rc = _build.kernels().skt_mp3_requantize_probe(
        qc.data_ptr(), ec.data_ptr(), qc.numel(), *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(dev).cuda_stream)
    launch_check("mp3_requantize_probe", rc)
    return tuple(outs)
