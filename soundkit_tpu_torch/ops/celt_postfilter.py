"""CELT comb postfilter and de-emphasis (K11): the sequential part of one
20 ms CELT frame for every lane (counterpart of the blocked
``lax.scan`` in ``soundkit_tpu/ops/celt_batch.py::_celt_synth_step`` and
the masked ``where`` of ``soundkit_tpu/models/opus_batch.py``).

:func:`celt_postfilter` takes the IMDCT output ``full`` f32 [B, C, 1080]
(after the long/short select), the comb parameters ``comb`` f32 [B, 16]
(``ops.celt_batch.pack_comb_params``' layout: the periods as floats,
truncated to int), ``valid`` bool [B] and the carried state, ``ola`` f32
[B, C, 120], ``hist`` f32 [B, C, 1200] (the filtered history) and
``emph`` f32 [B, C], and returns ``(pcm [B, C, 960], new_ola, new_hist,
new_emph)`` in new tensors. Per lane:

1. overlap-add: the frame is ``full[:960]`` with ``ola`` added to its
   first 120 samples; the new ``ola`` is ``full[960:]``;
2. over the line ``x = hist ++ frame``, the comb postfilter
   ``y = x + (1 - f) tap5(x, T0, G0) + f tap5(x, T1, G1)``, reading the
   line as already filtered: stage A (the first 120 samples: periods
   ``comb[0:2]``, gains ``comb[2:8]``, ``f = w^2[j]``), stage B (the rest:
   ``comb[8:10]``, ``comb[10:16]``, ``f = w^2[j - 120]`` then 1);
   ``tap5(x, T, g) = g0 x[j-T] + g1 (x[j-T-1] + x[j-T+1]) + g2 (x[j-T-2]
   + x[j-T+2])``;
3. the de-emphasis ``out[k] = sum_{i<=k} c^(k-i) y[i] + em c^(k+1)`` over
   blocks of 8 samples, ``c = 27853/32768``, ``em`` the previous block's
   ``out[7]`` (the reference's lower-triangular [8, 8] product);
4. ``pcm = out / 32768``; the new ``hist`` is the line's last 1200
   filtered samples, the new ``emph`` the last ``out``.

A lane with ``valid`` False gives zero PCM and passes ``ola``, ``hist``
and ``emph`` through bit for bit. The periods are clamped to [15, 1024]
on both paths so that no read leaves the line: ``pack_comb_params``
clamps them below to 15 and CELT's largest is 1022, so inside that range
(the contract) the clamp changes nothing.

For CUDA tensors it launches ``csrc/celt_postfilter.cu`` and counts
``celt_postfilter.launches``. For CPU tensors it takes
:func:`celt_postfilter_plain`, the reference's scan rendered op for op
(``gather12``, ``tap5``, the [8, 8] de-emphasis matrix ``Lmat`` and
``cpow``; 120 steps of 8 samples), its products in IEEE float32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.codecs.opus_celt import CELT_EMPH_COEFF, OVERLAP
from soundkit_tpu_torch.ops.celt_batch import HIST, N, _win2
from soundkit_tpu_torch.utils.device import check_cuda, ieee_fp32, launch_check

BLK = 8
T_MIN, T_MAX = 15, 1024  # the comb periods' range (see the module's docstring)


@functools.lru_cache(maxsize=8)
def kernel_tables(device: torch.device) -> torch.Tensor:
    """K11's float32 table on ``device``, in the order of the ``T_*``
    offsets of ``csrc/celt_postfilter.cu``: ``w^2`` [120], then ``c^0 ..
    c^8`` [9] as the reference builds its powers (``np.power`` of
    ``np.float32(c)``, then float32), then ``m^0 .. m^32`` [33] for the
    de-emphasis memory's warp scan, ``m`` = that float32 ``c^8`` and each
    power the float32 product of the one before and ``m``."""
    powers = np.power(np.float32(CELT_EMPH_COEFF), np.arange(BLK + 1)).astype(np.float32)
    mpow = [np.float32(1.0)]
    for _ in range(32):
        mpow.append(np.float32(mpow[-1] * powers[BLK]))
    flat = np.concatenate([_win2(), powers, np.array(mpow, np.float32)])
    return torch.from_numpy(flat).to(device)


@functools.lru_cache(maxsize=8)
def _plain_tables(device: torch.device):
    """(fvec [960], Lmat [8, 8], cpow [8]) of the reference's scan on
    ``device``."""
    w2 = _win2()
    fvec = np.concatenate([w2, w2, np.ones(N - 2 * OVERLAP, np.float32)])
    kk = np.arange(BLK)
    lower = np.tril(
        np.power(np.float32(CELT_EMPH_COEFF), (kk[:, None] - kk[None, :]))
    ).astype(np.float32)
    cpow = np.power(np.float32(CELT_EMPH_COEFF), kk + 1).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (fvec, lower.T, cpow))


def _periods(comb, col: int):
    return comb[:, col].to(torch.int32).clamp(T_MIN, T_MAX)


def celt_postfilter_plain(full, comb, valid, ola, hist, emph):
    """:func:`celt_postfilter` in plain torch: the reference's blocked
    scan, op for op, then the validity mask."""
    B, C, _ = full.shape
    frame = torch.cat([full[..., :OVERLAP] + ola, full[..., OVERLAP:N]], dim=-1)
    new_ola = full[..., N:]
    xbuf = torch.cat([hist, frame], dim=-1)  # [B, C, HIST + 960]
    fvec, Lmat, cpow = _plain_tables(full.device)
    Ta0, Ta1, Tb0, Tb1 = (_periods(comb, i) for i in (0, 1, 8, 9))
    ga, gb, gc, gd = comb[:, 2:5], comb[:, 5:8], comb[:, 10:13], comb[:, 13:16]
    ar12 = torch.arange(12, device=full.device)

    def tap5(win12, g3):
        """5-tap comb from a contiguous 12-sample window centered on
        [2:10]: g0*x[j-T] + g1*(x+-1) + g2*(x+-2), per lane/channel."""
        return (g3[:, None, 0:1] * win12[:, :, 2:10]
                + g3[:, None, 1:2] * (win12[:, :, 1:9] + win12[:, :, 3:11])
                + g3[:, None, 2:3] * (win12[:, :, 0:8] + win12[:, :, 4:12]))

    def gather12(buf, start):
        """buf[b, c, start[b] : start[b]+12] as [B, C, 12]."""
        ix = (start[:, None] + ar12[None, :]).to(torch.int64)  # [B, 12]
        return torch.gather(buf, 2, ix[:, None, :].expand(B, C, 12))

    em = emph
    outs = []
    with ieee_fp32():
        for k in range(N // BLK):
            j0 = k * BLK
            inA = k < OVERLAP // BLK
            T0, T1 = (Ta0, Ta1) if inA else (Tb0, Tb1)
            G0, G1 = (ga, gb) if inA else (gc, gd)
            f = fvec[j0: j0 + BLK]
            x_blk = xbuf[..., HIST + j0: HIST + j0 + BLK]
            w0 = gather12(xbuf, HIST + j0 - T0 - 2)
            w1 = gather12(xbuf, HIST + j0 - T1 - 2)
            y = x_blk + (1.0 - f) * tap5(w0, G0) + f * tap5(w1, G1)
            xbuf[..., HIST + j0: HIST + j0 + BLK] = y
            out = y @ Lmat + em[:, :, None] * cpow
            em = out[:, :, BLK - 1]
            outs.append(out)
    pcm = torch.cat(outs, dim=-1) / 32768.0
    new_hist = xbuf[..., -HIST:]
    v = valid.reshape(B, 1, 1).to(torch.bool)
    return (torch.where(v, pcm, 0.0), torch.where(v, new_ola, ola), torch.where(v, new_hist, hist),
            torch.where(v[:, :, 0], em, emph))


def celt_postfilter(full, comb, valid, ola, hist, emph, pcm_out=None):
    """K11: the overlap-add, comb postfilter and de-emphasis of one frame
    for every lane (see the module's docstring) -> (pcm [B, C, 960],
    new_ola, new_hist, new_emph). The PCM goes into ``pcm_out`` (f32 [B,
    C, 960]) where given. On the card every tensor must be contiguous
    (the kernel indexes packed rows) and ``full``, ``ola``, ``hist`` and
    ``pcm_out`` start on a 16-byte boundary; anything else raises."""
    if full.device.type == "cpu":
        pcm, new_ola, new_hist, new_emph = celt_postfilter_plain(full, comb, valid, ola, hist,
                                                                 emph)
        if pcm_out is not None:
            pcm = pcm_out.copy_(pcm)
        return pcm, new_ola, new_hist, new_emph
    outs = () if pcm_out is None else (pcm_out,)
    dev = check_cuda("celt_postfilter", full, comb, valid, ola, hist, emph, *outs)
    B, C = full.shape[0], full.shape[1]
    if C not in (1, 2) or full.shape != (B, C, N + OVERLAP) or comb.shape != (B, 16) or \
            valid.shape != (B,) or ola.shape != (B, C, OVERLAP) or hist.shape != (B, C, HIST) or \
            emph.shape != (B, C) or any(t.shape != (B, C, N) for t in outs):
        raise ValueError(f"celt_postfilter: full{tuple(full.shape)} comb{tuple(comb.shape)} "
                         f"valid{tuple(valid.shape)} ola{tuple(ola.shape)} hist{tuple(hist.shape)} "
                         f"emph{tuple(emph.shape)}; want full [B, C, 1080], comb [B, 16], valid "
                         "[B], ola [B, C, 120], hist [B, C, 1200], emph [B, C], pcm_out "
                         "[B, C, 960], C 1 or 2")
    if valid.dtype != torch.bool or any(t.dtype != torch.float32
                                        for t in (full, comb, ola, hist, emph, *outs)):
        raise TypeError("celt_postfilter: valid bool; full, comb, ola, hist, emph and pcm_out "
                        "float32")
    if any(t.data_ptr() % 16 for t in (full, ola, hist, *outs)):
        raise ValueError("celt_postfilter: full, ola, hist and pcm_out must start on a 16-byte "
                         "boundary")
    pcm = torch.empty((B, C, N), dtype=torch.float32, device=dev) if pcm_out is None \
        else pcm_out
    new_ola, new_hist, new_emph = (torch.empty_like(t) for t in (ola, hist, emph))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.kernels().skt_celt_postfilter(
        full.data_ptr(), comb.data_ptr(), valid.data_ptr(), ola.data_ptr(), hist.data_ptr(),
        emph.data_ptr(), kernel_tables(dev).data_ptr(), pcm.data_ptr(), new_ola.data_ptr(),
        new_hist.data_ptr(), new_emph.data_ptr(), B, C, stream)
    launch_check("celt_postfilter", rc)
    celt_postfilter.launches += 1
    return pcm, new_ola, new_hist, new_emph


celt_postfilter.launches = 0
