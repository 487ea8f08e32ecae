"""SILK LTP/LPC synthesis of one 20 ms frame (K12), the per-sample
recursion of the SILK voice path for every (lane, channel) row
(counterpart of ``synth_frame`` in ``soundkit_tpu/ops/silk_batch.py``,
its ``lax.scan`` at ``:229``).

:func:`silk_synth` takes, for a bandwidth ``bw`` (0 NB, 1 MB, 2 WB:
subframes of ``sfl`` = 40, 60, 80 samples, LPC order 10, 10, 16), the
parse's export of one frame for ``[B, 2]`` rows:

- ``exc`` f32 [B, 2, 320] (the first ``4 sfl`` samples are the frame's
  excitation), ``gains`` f32 [B, 2, 4], ``coef`` f32 [B, 2, 2, 16]
  (lead-in and frame LPC coefficients), ``has_leadin`` and ``voiced``
  i32 [B, 2], ``lags`` i32 [B, 2, 4], ``ltp`` f32 [B, 2, 4, 5],
  ``ltpscale`` f32 [B, 2];
- the carried state: ``out_hist`` f32 [B, 2, 322] and ``lpch_tail`` f32
  [B, 2, 16];

and returns ``(dst f32 [B, 2, 322 + 4 sfl], new lpch_tail)``: the old
history, then the frame's clipped output, as the JAX function does.
Per row, for each subframe i in order:

1. the coefficient select (the lead-in set for subframes 0-1 of a frame
   with a lead-in);
2. on a voiced row, the re-whitening of the output before the subframe:
   an order-``order`` FIR over the 290 samples of ``dst`` before it,
   clipped to [-1, 1], times ``rescale / g_i``, replaces the residual on
   ``[-lag - 2, out_end)``; for i > 0 the residual on ``[out_end, 0)`` is
   scaled by ``g_{i-1} / g_i``;
3. the scan over the subframe: the 5-tap LTP ``r_j = e_j + sum_k ltp[k]
   res[j - lag + 2 - k]`` (voiced rows), written back into the residual;
   ``u_j = r_j g_i + sum_k coeff[k] tail[k]``; the unclipped ``u_j``
   shifts into the tail and ``clip(u_j)`` goes to ``dst``.

The residual line starts at zero each frame; only ``out_hist`` and
``lpch_tail`` carry over. The order of every sum is fixed, the same on
both paths: the FIR and the LTP over k ascending from 0; the LPC as
``(r_j g_i + T) + coeff[0] u_{j-1}``, ``T`` the pairwise sum
(:func:`_pairwise_sum`) of ``coeff[k] u_{j-1-k}`` for k from ``order - 1``
down to 1, so that the chain from one sample to the next is one product
and one add, and a sample's other sums do not wait on each other. The
JAX einsums sum in XLA's order, so the two packages agree to rounding,
not bit for bit. The lags are clamped to [3, 288] on both
paths, so that no read leaves the lines; the lags of a valid stream lie
in [16, 288], where the clamp changes nothing.

For CUDA tensors :func:`silk_synth` launches ``csrc/silk_synth.cu`` and
counts ``silk_synth.launches``. For CPU tensors it takes
:func:`silk_synth_plain`, the same arithmetic in plain torch, vectorized
over the rows: the LTP in blocks of ``min(lag) - 2`` samples (each reads
only finished samples, as the kernel's steps do), the LPC sample by
sample.
"""
from __future__ import annotations

import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.utils.device import check_cuda, launch_check

LTP_ORDER = 5
HIST = 322       # carried output history (silk_parse.cpp SILK_HISTORY)
MAXLAG = 290     # residual line before the frame (SILK_MAX_LAG)
SUBFRAMES = 4
EXC = 320        # the excitation row's length
TAIL = 16
LAG_MIN, LAG_MAX = 3, 288
SFL = (40, 60, 80)
ORDER = (10, 10, 16)


def _pairwise_sum(terms):
    """Neighbours added level by level, an odd last term passed up:
    ``((t0 + t1) + (t2 + t3)) + ...`` (K12's ``tree_sum``)."""
    while len(terms) > 1:
        pairs = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        terms = pairs + terms[len(terms) - 1:] if len(terms) % 2 else pairs
    return terms[0]


def _out_end(i: int, lead: torch.Tensor, sfl: int) -> torch.Tensor:
    """End of subframe i's re-whitened span, relative to its start."""
    if i < 2:
        return torch.full_like(lead, -i * sfl, dtype=torch.int64)
    return torch.where(lead, -(i - 2) * sfl, -i * sfl).to(torch.int64)


def silk_synth_plain(bw: int, exc, gains, coef, has_leadin, voiced, lags, ltp, ltpscale,
                     out_hist, lpch_tail):
    """:func:`silk_synth` in plain torch (see the module's docstring)."""
    sfl, order = SFL[bw], ORDER[bw]
    flen = SUBFRAMES * sfl
    B, C = exc.shape[:2]
    dev = exc.device
    one = torch.ones((), dtype=exc.dtype, device=dev)
    dst = torch.cat([out_hist, torch.zeros((B, C, flen), dtype=exc.dtype, device=dev)], dim=-1)
    res = torch.cat([torch.zeros((B, C, MAXLAG), dtype=exc.dtype, device=dev), exc[..., :flen]],
                    dim=-1)
    voi = voiced != 0
    lead = has_leadin != 0
    lag_c = lags.to(torch.int64).clamp(LAG_MIN, LAG_MAX)
    jgrid = torch.arange(-MAXLAG, 0, device=dev)
    tail = lpch_tail.clone()
    for i in range(SUBFRAMES):
        r0, d0 = MAXLAG + i * sfl, HIST + i * sfl
        coeff = torch.where(lead[..., None], coef[:, :, 0], coef[:, :, 1]) if i < 2 \
            else coef[:, :, 1]
        g = gains[..., i]
        # the re-whitening: the FIR over the 290 samples before the subframe
        acc = torch.zeros((B, C, MAXLAG), dtype=exc.dtype, device=dev)
        for k in range(order):
            acc = acc + dst[..., d0 - MAXLAG - 1 - k: d0 - 1 - k] * coeff[..., k: k + 1]
        v = torch.clamp(dst[..., d0 - MAXLAG: d0] - acc, -one, one)
        end = _out_end(i, lead, sfl)
        rescale = ltpscale if i < 2 else torch.where(lead, one, ltpscale)
        start = -lag_c[..., i] - LTP_ORDER // 2
        m_new = voi[..., None] & (jgrid >= start[..., None]) & (jgrid < end[..., None])
        merged = torch.where(m_new, v * (rescale / g)[..., None], res[..., r0 - MAXLAG: r0])
        if i > 0:
            m_sc = voi[..., None] & (jgrid >= end[..., None])
            merged = torch.where(m_sc, merged * (gains[..., i - 1] / g)[..., None], merged)
        res[..., r0 - MAXLAG: r0] = merged
        # the LTP in blocks that read only finished samples
        taps = ltp[:, :, i]
        lag_i = lag_c[..., i]
        step = int(lag_i[voi].min()) - 2 if bool(voi.any()) else sfl
        for j0 in range(0, sfl, step):
            n = min(step, sfl - j0)
            base = (r0 + j0 - lag_i + LTP_ORDER // 2)[..., None] + torch.arange(n, device=dev)
            ltp_v = torch.zeros((B, C, n), dtype=exc.dtype, device=dev)
            for k in range(LTP_ORDER):
                ltp_v = ltp_v + taps[..., k: k + 1] * torch.gather(res, 2, base - k)
            e = res[..., r0 + j0: r0 + j0 + n]
            res[..., r0 + j0: r0 + j0 + n] = torch.where(voi[..., None], e + ltp_v, e)
        # the LPC, sample by sample
        for j in range(sfl):
            older = _pairwise_sum([coeff[..., k] * tail[..., k] for k in range(order - 1, 0, -1)])
            u = (res[..., r0 + j] * g + older) + coeff[..., 0] * tail[..., 0]
            tail = torch.cat([u[..., None], tail[..., :-1]], dim=-1)
            dst[..., d0 + j] = torch.clamp(u, -one, one)
    return dst, tail


def silk_synth(bw: int, exc, gains, coef, has_leadin, voiced, lags, ltp, ltpscale, out_hist,
               lpch_tail):
    """K12: the LTP/LPC synthesis of one frame for every row at bandwidth
    ``bw`` (see the module's docstring) -> (dst [B, 2, 322 + 4 sfl],
    new lpch_tail [B, 2, 16]). On the card every tensor must be
    contiguous; anything else raises."""
    if exc.device.type == "cpu":
        return silk_synth_plain(bw, exc, gains, coef, has_leadin, voiced, lags, ltp, ltpscale,
                                out_hist, lpch_tail)
    ins = (exc, gains, coef, has_leadin, voiced, lags, ltp, ltpscale, out_hist, lpch_tail)
    dev = check_cuda("silk_synth", *ins)
    if bw not in (0, 1, 2):
        raise ValueError(f"silk_synth: bandwidth {bw}, want 0, 1 or 2")
    B, C = exc.shape[0], 2
    want = ((B, C, EXC), (B, C, SUBFRAMES), (B, C, 2, TAIL), (B, C), (B, C), (B, C, SUBFRAMES),
            (B, C, SUBFRAMES, LTP_ORDER), (B, C), (B, C, HIST), (B, C, TAIL))
    if any(tuple(t.shape) != w for t, w in zip(ins, want)):
        raise ValueError("silk_synth: shapes " + ", ".join(str(tuple(t.shape)) for t in ins)
                         + "; want exc [B, 2, 320], gains [B, 2, 4], coef [B, 2, 2, 16], "
                         "has_leadin and voiced [B, 2], lags [B, 2, 4], ltp [B, 2, 4, 5], "
                         "ltpscale [B, 2], out_hist [B, 2, 322], lpch_tail [B, 2, 16]")
    if any(t.dtype != torch.int32 for t in (has_leadin, voiced, lags)) or \
            any(t.dtype != torch.float32 for t in (exc, gains, coef, ltp, ltpscale, out_hist,
                                                   lpch_tail)):
        raise TypeError("silk_synth: has_leadin, voiced and lags int32; the rest float32")
    dst = torch.empty((B, C, HIST + SUBFRAMES * SFL[bw]), dtype=torch.float32, device=dev)
    new_tail = torch.empty_like(lpch_tail)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.kernels().skt_silk_synth(*(t.data_ptr() for t in ins), dst.data_ptr(),
                                         new_tail.data_ptr(), B * C, bw, stream)
    launch_check("silk_synth", rc)
    silk_synth.launches += 1
    return dst, new_tail


silk_synth.launches = 0
